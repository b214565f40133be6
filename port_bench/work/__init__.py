"""A call's work, one file per spec: ``count(shape, ranks, levels)``
returns ``{"bytes": ..., "ops": ...}``.  Every input is read once and the
output written once; the operations are the paper's factorize-and-fuse
count.  ``levels[p]`` is nnz^(I1..Ip) of the generated tensor."""
