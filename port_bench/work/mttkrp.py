"""MTTKRP ``ijk,ja,ka->ia``: 2 R (nnz + nnz^(IJ)) operations."""
from port_bench.roofline import VALUE_BYTES, csf_bytes


def count(shape, ranks, levels):
    i, j, k = shape
    r = ranks["a"]
    nbytes = csf_bytes(levels) + VALUE_BYTES * r * (j + k + i)
    return {"bytes": nbytes, "ops": 2 * r * (levels[3] + levels[2])}
