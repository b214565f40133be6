"""Launch entry points (the JAX package's ``repro.launch``): so far only
the serving CLI, ``serve``.  The mesh, dry-run, report, roofline and
training entry points come with later slices."""
