"""Launch entry points (the JAX package's ``repro.launch``): the serving
CLI, ``serve``, and the one-device training driver, ``train``.  The mesh,
dry-run, report and roofline entry points come with later slices."""
