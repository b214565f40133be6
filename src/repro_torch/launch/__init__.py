"""Launch entry points (the JAX package's ``repro.launch``): the serving
CLI, ``serve``; the training driver, ``train`` (one device, or sharded
with ``--mesh`` under ``torchrun``); the meshes, ``mesh``; the dry run,
``dryrun``, with its ``roofline`` terms and ``report`` tables."""
