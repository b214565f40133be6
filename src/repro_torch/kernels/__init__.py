"""Hand-written Hopper kernels and their host-side layouts.

  csrc/stage_kernels.cu     — the CUDA sources (built at first use)
  native                    — nvcc build, ctypes binding, launch counts
  segment                   — sorted segment sum (the combine kernel)
  codegen/                  — stage IR, the Hopper lowerings and the plan
                              executor (backends "cuda", "cuda-splitk")
  util                      — block-aligned segment layouts (numpy)

Submodules are imported where they are used: ``core.executor`` needs
``segment``, and ``codegen`` needs ``core.executor``.
"""
