"""Hand-written Hopper kernels and their host-side layouts.

  csrc/stage_kernels.cu     — the stage kernels' CUDA sources (K1-K4 and
                              the segment combine; built at first use)
  csrc/paper_kernels.cu     — the paper kernels' CUDA sources (K5-K7)
  csrc/lm_kernels.cu        — the LM kernels' CUDA sources (K8-K11)
  native                    — nvcc build, ctypes binding, launch counts
  segment                   — sorted segment sum (the combine kernel)
  codegen/                  — stage IR, the Hopper lowerings and the plan
                              executor (backends "cuda", "cuda-splitk")
  paper, ref, ops           — K5-K7's wrappers, the oracles of K5-K11 (the
                              plain versions) and the drivers of K5-K11
  grouped_matmul, local_attn,
  wkv6, rglru               — K8-K11's wrappers
  util                      — block-aligned segment layouts (numpy)

Submodules are imported where they are used: ``core.executor`` needs
``segment``, and ``codegen`` needs ``core.executor``.
"""
