"""K8, the expert-grouped GEMM, on the H100.

:func:`grouped_matmul_kernel` replaces
``src/repro/kernels/grouped_matmul.py:39`` ``grouped_matmul_pallas``:
``y[e] = x[e] @ w[e]`` for ``x (E, C, D)`` and ``w (E, D, F)``, summed in
float32, ``y`` in ``x.dtype`` (float32 or bfloat16).  The CUDA kernel
(``csrc/lm_kernels.cu``) gives each thread block a 64 x 64 tile of one
expert's output and walks ``D`` in steps of 16 through shared memory;
edge tiles are masked, so any ``C``, ``D`` and ``F``.  A matrix product
at MoE widths is bound by the tensor cores; this first version runs on
the CUDA cores (PERF.md has its time against the bound).

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.grouped_matmul_ref`); on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native, ref

TILE = 64          # output tile rows and columns of the kernel


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the float32 batched product, cast back."""
    return ref.grouped_matmul_ref(x, w)


def grouped_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8: x ``(E, C, D)`` @ w ``(E, D, F)`` -> ``(E, C, F)``."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w)
    native.check_cuda_tensors(x, w, dtype=x.dtype)
    native.check_dtype("grouped_matmul", x.dtype)
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0],
                                                       x.shape[2]):
        raise ValueError(f"grouped_matmul: x (E, C, D) and w (E, D, F), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if max(C, D, F) >= 2**31:
        raise ValueError("grouped_matmul: C, D and F must be below 2**31")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    native.check_grid(-(-F // TILE), -(-C // TILE), E)
    if E * C * F:
        native.launch("grouped_matmul", x.dtype, x.device, x, w, E, C, D, F,
                      out)
    return out
