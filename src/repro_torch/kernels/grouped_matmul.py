"""K8, the expert-grouped GEMM, on the H100.

:func:`grouped_matmul_kernel` replaces
``src/repro/kernels/grouped_matmul.py:39`` ``grouped_matmul_pallas``:
``y[e] = x[e] @ w[e]`` for ``x (E, C, D)`` and ``w (E, D, F)``, summed in
float32, ``y`` in ``x.dtype`` (float32 or bfloat16).  A matrix product
at MoE widths is bound by operations: by the tensor cores in bf16, by
the CUDA cores' FFMA in float32.  The CUDA kernels
(``csrc/lm_kernels.cu``):

* **bf16**: one thread block per (expert, 128-row tile of ``C``,
  128-column tile of ``F``) on the tensor cores: a producer warp keeps
  TMA loads of 64-deep slices of ``x[e]`` and ``w[e]`` in flight in a
  ring of shared-memory stages, and two consumer warpgroups run
  ``wgmma`` on them with float32 sums in registers.  TMA needs 16-byte
  row strides, so :func:`padded_widths` pads ``D`` and ``F`` to multiples
  of 8 (zero columns of ``x`` and rows of ``w`` add nothing; the padded
  columns of ``y`` are sliced off), and the wrapper raises when a tensor
  it hands to TMA has a base pointer that is not 16-byte aligned.
* **float32**: a register-blocked FFMA GEMM on the CUDA cores, bound by
  their 67 TFLOP/s (``wgmma``'s only float32 mode is TF32, whose
  operands it takes only K-major in shared memory, where ``w`` is
  MN-major, and which keeps about three decimal digits: it would miss
  the float32 tolerance).  One block of 256 threads per (expert,
  128-row tile of ``C``, 128-column tile of ``F``); each thread keeps
  8 x 8 sums in registers, four 4 x 4 quadrants 64 rows and columns
  apart, so a warp's 16-byte shared reads have no bank conflict and one
  of them feeds 16 FMAs.  ``D`` goes in steps of 16 through two
  shared-memory stages with one barrier a step: the next step's ``w``
  tile arrives by ``cp.async`` and its ``x`` tile by loads into
  registers while the step's arithmetic runs.  Each output is
  summed from 0 in ascending ``d``, one ``fmaf`` at a time, so two calls
  give the same bits.  When ``x``, ``w`` and ``y`` are 16-byte aligned
  and ``D`` and ``F`` are multiples of 4 it moves 16 bytes a load and a
  store; otherwise the same kernel moves scalars.  Any ``C``, ``D``,
  ``F`` (the edges are zero-filled).

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.grouped_matmul_ref`); on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import native, ref

#: output tile (rows, columns) of the kernel for each precision
TILES = {torch.float32: (128, 128), torch.bfloat16: (128, 128)}
#: TMA's row strides are multiples of 16 bytes: 8 bf16
ALIGN = 8


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the float32 batched product, cast back."""
    return ref.grouped_matmul_ref(x, w)


def padded_widths(D: int, F: int, dtype: torch.dtype) -> tuple[int, int]:
    """``D`` and ``F`` as the kernel in ``dtype`` takes them: rounded up
    to multiples of :data:`ALIGN` for bf16, unchanged for float32."""
    if dtype != torch.bfloat16:
        return D, F
    return -(-D // ALIGN) * ALIGN, -(-F // ALIGN) * ALIGN


def pad_operands(x: torch.Tensor, w: torch.Tensor):
    """``x (E, C, D)`` and ``w (E, D, F)`` zero-padded to the widths of
    :func:`padded_widths` (the tensors themselves when none is needed)."""
    D, F_ = w.shape[1:]
    Dp, Fp = padded_widths(D, F_, x.dtype)
    if Dp != D:
        x = F.pad(x, (0, Dp - D))
    if (Dp, Fp) != (D, F_):
        w = F.pad(w, (0, Fp - F_, 0, Dp - D))
    return x, w


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
    F_ = w.shape[2]
    if max(C, D, F_) >= 2**31:
        raise ValueError("grouped_matmul: C, D and F must be below 2**31")
    if x.dtype == torch.bfloat16:
        if D == 0:
            return torch.zeros((E, C, F_), dtype=x.dtype, device=x.device)
        x, w = pad_operands(x, w)
        for name, t in (("x", x), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"grouped_matmul: {name}'s base pointer "
                                 f"is not 16-byte aligned (TMA needs it)")
    Fp = w.shape[2]
    out = torch.empty((E, C, Fp), dtype=x.dtype, device=x.device)
    bm, bn = TILES[x.dtype]
    native.check_grid(-(-Fp // bn), -(-C // bm), E)
    if E * C * Fp:
        native.launch("grouped_matmul", x.dtype, x.device, x, w, E, C,
                      w.shape[1], Fp, out)
    return out if Fp == F_ else out[..., :F_].contiguous()
