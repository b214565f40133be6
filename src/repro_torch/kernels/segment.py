"""Sorted segment sum: the segment-combine kernel and its plain version.

Replaces the XLA ``segment_combine`` of the JAX package
(``src/repro/kernels/codegen/lower_gpu.py:109``), the final pass of its
split-K reduce, and every ``jax.ops.segment_sum(...,
indices_are_sorted=True)`` of its engines.  The segment ids are sorted
(CSF order, block layouts), so a segment is the row range
``[ptr[s], ptr[s+1])`` and the combine adds those rows in ascending order —
the order the TPU's sequential accumulator adds them.  No atomics, so the
result is the same on every run.

Bound: bytes.  It reads each input row once and writes each output row
once, one addition per element read; neighbouring threads take
neighbouring columns so reads and writes coalesce.

On CPU tensors :func:`segment_combine` runs :func:`segment_combine_plain`;
on CUDA tensors it launches the kernel (``csrc/stage_kernels.cu``) or
raises.  On either device its gradient is the adjoint gather
(:func:`segment_combine_adjoint`), as ``jax.grad`` of the reference's
``jax.ops.segment_sum`` is a gather.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import native


def segment_ptr(seg: np.ndarray, nseg: int) -> np.ndarray:
    """Row offsets ``ptr`` (``nseg + 1``, int64) of a sorted segment map:
    segment ``s`` owns rows ``[ptr[s], ptr[s+1])``."""
    return np.searchsorted(np.asarray(seg), np.arange(nseg + 1)) \
        .astype(np.int64)


def segment_combine_plain(rows: torch.Tensor, ptr: torch.Tensor,
                          nseg: int) -> torch.Tensor:
    """Plain PyTorch version: ``(n, w)`` rows -> ``(nseg, w)`` sums (rows
    past ``ptr[-1]`` are in no segment, as in the kernel)."""
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=rows.device), ptr.diff())
    out = torch.zeros((nseg, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, seg, rows[:seg.numel()])


def segment_combine_adjoint(grad_out: torch.Tensor, ptr: torch.Tensor,
                            nrows: int) -> torch.Tensor:
    """The adjoint of the sorted segment sum: row ``r`` of the result is
    ``grad_out[s]`` for the segment ``s`` that owns it, zero for a row in
    none (before ``ptr[0]`` or at or past ``ptr[-1]``).  A gather on the
    device; nothing is read back to the host."""
    nseg = grad_out.shape[0]
    if nseg == 0 or nrows == 0:
        return grad_out.new_zeros((nrows,) + tuple(grad_out.shape[1:]))
    seg = torch.searchsorted(
        ptr, torch.arange(nrows, device=ptr.device), right=True) - 1
    inside = (seg >= 0) & (seg < nseg)
    rows = grad_out[seg.clamp(0, nseg - 1)]
    return torch.where(inside[:, None], rows, rows.new_zeros(()))


def _combine(rows: torch.Tensor, ptr: torch.Tensor,
             nseg: int) -> torch.Tensor:
    if rows.device.type == "cpu":
        return segment_combine_plain(rows, ptr, nseg)
    native.check_cuda_tensors(rows, ptr)
    if rows.ndim != 2 or ptr.dtype != torch.int64 \
            or ptr.shape != (nseg + 1,):
        raise ValueError(f"segment_combine: rows {tuple(rows.shape)}, "
                         f"ptr {ptr.dtype}{tuple(ptr.shape)}, nseg {nseg}")
    w = rows.shape[1]
    out = torch.empty((nseg, w), dtype=rows.dtype, device=rows.device)
    if nseg * w == 0:
        return out
    native.check_grid((nseg * w + 255) // 256, 1)
    native.launch("combine", rows.dtype, rows.device, rows, ptr, nseg, w,
                  out)
    return out


class SegmentCombine(torch.autograd.Function):
    """The sorted segment sum as an autograd function: the forward is the
    combine (the kernel on CUDA, its plain version on the CPU), the
    backward :func:`segment_combine_adjoint`."""

    @staticmethod
    def forward(ctx, rows, ptr, nseg):
        ctx.save_for_backward(ptr)
        ctx.nrows = rows.shape[0]
        return _combine(rows, ptr, nseg)

    @staticmethod
    def backward(ctx, grad_out):
        (ptr,) = ctx.saved_tensors
        return segment_combine_adjoint(grad_out, ptr, ctx.nrows), None, None


def segment_combine(rows: torch.Tensor, ptr: torch.Tensor,
                    nseg: int) -> torch.Tensor:
    """Sum the rows of each segment: ``rows`` is ``(n, w)``, ``ptr`` the
    int64 ``(nseg + 1,)`` row offsets of the sorted segments (rows past
    ``ptr[-1]`` are in none).  Differentiable in ``rows``
    (:class:`SegmentCombine`)."""
    return SegmentCombine.apply(rows, ptr, nseg)
