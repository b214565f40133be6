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
raises.
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


def segment_combine(rows: torch.Tensor, ptr: torch.Tensor,
                    nseg: int) -> torch.Tensor:
    """Sum the rows of each segment: ``rows`` is ``(n, w)``, ``ptr`` the
    int64 ``(nseg + 1,)`` row offsets of the sorted segments (rows past
    ``ptr[-1]`` are in none)."""
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
