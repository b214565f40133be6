"""K11, the RG-LRU recurrence (RecurrentGemma), on the H100.

:func:`rglru_kernel` replaces ``src/repro/kernels/rglru.py:38``
``rglru_pallas`` on ``x, a (B, T, D)``:
``h_t = a_t h_{t-1} + sqrt(clip(1 - a_t², 0, 1)) x_t`` from ``h = 0``,
with a float32 state and ``h`` in ``x.dtype``.  The CUDA kernel
(``csrc/lm_kernels.cu``) gives each (batch, tile of :data:`TILE`
channels) one thread block and each channel one thread that walks ``T``
in order.  The steps stream through a ring of :data:`STAGES`
shared-memory stages of :func:`stage_steps` steps of the tile's ``x``
and ``a``, the next ones in flight while one is walked.  Each operation
rounds once, in the plain version's order, so the kernel gives the
plain version's bits.  Bound by bytes (three elements moved per step
for about eight operations); no chunk size constrains ``T``.

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.rglru_ref`); on CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native, ref

#: Channels of a thread block, one thread each.
TILE = 128
#: Shared-memory stages of the ring, and the bytes of one (x and a).
STAGES = 6
STAGE_BYTES = 16384


def stage_steps(dtype: torch.dtype) -> int:
    """Steps of one stage of the ring in ``dtype``: 32 in bf16, 16 in
    float32."""
    return STAGE_BYTES // (2 * TILE * dtype.itemsize)


def rglru_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: the time-stepped float32 recurrence."""
    return ref.rglru_ref(x, a)


def rglru_kernel(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K11: x, a ``(B, T, D)`` -> h ``(B, T, D)``."""
    if x.device.type == "cpu":
        return rglru_plain(x, a)
    native.check_cuda_tensors(x, a, dtype=x.dtype)
    native.check_dtype("rglru", x.dtype)
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru: x and a (B, T, D), got {tuple(x.shape)} "
                         f"and {tuple(a.shape)}")
    B, T, D = x.shape
    if max(T, D) >= 2**31:
        raise ValueError("rglru: T and D must be below 2**31")
    out = torch.empty_like(x)
    native.check_grid(B * -(-D // TILE), 1)
    if B * T * D:
        native.launch("rglru", x.dtype, x.device, x, a, B, T, D, out)
    return out
