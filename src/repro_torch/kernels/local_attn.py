"""K9, causal sliding-window attention, on the H100.

:func:`local_attn_kernel` replaces ``src/repro/kernels/local_attn.py:66``
``local_attn_pallas`` on ``(BH, T, D)``: ``out[q] = softmax_k(q·k ·
scale) v`` over the keys ``q - window < k <= q``.  The CUDA kernel
(``csrc/lm_kernels.cu``) gives each thread block one 64-row query tile
and walks only the 64-row key tiles the band touches, with an online
softmax in float32 and the Pallas kernel's rounding points for bf16
(``q * scale`` in the input dtype, float32 logits, ``p`` cast to
``v.dtype`` before ``p @ v``).  The mask is exact for any ``T`` and any
``window >= 1``.  Unlike the Pallas kernel, whose kv-block index mixes
query-tile and key-tile units when ``bq != bk``, the tile sizes are the
kernel's own and the wrapper takes none.
Attention is bound by the tensor cores at these widths; this first
version runs on the CUDA cores (PERF.md).

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.  ``D`` is at most 256 (the kernel keeps a
query tile's float32 accumulators in registers).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native, ref

TILE = 64            # query and key tile rows of the kernel
MAX_HEAD_DIM = 256


def local_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, scale: float | None = None) -> torch.Tensor:
    """Plain version of K9: each chunk of queries against its dense
    slice of keys (:func:`~repro_torch.kernels.ref.local_attn_band`)."""
    return ref.local_attn_band(q, k, v, window, scale)


def local_attn_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int, scale: float | None = None
                      ) -> torch.Tensor:
    """K9: q/k/v ``(BH, T, D)`` -> ``(BH, T, D)``; ``scale`` defaults to
    ``D ** -0.5``."""
    if q.device.type == "cpu":
        return local_attn_plain(q, k, v, window, scale)
    native.check_cuda_tensors(q, k, v, dtype=q.dtype)
    native.check_dtype("local_attn", q.dtype)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"local_attn: q, k, v (BH, T, D) of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, T, D = q.shape
    if not 1 <= D <= MAX_HEAD_DIM or T >= 2**31:
        raise ValueError(f"local_attn: head size {D} not in [1, "
                         f"{MAX_HEAD_DIM}] or T = {T} too long")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    native.check_grid(-(-T // TILE), BH)
    if BH * T:
        # a window of T or more is the causal mask: pass min(window, T)
        native.launch("local_attn", q.dtype, q.device, q, k, v, BH, T, D,
                      min(window, T), scale, out)
    return out
