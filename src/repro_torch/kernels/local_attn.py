"""K9, causal sliding-window attention, on the H100.

:func:`local_attn_kernel` replaces ``src/repro/kernels/local_attn.py:66``
``local_attn_pallas`` on ``(BH, T, D)``: ``out[q] = softmax_k(q·k ·
scale) v`` over the keys ``q - window < k <= q``.  Each thread block of
the CUDA kernels (``csrc/lm_kernels.cu``) takes one query tile and walks
only the 64-row key tiles the band touches, with an online softmax in
float32 and the Pallas kernel's rounding points for bf16 (``q * scale``
in the input dtype, float32 logits, ``p`` cast to ``v.dtype`` before
``p @ v``, ``l`` summed from the float32 ``p``).  The mask is exact for
any ``T`` and any ``window >= 1``.  Unlike the Pallas kernel, whose
kv-block index mixes query-tile and key-tile units when ``bq != bk``,
the tile sizes are the kernel's own and the wrapper takes none.

* **bf16**, on the tensor cores: 128-row query tiles, two consumer
  warpgroups of 64 rows each run ``Q·Kᵀ`` and ``P·V`` as ``wgmma`` while
  a producer warpgroup keeps TMA loads of K and V in flight in a ring of
  shared-memory stages; ``P`` stays in registers.  TMA needs 16-byte row
  strides, so :func:`padded_head` pads ``D`` to a multiple of 8 (zero
  columns add nothing to ``q·k`` and give zero output columns, which are
  sliced off) and the original ``D``'s scale is passed.
* **float32**, on the CUDA cores (``wgmma``'s float32 mode is TF32, which
  misses the float32 tolerance): 64-row query tiles; 16-byte ``cp.async``
  loads of K and V take turns in two shared-memory stages, so each lands
  while the other product runs; each thread keeps 8 x 8 register blocks
  (scores over a quarter of ``d``, added across lanes by shuffles, and
  outputs at D = 256) read from shared memory as 16-byte vectors, with
  the softmax statistics in registers.  :func:`padded_head` pads ``D`` to
  a multiple of 4.

Both kernels need 16-byte aligned base pointers: a tensor whose base is
not raises (a padded copy is aligned).  On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.
``D`` is at most 256 (the kernels keep a query tile's float32
accumulators in registers).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import native, ref

#: query tile rows of the kernel for each precision (key tiles: 64)
QUERY_TILES = {torch.float32: 64, torch.bfloat16: 128}
MAX_HEAD_DIM = 256
#: the kernels' rows are whole 16-byte copies (TMA in bf16, cp.async in
#: float32): 8 bf16 or 4 float32 values
ALIGN = {torch.float32: 4, torch.bfloat16: 8}


def local_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, scale: float | None = None) -> torch.Tensor:
    """Plain version of K9: each chunk of queries against its dense
    slice of keys (:func:`~repro_torch.kernels.ref.local_attn_band`)."""
    return ref.local_attn_band(q, k, v, window, scale)


def padded_head(D: int, dtype: torch.dtype) -> int:
    """The head size the kernel in ``dtype`` takes: ``D`` rounded up to a
    multiple of :data:`ALIGN`'s entry for ``dtype``."""
    return -(-D // ALIGN[dtype]) * ALIGN[dtype]


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
    Dp = padded_head(D, q.dtype)
    if Dp != D:
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"local_attn: {name}'s base pointer is not "
                             f"16-byte aligned (the kernels' 16-byte copies "
                             f"need it)")
    out = torch.empty_like(q)
    native.check_grid(-(-T // QUERY_TILES[q.dtype]), BH)
    if BH * T:
        # a window of T or more is the causal mask: pass min(window, T)
        native.launch("local_attn", q.dtype, q.device, q, k, v, BH, T, Dp,
                      min(window, T), scale, out)
    return out if Dp == D else out[..., :D].contiguous()
