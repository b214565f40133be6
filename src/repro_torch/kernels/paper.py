"""The paper's hand-written SpTTN kernels K5-K7 on the H100.

Each wrapper checks its inputs and launches its CUDA kernel
(``csrc/paper_kernels.cu``) on CUDA tensors, or runs its plain version
(the oracles of :mod:`repro_torch.kernels.ref` on the same padded
inputs) on CPU tensors.  Inputs are in the padded per-segment layout of
:func:`~repro_torch.kernels.util.padded_segment_layout`: segment ``s``
owns blocks ``[block_ptr[s], block_ptr[s+1])`` of ``block`` rows each.

* **K5** :func:`mttkrp_kernel` replaces ``src/repro/kernels/mttkrp.py:41``
  ``mttkrp_pallas``: ``out[s, :] += vals*mask*B[j]*C[k]`` over the
  segment's rows.  The skewed slice sizes (one mode-0 slice can hold
  most of the rows) would leave a segment's walk to one thread block, so
  each segment's blocks are cut into work items of at most
  :data:`MTTKRP_ITEM_BLOCKS` consecutive blocks
  (:func:`~repro_torch.kernels.codegen.ir.chain_items`, a function of the
  layout alone).  One 256-thread block sums an item's rows into a
  partial row, 16-byte column vectors a thread and several rows' loads
  in flight, its row lanes met in a fixed tree; then the segment combine
  adds each segment's partial rows in item order.  Two launches, no
  atomics, the same bits on every call.
* **K6** :func:`ttmc_kernel` replaces ``src/repro/kernels/ttmc.py:33``
  ``ttmc_pallas``: ``out[s] += ugᵀ·xf`` per block of fibers, giving
  ``(nseg, R, S)``.  That is K1's outer product ``Zd,Ze->de`` with zero
  pad rows and no mask, so K6 runs over K1's work items
  (:func:`~repro_torch.kernels.codegen.ir.reduce_items`, cut on the host
  once per call) with K1's walk: 4 × 4 register blocks of ``(r, t)`` sums
  fed by 16-byte loads where R and S are multiples of 4 and the bases
  16-byte aligned (:func:`ttmc_path`), one output a thread otherwise;
  then the segment combine adds each segment's partial rows in item
  order.  Two launches, no atomics, the same bits on every call.
* **K7** :func:`tttp_kernel` replaces ``src/repro/kernels/tttp.py:24``
  ``tttp_pallas``: ``out[n] = vals[n]·Σ_r U·V·W``, a warp per row, no
  cross-block state.

All three are bound by bytes (a few multiply-adds per element read).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native, ref
from repro_torch.kernels.codegen.ir import (ChainItems, accumulator_type,
                                            chain_items, reduce_items)
from repro_torch.kernels.codegen.stages import OUTER_BLOCK
from repro_torch.kernels.segment import segment_combine

#: K5's work items hold at most this many consecutive blocks of one
#: segment: 4,096 rows at block 256, about 2 MB of ``bg`` and ``cg`` in
#: float32 at R = 64.  Fixed, so the cut (and every float sum's order) is
#: the same on every card.
MTTKRP_ITEM_BLOCKS = 16


def _slot_segments(block_ptr: torch.Tensor, block: int,
                   nseg: int) -> torch.Tensor:
    """The segment of every padded row, from the block offsets."""
    blocks = torch.repeat_interleave(
        torch.arange(nseg, device=block_ptr.device), block_ptr.diff())
    return torch.repeat_interleave(blocks, block)


def _check(block_ptr, nseg: int, block: int, nrows: int, *rows) -> None:
    native.check_cuda_tensors(*rows, block_ptr)
    native.check_cuda_tensors(block_ptr, dtype=torch.int64)
    if block_ptr.shape != (nseg + 1,) or nrows % block:
        raise ValueError(f"{nrows} padded rows, block {block}, block_ptr "
                         f"{tuple(block_ptr.shape)} for {nseg} segments")


def mttkrp_kernel_plain(vals, bg, cg, mask, block_ptr, nseg: int,
                        block: int) -> torch.Tensor:
    """Plain version of K5: the MTTKRP oracle on the padded rows."""
    seg = _slot_segments(block_ptr, block, nseg)
    return ref.mttkrp_ref(vals * mask.to(vals.dtype), bg, cg, seg, nseg)


def mttkrp_kernel(vals, bg, cg, mask, block_ptr, nseg: int,
                  block: int) -> torch.Tensor:
    """K5: vals/mask ``(P,)``, bg/cg ``(P, R)`` -> ``(nseg, R)``: the
    kernel over the work items, then the combine of their partial rows."""
    if vals.device.type == "cpu":
        return mttkrp_kernel_plain(vals, bg, cg, mask, block_ptr, nseg,
                                   block)
    dtype = accumulator_type(bg.dtype)
    vals, bg, cg = (t.to(dtype).contiguous() for t in (vals, bg, cg))
    P, R = bg.shape
    _check(block_ptr, nseg, block, P, vals, bg, cg, mask)
    native.check_cuda_tensors(mask, dtype=torch.float32)
    if vals.shape != (P,) or cg.shape != (P, R) or mask.shape != (P,):
        raise ValueError("mttkrp_kernel: vals/mask (P,), bg/cg (P, R)")
    items = chain_items(block_ptr, MTTKRP_ITEM_BLOCKS)
    partials = torch.empty((items.nitems, R), dtype=dtype, device=bg.device)
    native.check_grid(items.nitems, -(-R // 256))
    if items.nitems * R:
        native.launch("mttkrp", dtype, bg.device, vals, bg, cg, mask,
                      items.item_block, items.nitems, block, R, partials)
    return segment_combine(partials, items.item_ptr, nseg)


def ttmc_kernel_plain(ug, xf, block_ptr, nseg: int,
                      block: int) -> torch.Tensor:
    """Plain version of K6: the TTMc fiber oracle on the padded rows."""
    seg = _slot_segments(block_ptr, block, nseg)
    return ref.ttmc_fiber_ref(xf, ug, seg, nseg)


#: K6's paths, the kernel's ``kTtmc*``: one thread an output ``(r, t)``,
#: or K1's 4 x 4 register blocks of the outer product.
TTMC_SCALAR, TTMC_OUTER = 0, 1


def ttmc_path(ug: torch.Tensor, xf: torch.Tensor) -> int:
    """K6's path on these rows: :data:`TTMC_OUTER` when R and S are
    multiples of the register block's edge and both bases lie on 16-byte
    boundaries, :data:`TTMC_SCALAR` otherwise."""
    R, S = ug.shape[1], xf.shape[1]
    if R % OUTER_BLOCK or S % OUTER_BLOCK or \
            any(t.data_ptr() % 16 for t in (ug, xf)):
        return TTMC_SCALAR
    return TTMC_OUTER


def ttmc_columns(R: int, S: int, path: int) -> int:
    """The threads a row lane of K6 spans on ``path``: one per output or
    per register block."""
    return R * S // (OUTER_BLOCK * OUTER_BLOCK) if path == TTMC_OUTER \
        else R * S


def ttmc_kernel(ug, xf, block_ptr, nseg: int, block: int,
                items: ChainItems | None = None) -> torch.Tensor:
    """K6: ug ``(P, R)``, xf ``(P, S)`` (pad rows zero) ->
    ``(nseg, R, S)``: the kernel over ``items`` (K1's, the layout's
    :func:`~repro_torch.kernels.codegen.ir.reduce_items` on the rows'
    device), then the combine of their partial rows.  Given ``items``,
    nothing is read back to the host; without them they are cut here
    from a host copy of ``block_ptr``."""
    if ug.device.type == "cpu":
        return ttmc_kernel_plain(ug, xf, block_ptr, nseg, block)
    dtype = accumulator_type(torch.promote_types(ug.dtype, xf.dtype))
    ug, xf = ug.to(dtype).contiguous(), xf.to(dtype).contiguous()
    P, R = ug.shape
    S = xf.shape[1]
    _check(block_ptr, nseg, block, P, ug, xf)
    if xf.shape[0] != P:
        raise ValueError("ttmc_kernel: ug and xf need the same rows")
    if items is None:
        items = reduce_items(block_ptr.cpu(), block).to(ug.device)
    native.check_cuda_tensors(ug, items.item_block, items.item_ptr)
    native.check_cuda_tensors(items.item_block, items.item_ptr,
                              dtype=torch.int64)
    if items.item_ptr.shape != (nseg + 1,):
        raise ValueError(f"ttmc_kernel: item_ptr "
                         f"{tuple(items.item_ptr.shape)} for {nseg} "
                         f"segments")
    path = ttmc_path(ug, xf)
    cols = ttmc_columns(R, S, path)
    partials = torch.empty((items.nitems, R * S), dtype=dtype,
                           device=ug.device)
    native.check_grid(items.nitems, -(-cols // native.column_threads(cols)))
    if items.nitems * R * S:
        native.launch("ttmc", dtype, ug.device, ug, xf, items.item_block,
                      items.nitems, block, R, S, path, partials)
    return segment_combine(partials, items.item_ptr, nseg).view(nseg, R, S)


def tttp_kernel_plain(vals, ug, vg, wg) -> torch.Tensor:
    """Plain version of K7: the TTTP oracle."""
    return ref.tttp_ref(vals, ug, vg, wg)


def tttp_kernel(vals, ug, vg, wg, block: int = 512) -> torch.Tensor:
    """K7: vals ``(n,)``, ug/vg/wg ``(n, R)`` -> ``(n,)``; ``block`` rows
    per thread block.  Rows map 1:1, so no padding is needed."""
    if vals.device.type == "cpu":
        return tttp_kernel_plain(vals, ug, vg, wg)
    dtype = accumulator_type(ug.dtype)
    vals, ug, vg, wg = (t.to(dtype).contiguous()
                        for t in (vals, ug, vg, wg))
    native.check_cuda_tensors(vals, ug, vg, wg)
    n, R = ug.shape
    if vals.shape != (n,) or vg.shape != (n, R) or wg.shape != (n, R) \
            or block < 1:
        raise ValueError("tttp_kernel: vals (n,), ug/vg/wg (n, R)")
    out = torch.empty((n,), dtype=dtype, device=ug.device)
    native.check_grid(-(-n // block), 1)
    if n:
        native.launch("tttp", dtype, ug.device, vals, ug, vg, wg, n, block,
                      R, out)
    return out
