"""Host-side static layout helpers for the Pallas kernels.

The paper's central structural fact — SpTTN sparsity is FIXED — lets us
precompute, once, a block-aligned padded layout per segment (output row):
every nonzero/fiber block then belongs to exactly one output row, so the
TPU kernel is a sequential grid of dense VMEM-resident blocks whose output
BlockSpec is driven by a scalar-prefetched block->row map.  This replaces
the CSF pointer-chasing of the CPU implementation (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PaddedSegments:
    """Block-aligned segment layout (static; computed once per pattern).

    gather:      (P,) int32 — source nonzero index per padded slot (0 for pads)
    mask:        (P,) float32 — 1.0 for real slots, 0.0 for pads
    block_seg:   (P//block,) int32 — output segment of each block
    block_first: (P//block,) int32 — 1 iff block is its segment's first
    nseg, block: ints
    """

    gather: np.ndarray
    mask: np.ndarray
    block_seg: np.ndarray
    block_first: np.ndarray
    nseg: int
    block: int

    @property
    def padded_len(self) -> int:
        return self.gather.shape[0]

    @property
    def nblocks(self) -> int:
        return self.padded_len // self.block


def padded_segment_layout(seg: np.ndarray, nseg: int,
                          block: int) -> PaddedSegments:
    """seg must be sorted ascending (CSF order guarantees this)."""
    seg = np.asarray(seg, dtype=np.int64)
    counts = np.bincount(seg, minlength=nseg)
    # every segment gets at least one block so its output row is zeroed
    padded = np.maximum(block, ((counts + block - 1) // block) * block)
    offs = np.concatenate([[0], np.cumsum(padded)])
    total = int(offs[-1])
    gather = np.zeros(total, dtype=np.int32)
    mask = np.zeros(total, dtype=np.float32)
    if seg.size:
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(seg.size, dtype=np.int64) - starts[seg]
        dst = offs[seg] + rank
        gather[dst] = np.arange(seg.size, dtype=np.int32)
        mask[dst] = 1.0
    nblocks = total // block
    block_seg = np.repeat(np.arange(nseg, dtype=np.int32),
                          (padded // block).astype(np.int64))
    block_first = np.zeros(nblocks, dtype=np.int32)
    first_of_seg = (offs[:-1] // block).astype(np.int64)
    block_first[first_of_seg] = 1
    return PaddedSegments(gather=gather, mask=mask, block_seg=block_seg,
                          block_first=block_first, nseg=nseg, block=block)


def pad_segment_layout(lay: PaddedSegments,
                       padded_len: int) -> PaddedSegments:
    """Extend a layout with inert trailing blocks up to ``padded_len``.

    The stacked distributed engine pads every shard's layout to the
    mesh-wide maximum so one kernel trace serves all shards.  Appended
    slots gather nonzero 0 under mask 0 (contribute nothing) and appended
    blocks replicate the final block's segment id with ``block_first=0``,
    so they re-visit the already-initialized last output row and add an
    all-masked (zero) partial — the output BlockSpec's revisit runs stay
    contiguous and every row keeps its exact value.
    """
    if padded_len == lay.padded_len:
        return lay
    if padded_len < lay.padded_len or padded_len % lay.block:
        raise ValueError(
            f"padded_len {padded_len} must be a multiple of block "
            f"{lay.block} and >= current length {lay.padded_len}")
    extra = padded_len - lay.padded_len
    nblocks = padded_len // lay.block - lay.nblocks
    return PaddedSegments(
        gather=np.pad(lay.gather, (0, extra)),
        mask=np.pad(lay.mask, (0, extra)),
        block_seg=np.pad(lay.block_seg, (0, nblocks), mode="edge"),
        block_first=np.pad(lay.block_first, (0, nblocks)),
        nseg=lay.nseg, block=lay.block)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
