"""Compressed Sparse Fiber format, TPU-adapted (paper §2.2).

The classic CSF tree (pointer chasing) is re-laid-out as *flattened
per-level arrays*, which is the TPU-native form: every sparse loop level p
becomes three contiguous int32 arrays

  coord[p]  : (nfib_p,)  the p-th coordinate of each level-p fiber
  parent[p] : (nfib_p,)  index of the enclosing level-(p-1) fiber
  seg[p]    : (nnz,)     level-p fiber id of every nonzero (for segment_sum)

``nfib_p == nnz^(I1..Ip)`` of the paper.  Traversal becomes vectorized
gather/segment-reduce instead of a tree walk; ranges of children are
contiguous because coordinates are lexicographically sorted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.coo import COOTensor


@dataclasses.dataclass
class CSFTensor:
    """Flattened CSF: one entry per level, plus leaf values.

    level arrays are indexed 1..order (level p compresses the first p modes);
    ``fiber_coords[p]`` is the (nfib_p, p) array of unique p-prefixes.
    """

    coo: COOTensor
    coord: dict[int, np.ndarray]     # p -> (nfib_p,) p-th coordinate
    parent: dict[int, np.ndarray]    # p -> (nfib_p,) parent fiber at p-1
    seg: dict[int, np.ndarray]       # p -> (nnz,) fiber id per nonzero
    nfib: dict[int, int]             # p -> nnz^(I1..Ip)

    @property
    def order(self) -> int:
        return self.coo.order

    @property
    def nnz(self) -> int:
        return self.coo.nnz

    @property
    def values(self) -> np.ndarray:
        return self.coo.values

    @property
    def shape(self) -> tuple[int, ...]:
        return self.coo.shape

    def nnz_level(self, p: int) -> int:
        """nnz^(I1..Ip) (paper §2.2); p=0 -> 1 (the root), p=order -> nnz."""
        if p == 0:
            return 1
        return self.nfib[p]

    def nnz_levels(self) -> dict[int, int]:
        return {p: self.nnz_level(p) for p in range(self.order + 1)}

    def fiber_coords(self, p: int) -> np.ndarray:
        """(nfib_p, p) coordinates of each level-p fiber prefix."""
        out = np.empty((self.nfib[p], p), dtype=np.int32)
        f = np.arange(self.nfib[p])
        for lvl in range(p, 0, -1):
            out[:, lvl - 1] = self.coord[lvl][f]
            f = self.parent[lvl][f]
        return out


def build_csf(coo: COOTensor) -> CSFTensor:
    """One-time host-side construction (sparsity is fixed — paper §1)."""
    coords = coo.coords
    nnz, order = coords.shape
    coord: dict[int, np.ndarray] = {}
    parent: dict[int, np.ndarray] = {}
    seg: dict[int, np.ndarray] = {}
    nfib: dict[int, int] = {}
    prev_seg = np.zeros(nnz, dtype=np.int64)  # level-0: single root fiber
    for p in range(1, order + 1):
        # a new level-p fiber starts where the p-prefix changes
        if nnz == 0:
            coord[p] = np.zeros(0, np.int32)
            parent[p] = np.zeros(0, np.int32)
            seg[p] = np.zeros(0, np.int32)
            nfib[p] = 0
            continue
        changed = np.zeros(nnz, dtype=bool)
        changed[0] = True
        changed[1:] = np.any(coords[1:, :p] != coords[:-1, :p], axis=1)
        fib_id = np.cumsum(changed) - 1
        starts = np.flatnonzero(changed)
        coord[p] = coords[starts, p - 1].astype(np.int32)
        parent[p] = prev_seg[starts].astype(np.int32)
        seg[p] = fib_id.astype(np.int32)
        nfib[p] = int(fib_id[-1]) + 1
        prev_seg = fib_id
    return CSFTensor(coo=coo, coord=coord, parent=parent, seg=seg, nfib=nfib)


def build_csf_batch(coos: "list[COOTensor] | tuple[COOTensor, ...]"
                    ) -> list[CSFTensor]:
    """Amortized CSF construction for a *request batch* (DESIGN.md §9).

    A serving stream hands over many small same-order patterns per step
    (MoE routing masks, per-user masks); building each CSF separately pays
    the fixed numpy dispatch cost of every level pass B times.  This
    builder concatenates the batch with a leading batch-id column — each
    member is already lexicographically sorted, so the concatenation is
    sorted too and needs no re-sort — runs the per-level prefix-change
    scan ONCE over the whole stream, and splits the global fiber arrays
    back per member.  Results are exactly ``[build_csf(c) for c in coos]``
    (tested element-for-element); only the constant factor changes.
    """
    if not coos:
        return []
    order = coos[0].order
    if any(c.order != order for c in coos):
        raise ValueError("batched CSF construction needs same-order tensors")
    sizes = [c.nnz for c in coos]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])
    if total == 0:
        return [build_csf(c) for c in coos]
    # batch-id column in front keeps the concatenation lexicographic and
    # forces a fiber break at every member boundary at every level
    ext = np.empty((total, order + 1), dtype=np.int32)
    ext[:, 0] = np.repeat(np.arange(len(coos), dtype=np.int32), sizes)
    ext[:, 1:] = np.concatenate(
        [c.coords for c in coos if c.nnz], axis=0)
    per = [
        {"coord": {}, "parent": {}, "seg": {}, "nfib": {}}
        for _ in coos]
    # level-0: one root fiber per member, globally numbered by batch id
    prev_seg = ext[:, 0].copy()
    prev_offsets = np.arange(len(coos), dtype=np.int64)
    nnz_member = ext[:, 0]                       # member id per nonzero
    for p in range(1, order + 1):
        changed = np.zeros(total, dtype=bool)
        changed[0] = True
        # prefix includes the batch column, so member boundaries always cut
        changed[1:] = np.any(ext[1:, :p + 1] != ext[:-1, :p + 1], axis=1)
        fib_id = np.cumsum(changed) - 1
        starts = np.flatnonzero(changed)
        fib_member = nnz_member[starts]          # member id per fiber
        fib_offsets = np.searchsorted(starts, offsets[:-1])
        # re-base every global id to its member's range in ONE pass, then
        # split into views — no per-member arithmetic
        coord_all = ext[starts, p].astype(np.int32)
        parent_all = (prev_seg[starts]
                      - prev_offsets[fib_member]).astype(np.int32)
        seg_all = (fib_id - fib_offsets[nnz_member]).astype(np.int32)
        coords = np.split(coord_all, fib_offsets[1:])
        parents = np.split(parent_all, fib_offsets[1:])
        segs = np.split(seg_all, offsets[1:-1])
        for b, d in enumerate(per):
            d["coord"][p] = coords[b]
            d["parent"][p] = parents[b]
            d["seg"][p] = segs[b]
            d["nfib"][p] = len(coords[b])
        prev_seg = fib_id
        prev_offsets = fib_offsets.astype(np.int64)
    out = []
    for b, c in enumerate(coos):
        if c.nnz == 0:
            out.append(build_csf(c))  # empty arrays, canonical layout
            continue
        d = per[b]
        out.append(CSFTensor(coo=c, coord=d["coord"], parent=d["parent"],
                             seg=d["seg"], nfib=d["nfib"]))
    return out


def level_segments(csf: CSFTensor, child: int, parentlvl: int) -> np.ndarray:
    """Segment ids mapping level-``child`` fibers to level-``parentlvl``
    fibers (child > parentlvl).  parentlvl=0 maps everything to one root."""
    if child == parentlvl:
        raise ValueError("child must be deeper than parent")
    if parentlvl == 0:
        return np.zeros(csf.nfib[child] if child > 0 else 1, dtype=np.int32)
    f = np.arange(csf.nfib[child], dtype=np.int64)
    segs = f
    for lvl in range(child, parentlvl, -1):
        segs = csf.parent[lvl][segs]
    return segs.astype(np.int32)
