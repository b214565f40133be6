"""StagePlanExecutor — lower any fused SpTTN plan to Hopper stage kernels.

The counterpart of the JAX package's ``PallasPlanExecutor``
(``src/repro/kernels/codegen/executor.py``), and, like it, a subclass of
the eager engine (:class:`~repro_torch.core.executor.VectorizedExecutor`):
operand lifting, dense fallbacks and output materialization are shared,
so the two engines agree by construction everywhere except the lowering
unit — ``_fiber_contract``, where the einsum + segment sum becomes
generated stages.  The executor emits the *target-neutral* stage IR
(kernels/codegen/ir.py) — the same records the JAX package emits for the
same plan and operand — and hands it to the registered lowering for its
``target``: ``"hopper"`` (segment loop, ``backend="cuda"``) or
``"hopper-splitk"`` (split-K + combine, ``backend="cuda-splitk"``).

Per reducing term the generator picks one of two lowerings from the
static segment profile:

* **row** — a reduce stage: fibers padded per output segment to block
  multiples (``padded_segment_layout``), one output row per segment.
  Chosen when segments are block-sized, so padding stays bounded.
* **segsum** — a product stage followed by a sorted segment sum (the
  combine kernel).  Chosen when segments are tiny (e.g. leaf -> next
  level), where block-per-segment padding would explode.

Under ``strategy="fused"`` a provably safe chain of reducing terms
(``fusible_chains``) is one ``chain`` lowering unit instead: the K3
kernel (work items of a bounded number of blocks, their partial rows
added by the combine) on ``"hopper"``, split-K partials plus one
batched einsum and one combine per link on ``"hopper-splitk"``.

The gathers that build each stage's operand rows stay PyTorch indexing,
as they stay XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.analysis.invariants import fusible_chains
from repro_torch.core.executor import (CSFArrays, DenseVal, FiberVal,
                                       VectorizedExecutor, segment_sum)
from repro_torch.core.loopnest import LoopOrder
from repro_torch.core.paths import ContractionPath
from repro_torch.core.spec import SpTTNSpec
# importing the lowering modules registers the built-in targets
from repro_torch.kernels.codegen import lower_gpu, stages  # noqa: F401
from repro_torch.kernels.codegen.ir import (TILE_SUBLANE, ChainLayout,
                                            ChainLink, Stage, StageIR,
                                            StageOperand, get_lowering,
                                            index_tables, link_stage)
from repro_torch.kernels.segment import segment_ptr
from repro_torch.kernels.util import padded_segment_layout, round_up

DEFAULT_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class SegmentProfile:
    """Static reduction profile of one (lvl → out_lvl) CSF segment map:
    everything the strategy choice reads about the pattern."""

    lvl: int
    out_lvl: int
    nfib: int            # level-``lvl`` fibers entering the reduction
    nseg: int            # level-``out_lvl`` output rows
    max_seg: int         # longest segment (fibers feeding one output row)
    mean_seg: float      # nfib / nseg

    @staticmethod
    def row_decision(nfib: int, nseg: int, block: int) -> bool:
        """The strategy formula on the O(1) fiber counts alone: row wins
        when block-per-segment padding stays within ~4x of the fiber
        count (small kernels always qualify via the absolute floor)."""
        return nseg * block <= max(4 * nfib, 4 * block)


def layout_cache(csf: CSFArrays) -> dict:
    """The per-operand static layout cache (``CSFArrays.cache``).
    Stage entries, key ``(lvl, out_lvl, block)``: ``(lay, gather, mask,
    block_ptr)`` with the last three on the operand's device; index-table
    entries, key ``("tables", stage fields)``: :class:`IndexTables`."""
    return csf.cache


def stage_layout_key(lvl: int, out_lvl: int, block: int) -> tuple:
    return (lvl, out_lvl, block)


def chain_layout_key(lvl0: int, levels: tuple, block: int) -> tuple:
    return ("chain", lvl0, tuple(levels), block)


def chain_block_arrays(csf: CSFArrays, lvl0: int, levels: tuple,
                       block: int):
    """Numpy block-level chain layout: the padded innermost layout (the
    level-``lvl0`` fibers padded per ``levels[0]`` row to block
    multiples) plus, at every chain level, the per-block segment ids,
    segment-opens flags and segment-closes flags."""
    seg0 = csf.host_segments(lvl0, levels[0])
    lay = padded_segment_layout(seg0, csf.nfib[levels[0]], block)

    def firsts_of(seg: np.ndarray) -> np.ndarray:
        f = np.zeros(len(seg), np.int32)
        f[0] = 1
        f[1:] = seg[1:] != seg[:-1]
        return f

    def lasts_of(seg: np.ndarray) -> np.ndarray:
        last = np.zeros(len(seg), np.int32)
        last[-1] = 1
        last[:-1] = seg[1:] != seg[:-1]
        return last

    segs = [lay.block_seg.astype(np.int32)]
    for prev, lvl in zip(levels, levels[1:]):
        up = (csf.host_segments(prev, lvl)[segs[-1]] if lvl > 0
              else np.zeros_like(segs[-1]))
        segs.append(up.astype(np.int32))
    firsts = [lay.block_first.astype(np.int32)] + \
        [firsts_of(s) for s in segs[1:]]
    lasts = [lasts_of(s) for s in segs]
    return lay, segs, firsts, lasts


def segment_profile(csf: CSFArrays, lvl: int, out_lvl: int) -> SegmentProfile:
    """Profile the ``(lvl, out_lvl)`` segment map of ``csf`` (from the
    host CSF; one O(nfib) pass)."""
    nfib = csf.nfib[lvl]
    nseg = csf.nfib[out_lvl] if out_lvl > 0 else 1
    if nfib == 0:
        return SegmentProfile(lvl, out_lvl, 0, nseg, 0, 0.0)
    counts = np.bincount(csf.host_segments(lvl, out_lvl),
                         minlength=max(nseg, 1))
    return SegmentProfile(lvl, out_lvl, nfib, nseg, int(counts.max()),
                          nfib / max(nseg, 1))


class StagePlanExecutor(VectorizedExecutor):
    """Execute a (path, order) plan through generated stage kernels.

    ``strategy`` forces the reduction lowering (``"row"``/``"segsum"``);
    ``"auto"`` picks per stage from the segment profile; ``"fused"``
    runs each provably safe reducing chain as one ``chain`` unit and
    picks the rest as ``"auto"`` does.  ``tile_align`` asks
    for the TPU's pad-to-tile IR (``Stage.tile``, block rounded up to a
    multiple of 8); the Hopper lowerings read only the block.

    ``target`` names the registered stage lowering: ``"hopper"`` or
    ``"hopper-splitk"``.  The executor emits the same IR either way.
    """

    def __init__(self, spec: SpTTNSpec, path: ContractionPath,
                 order: LoopOrder, block: int = DEFAULT_BLOCK,
                 strategy: str = "auto", tile_align: bool = False,
                 target: str = "hopper"):
        super().__init__(spec, path, order)
        if strategy not in ("auto", "row", "segsum", "fused"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if block < 1:
            raise ValueError(f"block must be positive, got {block}")
        self.target = target
        self.lowering = get_lowering(target)   # ValueError on unknown
        self.tile_align = bool(tile_align)
        self.block = round_up(block, TILE_SUBLANE) if self.tile_align \
            else block
        self.strategy = strategy
        # every Stage / StageIR emitted by the latest call, in order (a
        # fused chain also records (stage, links) in emitted_chains)
        self.emitted_stages: list[Stage] = []
        self.emitted_chains: list[tuple[Stage, tuple[ChainLink, ...]]] = []
        self.emitted_ir: list[StageIR] = []
        # (lvl, out_lvl) -> "row" | "segsum" | "fused", recorded per call;
        # a fused chain is one entry, keyed (innermost lvl, final out_lvl)
        self.stage_strategy: dict[tuple[int, int], str] = {}
        # start tid -> member tids of each provably safe reducing chain
        self._chains = (fusible_chains(spec, path)
                        if strategy == "fused" else {})

    def __call__(self, csf, factors):
        self.emitted_stages.clear()
        self.emitted_chains.clear()
        self.emitted_ir.clear()
        self.stage_strategy.clear()
        return super().__call__(csf, factors)

    # -- static layouts (pattern-fixed, cached on the CSFArrays) -------- #
    def _layout(self, csf: CSFArrays, lvl: int, out_lvl: int):
        cache = layout_cache(csf)
        key = stage_layout_key(lvl, out_lvl, self.block)
        if key not in cache:
            nseg = csf.nfib[out_lvl] if out_lvl > 0 else 1
            lay = padded_segment_layout(csf.host_segments(lvl, out_lvl), nseg,
                                        self.block)
            dev = csf.device
            cache[key] = (
                lay,
                torch.from_numpy(lay.gather.astype(np.int64)).to(dev),
                torch.from_numpy(lay.mask).to(dev),
                torch.from_numpy(segment_ptr(lay.block_seg, nseg)).to(dev))
        return cache[key]

    def _tables(self, csf: CSFArrays, stage: Stage):
        cache = layout_cache(csf)
        key = ("tables", stage.operands, stage.out_subs, stage.out_shape)
        if key not in cache:
            cache[key] = index_tables(stage, csf.device)
        return cache[key]

    def strategy_for(self, csf: CSFArrays, lvl: int, out_lvl: int) -> str:
        """Reduction lowering for this operand's (lvl, out_lvl) stage,
        chosen from its fiber counts unless forced by ``strategy``
        (under ``"fused"``, stages outside a chain choose as ``"auto"``)."""
        if self.strategy not in ("auto", "fused"):
            return self.strategy
        nfib = csf.nfib[lvl]
        nseg = csf.nfib[out_lvl] if out_lvl > 0 else 1
        row = SegmentProfile.row_decision(nfib, nseg, self.block)
        return "row" if row else "segsum"

    def _use_row(self, csf: CSFArrays, lvl: int, out_lvl: int) -> bool:
        choice = self.strategy_for(csf, lvl, out_lvl)
        self.stage_strategy[(lvl, out_lvl)] = choice
        return choice == "row"

    # -- fused reducing chains ----------------------------------------- #
    def _chain_len(self, tid: int) -> int:
        chain = self._chains.get(tid)
        return len(chain) if chain else 1

    def _chain_layout(self, csf: CSFArrays, lvl0: int,
                      levels: tuple) -> ChainLayout:
        """The chain's :class:`ChainLayout` and its padded innermost
        layout, cached on the operand like the single-stage layouts.
        ``levels`` are the chain's output levels innermost-first (e.g.
        MTTKRP's ``(2, 1)``)."""
        cache = layout_cache(csf)
        key = chain_layout_key(lvl0, levels, self.block)
        if key not in cache:
            lay, segs, firsts, lasts = chain_block_arrays(
                csf, lvl0, levels, self.block)
            dev = csf.device
            inner = [a for j in range(len(levels) - 1)
                     for a in (segs[j], firsts[j], lasts[j])]
            nlvl = [csf.nfib[lvl] if lvl > 0 else 1 for lvl in levels]

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            chain = ChainLayout(
                mask=up(lay.mask),
                levels=up(np.stack(inner)),
                out_block_ptr=up(segment_ptr(segs[-1], nlvl[-1])),
                block_ptr=up(segment_ptr(segs[0], nlvl[0])),
                parent_ptrs=tuple(csf.segment_ptr(a, b) for a, b in
                                  zip(levels, levels[1:])))
            cache[key] = (lay, up(lay.gather.astype(np.int64)), chain)
        return cache[key]

    def _exec_chain(self, csf: CSFArrays, factors, env: dict, tid: int,
                    length: int):
        """Lower a whole detected reducing chain as one ``chain`` unit:
        the innermost term's block contraction feeds one crossing buffer
        per intermediate level, and segment closes carry partials
        outward."""
        tids = self._chains[tid]
        terms = [self.path[k] for k in tids]
        first = terms[0]
        lvl0 = self._sparse_level(first.indices)
        levels = tuple(self._sparse_level(t.out.indices) for t in terms)
        dims = self.spec.dims
        sp = set(self.spos)

        if csf.nfib.get(lvl0, 0) == 0:
            # degenerate pattern: the staged per-term path
            val = None
            for k in tids:
                val = self._exec_term(csf, factors, env, self.path[k])
                if k != tids[-1]:
                    env[self.path[k].out.name] = val
            return val

        a = self._get_operand(csf, factors, env, first.lhs)
        b = self._get_operand(csf, factors, env, first.rhs)
        fa, da = self._lift(csf, a, first.lhs, lvl0)
        fb, db = self._lift(csf, b, first.rhs, lvl0)
        dtype = torch.promote_types(fa.dtype, fb.dtype)

        operands, arrays = [], []
        for arr, inds in ((fa, da), (fb, db)):
            operands.append(StageOperand(
                subs="".join(self._letter[i] for i in inds),
                shape=tuple(dims[i] for i in inds),
                fiber=arr.ndim == len(inds) + 1))
            arrays.append(arr)
        out_dense0 = tuple(i for i in first.out.indices if i not in sp)
        out_subs = "".join(self._letter[i] for i in out_dense0)
        out_shape = tuple(dims[i] for i in out_dense0)

        lay, gather, chain = self._chain_layout(csf, lvl0, levels)
        nfib0 = csf.nfib[lvl0]
        padded = [arr.reshape(nfib0, -1)[gather] if op.fiber
                  else arr.reshape(1, -1)
                  for arr, op in zip(arrays, operands)]
        stage = Stage(operands=tuple(operands), out_subs=out_subs,
                      out_shape=out_shape, reduce=True, block=self.block,
                      nseg=lay.nseg, tile=self.tile_align)

        links, link_arrays = [], []
        for pos, term in enumerate(terms[1:]):
            lvl_k = levels[pos]          # level the intermediate lives on
            inter = terms[pos].out.name
            other = term.rhs if term.lhs.name == inter else term.lhs
            val = self._get_operand(csf, factors, env, other)
            arr, dense_inds = self._lift(csf, val, other, lvl_k)
            fiber = arr.ndim == len(dense_inds) + 1
            link_ops = (StageOperand(subs=out_subs, shape=out_shape,
                                     fiber=True),
                        StageOperand(
                            subs="".join(self._letter[i]
                                         for i in dense_inds),
                            shape=tuple(dims[i] for i in dense_inds),
                            fiber=fiber))
            link_arrays.append(arr.reshape(csf.nfib[lvl_k], -1) if fiber
                               else arr.reshape(1, -1))
            out_dense = tuple(i for i in term.out.indices if i not in sp)
            out_subs = "".join(self._letter[i] for i in out_dense)
            out_shape = tuple(dims[i] for i in out_dense)
            links.append(ChainLink(operands=link_ops, out_subs=out_subs,
                                   out_shape=out_shape))

        out_lvl = levels[-1]
        nseg_out = csf.nfib[out_lvl] if out_lvl > 0 else 1
        dtype = torch.promote_types(dtype, functools.reduce(
            torch.promote_types, [x.dtype for x in link_arrays]))
        nseg_lvls = tuple(csf.nfib[lv] if lv > 0 else 1 for lv in levels)
        ir = StageIR(kind="chain", stage=stage, links=tuple(links),
                     nseg_out=nseg_out, nseg_lvls=nseg_lvls)
        self.emitted_stages.append(stage)
        self.emitted_chains.append((stage, tuple(links)))
        self.emitted_ir.append(ir)
        link_tables = tuple(self._tables(csf, link_stage(link))
                            for link in links)
        out2d = self.lowering.chain(ir, chain, self._tables(csf, stage),
                                    link_tables, padded, link_arrays, dtype)
        self.stage_strategy[(lvl0, out_lvl)] = "fused"
        arr = out2d.reshape((nseg_out,) + out_shape)
        if out_lvl == 0:
            return DenseVal(arr.reshape(out_shape), out_dense)
        return FiberVal(arr, out_lvl, out_dense)

    # -- the lowering unit ---------------------------------------------- #
    def _fiber_contract(self, csf: CSFArrays, fa, da, fb, db,
                        out_dense: tuple[str, ...], lvl: int,
                        out_lvl: int) -> torch.Tensor:
        dims = self.spec.dims
        nfib = csf.nfib[lvl]
        oshape = tuple(dims[i] for i in out_dense)
        dtype = torch.promote_types(fa.dtype, fb.dtype)
        reduce_ = out_lvl < lvl

        if nfib == 0:
            if out_lvl == 0:
                return torch.zeros(oshape, dtype=dtype, device=csf.device)
            rows = csf.nfib[out_lvl] if reduce_ else 0
            return torch.zeros((rows,) + oshape, dtype=dtype,
                               device=csf.device)

        operands, arrays = [], []
        for arr, inds in ((fa, da), (fb, db)):
            shape = tuple(dims[i] for i in inds)
            fiber = arr.ndim == len(inds) + 1
            operands.append(StageOperand(
                subs="".join(self._letter[i] for i in inds),
                shape=shape, fiber=fiber))
            arrays.append(arr)
        out_subs = "".join(self._letter[i] for i in out_dense)

        if reduce_ and self._use_row(csf, lvl, out_lvl):
            lay, gather, mask, block_ptr = self._layout(csf, lvl, out_lvl)
            padded = [
                arr.reshape(nfib, -1)[gather] if op.fiber
                else arr.reshape(1, -1)
                for arr, op in zip(arrays, operands)]
            stage = Stage(operands=tuple(operands), out_subs=out_subs,
                          out_shape=oshape, reduce=True, block=self.block,
                          nseg=lay.nseg, tile=self.tile_align)
            ir = StageIR(kind="reduce", stage=stage)
            self.emitted_stages.append(stage)
            self.emitted_ir.append(ir)
            out2d = self.lowering.reduce(ir, self._tables(csf, stage),
                                         block_ptr, mask, padded, dtype)
            arr = out2d.reshape((lay.nseg,) + oshape)
            return arr.reshape(oshape) if out_lvl == 0 else arr

        # product stage: per-fiber contraction; the sparse reduction (if
        # any) is a sorted segment sum over the CSF segment ids
        rows = [arr.reshape(nfib, -1) if op.fiber else arr.reshape(1, -1)
                for arr, op in zip(arrays, operands)]
        stage = Stage(operands=tuple(operands), out_subs=out_subs,
                      out_shape=oshape, reduce=False, block=self.block,
                      nseg=0, tile=self.tile_align)
        ir = StageIR(kind="product", stage=stage)
        self.emitted_stages.append(stage)
        self.emitted_ir.append(ir)
        per_fiber = self.lowering.product(ir, self._tables(csf, stage), rows,
                                          dtype)
        arr = per_fiber.reshape((nfib,) + oshape)
        if reduce_:
            arr = segment_sum(csf, arr, lvl, out_lvl)
            if out_lvl == 0:
                arr = arr[0]
        return arr
