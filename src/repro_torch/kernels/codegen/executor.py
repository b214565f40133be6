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

The gathers that build each stage's operand rows stay PyTorch indexing,
as they stay XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.executor import (CSFArrays, VectorizedExecutor,
                                       segment_sum)
from repro_torch.core.loopnest import LoopOrder
from repro_torch.core.paths import ContractionPath
from repro_torch.core.spec import SpTTNSpec
# importing the lowering modules registers the built-in targets
from repro_torch.kernels.codegen import lower_gpu, stages  # noqa: F401
from repro_torch.kernels.codegen.ir import (TILE_SUBLANE, Stage, StageIR,
                                            StageOperand, get_lowering,
                                            index_tables)
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
    ``"auto"`` picks per stage from the segment profile.  ``"fused"``
    (one kernel per reducing chain) needs the chain kernel, which is not
    ported yet, and raises ``NotImplementedError``.  ``tile_align`` asks
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
        if strategy == "fused":
            raise NotImplementedError(
                "strategy='fused' needs the fused-chain kernel (K3, "
                "run_fused_chain_stage), which is not ported yet: next "
                "slice, with autotune/")
        if strategy not in ("auto", "row", "segsum"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if block < 1:
            raise ValueError(f"block must be positive, got {block}")
        self.target = target
        self.lowering = get_lowering(target)   # ValueError on unknown
        self.tile_align = bool(tile_align)
        self.block = round_up(block, TILE_SUBLANE) if self.tile_align \
            else block
        self.strategy = strategy
        # every Stage / StageIR emitted by the latest call, in order
        self.emitted_stages: list[Stage] = []
        self.emitted_ir: list[StageIR] = []
        # (lvl, out_lvl) -> "row" | "segsum", recorded per call
        self.stage_strategy: dict[tuple[int, int], str] = {}

    def __call__(self, csf, factors):
        self.emitted_stages.clear()
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
        chosen from its fiber counts unless forced by ``strategy``."""
        if self.strategy != "auto":
            return self.strategy
        nfib = csf.nfib[lvl]
        nseg = csf.nfib[out_lvl] if out_lvl > 0 else 1
        row = SegmentProfile.row_decision(nfib, nseg, self.block)
        return "row" if row else "segsum"

    def _use_row(self, csf: CSFArrays, lvl: int, out_lvl: int) -> bool:
        choice = self.strategy_for(csf, lvl, out_lvl)
        self.stage_strategy[(lvl, out_lvl)] = choice
        return choice == "row"

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
