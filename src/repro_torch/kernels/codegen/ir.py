"""Target-neutral stage IR — what the code generator says, not how.

The plan executor (kernels/codegen/executor.py) lowers a fused SpTTN
plan into a sequence of *stage descriptions*: pure dataclasses carrying
the operand index maps (einsum subscripts + dense shapes), the block
layout request (block size, segment-row count) and the einsum links of a
fused chain.  They are field for field the JAX package's stage IR
(``src/repro/kernels/codegen/ir.py``), so the two code generators can be
held equal on the same plan.  A registered :class:`Lowering` turns the IR
into kernels for one target:

* ``"hopper"`` (kernels/codegen/stages.py) — the segment-loop lowering:
  one thread block per output segment walks the segment's blocks in
  ascending order (K1), per-fiber products are K2, and a fused chain is
  one thread block per work item of at most a fixed number of blocks of
  one outermost segment, whose partial rows the segment combine adds in
  item order (K3).
* ``"hopper-splitk"`` (kernels/codegen/lower_gpu.py) — split-K partials
  per fiber block (K4) plus a segment-combine pass; a chain adds one
  batched einsum and one combine per link.

:func:`index_tables` turns a stage's einsum into the index table the
Hopper kernels read (``csrc/stage_kernels.cu``).  ``Stage.tile`` and
:data:`TILE_LANE` are the TPU tiling request; they stay in the IR so it
remains comparable, and the Hopper lowerings ignore them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

# float32 TPU tile: (sublane, lane) = (8, 128).  Kept for IR parity with
# the JAX package (tile-aligned blocks round up to TILE_SUBLANE).
TILE_LANE = 128
TILE_SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class StageOperand:
    """One kernel input: ``subs`` are the dense-axis einsum letters,
    ``shape`` the dense shape.  ``fiber`` operands carry the fiber axis
    (einsum batch letter Z) and arrive as (P, prod(shape)) rows;
    broadcast operands arrive as one (1, prod(shape)) row shared by
    every fiber."""

    subs: str
    shape: tuple[int, ...]
    fiber: bool

    @property
    def flat_dim(self) -> int:
        return math.prod(self.shape)


def accumulator_type(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for a stage's einsum: at least float32, widened
    to match wider operands — float64 stages accumulate at float64."""
    return torch.promote_types(torch.float32, dtype)


@dataclasses.dataclass(frozen=True)
class Stage:
    """A single generated kernel: ``einsum(operands) -> out_subs`` per
    block, reduced over the fiber axis into ``nseg`` segment rows when
    ``reduce`` is set.  ``tile`` is the TPU pad-to-tile request."""

    operands: tuple[StageOperand, ...]
    out_subs: str
    out_shape: tuple[int, ...]
    reduce: bool
    block: int
    nseg: int            # segment-row count (reduce stages only)
    tile: bool = False

    @property
    def out_flat_dim(self) -> int:
        return math.prod(self.out_shape)

    @property
    def expr(self) -> str:
        ins = ",".join(("Z" + op.subs) if op.fiber else op.subs
                       for op in self.operands)
        return f"{ins}->{'' if self.reduce else 'Z'}{self.out_subs}"

    @property
    def fiber_expr(self) -> str:
        """:attr:`expr` with the fiber axis kept on the output — the
        per-fiber contraction both stage kinds start from."""
        return self.expr.split("->")[0] + "->Z" + self.out_subs


@dataclasses.dataclass(frozen=True)
class ChainLink:
    """One outer level of a fused reducing chain.

    ``operands[0]`` is the inner crossing buffer (always a fiber operand:
    one level-``lvl`` row per flush); the rest are the link term's other
    operands.  ``expr`` reduces the singleton fiber axis away."""

    operands: tuple[StageOperand, ...]
    out_subs: str
    out_shape: tuple[int, ...]

    @property
    def out_flat_dim(self) -> int:
        return math.prod(self.out_shape)

    @property
    def expr(self) -> str:
        ins = ",".join(("Z" + op.subs) if op.fiber else op.subs
                       for op in self.operands)
        return f"{ins}->{self.out_subs}"


@dataclasses.dataclass(frozen=True)
class StageIR:
    """One target-neutral lowering unit, as emitted by the executor.

    ``kind`` selects the lowering entry point:

    * ``"reduce"`` — a row-strategy reducing stage: ``stage`` plus the
      block layout (segment block offsets, mask) supplied at lowering
      time.
    * ``"product"`` — a per-fiber product stage (no cross-block state).
    * ``"chain"`` — a fused reducing chain: innermost ``stage`` plus
      ``links`` outward; ``nseg_lvls[j]`` is the segment-row count at
      chain level ``j`` (innermost-first), ``nseg_out`` the final row
      count.

    The IR an executor emits is identical across targets, so
    ``emitted_ir`` equality makes a value disagreement a lowering bug,
    never a construction bug."""

    kind: str
    stage: Stage
    links: tuple[ChainLink, ...] = ()
    nseg_out: int = 0
    nseg_lvls: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """The block layout of a fused chain with ``C - 1`` links, on one
    device (pattern-static, cached with the operand).

    * ``mask`` — ``(P,)`` float32, 1 for real slots of the padded
      innermost layout, 0 for pads;
    * ``levels`` — ``(3 * (C - 1), P // block)`` int32: for each inner
      chain level ``j`` the per-block segment id (row ``3j``), the
      segment-opens flag (``3j + 1``, the TPU kernel's reset) and the
      segment-closes flag (``3j + 2``, its flush);
    * ``out_block_ptr`` — int64 ``(nseg_out + 1,)``: the contiguous block
      range of each outermost segment (an empty range is a row with no
      blocks, which stays zero);
    * ``block_ptr`` — int64 ``(nseg_lvls[0] + 1,)``: the block range of
      each level-0 row (the split-K combine);
    * ``parent_ptrs`` — per link ``j``, int64 row offsets of the level-``j``
      rows of each level-``j + 1`` row (the last one's parents are the
      output rows)."""

    mask: torch.Tensor
    levels: torch.Tensor
    out_block_ptr: torch.Tensor
    block_ptr: torch.Tensor
    parent_ptrs: tuple[torch.Tensor, ...]

    @property
    def padded_len(self) -> int:
        return self.mask.shape[0]

    @functools.cached_property
    def items(self) -> ChainItems:
        """K3's work items at the default cap (:func:`chain_items` of
        ``out_block_ptr``), built on first use and kept with the layout
        (which the executor caches per pattern); only K3 reads them."""
        return chain_items(self.out_block_ptr)


#: A work item of K3 holds at least this many blocks (unless its
#: outermost segment has fewer) ...
ITEM_MIN_BLOCKS = 64
#: ... and a layout is cut into about this many items at most.
ITEM_TARGET = 32768


def item_cap(nblocks: int) -> int:
    """The most blocks a work item of a chain of ``nblocks`` blocks holds:
    the larger of :data:`ITEM_MIN_BLOCKS` and ``nblocks /``
    :data:`ITEM_TARGET`, rounded up.  A function of the layout alone, so
    the cut (and with it every float sum's order) is the same on every
    card."""
    return max(ITEM_MIN_BLOCKS, -(-nblocks // ITEM_TARGET))


@dataclasses.dataclass(frozen=True)
class ChainItems:
    """K3's work items: each outermost segment's block range cut into
    runs of at most ``cap`` consecutive blocks, in order.

    * ``item_block`` — int64 ``(nitems + 1,)``: item ``i`` is blocks
      ``[item_block[i], item_block[i + 1])``;
    * ``item_ptr`` — int64 ``(nseg_out + 1,)``: outermost segment ``s``
      owns items ``[item_ptr[s], item_ptr[s + 1])`` (none for a segment
      with no blocks)."""

    item_block: torch.Tensor
    item_ptr: torch.Tensor
    cap: int

    @property
    def nitems(self) -> int:
        return self.item_block.shape[0] - 1


def chain_items(out_block_ptr: torch.Tensor,
                cap: int | None = None) -> ChainItems:
    """Cut the block ranges ``out_block_ptr`` (int64 ``(nseg_out + 1,)``)
    into work items of at most ``cap`` blocks (default :func:`item_cap`),
    with torch operations on ``out_block_ptr``'s device."""
    dev = out_block_ptr.device
    nblocks = int(out_block_ptr[-1])
    cap = cap or item_cap(nblocks)
    per_seg = (out_block_ptr.diff() + cap - 1) // cap
    item_ptr = torch.cat([per_seg.new_zeros(1), per_seg.cumsum(0)])
    nitems = int(item_ptr[-1])
    seg = torch.repeat_interleave(
        torch.arange(per_seg.shape[0], device=dev), per_seg,
        output_size=nitems)
    first = out_block_ptr[seg] + (torch.arange(nitems, device=dev)
                                  - item_ptr[seg]) * cap
    return ChainItems(torch.cat([first, out_block_ptr[-1:]]), item_ptr, cap)


def link_stage(link: ChainLink) -> Stage:
    """A link's flush as a stage: ``einsum(link.expr)`` of one buffer row
    and one operand row — what :func:`index_table_arrays` enumerates."""
    return Stage(operands=link.operands, out_subs=link.out_subs,
                 out_shape=link.out_shape, reduce=True, block=1, nseg=1)


# --------------------------------------------------------------------- #
# Index tables: a stage's einsum as the Hopper kernels read it
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class IndexTables:
    """The stage's dense index space in CSR form, on one device:
    output column ``o`` is ``sum_t A[z, a_idx[t]] * B[z, b_idx[t]]`` over
    ``t`` in ``[out_ptr[o], out_ptr[o+1])`` (all int32)."""

    out_ptr: torch.Tensor
    a_idx: torch.Tensor
    b_idx: torch.Tensor


def index_table_arrays(stage: Stage) -> tuple[np.ndarray, ...]:
    """Enumerate every assignment of the stage's dense letters once and
    record, per assignment, the flat column it reads in each operand and
    writes in the output; then group by output column (stable, so each
    column's terms keep the row-major enumeration order).  A letter that
    appears in the operands but not the output is contracted; a letter
    repeated within one operand takes the diagonal, as in einsum."""
    if len(stage.operands) != 2:
        raise ValueError(f"stages are two-operand einsums, got {stage.expr}")
    size: dict[str, int] = {}
    for subs, shape in [(op.subs, op.shape) for op in stage.operands] + \
            [(stage.out_subs, stage.out_shape)]:
        for letter, n in zip(subs, shape):
            if size.setdefault(letter, n) != n:
                raise ValueError(f"letter {letter!r} has sizes "
                                 f"{size[letter]} and {n} in {stage.expr}")
    letters = list(size)
    grids = (np.indices([size[c] for c in letters]).reshape(len(letters), -1)
             if letters else np.zeros((0, 1), np.int64))
    pos = {c: grids[i] for i, c in enumerate(letters)}

    def flat(subs: str, shape: tuple[int, ...]) -> np.ndarray:
        f = np.zeros(grids.shape[1], np.int64)
        for letter, n in zip(subs, shape):
            f = f * n + pos[letter]
        return f

    a, b = (flat(op.subs, op.shape) for op in stage.operands)
    out = flat(stage.out_subs, stage.out_shape)
    by_out = np.argsort(out, kind="stable")
    counts = np.bincount(out, minlength=stage.out_flat_dim)
    out_ptr = np.concatenate([[0], np.cumsum(counts)])
    return (out_ptr.astype(np.int32), a[by_out].astype(np.int32),
            b[by_out].astype(np.int32))


def index_tables(stage: Stage, device) -> IndexTables:
    return IndexTables(*(torch.from_numpy(t).to(device)
                         for t in index_table_arrays(stage)))


# --------------------------------------------------------------------- #
# Shared lowering helpers
# --------------------------------------------------------------------- #
def check_block_grid(padded_len: int, block: int) -> None:
    """The stage covers ``padded_len // block`` blocks; a non-multiple
    length would silently drop the tail slots, so fail loudly instead.
    Thin wrapper over the verifier's
    :func:`repro_torch.analysis.invariants.check_block_grid`
    (SPTTN-E022)."""
    from repro_torch.analysis.invariants import check_block_grid as check
    d = check(padded_len, block)
    if d is not None:
        raise ValueError(f"{d.message} [{d.code}]")


def load_operands(stage: Stage, padded, mask=None):
    """Restore each operand's dense shape for a plain einsum, in the
    accumulation dtype; the mask is folded into the first fiber operand
    so pad slots contribute zero."""
    acc_t = accumulator_type(torch.promote_types(padded[0].dtype,
                                                 padded[1].dtype))
    vals, masked = [], mask is None
    for arr, op in zip(padded, stage.operands):
        v = arr.to(acc_t)
        if op.fiber:
            v = v.reshape((arr.shape[0],) + op.shape)
            if not masked:
                v = v * mask.reshape((-1,) + (1,) * len(op.shape)).to(acc_t)
                masked = True
        else:
            v = v.reshape(op.shape)
        vals.append(v)
    return vals


# --------------------------------------------------------------------- #
# Per-target lowering registry
# --------------------------------------------------------------------- #
class Lowering:
    """Contract one target implements to consume the stage IR.

    Every method receives a :class:`StageIR`, the stage's
    :class:`IndexTables` and the already-gathered operand rows, and
    returns the stage's logical 2-D output:

    * ``reduce``  → ``(stage.nseg, stage.out_flat_dim)`` in ``dtype``;
      ``block_ptr`` (int64, ``nseg + 1``) gives each segment's
      contiguous block range, ``mask`` the (P,) pad-slot mask
    * ``product`` → ``(rows, stage.out_flat_dim)`` in ``dtype``, one
      row per fiber row given
    * ``chain``   → ``(ir.nseg_out, links[-1].out_flat_dim)``;
      ``layout`` is the chain's :class:`ChainLayout`, ``link_tables``
      one :class:`IndexTables` per link (of :func:`link_stage`) and
      ``link_arrays`` each link's other operand rows (one row per
      level-``j`` segment, or one broadcast row)
    """

    target: str = "?"

    def reduce(self, ir: StageIR, tables: IndexTables, block_ptr, mask,
               padded, dtype):
        raise NotImplementedError

    def product(self, ir: StageIR, tables: IndexTables, padded, dtype):
        raise NotImplementedError

    def chain(self, ir: StageIR, layout: "ChainLayout",
              tables: IndexTables, link_tables, padded, link_arrays, dtype):
        raise NotImplementedError


_LOWERINGS: dict[str, Lowering] = {}


def register_lowering(lowering: Lowering) -> Lowering:
    """Register ``lowering`` under its ``target`` name (last wins, so a
    caller can shadow and restore a target)."""
    _LOWERINGS[lowering.target] = lowering
    return lowering


def lowering_targets() -> tuple[str, ...]:
    """Registered target names, sorted."""
    return tuple(sorted(_LOWERINGS))


def get_lowering(target: str) -> Lowering:
    """The registered lowering for ``target``; raises ``ValueError``
    naming the registered targets otherwise (SPTTN-E041)."""
    try:
        return _LOWERINGS[target]
    except KeyError:
        raise ValueError(
            f"no stage lowering registered for target {target!r} "
            f"(registered: {lowering_targets()})") from None
