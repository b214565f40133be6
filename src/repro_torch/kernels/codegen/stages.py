"""Hopper stage lowering ``"hopper"`` — the segment-loop consumer of the IR.

The ``backend="cuda"`` engine.  It realizes the JAX package's TPU stage
kernels on the H100 (CUDA sources in ``csrc/stage_kernels.cu``):

* **K1, reduce** (:func:`run_reduce_stage`, replaces
  ``src/repro/kernels/codegen/stages.py:82`` ``run_reduce_stage``).  On
  the TPU one output row stays in VMEM while the sequential grid visits
  the segment's blocks.  A GPU grid has no order, so here one thread
  block owns one output segment (times a column tile) and walks that
  segment's contiguous block range in ascending order, adding each
  block's partial to the row in the accumulator type and writing the row
  once.  The block order is the TPU's, no atomics are used, and every
  segment owns at least one block (``padded_segment_layout``), so every
  row is written.
* **K2, product** (:func:`run_product_stage`, replaces ``stages.py:155``
  ``run_product_stage``): a persistent grid walks tiles of consecutive
  fiber rows; each tile of an operand is one contiguous chunk, copied
  into shared memory with 16-byte ``cp.async`` and double-buffered, and
  the output tile goes back as one chunk with 16-byte stores
  (:func:`product_tiling` picks the rows a tile).  No cross-block
  state.
* **K3, fused chain** (:func:`run_fused_chain_stage`, replaces
  ``stages.py:198`` ``run_fused_chain_stage``).  The TPU kernel runs a
  whole chain of reducing terms in one sequential grid: one VMEM
  crossing buffer per inner level, reset when that level's segment
  opens and flushed through the link's einsum into the next level when
  it closes.  A skewed pattern puts most blocks in a few outermost
  segments, so here each outermost segment's block range is cut into
  work items of at most ``ChainItems.cap`` consecutive blocks (a cut
  that depends on the layout alone, :func:`~repro_torch.kernels.codegen.
  ir.chain_items`), and one thread block of one or two warps runs one
  item in ascending block order with the crossing buffers in shared
  memory.  An item resets every buffer at its first block and flushes
  every level still open after its last, inner levels first, the last
  link into the item's own partial row: every link is linear in its
  buffer, so a segment flushed in parts sums to its whole flush.  The combine
  (:func:`~repro_torch.kernels.segment.segment_combine`) then adds each
  outermost segment's partial rows in ascending item order.  No
  atomics, so the result is the same on every run.  Link operands are
  read by the block's segment id at their level (stride 0 when
  broadcast).  A row with no blocks owns no item and comes out zero
  (the TPU kernel's ``row_written`` guard).

All three are bound by bytes: a stage does O(1) multiply-adds per
element it reads.  In K1 and K3, threads of one fiber row take
neighbouring output columns, so row reads and output writes coalesce.  Hot spots left for a later PR: K1
runs a heavy segment's blocks on one SM, and with few segments it does
not fill the card.

Each runner takes its kernel's plain PyTorch version (the ``*_plain``
functions) only for CPU tensors; for CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.codegen.ir import (ChainLayout, ChainLink,
                                            IndexTables, Lowering, Stage,
                                            StageIR, accumulator_type,
                                            check_block_grid,
                                            index_table_arrays,
                                            load_operands,
                                            register_lowering)
from repro_torch.kernels.segment import (segment_combine,
                                         segment_combine_plain)


def operand_rows(stage: Stage, padded, nrows: int, dtype):
    """The two operand row arrays as the kernels read them: contiguous,
    in ``dtype``, with their row strides (0 for a broadcast operand).
    Raises unless each is ``(nrows, flat)`` (fiber) or ``(1, flat)``."""
    rows = [p.to(dtype).contiguous() for p in padded]
    for r, op in zip(rows, stage.operands):
        if r.shape != ((nrows if op.fiber else 1), op.flat_dim):
            raise ValueError(f"stage {stage.expr}: operand rows "
                             f"{tuple(r.shape)} for {op}")
    strides = [op.flat_dim if op.fiber else 0 for op in stage.operands]
    return rows, strides


def check_layout(stage: Stage, tables: IndexTables, mask, *rows) -> None:
    """What a reducing kernel (K1, K4) needs besides its operand rows: a
    fiber operand, a float32 mask and int32 index tables, all on one
    CUDA device."""
    native.check_cuda_tensors(*rows, mask, tables.out_ptr)
    native.check_cuda_tensors(mask, dtype=torch.float32)
    native.check_cuda_tensors(tables.out_ptr, tables.a_idx, tables.b_idx,
                              dtype=torch.int32)
    if not any(op.fiber for op in stage.operands):
        raise ValueError(f"reduce stage {stage.expr} has no fiber operand")


def block_partials_plain(stage: Stage, mask, padded) -> torch.Tensor:
    """Per-block partials ``(P // block, out_flat)`` in the accumulator
    type: the per-fiber einsum with the mask folded in, summed over each
    block's fibers."""
    vals = load_operands(stage, padded, mask)
    per_fiber = torch.einsum(stage.fiber_expr, *vals)
    nblocks = mask.shape[0] // stage.block
    return per_fiber.reshape(nblocks, stage.block, -1).sum(dim=1)


def run_reduce_stage_plain(stage: Stage, block_ptr, mask, padded,
                           dtype) -> torch.Tensor:
    """Plain version of K1: block partials, then each segment's partials
    added in ascending block order."""
    parts = block_partials_plain(stage, mask, padded)
    return segment_combine_plain(parts, block_ptr, stage.nseg).to(dtype)


def run_reduce_stage(stage: Stage, tables: IndexTables, block_ptr, mask,
                     padded, dtype) -> torch.Tensor:
    """K1: ``out[s] = sum over the blocks b of segment s (ascending) of
    sum_{fibers z in b} mask[z] * einsum(stage.expr)(z)`` ->
    ``(stage.nseg, out_flat)`` in ``dtype``, accumulated at
    :func:`accumulator_type`."""
    check_block_grid(mask.shape[0], stage.block)
    if mask.device.type == "cpu":
        return run_reduce_stage_plain(stage, block_ptr, mask, padded, dtype)
    acc_t = accumulator_type(dtype)
    rows, strides = operand_rows(stage, padded, mask.shape[0], acc_t)
    check_layout(stage, tables, mask, *rows)
    native.check_cuda_tensors(block_ptr, dtype=torch.int64)
    if block_ptr.shape != (stage.nseg + 1,):
        raise ValueError(f"reduce stage {stage.expr}: needs nseg + 1 "
                         f"block offsets, got {tuple(block_ptr.shape)}")
    w = stage.out_flat_dim
    out = torch.empty((stage.nseg, w), dtype=acc_t, device=mask.device)
    tx = native.column_threads(w)
    native.check_grid(stage.nseg, -(-w // tx))
    if stage.nseg * w:
        native.launch("reduce", acc_t, mask.device, rows[0], strides[0],
                      rows[1], strides[1], mask, block_ptr, stage.nseg,
                      stage.block, tables.out_ptr, tables.a_idx,
                      tables.b_idx, w, tx, out)
    return out.to(dtype)


def run_product_stage_plain(stage: Stage, padded, dtype) -> torch.Tensor:
    """Plain version of K2: the per-fiber einsum."""
    vals = load_operands(stage, padded)
    out = torch.einsum(stage.expr, *vals)
    return out.reshape(out.shape[0], -1).to(dtype)


#: K2's shared-memory budget per thread block: four blocks on an SM.
PRODUCT_SMEM = 48 * 1024
#: K2 keeps its index tables in shared memory up to this size.
PRODUCT_TABLE_SMEM = 16 * 1024
#: K2's largest tile, in fiber rows.
PRODUCT_MAX_ROWS = 256


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class ProductTiling:
    """How K2 walks a stage: ``rows`` fiber rows a tile (a multiple of 4,
    so every tile starts 16-byte aligned), the tables in shared memory or
    read from global memory, the terms read a 16-byte chunk at a time or
    one by one (:func:`term_chunks`), the dynamic shared bytes of a
    thread block, and each operand's chunk swizzle (see
    ``csrc/stage_kernels.cu``)."""

    rows: int
    smem_tables: bool
    chunks: bool
    smem: int
    swizzle: tuple[int, int]


def chunk_swizzle(width: int, itemsize: int) -> int:
    """The XOR mask K2 applies to 16-byte chunk positions within a staged
    row of ``width`` elements: the largest power of two (at most 8)
    dividing the row's chunks, less one; 0 when the row is no whole
    number of chunks."""
    nbytes = width * itemsize
    if nbytes % 16:
        return 0
    chunks = nbytes // 16
    return min(chunks & -chunks, 8) - 1


def term_chunks(stage: Stage, itemsize: int) -> bool:
    """Whether every output column's terms come in runs of one whole
    16-byte chunk of both operands (``16 // itemsize`` consecutive
    columns from a multiple of it, in table order) and every fiber row
    is whole chunks: then K2 reads each run with one 16-byte load per
    operand.  The row dot ``Zd,Zd->Z`` is such a stage."""
    v = 16 // itemsize
    out_ptr, a_idx, b_idx = index_table_arrays(stage)
    if not a_idx.size or (np.diff(out_ptr) % v).any() or any(
            op.fiber and op.flat_dim % v for op in stage.operands):
        return False
    step = np.arange(v)
    return all(bool((runs[:, 0] % v == 0).all()
                    and (runs == runs[:, :1] + step).all())
               for runs in (a_idx.reshape(-1, v), b_idx.reshape(-1, v)))


@functools.lru_cache(maxsize=256)
def product_tiling(stage: Stage, itemsize: int) -> ProductTiling:
    """Choose K2's tile for ``stage`` in a type of ``itemsize`` bytes: the
    most rows (a multiple of 4, at most :data:`PRODUCT_MAX_ROWS`) whose
    double-buffered operand tiles, output tile, broadcast rows and index
    tables fit :data:`PRODUCT_SMEM`, or, when four rows do not, the whole
    of a block's shared memory.  Raises when four rows exceed even
    that."""
    widths = [op.flat_dim for op in stage.operands]
    fibers = [op.fiber for op in stage.operands]
    out_w = stage.out_flat_dim
    nterms = len(index_table_arrays(stage)[1])
    table_bytes = _round16(4 * (out_w + 1 + 2 * nterms))
    smem_tables = table_bytes <= PRODUCT_TABLE_SMEM
    fixed = sum(_round16(w * itemsize) for w, f in zip(widths, fibers)
                if not f) + (table_bytes if smem_tables else 0)
    per_row = itemsize * (out_w + 2 * sum(w for w, f in zip(widths, fibers)
                                          if f))
    for budget in (PRODUCT_SMEM, native.MAX_SHARED_BYTES):
        rows = min(PRODUCT_MAX_ROWS, (budget - fixed) // per_row // 4 * 4)
        if rows >= 4:
            break
    else:
        raise ValueError(f"product stage {stage.expr}: four fiber rows of "
                         f"widths {tuple(widths)} -> {out_w} do not fit "
                         f"the {native.MAX_SHARED_BYTES} bytes of shared "
                         f"memory of a thread block")
    swizzle = tuple(chunk_swizzle(w, itemsize) if f else 0
                    for w, f in zip(widths, fibers))
    return ProductTiling(rows, smem_tables, term_chunks(stage, itemsize),
                         fixed + rows * per_row, swizzle)


def run_product_stage(stage: Stage, tables: IndexTables, padded,
                      dtype) -> torch.Tensor:
    """K2: per-fiber ``einsum(stage.expr)`` over the fiber rows given ->
    ``(rows, out_flat)`` in ``dtype``.  Rows map 1:1, so the caller
    passes exactly its fibers: no padding is needed on this target.
    ``tables`` are ``index_tables(stage)`` (the tiling reads their host
    copy).  Tiles are copied 16 bytes at a time when every fiber
    operand's base is 16-byte aligned, one element at a time
    otherwise."""
    nrows = next(p.shape[0] for p, op in zip(padded, stage.operands)
                 if op.fiber)
    if padded[0].device.type == "cpu":
        return run_product_stage_plain(stage, padded, dtype)
    acc_t = accumulator_type(dtype)
    rows, _ = operand_rows(stage, padded, nrows, acc_t)
    native.check_cuda_tensors(*rows, tables.out_ptr)
    native.check_cuda_tensors(tables.out_ptr, tables.a_idx, tables.b_idx,
                              dtype=torch.int32)
    w = stage.out_flat_dim
    tiling = product_tiling(stage, acc_t.itemsize)
    vec = all(r.data_ptr() % 16 == 0
              for r, op in zip(rows, stage.operands) if op.fiber)
    out = torch.empty((nrows, w), dtype=acc_t, device=rows[0].device)
    if nrows * w:
        ops = stage.operands
        native.launch("product", acc_t, rows[0].device, rows[0],
                      int(ops[0].fiber), ops[0].flat_dim, tiling.swizzle[0],
                      rows[1], int(ops[1].fiber), ops[1].flat_dim,
                      tiling.swizzle[1], nrows, tiling.rows, tables.out_ptr,
                      tables.a_idx, tables.b_idx, w,
                      int(tables.a_idx.numel()), int(vec),
                      int(tiling.smem_tables), int(tiling.chunks),
                      tiling.smem, out)
    return out.to(dtype)


def link_flush_batched(link: ChainLink, rows, other, nrows: int, acc_t):
    """One link's flush for every level row at once: ``einsum(link.expr)``
    with the row axis kept, ``rows`` ``(nrows, buffer flat)`` and
    ``other`` the link operand's rows (``(nrows, flat)`` or one broadcast
    row) -> ``(nrows, link out flat)``."""
    buf_op, op = link.operands
    vals = [rows.to(acc_t).reshape((nrows,) + buf_op.shape)]
    ins = ["Z" + buf_op.subs]
    if op.fiber:
        vals.append(other.to(acc_t).reshape((nrows,) + op.shape))
        ins.append("Z" + op.subs)
    else:
        vals.append(other.to(acc_t).reshape(op.shape))
        ins.append(op.subs)
    out = torch.einsum(",".join(ins) + "->Z" + link.out_subs, *vals)
    return out.reshape(nrows, -1)


def run_fused_chain_stage_plain(ir: StageIR, layout: ChainLayout, padded,
                                link_arrays, dtype) -> torch.Tensor:
    """Plain version of K3, written level by level: the innermost stage's
    block partials summed per level-0 row, then per link one batched
    einsum over all rows and a segment sum onto the next level."""
    acc_t = accumulator_type(dtype)
    parts = block_partials_plain(ir.stage, layout.mask, padded)
    rows = segment_combine_plain(parts.to(acc_t), layout.block_ptr,
                                 ir.nseg_lvls[0])
    for j, link in enumerate(ir.links):
        per_row = link_flush_batched(link, rows, link_arrays[j],
                                     ir.nseg_lvls[j], acc_t)
        nxt = ir.nseg_lvls[j + 1] if j + 1 < len(ir.links) else ir.nseg_out
        rows = segment_combine_plain(per_row, layout.parent_ptrs[j], nxt)
    return rows.to(dtype)


def run_fused_chain_stage(ir: StageIR, layout: ChainLayout,
                          tables: IndexTables, link_tables, padded,
                          link_arrays, dtype) -> torch.Tensor:
    """K3: the whole reducing chain ``ir`` (innermost ``ir.stage``, then
    ``ir.links`` outward) as one kernel over ``layout.items``, then the
    combine of the items' partial rows -> ``(ir.nseg_out, last link's
    out flat)`` in ``dtype``, accumulated at :func:`accumulator_type`."""
    stage, links = ir.stage, ir.links
    P = layout.padded_len
    check_block_grid(P, stage.block)
    if layout.mask.device.type == "cpu":
        return run_fused_chain_stage_plain(ir, layout, padded, link_arrays,
                                           dtype)
    acc_t = accumulator_type(dtype)
    rows, strides = operand_rows(stage, padded, P, acc_t)
    check_layout(stage, tables, layout.mask, *rows)
    dev = layout.mask.device
    nblocks = P // stage.block
    nlinks = len(links)
    items = layout.items
    native.check_cuda_tensors(layout.levels, dtype=torch.int32)
    native.check_cuda_tensors(items.item_block, items.item_ptr,
                              dtype=torch.int64)
    if layout.levels.shape != (3 * nlinks, nblocks) or \
            items.item_ptr.shape != (ir.nseg_out + 1,):
        raise ValueError(f"chain {stage.expr}: layout levels "
                         f"{tuple(layout.levels.shape)}, item_ptr "
                         f"{tuple(items.item_ptr.shape)} for "
                         f"{nlinks} links, {nblocks} blocks, "
                         f"{ir.nseg_out} rows")
    # widths along the chain: stage -> buffer 0 -> link 0 -> buffer 1 ...
    widths = [stage.out_flat_dim] + [link.out_flat_dim for link in links]
    for j, link in enumerate(links):
        if link.operands[0].flat_dim != widths[j]:
            raise ValueError(f"chain link {link.expr} reads a buffer of "
                             f"{link.operands[0].flat_dim}, not {widths[j]}")
    offsets = np.concatenate([[0], np.cumsum(widths[:-1])])
    # desc passes raw pointers: ``others`` keeps each converted operand
    # alive until the launch is queued on the stream
    others = []
    desc = []
    for j, (link, arr, tab) in enumerate(zip(links, link_arrays,
                                             link_tables)):
        op = link.operands[1]
        want = (ir.nseg_lvls[j] if op.fiber else 1, op.flat_dim)
        other = arr.to(acc_t).contiguous()
        if other.shape != want:
            raise ValueError(f"chain link {link.expr}: operand rows "
                             f"{tuple(other.shape)}, expected {want}")
        native.check_cuda_tensors(other, tab.out_ptr, layout.mask)
        native.check_cuda_tensors(tab.out_ptr, tab.a_idx, tab.b_idx,
                                  dtype=torch.int32)
        others.append(other)
        dst = int(offsets[j + 1]) if j + 1 < nlinks else -1
        # the kernel's kLinkFields: operand rows and stride, index table,
        # buffer read (width, offset), buffer written (width, offset)
        desc += [other.data_ptr(), op.flat_dim if op.fiber else 0,
                 tab.out_ptr.data_ptr(), tab.a_idx.data_ptr(),
                 tab.b_idx.data_ptr(), widths[j], int(offsets[j]),
                 widths[j + 1], dst]
    desc_t = torch.tensor(desc, dtype=torch.int64).to(dev)
    w_out = widths[-1]
    partials = torch.empty((items.nitems, w_out), dtype=acc_t, device=dev)
    tx = native.column_threads(stage.out_flat_dim)
    smem = (256 + int(offsets[-1])) * partials.element_size()
    if smem > native.MAX_SHARED_BYTES:
        raise ValueError(f"chain {stage.expr}: crossing buffers of "
                         f"{smem} bytes exceed the shared memory of a "
                         f"thread block")
    native.check_grid(items.nitems, 1)
    if items.nitems * w_out:
        native.launch("chain", acc_t, dev, rows[0], strides[0], rows[1],
                      strides[1], layout.mask, stage.block, tables.out_ptr,
                      tables.a_idx, tables.b_idx, stage.out_flat_dim, tx,
                      nlinks, layout.levels, nblocks, desc_t,
                      items.item_block, items.nitems, w_out, smem,
                      partials)
    return segment_combine(partials, items.item_ptr, ir.nseg_out).to(dtype)


class HopperLowering(Lowering):
    """The segment-loop target, registered as ``"hopper"`` — the
    lowering behind ``make_executor(backend="cuda")``."""

    target = "hopper"

    def reduce(self, ir: StageIR, tables, block_ptr, mask, padded, dtype):
        return run_reduce_stage(ir.stage, tables, block_ptr, mask, padded,
                                dtype)

    def product(self, ir: StageIR, tables, padded, dtype):
        return run_product_stage(ir.stage, tables, padded, dtype)

    def chain(self, ir: StageIR, layout, tables, link_tables, padded,
              link_arrays, dtype):
        return run_fused_chain_stage(ir, layout, tables, link_tables,
                                     padded, link_arrays, dtype)


register_lowering(HopperLowering())
