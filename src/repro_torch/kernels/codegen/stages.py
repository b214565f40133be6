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
  ``run_product_stage``): one thread per (fiber, output column), no
  cross-block state.

Both are bound by bytes: a stage does O(1) multiply-adds per element it
reads.  Threads of one fiber row take neighbouring output columns, so
row reads and output writes coalesce.  Hot spots left for a later PR: K1
runs a heavy segment's blocks on one SM, and with few segments it does
not fill the card.

Each runner takes its kernel's plain PyTorch version (the ``*_plain``
functions) only for CPU tensors; for CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.codegen.ir import (IndexTables, Lowering, Stage,
                                            StageIR, accumulator_type,
                                            check_block_grid, load_operands,
                                            register_lowering)
from repro_torch.kernels.segment import segment_combine_plain


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


def run_product_stage(stage: Stage, tables: IndexTables, padded,
                      dtype) -> torch.Tensor:
    """K2: per-fiber ``einsum(stage.expr)`` over the fiber rows given ->
    ``(rows, out_flat)`` in ``dtype``.  Rows map 1:1, so the caller
    passes exactly its fibers: no padding is needed on this target."""
    nrows = next(p.shape[0] for p, op in zip(padded, stage.operands)
                 if op.fiber)
    if padded[0].device.type == "cpu":
        return run_product_stage_plain(stage, padded, dtype)
    acc_t = accumulator_type(dtype)
    rows, strides = operand_rows(stage, padded, nrows, acc_t)
    native.check_cuda_tensors(*rows, tables.out_ptr)
    native.check_cuda_tensors(tables.out_ptr, tables.a_idx, tables.b_idx,
                              dtype=torch.int32)
    w = stage.out_flat_dim
    out = torch.empty((nrows, w), dtype=acc_t, device=rows[0].device)
    tx = native.column_threads(w)
    native.check_grid(-(-nrows // (256 // tx)), -(-w // tx))
    if nrows * w:
        native.launch("product", acc_t, rows[0].device, rows[0],
                      strides[0], rows[1], strides[1], nrows,
                      tables.out_ptr, tables.a_idx, tables.b_idx, w, tx,
                      out)
    return out.to(dtype)


class HopperLowering(Lowering):
    """The segment-loop target, registered as ``"hopper"`` — the
    lowering behind ``make_executor(backend="cuda")``."""

    target = "hopper"

    def reduce(self, ir: StageIR, tables, block_ptr, mask, padded, dtype):
        return run_reduce_stage(ir.stage, tables, block_ptr, mask, padded,
                                dtype)

    def product(self, ir: StageIR, tables, padded, dtype):
        return run_product_stage(ir.stage, tables, padded, dtype)


register_lowering(HopperLowering())
