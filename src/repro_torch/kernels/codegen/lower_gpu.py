"""Split-K stage lowering ``"hopper-splitk"`` — the ``cuda-splitk`` engine.

The counterpart of the JAX package's Mosaic-GPU-style lowering
(``src/repro/kernels/codegen/lower_gpu.py``), written for the H100:

* **K4 split-K partials** (:func:`splitk_partials`, replaces
  ``lower_gpu.py:61`` ``splitk_partials``): one thread block per fiber
  block (times a column tile) computes that block's partial and writes it
  to its own row of an ``(n_blocks, out_flat)`` buffer in the
  accumulator type.  No two blocks touch the same memory, so the kernel
  is legal in any execution order and fills the card with
  ``n_blocks`` independent blocks (``"hopper"``'s K1 runs one block per
  work item of a bounded number of rows instead).
* **segment combine** (:func:`repro_torch.kernels.segment.
  segment_combine`, replaces ``lower_gpu.py:109``): each segment's
  partials are added in ascending block order — the order of the TPU's
  sequential accumulator.

The price is one round trip of the partials through device memory
(``n_blocks * out_flat`` elements written and read back).  Product
stages carry no cross-block state and use K2 unchanged.  Bound: bytes,
as for every stage kernel.

A fused chain (``chain``, the counterpart of ``MosaicGPULowering.chain``,
``lower_gpu.py:152``) runs K4 partials and the combine onto the level-0
rows, then per link one batched ``torch.einsum`` over all rows of that
level (a plain product, which the reference leaves to XLA) and a combine
onto the next level's rows.  The combine keys on the CSF's own
child -> parent offsets, which equal the reference's per-block
``_rows_to_parents`` map on a CSF operand (every fiber owns a block).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.codegen.ir import (IndexTables, Lowering, Stage,
                                            StageIR, accumulator_type,
                                            check_block_grid,
                                            register_lowering)
from repro_torch.kernels.codegen.stages import (block_partials_plain,
                                                check_layout,
                                                link_flush_batched,
                                                operand_rows,
                                                run_product_stage)
from repro_torch.kernels.segment import segment_combine


def splitk_partials(stage: Stage, tables: IndexTables, mask,
                    padded) -> torch.Tensor:
    """K4: per-block partials ``(P // block, out_flat)`` in the
    accumulation dtype, one row per fiber block, no cross-block state."""
    P = mask.shape[0]
    check_block_grid(P, stage.block)
    if mask.device.type == "cpu":
        return block_partials_plain(stage, mask, padded)
    acc_t = accumulator_type(torch.promote_types(padded[0].dtype,
                                                 padded[1].dtype))
    rows, strides = operand_rows(stage, padded, P, acc_t)
    check_layout(stage, tables, mask, *rows)
    w = stage.out_flat_dim
    nblocks = P // stage.block
    out = torch.empty((nblocks, w), dtype=acc_t, device=mask.device)
    tx = native.column_threads(w)
    native.check_grid(nblocks, -(-w // tx))
    if nblocks * w:
        native.launch("splitk", acc_t, mask.device, rows[0], strides[0],
                      rows[1], strides[1], mask, nblocks, stage.block,
                      tables.out_ptr, tables.a_idx, tables.b_idx, w, tx,
                      out)
    return out


class HopperSplitKLowering(Lowering):
    """The split-K target: partials + segment combine.  Registered as
    ``"hopper-splitk"`` — the lowering behind
    ``make_executor(backend="cuda-splitk")``."""

    target = "hopper-splitk"

    def reduce(self, ir: StageIR, tables, block_ptr, mask, padded, dtype,
               items=None):
        parts = splitk_partials(ir.stage, tables, mask, padded)
        return segment_combine(parts, block_ptr, ir.stage.nseg).to(dtype)

    def product(self, ir: StageIR, tables, padded, dtype):
        return run_product_stage(ir.stage, tables, padded, dtype)

    def chain(self, ir: StageIR, layout, tables, link_tables, padded,
              link_arrays, dtype):
        acc_t = accumulator_type(dtype)
        parts = splitk_partials(ir.stage, tables, layout.mask, padded)
        rows = segment_combine(parts.to(acc_t), layout.block_ptr,
                               ir.nseg_lvls[0])
        for j, link in enumerate(ir.links):
            per_row = link_flush_batched(link, rows, link_arrays[j],
                                         ir.nseg_lvls[j], acc_t)
            nxt = ir.nseg_lvls[j + 1] if j + 1 < len(ir.links) \
                else ir.nseg_out
            rows = segment_combine(per_row.contiguous(),
                                   layout.parent_ptrs[j], nxt)
        return rows.to(dtype)


register_lowering(HopperSplitKLowering())
