"""Split-K stage lowering ``"hopper-splitk"`` — the ``cuda-splitk`` engine.

The counterpart of the JAX package's Mosaic-GPU-style lowering
(``src/repro/kernels/codegen/lower_gpu.py``), written for the H100:

* **K4 split-K partials** (:func:`splitk_partials`, replaces
  ``lower_gpu.py:61`` ``splitk_partials``): one thread block per fiber
  block (times a column tile) computes that block's partial and writes it
  to its own row of an ``(n_blocks, out_flat)`` buffer in the
  accumulator type.  No two blocks touch the same memory, so the kernel
  is legal in any execution order and fills the card with
  ``n_blocks`` independent blocks, where the segment loop of
  ``"hopper"`` has one block per segment.
* **segment combine** (:func:`repro_torch.kernels.segment.
  segment_combine`, replaces ``lower_gpu.py:109``): each segment's
  partials are added in ascending block order — the order of the TPU's
  sequential accumulator — so split-K then combine equals the segment
  loop's order of additions at the block level.

The price is one round trip of the partials through device memory
(``n_blocks * out_flat`` elements written and read back).  Product
stages carry no cross-block state and use K2 unchanged.  Bound: bytes,
as for every stage kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.codegen.ir import (IndexTables, Lowering, Stage,
                                            StageIR, accumulator_type,
                                            check_block_grid,
                                            register_lowering)
from repro_torch.kernels.codegen.stages import (block_partials_plain,
                                                check_layout, operand_rows,
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

    def reduce(self, ir: StageIR, tables, block_ptr, mask, padded, dtype):
        parts = splitk_partials(ir.stage, tables, mask, padded)
        return segment_combine(parts, block_ptr, ir.stage.nseg).to(dtype)

    def product(self, ir: StageIR, tables, padded, dtype):
        return run_product_stage(ir.stage, tables, padded, dtype)


register_lowering(HopperSplitKLowering())
