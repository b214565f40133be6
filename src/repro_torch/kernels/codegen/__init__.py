"""Stage code generator: IR, the Hopper lowerings and the plan executor.

``make_executor(backend="cuda")`` lowers through ``"hopper"`` (segment
loop: K1 reduce, K2 product) and ``backend="cuda-splitk"`` through
``"hopper-splitk"`` (K4 split-K partials + segment combine, K2 product).
"""
from repro_torch.kernels.codegen.executor import (DEFAULT_BLOCK,
                                                  SegmentProfile,
                                                  StagePlanExecutor,
                                                  layout_cache,
                                                  segment_profile,
                                                  stage_layout_key)
from repro_torch.kernels.codegen.ir import (TILE_LANE, TILE_SUBLANE,
                                            ChainLink, IndexTables, Lowering,
                                            Stage, StageIR, StageOperand,
                                            accumulator_type, get_lowering,
                                            index_tables, lowering_targets,
                                            register_lowering)
from repro_torch.kernels.codegen.lower_gpu import (HopperSplitKLowering,
                                                   splitk_partials)
from repro_torch.kernels.codegen.stages import (HopperLowering,
                                                run_product_stage,
                                                run_reduce_stage)

__all__ = [
    "DEFAULT_BLOCK", "SegmentProfile", "StagePlanExecutor", "layout_cache",
    "segment_profile", "stage_layout_key", "TILE_LANE", "TILE_SUBLANE",
    "ChainLink", "IndexTables", "Lowering", "Stage", "StageIR",
    "StageOperand", "accumulator_type", "get_lowering", "index_tables",
    "lowering_targets", "register_lowering", "HopperSplitKLowering",
    "splitk_partials", "HopperLowering", "run_product_stage",
    "run_reduce_stage",
]
