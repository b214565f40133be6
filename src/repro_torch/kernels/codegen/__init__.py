"""Stage code generator: IR, the Hopper lowerings and the plan executor.

``make_executor(backend="cuda")`` lowers through ``"hopper"`` (segment
loop: K1 reduce, K2 product, K3 fused chain) and
``backend="cuda-splitk"`` through ``"hopper-splitk"`` (K4 split-K
partials + segment combine, K2 product; a chain adds one batched einsum
and one combine per link).
"""
from repro_torch.kernels.codegen.executor import (DEFAULT_BLOCK,
                                                  SegmentProfile,
                                                  StagePlanExecutor,
                                                  chain_block_arrays,
                                                  chain_layout_key,
                                                  fusible_chains,
                                                  layout_cache,
                                                  segment_profile,
                                                  stage_layout_key)
from repro_torch.kernels.codegen.ir import (TILE_LANE, TILE_SUBLANE,
                                            ChainLayout, ChainLink,
                                            IndexTables, Lowering, Stage,
                                            StageIR, StageOperand,
                                            accumulator_type, get_lowering,
                                            index_tables, link_stage,
                                            lowering_targets,
                                            register_lowering)
from repro_torch.kernels.codegen.lower_gpu import (HopperSplitKLowering,
                                                   splitk_partials)
from repro_torch.kernels.codegen.stages import (HopperLowering,
                                                run_fused_chain_stage,
                                                run_product_stage,
                                                run_reduce_stage)

__all__ = [
    "DEFAULT_BLOCK", "SegmentProfile", "StagePlanExecutor",
    "chain_block_arrays", "chain_layout_key", "fusible_chains",
    "layout_cache", "segment_profile", "stage_layout_key", "TILE_LANE",
    "TILE_SUBLANE", "ChainLayout", "ChainLink", "IndexTables", "Lowering",
    "Stage", "StageIR", "StageOperand", "accumulator_type", "get_lowering",
    "index_tables", "link_stage", "lowering_targets", "register_lowering",
    "HopperSplitKLowering", "splitk_partials", "HopperLowering",
    "run_fused_chain_stage", "run_product_stage", "run_reduce_stage",
]
