"""Core SpTTN machinery: the paper's primary contribution.

Public API:
  spec.parse / spec.mttkrp / ...      SpTTN kernel specs
  paths.min_depth_paths                contraction-path enumeration (§4.1.1)
  loopnest.enumerate_orders            index-order enumeration (§4.1.2)
  cost.{MaxBufferDim,MaxBufferSize,CacheMisses,ConstrainedBlas}   (§4.2)
  order_dp.optimal_order               Algorithm 1
  planner.plan / cached_plan           full pipeline (§5)
  executor.{reference_execute,VectorizedExecutor,make_executor}   (Alg. 2;
    the engines behind one signature)
"""
from repro_torch.core import cost, executor, loopnest, order_dp, paths
from repro_torch.core import planner, spec
from repro_torch.core.cost import (CacheMisses, ConstrainedBlas,
                                   MaxBufferDim, MaxBufferSize)
from repro_torch.core.executor import (CSFArrays, ReferenceExecutor,
                                       VectorizedExecutor, dense_oracle,
                                       execute_plan, factors_to_torch,
                                       make_executor, reference_execute)
from repro_torch.core.order_dp import optimal_order
from repro_torch.core.planner import SpTTNPlan, cached_plan, plan
from repro_torch.core.spec import SpTTNSpec, parse

__all__ = [
    "cost", "executor", "loopnest", "order_dp", "paths",
    "planner", "spec", "CacheMisses", "ConstrainedBlas", "MaxBufferDim",
    "MaxBufferSize", "CSFArrays", "ReferenceExecutor",
    "VectorizedExecutor", "dense_oracle", "execute_plan",
    "factors_to_torch", "make_executor", "reference_execute",
    "optimal_order", "SpTTNPlan", "cached_plan", "plan", "SpTTNSpec",
    "parse",
]
