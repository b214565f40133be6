"""Serving: the SpTTN plan-cache hot path (DESIGN.md §9).

The JAX package's ``Server``/``Request`` (batched prefill + decode) need
the model stack, which the port does not carry yet; what is here is the
plan service and the MoE routing helpers it dispatches.
"""
from repro_torch.serve import serve_step
from repro_torch.serve.serve_step import (PlanService, ServeStats,
                                          moe_dispatch_spec, moe_routing_coo)

__all__ = ["serve_step", "PlanService", "ServeStats", "moe_dispatch_spec",
           "moe_routing_coo"]
