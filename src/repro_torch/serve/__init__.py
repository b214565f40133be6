"""Serving (DESIGN.md §9): the continuous-batching ``Server`` over the
model stack, and the SpTTN plan-cache hot path (``PlanService``) with the
MoE routing helpers it dispatches.
"""
from repro_torch.serve import serve_step
from repro_torch.serve.serve_step import (PlanService, Request, Server,
                                          ServeStats, moe_dispatch_spec,
                                          moe_routing_coo)

__all__ = ["serve_step", "Server", "Request", "PlanService", "ServeStats",
           "moe_dispatch_spec", "moe_routing_coo"]
