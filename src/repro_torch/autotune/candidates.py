"""Model-pruned candidate generation (paper §4.1 + SparseAuto's hybrid).

The JAX package's ``src/repro/autotune/candidates.py``, with the
backend axis over this package's engines: the code-generator backends
(``cuda``, ``cuda-splitk``) carry the fused and block axes that the
Pallas backends carry there.

The full loop-nest space is O((n!)^2/(n·2^n) · prod |I_i|!/k_i!) — far too
large to time exhaustively, but the paper's cost models rank it well enough
that the true optimum is almost always near the top.  We therefore keep,
per min-depth contraction path, the Algorithm-1 (DP) optimal order plus a
few enumerated alternatives, rank everything by (model cost, sparse-aware
FLOPs), and hand only the head of that ranking to the measuring stage.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Mapping, Sequence

from repro_torch.core import cost as cost_lib
from repro_torch.core.cost import ConstrainedBlas, TreeCost, path_flops
from repro_torch.core.loopnest import LoopOrder, enumerate_orders
from repro_torch.core.order_dp import OrderDP
from repro_torch.core.paths import ContractionPath, min_depth_paths, path_depth
from repro_torch.core.spec import SpTTNSpec


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One schedule the tuner may measure, with its model scores.

    ``backend`` is the execution engine the schedule would run on — a
    full autotuning axis: the same (path, order) may win on one backend
    and lose on another, so each (schedule, backend) pair is measured
    separately and the winner's backend lands in the plan cache.
    ``fused`` is the code generator's second axis: run detected reducing
    chains as one multi-level chain unit (True) or as staged per-term
    kernels (False); it is only expanded for schedules whose path
    actually contains a provably fusible chain.  ``block`` is its third
    axis: the fiber block size of every generated stage — a swept value
    is always a positive multiple of 8 (the block sizes plan JSON
    accepts); 0 means "engine default" and is what ``torch`` candidates
    carry.
    """

    path: ContractionPath
    order: LoopOrder
    cost: float          # model cost (TreeCost.evaluate — order-dependent)
    flops: float         # sparse-aware FLOP model (path-dependent)
    backend: str = "torch"
    fused: bool = False
    block: int = 0       # 0 = engine default (torch candidates)

    @property
    def key(self) -> str:
        terms = "|".join(str(t) for t in self.path)
        orders = ";".join(",".join(a) for a in self.order)
        fz = "+fused" if self.fused else ""
        blk = f"%b{self.block}" if self.block else ""
        return f"{terms}#{orders}@{self.backend}{fz}{blk}"


def default_nnz_levels(spec: SpTTNSpec) -> dict[int, int]:
    """Density-agnostic default (same as the planner's): nnz^(I1..Ip) grows
    with the prefix index space."""
    prod = 1
    levels = {0: 1}
    for p, ind in enumerate(spec.sparse_indices, start=1):
        prod *= spec.dims[ind]
        levels[p] = prod
    return levels


def generate_candidates(spec: SpTTNSpec,
                        cost: TreeCost | None = None,
                        nnz_levels: Mapping[int, int] | None = None,
                        max_paths: int | None = 16,
                        depth_slack: int = 0,
                        max_candidates: int = 8,
                        orders_per_path: int = 3,
                        backends: Sequence[str] = ("torch",),
                        blocks: Sequence[int] | None = None
                        ) -> list[Candidate]:
    """Generate the model-pruned candidate set, best-ranked first.

    Per path: the DP-optimal order always survives; ``orders_per_path - 1``
    further orders come from exhaustive enumeration (cheap for the paper's
    kernel sizes).  The final ranking is (cost, flops) ascending, truncated
    to ``max_candidates``, then expanded across ``backends`` (the cost
    models are backend-blind, so every surviving schedule is measured on
    every requested engine; the head of the expansion — best model score
    on ``backends[0]`` — is the pure-model pick).  On an all-dense
    network the code-generator backends degrade to ``torch`` (the
    generator emits no sparse stages there), so they are folded into the
    ``torch`` candidate rather than measured twice — the expansion is
    never empty.  Code-generator candidates (:data:`CODEGEN_BACKENDS`)
    whose path contains a provably fusible reducing chain
    (``fusible_chains``) are additionally expanded across the ``fused``
    axis, so the staged and the chain lowerings compete on wall clock.

    ``blocks`` is the block-size grid of the code-generator backends:
    every such candidate is expanded once per grid value, so the fiber
    block size competes on wall clock like any other axis and the
    winner's block persists with the plan.  Entries must be positive
    multiples of 8 (as in the JAX package, whose TPU sublane tile is 8).
    ``None`` means the single-point grid ``(DEFAULT_BLOCK,)``.
    """
    from repro_torch.kernels.codegen.executor import DEFAULT_BLOCK
    blocks = tuple(blocks) if blocks else (DEFAULT_BLOCK,)
    bad_blocks = [b for b in blocks
                  if not isinstance(b, int) or b <= 0 or b % 8]
    if bad_blocks:
        raise ValueError(
            f"block sizes must be positive multiples of 8, got {bad_blocks}")
    cost = cost or ConstrainedBlas(bound=2)
    nnz_levels = dict(nnz_levels) if nnz_levels else default_nnz_levels(spec)
    sp = spec.sparse_indices
    seen: set[str] = set()
    out: list[Candidate] = []

    def add(path: ContractionPath, order: LoopOrder):
        c = cost.evaluate(path, order, spec.dims, sp)
        if c == cost_lib.INF:
            return
        f = path_flops(path, spec.dims, sp, nnz_levels)
        cand = Candidate(path=path, order=order, cost=c, flops=f)
        if cand.key in seen:
            return
        seen.add(cand.key)
        out.append(cand)

    for path in min_depth_paths(spec, max_paths=max_paths,
                                slack=depth_slack):
        res = OrderDP(path, cost, spec.dims, sp).solve()
        if res.order is not None and res.cost != cost_lib.INF:
            add(path, res.order)
        extra = max(0, orders_per_path - 1)
        if extra:
            for order in itertools.islice(enumerate_orders(path, sp),
                                          8 * extra):
                if len([c for c in out if c.path is path]) > extra:
                    break
                add(path, order)

    if not out:
        # constraint infeasible everywhere: fall back to minimizing buffer
        # size, which is always feasible (mirrors planner.plan's fallback)
        from repro_torch.core.cost import MaxBufferSize
        if not isinstance(cost, MaxBufferSize):
            return generate_candidates(
                spec, cost=MaxBufferSize(), nnz_levels=nnz_levels,
                max_paths=max_paths, depth_slack=depth_slack,
                max_candidates=max_candidates,
                orders_per_path=orders_per_path, backends=backends,
                blocks=blocks)
        raise ValueError(f"no feasible loop nest found for {spec}")

    out.sort(key=lambda c: (c.cost, c.flops, path_depth(c.path)))
    out = out[:max_candidates]
    from repro_torch.core.executor import BACKENDS
    bad = [b for b in backends if b not in BACKENDS]
    if bad:
        raise ValueError(f"unknown backends {bad}; expected from {BACKENDS}")
    from repro_torch.analysis.diagnostics import CODEGEN_BACKENDS
    from repro_torch.analysis.invariants import fusible_chains
    expanded, seen_keys = [], set()
    for c in out:
        for b in backends:
            if b in CODEGEN_BACKENDS and spec.sparse_input is None:
                b = "torch"  # identical engines on an all-dense network
            variants = (False,)
            if b in CODEGEN_BACKENDS and fusible_chains(spec, c.path):
                # fusion axis: staged AND fused chain lowering
                variants = (False, True)
            # block axis: only the code-generator engines take a block
            blks = blocks if b in CODEGEN_BACKENDS else (0,)
            for fz in variants:
                for blk in blks:
                    cand = dataclasses.replace(c, backend=b, fused=fz,
                                               block=blk)
                    if cand.key in seen_keys:
                        continue
                    seen_keys.add(cand.key)
                    expanded.append(cand)
    return expanded
