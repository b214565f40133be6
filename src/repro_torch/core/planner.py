"""SpTTN planner (paper §5): pick the minimum-cost fully-fused loop nest.

Pipeline:  enumerate min-depth contraction paths  →  Algorithm 1 per path
(under the chosen tree-separable cost)  →  tie-break across paths by the
sparse-aware FLOP model  →  an executable :class:`SpTTNPlan`.

Plans are cached by (spec signature, nnz-level profile), mirroring the
paper's observation that the schedule depends only on the fixed sparsity
pattern, not on values.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping, Sequence

from repro_torch.core import cost as cost_lib
from repro_torch.core.cost import ConstrainedBlas, TreeCost, path_flops
from repro_torch.core.loopnest import LoopOrder
from repro_torch.core.order_dp import OrderDP
from repro_torch.core.paths import ContractionPath, min_depth_paths, path_depth
from repro_torch.core.spec import SpTTNSpec


@dataclasses.dataclass
class SpTTNPlan:
    """A chosen schedule: contraction path + loop order (+ diagnostics).

    The fields and their meaning are those of the JAX package's plan, so
    a plan document written there replays here (plan JSON v6, see
    :func:`repro_torch.core.executor.plan_from_dict`).  ``backend`` names
    the engine the schedule was selected for (``BACKENDS`` of
    :mod:`repro_torch.analysis.diagnostics`).  ``mesh`` is the shard
    context a distributed plan was tuned under (``None`` for one device).
    ``fused`` marks a schedule that won with the single-kernel chain
    lowering, and ``block`` the fiber block size it won with (``None`` is
    the engine default).  ``slice_mode``/``slice_chunks`` record a
    memory-budget slicing decision (``None``/1 means unsliced).
    ``stats`` is attached by autotuned planning and is excluded from
    equality.
    """

    spec: SpTTNSpec
    path: ContractionPath
    order: LoopOrder
    cost: float
    flops: float
    depth: int
    backend: str = "torch"
    mesh: Mapping | None = None
    fused: bool = False
    block: int | None = None
    slice_mode: str | None = None
    slice_chunks: int = 1
    stats: object | None = dataclasses.field(default=None, compare=False,
                                             repr=False)

    def describe(self) -> str:  # pragma: no cover - debugging aid
        lines = [f"SpTTNPlan depth={self.depth} cost={self.cost} "
                 f"flops={self.flops:.3g} backend={self.backend}"]
        for t, a in zip(self.path, self.order):
            lines.append(f"  {t}   order={','.join(a)}")
        return "\n".join(lines)


def _resolve_tuner_alias(tuner, config, caller: str):
    """``tuner=`` is the blessed spelling of the TunerConfig kwarg across
    the API (``plan``/``tune``); ``config=`` is the deprecated alias."""
    if tuner is not None and config is not None:
        raise ValueError(f"{caller}() got both tuner= and config= "
                         "(aliases for the same TunerConfig); pass tuner=")
    if config is not None:
        import warnings
        warnings.warn(f"{caller}(config=...) is deprecated; use "
                      f"{caller}(tuner=...)", DeprecationWarning,
                      stacklevel=3)
        return config
    return tuner


def plan(spec: SpTTNSpec,
         cost: TreeCost | None = None,
         nnz_levels: Mapping[int, int] | None = None,
         max_paths: int | None = 64,
         depth_slack: int = 0,
         autotune: bool = False,
         cache_dir: str | None = None,
         csf=None,
         factors: Mapping | None = None,
         tuner=None,
         *,
         config=None,
         memory_budget: int | None = None) -> SpTTNPlan:
    """Find the minimum-cost loop nest for an SpTTN kernel.

    Default cost is the paper's experiment metric (§7): maximize BLAS-able
    innermost dense loops with intermediate buffer dimension bounded by 2.

    ``autotune=True`` augments the model with measurement (paper §4.1):
    candidates are model-pruned, run and timed on the operand's device,
    and the winner is persisted under ``cache_dir`` keyed by (spec
    signature, CSF nnz-level profile, device kind) — a later call in any
    process with the same key returns the cached plan without executing
    a single candidate (see ``plan.stats``).  ``csf``/``factors`` supply
    the measurement inputs (pass the tensor: one synthesized at the
    spec's dimensions holds 5 % of them all); ``tuner`` is an optional
    :class:`repro_torch.autotune.TunerConfig` (``config=`` is a
    deprecated alias).

    ``memory_budget`` (bytes) stamps the returned plan with the slicing
    decision that keeps each execution pass within budget
    (``slice_mode``/``slice_chunks``, DESIGN.md §10); ``execute_plan``
    then replays it sliced.  The budget never changes which schedule is
    chosen or cached — only how the winner is replayed.

    >>> from repro_torch.core import spec as S
    >>> p = plan(S.mttkrp(8, 6, 5, 4))
    >>> p.depth
    4
    >>> p.backend
    'torch'
    >>> p.mesh is None       # single-device plan
    True
    >>> len(p.path)          # two contraction terms: leaf and root
    2
    """
    tuner = _resolve_tuner_alias(tuner, config, "plan")
    if autotune:
        from repro_torch.autotune import TunerConfig, tune
        if tuner is None:
            # honor this function's search-width arguments; an explicit
            # TunerConfig overrides them wholesale
            tuner = TunerConfig(max_paths=max_paths,
                                depth_slack=depth_slack)
        best, stats = tune(spec, cost=cost, nnz_levels=nnz_levels, csf=csf,
                           factors=factors, cache_dir=cache_dir,
                           tuner=tuner, memory_budget=memory_budget)
        best.stats = stats
        return best
    cost = cost or ConstrainedBlas(bound=2)
    if nnz_levels is None:
        # density-agnostic default: nnz^(I1..Ip) grows with the prefix space
        sp = spec.sparse_indices
        prod = 1
        nnz_levels = {0: 1}
        for p, ind in enumerate(sp, start=1):
            prod *= spec.dims[ind]
            nnz_levels[p] = prod

    def search(cost, max_paths):
        best: SpTTNPlan | None = None
        for path in min_depth_paths(spec, max_paths=max_paths,
                                    slack=depth_slack):
            dp = OrderDP(path, cost, spec.dims, spec.sparse_indices)
            res = dp.solve()
            if res.order is None or res.cost == cost_lib.INF:
                continue
            c = res.cost
            if isinstance(cost, ConstrainedBlas):
                c += cost.order_independent_offset(path, spec.sparse_indices)
            f = path_flops(path, spec.dims, spec.sparse_indices, nnz_levels)
            cand = SpTTNPlan(spec=spec, path=path, order=res.order, cost=c,
                             flops=f, depth=path_depth(path))
            if best is None or (cand.cost, cand.flops) < (best.cost,
                                                          best.flops):
                best = cand
        return best

    best = search(cost, max_paths)
    if best is None and max_paths is not None:
        # constraint infeasible within the path cap: widen the search
        best = search(cost, None)
    if best is None and isinstance(cost, ConstrainedBlas):
        # every path violates the buffer bound: fall back to minimizing
        # buffer size outright (always feasible)
        from repro_torch.core.cost import MaxBufferSize
        best = search(MaxBufferSize(), max_paths)
    if best is None:
        raise ValueError(f"no feasible loop nest found for {spec}")
    if memory_budget is not None:
        from repro_torch.core.slicing import stamp_plan_slicing
        best = stamp_plan_slicing(best, nnz_levels, memory_budget)
    return best


@functools.lru_cache(maxsize=256)
def _cached_plan_key(expr: str, dims_key: tuple, sparse: int | None,
                     nnz_key: tuple, bound: int) -> SpTTNPlan:
    from repro_torch.core.spec import parse
    spec = parse(expr, dims=dict(dims_key), sparse=sparse)
    return plan(spec, cost=ConstrainedBlas(bound=bound),
                nnz_levels=dict(nnz_key) if nnz_key else None)


def cached_plan(expr: str, dims: Mapping[str, int], sparse: int | None = 0,
                nnz_levels: Mapping[int, int] | None = None,
                bound: int = 2) -> SpTTNPlan:
    """LRU-cached planning keyed by the kernel signature (pattern-static)."""
    return _cached_plan_key(expr, tuple(sorted(dims.items())), sparse,
                            tuple(sorted((nnz_levels or {}).items())), bound)


def autotune(spec: SpTTNSpec, csf, factors,
             candidates: Sequence[tuple[ContractionPath, LoopOrder]],
             repeats: int = 3):
    """Measurement-driven selection among explicit (path, order) pairs
    (§4's 'enumeration enables autotuning').  Thin wrapper over
    :mod:`repro_torch.autotune` for callers that bring their own
    candidate list; ``csf`` is a :class:`~repro_torch.core.executor.
    CSFArrays` (measured on its device) or a host CSF tensor (uploaded
    to the CUDA card).  Returns (best_candidate, [(seconds, path, order),
    ...] ascending).
    """
    from repro_torch.autotune.candidates import Candidate
    from repro_torch.autotune.measure import MeasureConfig, measure_candidates
    from repro_torch.core.executor import as_arrays

    arrays = as_arrays(csf)
    cands = [Candidate(path=p, order=o, cost=0.0, flops=0.0)
             for p, o in candidates]
    ms = measure_candidates(
        spec, cands, arrays, factors,
        config=MeasureConfig(warmup=1, repeats=repeats, prune_ratio=0.0))
    results = [(m.seconds, m.candidate.path, m.candidate.order) for m in ms]
    _, path, order = results[0]
    return (path, order), results
