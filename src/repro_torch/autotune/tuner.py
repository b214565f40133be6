"""Autotuning runtime: model-pruned enumeration + empirical measurement +
persistent plan cache (the JAX package's ``src/repro/autotune/tuner.py``,
measuring on the CUDA card).

This is the hybrid the paper motivates in §4.1 ("identification of the best
choice of loop nest without user guidance ... enumeration enables
autotuning") and SparseAuto / Ahrens-Kjolstad quantify: cost models prune
the combinatorial schedule space to a handful of candidates, wall-clock
measurement settles what the models cannot distinguish, and the winner is
persisted keyed by (kernel signature, sparsity profile, device) so repeated
traffic — a second process, a second tensor with the same pattern — pays
zero search cost.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping

from repro_torch.analysis.diagnostics import CODEGEN_BACKENDS
from repro_torch.autotune.cache import (PlanCache, bucket_nnz_levels,
                                  bucketed_cache_key, cache_key, device_kind)
from repro_torch.autotune.candidates import (default_nnz_levels,
                                       generate_candidates)
from repro_torch.autotune.measure import (MeasureConfig, measure_candidates,
                                    synth_factors, synth_inputs)
from repro_torch.core.cost import ConstrainedBlas, TreeCost
from repro_torch.core.spec import SpTTNSpec


@dataclasses.dataclass
class TunerConfig:
    """Search-size knobs; defaults sized for the paper's kernels (n<=6).

    ``backends`` is the engine axis of the search (``None`` resolves via
    :func:`default_backends`: ``torch`` and both code-generator engines
    where CUDA is present, ``torch`` alone elsewhere — on the CPU the
    code generator runs its kernels' plain versions, which can never win
    wall-clock; pass it explicitly to force one, e.g.
    ``backends=("cuda",)``).

    ``mesh`` is the distributed shard context for a shard-local search
    (DESIGN.md §7): a JSON-able mapping naming the mesh shape, the
    mode→axis partitioning, and the shard (the JAX package's
    ``shard_mesh_key``).  It enters the plan-cache key — a sharded
    pattern never reuses a single-device winner — and is stamped onto
    the tuned plan, which persists it in plan JSON.

    ``blocks`` is the code generator's block-size grid: every ``cuda`` /
    ``cuda-splitk`` candidate is measured once per grid value (positive
    multiples of 8), the winner's block is stamped onto the plan, and it
    persists in plan JSON so replay runs the layouts that won.  ``None``
    means the single-point default grid ``(DEFAULT_BLOCK,)`` — block
    sweeping costs measurements, so opting into a wider grid is
    explicit, like forcing a backend axis.

    ``profile_bucket`` opts the search into the serving hot path
    (DESIGN.md §9): on an exact-key miss, a plan tuned for a *bucketed*
    profile (:func:`repro.autotune.cache.bucket_nnz_levels`) is reused
    when its FLOP estimate on the true profile stays within
    ``bucket_tolerance`` × the estimate it was tuned at — otherwise the
    bucket entry is ignored and a fresh search runs.  A fresh winner is
    persisted under both the exact and the bucketed key, so a stream of
    perturbed patterns pays one search, not one per pattern.  ``None``
    (the default) keeps the classic exact-only behavior.
    """

    max_paths: int | None = 16
    depth_slack: int = 0
    max_candidates: int = 8
    orders_per_path: int = 3
    warmup: int = 1
    repeats: int = 3
    prune_ratio: float = 2.0
    synth_density: float = 0.05   # for synthesized measurement tensors
    synth_seed: int = 0
    backends: tuple[str, ...] | None = None
    mesh: Mapping | None = None
    blocks: tuple[int, ...] | None = None
    profile_bucket: str | None = None    # e.g. "log2" (serving streams)
    bucket_tolerance: float = 4.0        # replan when est. cost drifts past


def default_backends() -> tuple[str, ...]:
    """Engine axis default: where CUDA is present, ``torch`` and both
    code-generator engines (both lowerings run their kernels on the
    card, so either can win); elsewhere ``torch`` alone — the code
    generator would run its kernels' plain versions, which only slow the
    search.  The device kind is part of the cache key, so a card-tuned
    and a CPU-tuned winner never collide."""
    import torch
    if torch.cuda.is_available():
        return ("torch", "cuda", "cuda-splitk")
    return ("torch",)


@dataclasses.dataclass
class SearchStats:
    """What one ``tune`` call actually did (assertable by tests/benchmarks).

    ``executions`` counts every measured kernel launch, warmup included —
    a cache hit performs none.
    """

    cache_hit: bool = False
    cache_key: str = ""
    bucket_hit: bool = False      # served from a bucketed entry (§9 guard ok)
    bucket_key: str = ""          # bucketed key consulted ("" = bucketing off)
    bucket_est_flops: float | None = None   # reused plan's cost on the true
                                            # profile (guard's left-hand side)
    candidates_generated: int = 0
    candidates_timed: int = 0
    executions: int = 0
    pruned: int = 0
    vetoed: int = 0               # rejected by verify_plan pre-measurement
                                  # (E-severity diagnostics; DESIGN.md §11)
    search_seconds: float = 0.0
    best_seconds: float | None = None
    model_seconds: float | None = None   # measured time of the model's pick
    measurements: list = dataclasses.field(default_factory=list)
                                  # every Measurement, fastest first


def _bucket_reuse_ok(plan, spec: SpTTNSpec, true_levels: Mapping[int, int],
                     config: TunerConfig, stats: "SearchStats") -> bool:
    """Cost-model guard for bucketed reuse (DESIGN.md §9).

    A bucketed entry was tuned for *some* same-bucket profile, not this
    one.  Reuse is safe only while the plan's sparse-aware FLOP estimate
    on the true profile stays within ``bucket_tolerance`` × the estimate
    it was tuned at (``plan.flops``) — log2 buckets bound per-level drift
    by 2x, so a sound entry passes any tolerance ≥ 2; a stale or foreign
    entry whose profile diverged (e.g. the bucketing scheme coarsened)
    fails and forces a replan instead of silently executing a bad nest.
    """
    from repro_torch.core.cost import path_flops
    est_true = path_flops(plan.path, spec.dims, spec.sparse_indices,
                          dict(true_levels))
    stats.bucket_est_flops = est_true
    return est_true <= config.bucket_tolerance * max(plan.flops, 1.0)


def tune(spec: SpTTNSpec,
         cost: TreeCost | None = None,
         nnz_levels: Mapping[int, int] | None = None,
         csf=None,
         factors: Mapping | None = None,
         cache_dir: str | None = None,
         config: TunerConfig | None = None,
         *,
         tuner: TunerConfig | None = None,
         memory_budget: int | None = None):
    """Find the empirically fastest loop nest; returns (plan, stats).

    ``csf``/``factors`` supply measurement inputs; either may be omitted
    and is then synthesized deterministically from the spec.  With
    ``cache_dir`` set, a prior winner for the same (spec, nnz profile,
    device, backend axis, mesh context) is returned without executing any
    candidate.  ``tuner`` is the blessed spelling of the TunerConfig
    kwarg (matching ``plan(tuner=...)``); ``config=`` is a deprecated
    alias.

    ``csf`` is a :class:`~repro_torch.core.executor.CSFArrays` (measured
    on its device) or a host CSF tensor (uploaded to the CUDA card, as
    every entry point runs there unless asked for the CPU).  Pass the
    tensor: one synthesized at the spec's dimensions holds
    ``synth_density`` of them all.  ``memory_budget`` (bytes) stamps the
    returned plan with the slicing decision of DESIGN.md §10 for the
    operand's profile; the budget never enters the cache key and the
    cache stores the unsliced winner, so budgeted and unbudgeted callers
    share one entry.

    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.executor import CSFArrays
    >>> from repro_torch.sparse import build_csf, random_sparse
    >>> arrays = CSFArrays.from_csf(
    ...     build_csf(random_sparse((8, 6, 5), 0.2, seed=0)), device="cpu")
    >>> tuned, stats = tune(S.mttkrp(8, 6, 5, 4), csf=arrays,
    ...                     tuner=TunerConfig(max_paths=2, max_candidates=2,
    ...                                       orders_per_path=1, repeats=2))
    >>> stats.cache_hit
    False
    >>> stats.candidates_timed >= 1
    True
    >>> tuned.backend
    'torch'
    """
    from repro_torch.core.executor import CSFArrays
    from repro_torch.core.planner import _resolve_tuner_alias
    config = _resolve_tuner_alias(tuner, config, "tune") or TunerConfig()
    cost = cost or ConstrainedBlas(bound=2)
    stats = SearchStats()
    t_start = time.perf_counter()

    if csf is None:
        csf, synth = synth_inputs(spec, density=config.synth_density,
                                  seed=config.synth_seed)
        factors = factors if factors is not None else synth
    elif factors is None:
        factors = synth_factors(spec, seed=config.synth_seed)
    host = csf.host if isinstance(csf, CSFArrays) else csf
    levels = dict(nnz_levels) if nnz_levels else (
        host.nnz_levels() if hasattr(host, "nnz_levels")
        else default_nnz_levels(spec))

    backends = config.backends or default_backends()
    cache = PlanCache(cache_dir) if cache_dir else None
    device = device_kind(csf.device if isinstance(csf, CSFArrays)
                         else None)
    key = cache_key(spec, levels, device, backends=backends,
                    mesh=config.mesh, blocks=config.blocks)
    stats.cache_key = key
    bkey = None
    if config.profile_bucket is not None:
        bkey = bucketed_cache_key(spec, levels, device, backends=backends,
                                  mesh=config.mesh, blocks=config.blocks,
                                  scheme=config.profile_bucket)
        stats.bucket_key = bkey

    def _budgeted(p):
        # the slice decision is derived per call from (plan, profile,
        # budget) — never part of the cached schedule (DESIGN.md §10)
        if memory_budget is None:
            return p
        from repro_torch.core.slicing import stamp_plan_slicing
        return stamp_plan_slicing(p, levels, memory_budget)

    if cache is not None:
        hit = cache.get(key)         # exact-key fast path
        if hit is not None:
            stats.cache_hit = True
            stats.search_seconds = time.perf_counter() - t_start
            return _budgeted(hit), stats
        if bkey is not None:
            hit = cache.get(bkey)
            if hit is not None and _bucket_reuse_ok(hit, spec, levels,
                                                    config, stats):
                stats.cache_hit = True
                stats.bucket_hit = True
                stats.search_seconds = time.perf_counter() - t_start
                return _budgeted(hit), stats

    # --- model-side pruning ------------------------------------------- #
    # generate_candidates ranks by TreeCost.evaluate (the ground-truth
    # scale Algorithm 1 optimizes, dense-term offset included), so the
    # ranking head IS the pure-model pick — it is always measured, which
    # guarantees tuned-runtime <= model-runtime on these measurements.
    candidates = generate_candidates(
        spec, cost=cost, nnz_levels=levels, max_paths=config.max_paths,
        depth_slack=config.depth_slack,
        max_candidates=config.max_candidates,
        orders_per_path=config.orders_per_path,
        backends=backends, blocks=config.blocks)
    stats.candidates_generated = len(candidates)

    # --- static verification gate ------------------------------------- #
    # an E-severity diagnostic means some engine would reject (or
    # miscompute) the schedule — never spend compile+measure time on it.
    # Today's generator emits only legal candidates, so this prunes
    # nothing; it is the contract future candidate sources inherit.
    from repro_torch.analysis import verify_plan
    legal = [c for c in candidates
             if verify_plan(spec, c.path, c.order, backend=c.backend,
                            fused=c.fused, block=c.block or None).ok]
    stats.vetoed = len(candidates) - len(legal)
    if not legal:
        raise ValueError(
            "every generated candidate was rejected by verify_plan — "
            "the spec admits no legal schedule on the requested axes")
    candidates = legal
    model_cand = candidates[0]

    # --- empirical measurement ---------------------------------------- #
    arrays = (csf if isinstance(csf, CSFArrays)
              else CSFArrays.from_csf(csf))
    mcfg = MeasureConfig(warmup=config.warmup, repeats=config.repeats,
                         prune_ratio=config.prune_ratio)
    results = measure_candidates(spec, candidates, arrays, factors,
                                 config=mcfg, stats=stats)
    stats.measurements = results
    # winner selection skips pruned entries explicitly: a pruned
    # measurement is one first-call sample, not a median, and must never
    # win (measure_candidates sorts them last, but the skip is the
    # guarantee, not the sort).  All-pruned can only happen with a
    # degenerate prune_ratio; fall back to the least-bad sample then.
    best = next((m for m in results if not m.pruned), results[0])
    stats.best_seconds = best.seconds
    model_key = model_cand.key
    for m in results:
        if m.candidate.key == model_key:
            stats.model_seconds = m.seconds
            break

    from repro_torch.core.paths import path_depth
    from repro_torch.core.planner import SpTTNPlan
    plan = SpTTNPlan(spec=spec, path=best.candidate.path,
                     order=best.candidate.order, cost=best.candidate.cost,
                     flops=best.candidate.flops,
                     depth=path_depth(best.candidate.path),
                     backend=best.candidate.backend,
                     mesh=None if config.mesh is None else dict(config.mesh),
                     fused=best.candidate.fused,
                     block=(best.candidate.block or None)
                     if best.candidate.backend in CODEGEN_BACKENDS else None)

    if cache is not None:
        meta = {
            "best_seconds": best.seconds,
            "model_seconds": stats.model_seconds,
            "candidates_timed": stats.candidates_timed,
            "executions": stats.executions,
            "device": device,
            "backends": list(backends),
            "mesh": None if config.mesh is None else dict(config.mesh),
            "timings": [
                {"seconds": m.seconds, "pruned": m.pruned,
                 "cost": m.candidate.cost, "flops": m.candidate.flops,
                 "backend": m.candidate.backend,
                 "fused": m.candidate.fused,
                 "block": m.candidate.block}
                for m in results],
        }
        cache.put(key, plan, meta=meta)
        if bkey is not None:
            # the serving-stream entry: last same-bucket winner serves the
            # whole bucket (guarded on read, so "last" is safe)
            cache.put(bkey, plan, meta=dict(
                meta, profile_bucket=config.profile_bucket,
                nnz_levels={str(k): int(v) for k, v in sorted(
                    bucket_nnz_levels(levels,
                                      config.profile_bucket).items())}))

    stats.search_seconds = time.perf_counter() - t_start
    return _budgeted(plan), stats
