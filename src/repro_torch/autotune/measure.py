"""Empirical candidate timing (paper §4.1: 'enumeration enables
autotuning').

Each candidate runs through its backend's engine (``make_executor``),
warmed up first (the warm-up absorbs building the kernels and the
layouts, which are cached on the operand), then timed ``repeats`` times;
the score is the median.  On CUDA tensors one call is timed with CUDA
events after a ``torch.cuda.synchronize()`` (the JAX package's
``block_until_ready``); on CPU tensors with ``time.perf_counter``.
Early-exit pruning: once any candidate has finished, a later candidate
whose *first* timed call already exceeds ``prune_ratio x best_median``
is abandoned — the model ranking is good enough that most losers die
after one call.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.analysis.diagnostics import CODEGEN_BACKENDS
from repro_torch.autotune.candidates import Candidate
from repro_torch.core.spec import SpTTNSpec


@dataclasses.dataclass
class MeasureConfig:
    warmup: int = 1
    repeats: int = 3
    prune_ratio: float = 2.0     # 0/inf disables early-exit pruning


@dataclasses.dataclass
class Measurement:
    candidate: Candidate
    seconds: float               # median over completed repeats
    pruned: bool = False         # abandoned after the first timed call


def synth_inputs(spec: SpTTNSpec, density: float = 0.05, seed: int = 0):
    """Deterministic measurement inputs when the caller has no data yet:
    a random sparse tensor over the spec's sparse dims + random factors.
    Determinism matters — the synthesized nnz-level profile is part of the
    plan-cache key, so a restart must resynthesize the same pattern."""
    from repro_torch.sparse import build_csf, random_sparse
    shape = tuple(spec.dims[i] for i in spec.sparse_indices)
    csf = build_csf(random_sparse(shape, density, seed=seed))
    factors = synth_factors(spec, seed=seed)
    return csf, factors


def synth_factors(spec: SpTTNSpec, seed: int = 0) -> dict[str, np.ndarray]:
    """Float32 normal factors from ``seed`` (numpy, so the two packages
    draw the same numbers); the engines move them to the operand's
    device."""
    rng = np.random.default_rng(seed)
    factors = {}
    for t in spec.inputs:
        if t.is_sparse:
            continue
        shape = tuple(spec.dims[i] for i in t.indices)
        factors[t.name] = rng.standard_normal(shape).astype(np.float32)
    return factors


def timed_call(fn, device: torch.device) -> float:
    """Seconds of one ``fn()``: CUDA events around it on a CUDA device
    (after a synchronize, so nothing earlier is counted), the host clock
    on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_candidates(spec: SpTTNSpec,
                       candidates: Sequence[Candidate],
                       arrays,
                       factors: Mapping[str, object],
                       config: MeasureConfig | None = None,
                       stats=None) -> list[Measurement]:
    """Time every candidate; returns measurements sorted fastest-first.

    ``arrays`` is a device-resident :class:`CSFArrays`; the factors move
    to its device once.  ``stats`` (a
    :class:`~repro_torch.autotune.tuner.SearchStats`) is incremented in
    place so callers can assert how much empirical work a search
    performed.
    """
    from repro_torch.core.executor import factors_to_torch, make_executor

    config = config or MeasureConfig()
    factors = factors_to_torch(factors, arrays.device)
    results: list[Measurement] = []
    best: float | None = None

    def run(ex) -> float:
        secs = timed_call(lambda: ex(arrays, factors), arrays.device)
        if stats is not None:
            stats.executions += 1
        return secs

    for cand in candidates:
        backend = getattr(cand, "backend", "torch")
        kwargs = {}
        if getattr(cand, "fused", False):
            kwargs["strategy"] = "fused"   # the chain lowering
        if backend in CODEGEN_BACKENDS and getattr(cand, "block", 0):
            kwargs["block"] = cand.block   # swept block axis
        ex = make_executor(spec, cand.path, cand.order, backend=backend,
                           **kwargs)
        for _ in range(config.warmup):
            run(ex)
        if stats is not None:
            stats.candidates_timed += 1
        first = run(ex)
        if (best is not None and config.prune_ratio
                and first > config.prune_ratio * best):
            results.append(Measurement(cand, first, pruned=True))
            if stats is not None:
                stats.pruned += 1
            continue
        times = [first] + [run(ex) for _ in range(config.repeats - 1)]
        med = float(np.median(times))
        results.append(Measurement(cand, med))
        best = med if best is None else min(best, med)

    # pruned entries carry a single first-call sample, not a median —
    # they must never outrank (or tie) a fully measured candidate, so
    # they sort strictly after every completed measurement
    results.sort(key=lambda m: (m.pruned, m.seconds))
    return results
