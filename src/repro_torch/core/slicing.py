"""Memory-budgeted sliced execution (out-of-core SpTTN, DESIGN.md §10).

The cost layer already *prices* a loop nest's intermediates — the
vectorized memory model :func:`repro_torch.core.cost.buffer_bytes` is
``MaxBufferSize`` (paper Def 4.7) evaluated in bytes at fiber-level
materialization.  This module *acts* on that price: given a
``memory_budget`` in bytes, it prices a plan's peak working set
(intermediates + operands + output), and when the plan is over budget it
splits ONE dense mode into chunks and replays the *same* tuned schedule
once per chunk — chunk-restricted factors, chunk-restricted output slab —
streaming (output mode) or accumulating (contracted mode) the partials.

The pricing is the JAX package's, decision for decision (numpy only);
the replay runs on the operand's device and never copies a partial to
the host.

Design rules:

* **One cached plan.**  The slice decision is a function of
  (plan, nnz profile, budget) and is re-derived at planning/serving time;
  it never enters the plan-cache key and the cache always stores the
  *unsliced* schedule.  Budgeted and unbudgeted callers share one entry.
* **Dense modes only.**  A dense mode never appears in the CSF, so every
  chunk replays against the identical sparse operand and the identical
  segment layouts — no pattern rebuild, no re-tuning.  Slicing a *sparse*
  mode is exactly nonzero sharding, which `execute_plan` already does for
  shard lists; the two compose (slice within shard).
* **Exactness.**  Chunking a dense mode partitions either the output
  (mode kept by the output: disjoint slabs) or the contraction sum
  (mode contracted away: partial sums accumulated in float64), so sliced
  results match unsliced ones to float rounding.
* **Priced, not measured.**  The footprint counts intermediates at the
  fiber level the model assigns them; an engine that materializes a
  dense intermediate (TTTP3's ``(U.V)(i,j,r)``) can peak far above the
  price, so the budget bounds the model's bytes, not the device's.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

from repro_torch.core.cost import buffer_bytes
from repro_torch.core.loopnest import LoopOrder
from repro_torch.core.paths import ContractionPath
from repro_torch.core.spec import SpTTNSpec

DEFAULT_ITEMSIZE = 4   # float32 — every engine computes in f32


class MemoryBudgetError(ValueError):
    """No single-mode chunking brings the plan's working set under budget."""


@dataclasses.dataclass(frozen=True)
class SliceDecision:
    """How (and whether) a plan must be sliced to fit ``budget`` bytes.

    ``mode`` is the dense index being chunked (``None`` = fits unsliced),
    ``chunks`` the number of chunks (1 = unsliced), ``kind`` one of
    ``"none"`` / ``"output"`` (mode kept by the output: partials are
    disjoint slabs) / ``"contracted"`` (mode summed away: partials are
    accumulated).  ``peak_bytes`` is the unsliced working set and
    ``chunk_bytes`` the working set of the widest chunk — the quantity
    guaranteed ``<= budget`` when ``mode`` is not None.
    """

    mode: str | None
    chunks: int
    kind: str
    peak_bytes: int
    chunk_bytes: int


def _default_nnz_levels(spec: SpTTNSpec) -> dict[int, int]:
    """Density-agnostic profile (same default as the planner's)."""
    prod, levels = 1, {0: 1}
    for p, ind in enumerate(spec.sparse_indices, start=1):
        prod *= spec.dims[ind]
        levels[p] = prod
    return levels


def nnz_levels_of(csf) -> dict[int, int]:
    """nnz-level profile of a CSFTensor *or* device-side CSFArrays."""
    if hasattr(csf, "nnz_levels"):
        return dict(csf.nnz_levels())
    return {0: 1, **{int(p): int(n) for p, n in csf.nfib.items()}}


def _footprint(spec: SpTTNSpec, path: ContractionPath, order: LoopOrder,
               nnz_levels: Mapping[int, int], dims: Mapping[str, int],
               itemsize: int) -> int:
    """Working-set bytes of one execution pass under ``dims``:
    vectorized intermediates (the ``MaxBufferSize`` accounting in bytes,
    :func:`repro_torch.core.cost.buffer_bytes`) + dense operands + sparse
    values + the output the pass materializes."""
    total = buffer_bytes(path, order, dims, spec.sparse_indices,
                         nnz_levels, itemsize=itemsize)
    nnz = int(nnz_levels.get(len(spec.sparse_indices), 0))
    for t in spec.inputs:
        if t.is_sparse:
            total += nnz * itemsize
        else:
            total += math.prod(dims[i] for i in t.indices) * itemsize
    if spec.output_is_sparse:
        total += nnz * itemsize
    else:
        total += math.prod(dims[i] for i in spec.output.indices) * itemsize
    return int(total)


def plan_peak_bytes(spec: SpTTNSpec, path: ContractionPath,
                    order: LoopOrder,
                    nnz_levels: Mapping[int, int] | None = None,
                    itemsize: int = DEFAULT_ITEMSIZE) -> int:
    """Peak working-set bytes of running ``(path, order)`` unsliced.

    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> spec = S.mttkrp(8, 6, 5, 4)
    >>> p = plan(spec)
    >>> plan_peak_bytes(spec, p.path, p.order, {0: 1, 1: 8, 2: 20, 3: 40})
    784
    """
    levels = (dict(nnz_levels) if nnz_levels is not None
              else _default_nnz_levels(spec))
    return _footprint(spec, path, order, levels, spec.dims, itemsize)


def _chunk_width(D: int, chunks: int) -> int:
    return -(-D // chunks)


def _min_chunks(spec: SpTTNSpec, path, order, levels, budget: int,
                mode: str, itemsize: int) -> int | None:
    """Smallest chunk count for ``mode`` that fits, or None (infeasible).
    The footprint is monotone non-increasing in the chunk count, so
    bisection over [1, dims[mode]] is exact."""
    D = spec.dims[mode]

    def fits(chunks: int) -> bool:
        dims = dict(spec.dims)
        dims[mode] = _chunk_width(D, chunks)
        return _footprint(spec, path, order, levels, dims,
                          itemsize) <= budget

    if fits(1):
        return 1
    if not fits(D):
        return None
    lo, hi = 1, D          # invariant: not fits(lo), fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            hi = mid
        else:
            lo = mid
    return hi


def choose_slicing(spec: SpTTNSpec, path: ContractionPath, order: LoopOrder,
                   nnz_levels: Mapping[int, int] | None,
                   memory_budget: int,
                   itemsize: int = DEFAULT_ITEMSIZE) -> SliceDecision:
    """Pick the dense mode + chunk count that fits ``memory_budget``.

    Rule: among all dense modes, take the one needing the FEWEST chunks
    (fewest extra passes over the sparse operand — the Ahrens et al.
    asymptotic model's first-order term); break ties toward output modes
    (streamed slabs, no accumulation pass), then toward the larger mode
    (more future headroom), then lexicographically.  Raises
    :class:`MemoryBudgetError` when no single-mode chunking can fit —
    callers should shard the tensor (distributed replay) instead.

    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> spec = S.mttkrp(64, 32, 16, 64)
    >>> p = plan(spec)
    >>> levels = {0: 1, 1: 64, 2: 512, 3: 2048}
    >>> d = choose_slicing(spec, p.path, p.order, levels,
    ...                    memory_budget=300_000)
    >>> (d.mode, d.chunks, d.kind)       # fits: nothing to slice
    (None, 1, 'none')
    >>> d = choose_slicing(spec, p.path, p.order, levels,
    ...                    memory_budget=150_000)
    >>> (d.mode, d.kind, d.chunks > 1, d.chunk_bytes <= 150_000)
    ('a', 'output', True, True)
    """
    if memory_budget <= 0:
        raise ValueError(f"memory_budget must be positive bytes, got "
                         f"{memory_budget!r}")
    levels = (dict(nnz_levels) if nnz_levels is not None
              else _default_nnz_levels(spec))
    base = _footprint(spec, path, order, levels, spec.dims, itemsize)
    if base <= memory_budget:
        return SliceDecision(mode=None, chunks=1, kind="none",
                             peak_bytes=base, chunk_bytes=base)

    sp = set(spec.sparse_indices)
    out = set(spec.output.indices)
    best = None
    for mode in spec.all_indices:
        if mode in sp or spec.dims[mode] < 2:
            continue
        chunks = _min_chunks(spec, path, order, levels, memory_budget,
                             mode, itemsize)
        if chunks is None:
            continue
        kind = "output" if mode in out else "contracted"
        rank = (chunks, 0 if kind == "output" else 1,
                -spec.dims[mode], mode)
        if best is None or rank < best[0]:
            best = (rank, mode, chunks, kind)
    if best is None:
        raise MemoryBudgetError(
            f"plan working set is {base} bytes and no single dense-mode "
            f"chunking fits memory_budget={memory_budget}; shard the "
            "sparse tensor (pass a shard list to execute_plan) or raise "
            "the budget")
    _, mode, chunks, kind = best
    dims = dict(spec.dims)
    dims[mode] = _chunk_width(spec.dims[mode], chunks)
    cb = _footprint(spec, path, order, levels, dims, itemsize)
    return SliceDecision(mode=mode, chunks=chunks, kind=kind,
                         peak_bytes=base, chunk_bytes=cb)


def stamp_plan_slicing(plan, nnz_levels: Mapping[int, int] | None,
                       memory_budget: int | None,
                       itemsize: int = DEFAULT_ITEMSIZE):
    """Return ``plan`` with ``slice_mode``/``slice_chunks`` set for
    ``memory_budget`` (or cleared when it fits / budget is None).  Pure —
    the input plan is never mutated, so a cached instance stays unsliced."""
    if memory_budget is None:
        return plan
    d = choose_slicing(plan.spec, plan.path, plan.order, nnz_levels,
                       memory_budget, itemsize=itemsize)
    if (plan.slice_mode, plan.slice_chunks) == (d.mode, d.chunks):
        return plan
    return dataclasses.replace(plan, slice_mode=d.mode,
                               slice_chunks=d.chunks)


def plan_decision(plan, nnz_levels: Mapping[int, int] | None = None,
                  itemsize: int = DEFAULT_ITEMSIZE) -> SliceDecision:
    """Reconstruct the :class:`SliceDecision` a stamped plan encodes
    (footprints re-priced from the profile) — what benchmarks assert."""
    spec = plan.spec
    levels = (dict(nnz_levels) if nnz_levels is not None
              else _default_nnz_levels(spec))
    base = _footprint(spec, plan.path, plan.order, levels, spec.dims,
                      itemsize)
    mode, chunks = plan.slice_mode, plan.slice_chunks
    if mode is None:
        return SliceDecision(mode=None, chunks=1, kind="none",
                             peak_bytes=base, chunk_bytes=base)
    dims = dict(spec.dims)
    dims[mode] = _chunk_width(spec.dims[mode], chunks)
    cb = _footprint(spec, plan.path, plan.order, levels, dims, itemsize)
    kind = ("output" if mode in set(spec.output.indices) else "contracted")
    return SliceDecision(mode=mode, chunks=chunks, kind=kind,
                         peak_bytes=base, chunk_bytes=cb)


def chunk_footprints(plan, nnz_levels: Mapping[int, int] | None = None,
                     itemsize: int = DEFAULT_ITEMSIZE) -> list[int]:
    """Per-chunk working-set bytes of a stamped plan, tail included —
    every entry must be ``<= memory_budget`` for the stamping budget."""
    spec = plan.spec
    levels = (dict(nnz_levels) if nnz_levels is not None
              else _default_nnz_levels(spec))
    mode, chunks = plan.slice_mode, plan.slice_chunks
    if mode is None:
        return [_footprint(spec, plan.path, plan.order, levels, spec.dims,
                           itemsize)]
    D = spec.dims[mode]
    width = _chunk_width(D, chunks)
    out = []
    for start in range(0, D, width):
        dims = dict(spec.dims)
        dims[mode] = min(width, D - start)
        out.append(_footprint(spec, plan.path, plan.order, levels, dims,
                              itemsize))
    return out


# --------------------------------------------------------------------------- #
# Sliced replay
# --------------------------------------------------------------------------- #
def sliced_execute(plan, csf, factors: Mapping, backend: str | None = None,
                   mode: str | None = None, chunks: int | None = None,
                   executor_cache: dict | None = None, device=None,
                   **kwargs):
    """Replay one tuned plan per chunk of its sliced dense mode.

    ``mode``/``chunks`` default to the plan's stamped ``slice_mode``/
    ``slice_chunks``.  Factors carrying the mode are cut to the chunk's
    index range (``narrow``, then one contiguous copy per chunk, so every
    kernel reads a fresh 16-byte-aligned base); the CSF operand is
    untouched (dense modes never enter the sparse pattern).  Output-mode
    partials are copied into a preallocated result on the operand's
    device; contracted-mode partials are summed in a float64 tensor there
    and cast back.  ``executor_cache`` (chunk width -> engine) lets
    serving loops reuse chunk executors across requests.  ``csf`` is a
    :class:`~repro_torch.core.executor.CSFArrays` or a host CSF tensor
    (uploaded to ``device``: ``None`` is the CUDA card).  Extra kwargs
    reach :func:`repro_torch.core.executor.make_executor`.  Returns a
    tensor on the operand's device.
    """
    import torch

    from repro_torch.analysis.invariants import check_slice
    from repro_torch.core import executor as X
    spec = plan.spec
    mode = mode if mode is not None else plan.slice_mode
    chunks = chunks if chunks is not None else plan.slice_chunks
    if mode is None or chunks <= 1:
        raise ValueError("sliced_execute needs a sliced plan: slice_mode "
                         "is None / slice_chunks <= 1 (use execute_plan)")
    # slice-mode kind legality lives in the verifier (SPTTN-E030/E031);
    # chunk range is checked below against the actual chunking math
    for d in check_slice(spec, mode, None):
        raise ValueError(f"{d.message} [{d.code}]")

    D = spec.dims[mode]
    width = _chunk_width(D, max(1, min(chunks, D)))
    resolved = backend or plan.backend
    kwargs = X.plan_engine_kwargs(plan, resolved, kwargs)
    arrays = X.as_arrays(csf, device)
    factors = X.factors_to_torch(factors, arrays.device)
    by_name = {t.name: t for t in spec.inputs}
    out_ax = (spec.output.indices.index(mode)
              if mode in spec.output.indices else None)
    executor_cache = executor_cache if executor_cache is not None else {}

    result = None    # output mode: the assembled result; else float64 sum
    out_dtype = None
    for start in range(0, D, width):
        w = min(width, D - start)
        ex = executor_cache.get(w)
        if ex is None:
            dims_c = dict(spec.dims)
            dims_c[mode] = w
            spec_c = dataclasses.replace(spec, dims=dims_c)
            ex = X.make_executor(spec_c, plan.path, plan.order,
                                 backend=resolved, **kwargs)
            executor_cache[w] = ex
        f_c = {}
        for name, arr in factors.items():
            t = by_name.get(name)
            if t is not None and not t.is_sparse and mode in t.indices:
                arr = arr.narrow(t.indices.index(mode), start,
                                 w).contiguous()
            f_c[name] = arr
        part = torch.as_tensor(ex(arrays, f_c), device=arrays.device)
        out_dtype = part.dtype
        if out_ax is not None:
            if result is None:
                shape = list(part.shape)
                shape[out_ax] = D
                result = torch.empty(shape, dtype=part.dtype,
                                     device=part.device)
            result.narrow(out_ax, start, w).copy_(part)
        elif result is None:
            result = part.to(torch.float64, copy=True)
        else:
            result.add_(part)
        del part
    return result if out_ax is not None else result.to(out_dtype)
