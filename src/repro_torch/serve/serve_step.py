"""Serving runtime (DESIGN.md §9): batched prefill + decode with slot-based
continuous batching, plus the SpTTN plan-cache hot path.

:class:`Server` holds a fixed pool of B slots of independent sequences;
finished slots are refilled from the queue without stopping the decode loop
(slot count and cache length never change).  The reference wraps
``decode_step`` in ``jax.jit``; here it runs eagerly on the params' device.

:class:`PlanService` is the serving-side owner of the autotuner stack: it
resolves every incoming sparsity pattern to a tuned plan through three
tiers — exact-key hit, bucketed-profile hit (guarded by the cost model),
cold autotune — and executes MoE dispatch through the winner on the
operand's device.  A stream of perturbed routing patterns pays ONE
search, then runs hot.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.sparse.coo import COOTensor, from_coords
from repro_torch.sparse.csf import CSFTensor, build_csf, build_csf_batch


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (T,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Single-host continuous-batching server over ``slots`` sequences of
    at most ``cache_len`` positions, on the device of ``params``.

    Each slot decodes at its own position.  A slot whose position passes
    ``cache_len`` keeps decoding over its full cache, its new rows
    dropped, as the reference's does.  A prompt longer than ``cache_len``
    is refused at :meth:`submit`; a ``cache_len`` above a local layer's
    window raises when the first prompt is spliced into the pool (the
    pool holds a ring of ``window`` rows, the prompt's cache
    ``cache_len``), as the reference's does."""

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 cache_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.device = params["embed"]["w"].device
        self.caches = init_cache(cfg, slots, cache_len, device=self.device)
        self.pos = np.zeros(slots, np.int32)
        self.active: list[Request | None] = [None] * slots
        self.queue: collections.deque[Request] = collections.deque()

    def submit(self, req: Request):
        if len(req.prompt) > self.cache_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds cache_len "
                f"{self.cache_len}; raise cache_len or truncate the prompt")
        self.queue.append(req)

    def _fill_slot(self, s: int):
        if not self.queue:
            return
        req = self.queue.popleft()
        T = len(req.prompt)
        batch = {"tokens": torch.as_tensor(
            np.asarray(req.prompt)[None], dtype=torch.int32).to(self.device)}
        logits, caches1 = prefill(self.params, self.cfg, batch,
                                  cache_len=self.cache_len)
        # splice the single-row cache into slot s of the pooled cache
        self.caches = tree_map(
            lambda pool, one: _splice(pool, one, s, self.cfg.window),
            self.caches, caches1)
        req.out.append(int(torch.argmax(logits[0, -1])))
        self.active[s] = req
        self.pos[s] = T

    def _sweep(self, finished: list[Request]):
        """Retire every slot whose request reached max_new."""
        for s, req in enumerate(self.active):
            if req is not None and len(req.out) >= req.max_new:
                req.done = True
                finished.append(req)
                self.active[s] = None

    def step(self) -> list[Request]:
        """One decode step across all active slots; returns the requests
        that finished during this step (including ones done straight out
        of prefill — max_new=1 never reaches the decode at all)."""
        finished: list[Request] = []
        while True:
            for s in range(self.slots):
                if self.active[s] is None:
                    self._fill_slot(s)
            n = len(finished)
            self._sweep(finished)
            # a sweep that freed slots may admit more queued work before
            # the (expensive) decode launch; loop until admission settles
            if len(finished) == n or not self.queue:
                break
        if all(a is None for a in self.active):
            return finished
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None and req.out:
                toks[s, 0] = req.out[-1]
        # per-slot positions: each sequence decodes at its own depth, so
        # mixed-length prompts read/write the right cache rows
        logits, self.caches = decode_step(
            self.params, self.cfg, self.caches,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos.astype(np.int64)).to(self.device))
        nxt = torch.argmax(logits[:, 0], -1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[s]))
            self.pos[s] += 1
        self._sweep(finished)
        return finished

    def run(self, max_steps: int = 64) -> list[Request]:
        finished = []
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            finished.extend(self.step())
        return finished


def moe_routing_coo(idx: np.ndarray, n_experts: int,
                    capacity: int) -> COOTensor:
    """The MoE routing tensor D(t, e, c) as a sparse COO pattern.

    Capacity slots are assigned in token order per expert (dropless
    inference semantics — overflow drops trailing choices), so the
    pattern matches what a grouped dispatch executes.

    >>> D = moe_routing_coo(np.array([[0, 1], [1, 0], [1, 1]]), 2, 2)
    >>> D.shape, D.nnz        # expert 1's two slots: the third token drops
    ((3, 2, 2), 4)
    """
    idx = np.asarray(idx)
    N, k = idx.shape
    flat = idx.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    rank = np.empty(flat.shape[0], np.int64)
    rank[order] = np.arange(flat.shape[0]) - starts[flat[order]]
    keep = rank < capacity
    coords = np.stack([np.repeat(np.arange(N), k)[keep],
                       flat[keep], rank[keep]], axis=1).astype(np.int32)
    values = np.ones(int(keep.sum()), np.float32)
    return from_coords(coords, values, (N, n_experts, capacity),
                       sum_duplicates=False)


def moe_dispatch_spec(n_tokens: int, n_experts: int, capacity: int,
                      d_model: int):
    """SpTTN spec of MoE dispatch  Xe(e,c,d) = sum_t D(t,e,c) * X(t,d)."""
    from repro_torch.core.spec import parse
    return parse("tec,td->ecd",
                 dims={"t": n_tokens, "e": n_experts, "c": capacity,
                       "d": d_model}, sparse=0, names=["D", "X"])


@dataclasses.dataclass
class ServeStats:
    """How one request's plan was resolved (assertable by tests/benches)."""

    kind: str            # "cold" (fresh search) | "exact" | "bucket"
    key: str             # exact cache key of the request's true profile
    bucket_key: str      # bucketed key consulted ("" = bucketing off)
    seconds: float       # plan-resolution wall-clock (search or lookup)


class PlanService:
    """Serving-side owner of the plan cache, bucketer, and executors.

    Request flow per pattern (DESIGN.md §9):

    1. exact key in the in-process plan map  -> "exact" (no disk, no model)
    2. bucketed key in the in-process map, and the cost-model guard admits
       the plan on the request's true profile -> "bucket"
    3. :func:`repro_torch.autotune.tuner.tune` with ``cache_dir`` — which
       itself checks the exact and bucketed *disk* entries before
       searching -> "exact"/"bucket" (disk hit) or "cold" (fresh search,
       persisted under both keys for every later request in the bucket)

    Execution is eager: perturbed patterns change array sizes every
    request, so a captured graph would be rebuilt per pattern — the
    opposite of a hot path.

    ``memory_budget`` (bytes) applies the out-of-core regime of
    DESIGN.md §10 per request: every resolved plan is stamped with the
    slice decision for the request's true nnz profile, and over-budget
    dispatches replay the one tuned schedule chunk by chunk (chunk
    executors are cached like whole-plan executors).  ``tuner`` is the
    blessed spelling of the TunerConfig kwarg; ``config`` stays accepted.
    ``device`` is where patterns are uploaded, tuned and dispatched:
    ``None`` is the CUDA card, ``"cpu"`` the CPU.
    """

    def __init__(self, cache_dir: str | None = None, config=None, *,
                 tuner=None, memory_budget: int | None = None,
                 device=None):
        from repro_torch.autotune.tuner import TunerConfig
        if tuner is not None and config is not None:
            raise ValueError("PlanService() got both tuner= and config= "
                             "(aliases for the same TunerConfig)")
        self.cache_dir = cache_dir
        self.config = tuner or config or TunerConfig(
            profile_bucket="log2", max_paths=4, max_candidates=4,
            orders_per_path=1, warmup=0, repeats=1)
        self.memory_budget = memory_budget
        self.device = device
        self.stats: list[ServeStats] = []
        self._plans: dict = {}          # exact key -> plan
        self._bucket_plans: dict = {}   # bucketed key -> plan
        self._executors: dict = {}      # plan json -> engine instance
        self._chunk_executors: dict = {}   # plan json -> {width: engine}

    def plan_for(self, spec, csf):
        """Resolve (spec, pattern) to a tuned plan; returns (plan, stats).
        ``csf`` is a host CSF tensor (uploaded to the service's device)
        or a :class:`~repro_torch.core.executor.CSFArrays`."""
        from repro_torch.analysis import verify_plan
        from repro_torch.autotune import tuner as T
        from repro_torch.autotune.cache import (bucketed_cache_key,
                                                cache_key, device_kind)
        from repro_torch.core.executor import as_arrays
        t0 = time.perf_counter()
        arrays = as_arrays(csf, self.device)
        levels = arrays.host.nnz_levels()
        device = device_kind(arrays.device)
        backends = self.config.backends or T.default_backends()
        key = cache_key(spec, levels, device, backends=backends,
                        mesh=self.config.mesh, blocks=self.config.blocks)
        bkey = ""
        if self.config.profile_bucket is not None:
            bkey = bucketed_cache_key(
                spec, levels, device, backends=backends,
                mesh=self.config.mesh, blocks=self.config.blocks,
                scheme=self.config.profile_bucket)
        if key in self._plans:
            plan, kind = self._plans[key], "exact"
        elif bkey and bkey in self._bucket_plans and T._bucket_reuse_ok(
                self._bucket_plans[bkey], spec, levels, self.config,
                T.SearchStats()):
            plan, kind = self._bucket_plans[bkey], "bucket"
            if self.memory_budget is not None:
                # a bucket-mate's profile, not this one: re-price slicing
                from repro_torch.core.slicing import stamp_plan_slicing
                plan = stamp_plan_slicing(plan, levels, self.memory_budget)
            self._plans[key] = plan   # promote: next time it's an exact hit
        else:
            plan, tstats = T.tune(spec, csf=arrays, cache_dir=self.cache_dir,
                                  tuner=self.config,
                                  memory_budget=self.memory_budget)
            kind = ("bucket" if tstats.bucket_hit
                    else "exact" if tstats.cache_hit else "cold")
            # static pre-flight before the plan enters the serving tiers:
            # a corrupt disk-cache entry is rejected once, here, with a
            # structured diagnostic — the in-memory exact/bucket tiers
            # above only ever hold plans that passed (DESIGN.md §11)
            verify_plan(plan).raise_if_error("PlanService.plan_for")
            self._plans[key] = plan
            if bkey:
                self._bucket_plans[bkey] = plan
        st = ServeStats(kind=kind, key=key, bucket_key=bkey,
                        seconds=time.perf_counter() - t0)
        self.stats.append(st)
        return plan, st

    def _executor_for(self, plan):
        from repro_torch.core.executor import (make_executor,
                                               plan_engine_kwargs,
                                               plan_to_json)
        pkey = plan_to_json(plan)
        ex = self._executors.get(pkey)
        if ex is None:
            ex = make_executor(plan.spec, plan.path, plan.order,
                               backend=plan.backend,
                               **plan_engine_kwargs(plan, plan.backend))
            self._executors[pkey] = ex
        return ex

    def dispatch(self, routing, x):
        """MoE dispatch Xe(e,c,d) = sum_t D(t,e,c) X(t,d) through a tuned
        plan; returns (Xe as a tensor on the service's device, ServeStats).
        ``routing`` is a COO or CSF pattern (or one already uploaded as
        :class:`~repro_torch.core.executor.CSFArrays`); ``x`` a numpy
        array or a tensor."""
        from repro_torch.core.executor import (CSFArrays, as_arrays,
                                               plan_to_json)
        if not isinstance(routing, (CSFTensor, CSFArrays)):
            routing = build_csf(routing)
        arrays = as_arrays(routing, self.device)
        N, E, C = arrays.shape
        d_model = int((x.shape if hasattr(x, "shape") else np.shape(x))[-1])
        spec = moe_dispatch_spec(N, E, C, d_model)
        plan, st = self.plan_for(spec, arrays)
        factors = {"X": x}
        if getattr(plan, "slice_chunks", 1) > 1:
            # over-budget request: replay the one tuned schedule chunk by
            # chunk, reusing chunk executors across requests
            from repro_torch.core.slicing import sliced_execute
            cache = self._chunk_executors.setdefault(plan_to_json(plan), {})
            return sliced_execute(plan, arrays, factors,
                                  executor_cache=cache), st
        return self._executor_for(plan)(arrays, factors), st

    def dispatch_batch(self, routings: Sequence[COOTensor], xs):
        """Batched request path: one amortized CSF construction pass
        (:func:`repro_torch.sparse.csf.build_csf_batch`), then per-request
        plan resolution + dispatch.  Returns a list of (output, stats)."""
        csfs = build_csf_batch(list(routings))
        return [self.dispatch(csf, x) for csf, x in zip(csfs, xs)]


def _splice(pool, one, s: int, window: int | None = None):
    """Insert a batch-1 cache leaf into slot s of the pooled cache leaf
    (the batch axis is the first axis where the shapes disagree — stacked
    groups prepend a layer-group axis shared by both).  A leaf larger than
    the pool on another axis — a prompt's ``cache_len`` rows against a
    local layer's ring of ``window`` rows — raises, as the reference's
    ``dynamic_update_slice`` does."""
    if pool.shape == one.shape:
        return one.to(pool.dtype)
    for ax in range(pool.ndim):
        if one.shape[ax] == 1 and pool.shape[ax] != 1:
            break
    else:
        return pool
    for a, (n, m) in enumerate(zip(one.shape, pool.shape)):
        if n > m:
            raise ValueError(
                f"a prompt's cache leaf {tuple(one.shape)} does not fit the "
                f"pooled cache leaf {tuple(pool.shape)} on axis {a}: a local "
                f"layer's pool holds a ring of min(cache_len, window="
                f"{window}) rows; keep cache_len <= {window}")
    at = [slice(0, n) for n in one.shape]
    start = min(s, pool.shape[ax] - 1)      # clamped, as the reference's
    at[ax] = slice(start, start + 1)
    out = pool.clone()
    out[tuple(at)] = one.to(pool.dtype)
    return out
