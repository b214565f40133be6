"""Disk-backed plan cache.

The JAX package's ``src/repro/autotune/cache.py``: the same key layout,
the same ``CACHE_VERSION`` and the same entry format, so the two
packages agree on what a key covers; only the device kind names this
package's devices (``gpu:<card name>`` or ``cpu:cpu``).

Plans depend only on the *fixed* sparsity pattern (paper §1), never on
values, so a tuned schedule is reusable across process restarts and across
tensors sharing a pattern.  The key is a content hash of

  (spec signature, CSF nnz-level profile, device kind, backend axis,
   mesh/shard context, profile-quantization scheme, CACHE_VERSION)

- spec signature: canonical kernel string incl. names, dims, sparse marker;
- nnz-level profile: {p: nnz^(I1..Ip)} — the exact quantity every cost
  model consumes, so two patterns with equal profiles are planning-
  equivalent by construction (values never enter);
- device kind: platform + device model, since the empirically best nest is
  hardware-specific;
- mesh/shard context: mesh shape + partitioned axes + shard index for a
  distributed shard-local search (None for single-device), so a sharded
  pattern never reuses a single-device winner (DESIGN.md §7);
- profile-quantization scheme: ``"exact"`` for the classic per-pattern
  key; a bucketing scheme name (``"log2"``) for the serving-stream key
  over a quantized profile, so a stream of perturbed patterns shares one
  tuned plan (DESIGN.md §9) without ever colliding with an exact entry;
- CACHE_VERSION: bumped whenever plan semantics / serialization change —
  the invalidation rule for stale entries (old files are simply unmatched,
  never read).

Entries are one JSON file per key, written atomically (tmp + rename) so a
crashed search never leaves a torn plan.  A corrupt/unreadable entry is
treated as a miss and overwritten by the next search.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from collections.abc import Mapping

from repro_torch.core.spec import SpTTNSpec

# v2: plans carry a tuned ``backend`` (PLAN_JSON_VERSION 2).  v3: the key
# gains a ``mesh`` component (mesh shape + partitioned axes + shard index,
# DESIGN.md §7) and plans carry the mesh/shard fields (PLAN_JSON_VERSION
# 3).  v4: the Pallas fusion axis — plans carry ``fused`` (PLAN_JSON_VERSION
# 4) and entries stamp ``cache_version`` so a stale-but-parseable file is
# an explicit miss, not a downstream schema error.  v5: the Pallas block
# axis (DESIGN.md §8) — the key gains a ``blocks`` grid component and
# plans carry the winner's ``block`` (PLAN_JSON_VERSION 5).  v6: the
# serving hot path (DESIGN.md §9) — the key gains a ``profile`` component
# naming how the nnz-level profile was quantized (``"exact"`` for the
# classic per-pattern key, a bucketing scheme name for the shared
# serving-stream key), so a bucketed winner can never shadow an exact one
# and vice versa.  v7: plan JSON grew the memory-budget slicing fields
# (``slice_mode``/``slice_chunks``, PLAN_JSON_VERSION 6, DESIGN.md §10) —
# the budget itself is deliberately NOT a key component (the cache stores
# the unsliced schedule; the slice decision is re-derived per call), but
# v6 entries carry v5 plan docs and must be unmatched, never read.
CACHE_VERSION = 7

# Profile-quantization schemes for serving streams (DESIGN.md §9): a
# stream of near-identical patterns (MoE routing masks, per-user masks)
# has a *different* exact profile per request, so the exact key is a
# guaranteed cold miss.  Bucketing quantizes each level count before
# keying, collapsing the stream onto one tuned plan.
BUCKET_SCHEMES = ("log2",)


def bucket_nnz_levels(nnz_levels: Mapping[int, int],
                      scheme: str = "log2") -> dict[int, int]:
    """Quantize an nnz-level profile for a bucketed cache key.

    ``log2`` rounds each level count to the nearest power of two, so two
    profiles land in the same bucket iff every level agrees within a
    factor of ~sqrt(2) of a common power of two — and therefore any two
    same-bucket profiles differ by at most 2x per level, which bounds
    how far a reused plan's FLOP estimate can drift (the tuner's
    bucketed-reuse guard leans on this).

    >>> bucket_nnz_levels({0: 1, 1: 100, 2: 1000, 3: 0})
    {0: 1, 1: 128, 2: 1024, 3: 0}
    >>> bucket_nnz_levels({1: 100}) == bucket_nnz_levels({1: 170})
    True
    >>> bucket_nnz_levels({1: 100}) == bucket_nnz_levels({1: 200})
    False
    """
    if scheme not in BUCKET_SCHEMES:
        raise ValueError(f"unknown bucketing scheme {scheme!r}; expected "
                         f"one of {BUCKET_SCHEMES}")
    out = {}
    for p, n in nnz_levels.items():
        n = int(n)
        out[int(p)] = 0 if n <= 0 else 1 << max(0, round(math.log2(n)))
    return out


def spec_signature(spec: SpTTNSpec) -> str:
    """Canonical kernel signature: operands (with sparse markers) + dims."""
    ins = ",".join(
        f"{t.name}{'*' if t.is_sparse else ''}({','.join(t.indices)})"
        for t in spec.inputs)
    out = f"{spec.output.name}({','.join(spec.output.indices)})"
    dims = ",".join(f"{k}={spec.dims[k]}" for k in sorted(spec.dims))
    return f"{ins}->{out}|{dims}"


def device_kind(device=None) -> str:
    """``"gpu:<card name>"`` where the tuner measures on the CUDA card,
    ``"cpu:cpu"`` where it measures on the CPU (``device`` is where the
    measured operand lives; ``None`` means the card where there is one)."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return "cpu:cpu"


def cache_key(spec: SpTTNSpec,
              nnz_levels: Mapping[int, int],
              device: str | None = None,
              backends: tuple[str, ...] = ("torch",),
              mesh: Mapping | None = None,
              blocks: tuple[int, ...] | None = None,
              profile: str = "exact") -> str:
    """``backends`` is the tuner's engine search axis: a plan tuned under
    a forced/narrower axis (e.g. ``("cuda",)``) must never be served to
    a search over a different axis, so the axis is part of the key.

    ``mesh`` is the distributed shard context (DESIGN.md §7): any JSON-able
    mapping naming the mesh shape, the mode→axis partitioning, and the
    shard — e.g. the output of the JAX package's
    ``repro.distributed.spttn_dist.shard_mesh_key``.  ``None`` means
    single-device.  Because the component is part of the hashed document, a
    sharded pattern can never be served a single-device winner (or a winner
    tuned for a different mesh axis), even when the local nnz profile
    happens to coincide.

    ``blocks`` is the code generator's block-size grid swept by the search
    (DESIGN.md §8) — the same narrowing rule as ``backends``: a winner
    found over one grid must never be served to a search over another.
    ``None`` (the default single-point grid) hashes distinctly from any
    explicit grid.

    ``profile`` names how ``nnz_levels`` was quantized (DESIGN.md §9):
    ``"exact"`` is the classic per-pattern key; a bucketing scheme name
    (see :func:`bucket_nnz_levels`) marks a serving-stream key whose
    profile has already been bucketed — the caller passes the *bucketed*
    levels.  Keeping the scheme in the hashed document means an exact
    winner and a bucketed winner can never collide, even when the
    bucketed profile happens to equal some exact one.

    >>> from repro_torch.core import spec as S
    >>> spec = S.mttkrp(8, 6, 5, 4)
    >>> levels = {0: 1, 1: 8, 2: 20, 3: 40}
    >>> single = cache_key(spec, levels, "cpu:x")
    >>> shard0 = cache_key(spec, levels, "cpu:x",
    ...                    mesh={"mesh_shape": {"data": 4},
    ...                          "mode_axis": {"0": "data"}, "shard": 0})
    >>> single == shard0
    False
    >>> single == cache_key(spec, levels, "cpu:x", blocks=(128, 256))
    False
    >>> bucketed = cache_key(spec, bucket_nnz_levels(levels), "cpu:x",
    ...                      profile="log2")
    >>> single == bucketed
    False
    >>> len(single)
    64
    """
    doc = {
        "version": CACHE_VERSION,
        "spec": spec_signature(spec),
        "nnz_levels": {str(k): int(v)
                       for k, v in sorted(nnz_levels.items())},
        "device": device if device is not None else device_kind(),
        "backends": list(backends),
        "mesh": None if mesh is None else dict(mesh),
        "blocks": None if blocks is None else [int(b) for b in blocks],
        "profile": str(profile),
    }
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def bucketed_cache_key(spec: SpTTNSpec,
                       nnz_levels: Mapping[int, int],
                       device: str | None = None,
                       backends: tuple[str, ...] = ("torch",),
                       mesh: Mapping | None = None,
                       blocks: tuple[int, ...] | None = None,
                       scheme: str = "log2") -> str:
    """The serving-stream key (DESIGN.md §9): :func:`cache_key` over the
    *bucketed* profile, with the scheme recorded in the hashed document.
    Two perturbed patterns whose per-level counts round to the same
    buckets share this key — and therefore one tuned plan.

    >>> from repro_torch.core import spec as S
    >>> spec = S.mttkrp(8, 6, 5, 4)
    >>> a = bucketed_cache_key(spec, {0: 1, 1: 8, 2: 20, 3: 40}, "cpu:x")
    >>> b = bucketed_cache_key(spec, {0: 1, 1: 8, 2: 22, 3: 37}, "cpu:x")
    >>> a == b
    True
    """
    return cache_key(spec, bucket_nnz_levels(nnz_levels, scheme), device,
                     backends=backends, mesh=mesh, blocks=blocks,
                     profile=scheme)


@dataclasses.dataclass
class PlanCache:
    """One JSON file per plan under ``cache_dir``.

    >>> import tempfile
    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> cache = PlanCache(tempfile.mkdtemp())
    >>> p = plan(S.mttkrp(8, 6, 5, 4))
    >>> path = cache.put("some-key", p)
    >>> cache.get("some-key") == p
    True
    >>> cache.get("missing") is None
    True
    """

    cache_dir: str

    def __post_init__(self):
        os.makedirs(self.cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"plan-{key}.json")

    def get(self, key: str):
        """Returns the cached SpTTNPlan or None (miss / corrupt entry).

        The entry's ``cache_version`` is checked explicitly before the
        plan document is deserialized: a stale-but-parseable file (e.g. a
        v3 entry surviving at a colliding name, or a hand-restored
        backup) is a clean miss rather than a downstream schema error.
        """
        from repro_torch.core.executor import plan_from_dict
        try:
            with open(self._path(key)) as f:
                doc = json.load(f)
            if doc.get("cache_version") != CACHE_VERSION:
                return None
            return plan_from_dict(doc["plan"])
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # any malformed entry — invalid JSON, wrong shape, foreign
            # writer — is a miss; the next search overwrites it
            return None

    def annotate(self, key: str, **fields) -> bool:
        """Merge ``fields`` into an existing entry's ``meta`` (atomic
        rewrite).  Returns False on a miss, a corrupt entry, or a stale
        ``cache_version`` — annotation never resurrects or creates
        entries, it only enriches live ones (e.g. the distributed router
        recording which execution mode a shard's winner was routed
        through, ``dist_mode``, in the JAX package).

        >>> import tempfile
        >>> from repro_torch.core import spec as S
        >>> from repro_torch.core.planner import plan
        >>> cache = PlanCache(tempfile.mkdtemp())
        >>> _ = cache.put("k", plan(S.mttkrp(8, 6, 5, 4)),
        ...               meta={"best_us": 1.0})
        >>> cache.annotate("k", dist_mode="collective-pallas")
        True
        >>> cache.meta("k")["dist_mode"]
        'collective-pallas'
        >>> cache.meta("k")["best_us"]
        1.0
        >>> cache.annotate("missing", dist_mode="replay")
        False
        """
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("cache_version") != CACHE_VERSION:
                return False
        except (OSError, ValueError):
            return False
        meta = dict(doc.get("meta") or {})
        meta.update(fields)
        doc["meta"] = meta
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1)
            os.replace(tmp, path)   # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return True

    def meta(self, key: str) -> dict | None:
        """The entry's meta mapping (timings, annotations), or None on a
        miss/corrupt/stale entry — same miss semantics as :meth:`get`."""
        try:
            with open(self._path(key)) as f:
                doc = json.load(f)
            if doc.get("cache_version") != CACHE_VERSION:
                return None
            return dict(doc.get("meta") or {})
        except (OSError, ValueError):
            return None

    def put(self, key: str, plan, meta: Mapping | None = None) -> str:
        from repro_torch.core.executor import plan_to_dict
        doc = {"cache_version": CACHE_VERSION,
               "plan": plan_to_dict(plan), "meta": dict(meta or {})}
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1)
            os.replace(tmp, path)   # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path
