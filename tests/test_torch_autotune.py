"""The autotuned path, port vs reference, on the CPU.

* ``generate_candidates`` equals the reference's candidate for candidate
  (path, order, cost, flops, fused, block; backends mapped through
  ``REFERENCE_BACKENDS``), at the tests' small sizes and at nell-2's
  dimensions, whose lists ``chip_smoke.py`` tunes over;
* the cache: ``spec_signature``, ``bucket_nnz_levels`` and the hashed key
  layout equal the reference's; the round trip, the version guard and a
  corrupt entry counted as a miss;
* ``tune`` / ``plan(autotune=True)``: a fused winner persists and
  replays, and a second call is a cache hit with 0 executions;
* ``enumerate_loop_nests``, ``brute_force_optimal`` and
  ``best_partial_fusion`` equal the reference's.

The port measures CPU tensors with the host clock here; its timings are
never compared with the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune import cache as jcache  # noqa: E402
from repro.autotune import candidates as jcand  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import enumerate as jenum  # noqa: E402
from repro.core import partial_fusion as jpf  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro_torch.analysis.diagnostics import REFERENCE_BACKENDS  # noqa: E402
from repro_torch.autotune import (CACHE_VERSION, PlanCache,  # noqa: E402
                                  TunerConfig, cache_key,
                                  default_backends, device_kind,
                                  generate_candidates, tune)
from repro_torch.autotune import cache as tcache  # noqa: E402
from repro_torch.autotune import tuner as tuner_mod  # noqa: E402
from repro_torch.core import cost as tcost  # noqa: E402
from repro_torch.core import enumerate as tenum  # noqa: E402
from repro_torch.core import partial_fusion as tpf  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.core.executor import CSFArrays, execute_plan  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402

SPECS = [("mttkrp", (6, 7, 8, 4)), ("ttmc3", (6, 7, 8, 4, 3)),
         ("ttmc4", (4, 5, 3, 4, 3, 2, 2)), ("tttp3", (6, 7, 8, 4)),
         ("sddmm", (9, 7, 5)), ("tttc6", (4, 3))]
NELL2 = {"mttkrp": (12092, 9184, 28818, 64),
         "ttmc3": (12092, 9184, 28818, 16, 16)}
NELL2_LEVELS = {0: 1, 1: 714, 2: 4634391, 3: 16000000}


def _pair(builder, args):
    return getattr(JS, builder)(*args), getattr(TS, builder)(*args)


def _rows(cands, mapped=False):
    return [(str([str(t) for t in c.path]), c.order, c.cost, c.flops,
             REFERENCE_BACKENDS[c.backend] if mapped else c.backend,
             c.fused, c.block) for c in cands]


def _factors(spec, seed=0):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(np.float32)
        for t in spec.inputs if not t.is_sparse}


def _mttkrp_case():
    spec = TS.mttkrp(16, 12, 10, 4)
    csf = build_csf(random_sparse((16, 12, 10), 0.1, seed=3))
    return spec, csf, CSFArrays.from_csf(csf, device="cpu")


# --------------------------------------------------------------------- #
# candidates
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("blocks", [None, (8, 16)])
@pytest.mark.parametrize("builder,args", SPECS, ids=[s[0] for s in SPECS])
def test_generate_candidates_equal_reference(builder, args, blocks):
    jspec, tspec = _pair(builder, args)
    want = jcand.generate_candidates(
        jspec, max_candidates=6, blocks=blocks,
        backends=("xla", "pallas", "pallas-gpu"))
    got = generate_candidates(tspec, max_candidates=6, blocks=blocks,
                              backends=("torch", "cuda", "cuda-splitk"))
    assert _rows(got) == _rows(want, mapped=True)
    assert any(c.fused for c in got) == any(c.fused for c in want)


@pytest.mark.parametrize("name", sorted(NELL2))
def test_nell2_candidates_equal_reference(name):
    """The lists ``chip_smoke.py`` tunes over (blocks (8,), every
    schedule the model keeps) are the reference's."""
    jspec, tspec = _pair(name, NELL2[name])
    want = jcand.generate_candidates(jspec, nnz_levels=NELL2_LEVELS,
                                     backends=("xla", "pallas",
                                               "pallas-gpu"),
                                     blocks=(8,))
    got = generate_candidates(tspec, nnz_levels=NELL2_LEVELS,
                              backends=("torch", "cuda", "cuda-splitk"),
                              blocks=(8,))
    assert _rows(got) == _rows(want, mapped=True)


def test_candidate_blocks_are_validated_and_default():
    spec = TS.mttkrp(6, 7, 8, 4)
    with pytest.raises(ValueError, match="multiples of 8"):
        generate_candidates(spec, backends=("cuda",), blocks=(12,))
    blocks = {c.block for c in generate_candidates(
        spec, backends=("torch", "cuda"))}
    assert blocks == {0, 128}


# --------------------------------------------------------------------- #
# the plan cache
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("builder,args", SPECS, ids=[s[0] for s in SPECS])
def test_cache_key_layout_equals_reference(builder, args):
    jspec, tspec = _pair(builder, args)
    levels = {0: 1, 1: 100, 2: 1000, 3: 0}
    assert tcache.spec_signature(tspec) == jcache.spec_signature(jspec)
    assert tcache.bucket_nnz_levels(levels) == \
        jcache.bucket_nnz_levels(levels)
    for kw in ({}, {"blocks": (8, 16)},
               {"mesh": {"mesh_shape": {"data": 4}, "shard": 1}}):
        assert cache_key(tspec, levels, "gpu:x", backends=("cuda",),
                         **kw) == \
            jcache.cache_key(jspec, levels, "gpu:x", backends=("cuda",),
                             **kw)
    assert tcache.bucketed_cache_key(tspec, levels, "gpu:x",
                                     backends=("cuda",)) == \
        jcache.bucketed_cache_key(jspec, levels, "gpu:x",
                                  backends=("cuda",))
    assert CACHE_VERSION == jcache.CACHE_VERSION == 7


def test_cache_round_trip_version_guard_and_corrupt_entry(tmp_path):
    cache = PlanCache(str(tmp_path))
    p = plan(TS.mttkrp(8, 6, 5, 3))
    fused = dataclasses.replace(p, backend="cuda", fused=True, block=16)
    path = cache.put("k", fused, meta={"best_seconds": 1.0})
    assert cache.get("k") == fused and cache.get("k").fused
    assert cache.meta("k") == {"best_seconds": 1.0}
    assert cache.get("missing") is None
    with open(path) as f:
        doc = json.load(f)
    doc["cache_version"] = 6              # a stale but parseable entry
    with open(path, "w") as f:
        json.dump(doc, f)
    assert cache.get("k") is None
    with open(path, "w") as f:
        f.write("{not json")
    assert cache.get("k") is None and cache.meta("k") is None
    assert not cache.annotate("k", note=1)


def test_corrupt_entry_is_a_miss_and_is_overwritten(tmp_path):
    spec, csf, arrays = _mttkrp_case()
    cfg = TunerConfig(max_paths=2, max_candidates=1, orders_per_path=1,
                      repeats=2)
    first, s1 = tune(spec, csf=arrays, cache_dir=str(tmp_path), tuner=cfg)
    (entry,) = tmp_path.glob("plan-*.json")
    entry.write_text("garbage")
    again, s2 = tune(spec, csf=arrays, cache_dir=str(tmp_path), tuner=cfg)
    assert not s2.cache_hit and s2.executions > 0
    assert again == first
    _, s3 = tune(spec, csf=arrays, cache_dir=str(tmp_path), tuner=cfg)
    assert s3.cache_hit and s3.executions == 0


def test_device_kind_and_default_backends(monkeypatch):
    assert device_kind("cpu") == "cpu:cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_backends() == ("torch",)
    assert device_kind() == "cpu:cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_backends() == ("torch", "cuda", "cuda-splitk")


# --------------------------------------------------------------------- #
# tune / plan(autotune=True)
# --------------------------------------------------------------------- #
def test_fused_winner_persists_and_replays(tmp_path, monkeypatch):
    """Over the ``cuda`` and ``cuda-splitk`` axes with the fused axis
    expanded, let the fused candidate win (the measurements are taken,
    then the fused ones ranked first, as on a card where the chain is
    faster); the winner persists, a second ``plan(autotune=True)`` is a
    cache hit with 0 executions, and the plan replays through the chain
    lowering to the ``torch`` engine's result."""
    spec, csf, arrays = _mttkrp_case()
    factors = _factors(spec)
    real = tuner_mod.measure_candidates

    def fused_first(*args, **kwargs):
        return sorted(real(*args, **kwargs),
                      key=lambda m: (not m.candidate.fused, m.seconds))

    monkeypatch.setattr(tuner_mod, "measure_candidates", fused_first)
    cfg = TunerConfig(max_paths=2, max_candidates=1, orders_per_path=1,
                      repeats=2, prune_ratio=0.0, blocks=(8,),
                      backends=("torch", "cuda", "cuda-splitk"))
    p = plan(spec, nnz_levels=csf.nnz_levels(), autotune=True, csf=arrays,
             factors=factors, cache_dir=str(tmp_path), tuner=cfg)
    assert p.fused and p.block == 8 and p.backend in ("cuda", "cuda-splitk")
    assert p.stats.candidates_timed == 5       # torch + 2 x (staged, fused)
    assert p.stats.executions == 5 * (cfg.warmup + cfg.repeats)
    assert len(p.stats.measurements) == 5
    monkeypatch.undo()

    again = plan(spec, nnz_levels=csf.nnz_levels(), autotune=True,
                 csf=arrays, factors=factors, cache_dir=str(tmp_path),
                 tuner=cfg)
    assert again.stats.cache_hit and again.stats.executions == 0
    assert again == p and again.fused
    (entry,) = tmp_path.glob("plan-*.json")
    doc = json.loads(entry.read_text())
    assert doc["plan"]["fused"] is True
    assert doc["meta"]["device"] == "cpu:cpu"
    want = execute_plan(p, arrays, factors, backend="torch")
    got = execute_plan(again, arrays, factors)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_tune_counts_and_ranks_on_the_cpu():
    spec, csf, arrays = _mttkrp_case()
    cfg = TunerConfig(max_paths=2, max_candidates=2, orders_per_path=1,
                      warmup=1, repeats=2, prune_ratio=0.0)
    tuned, stats = tune(spec, csf=arrays, tuner=cfg)
    assert not stats.cache_hit
    assert stats.candidates_generated == stats.candidates_timed == 2
    assert stats.executions == 2 * 3
    secs = [m.seconds for m in stats.measurements]
    assert secs == sorted(secs) and stats.best_seconds == secs[0]
    assert tuned.backend == "torch" and tuned.block is None


def test_tune_on_a_host_tensor_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, csf, _ = _mttkrp_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune(spec, csf=csf, tuner=TunerConfig(max_candidates=1))


# --------------------------------------------------------------------- #
# enumeration and partial fusion
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("builder,args", SPECS[:4],
                         ids=[s[0] for s in SPECS[:4]])
def test_enumeration_and_partial_fusion_equal_reference(builder, args):
    jspec, tspec = _pair(builder, args)
    want = [([str(t) for t in p], o)
            for p, o in jenum.enumerate_loop_nests(jspec, max_paths=4)]
    got = [([str(t) for t in p], o)
           for p, o in tenum.enumerate_loop_nests(tspec, max_paths=4)]
    assert got == want and got
    jpaths = {str([str(t) for t in p]): p
              for p, _ in jenum.enumerate_loop_nests(jspec, max_paths=4)}
    for tpath, order in {str([str(t) for t in p]): (p, o) for p, o in
                         tenum.enumerate_loop_nests(tspec,
                                                    max_paths=4)}.values():
        jpath = jpaths[str([str(t) for t in tpath])]
        for jc, tc in ((jcost.ConstrainedBlas(bound=2),
                        tcost.ConstrainedBlas(bound=2)),
                       (jcost.MaxBufferSize(), tcost.MaxBufferSize())):
            assert tenum.brute_force_optimal(
                tpath, tc, tspec.dims, tspec.sparse_indices) == \
                jenum.brute_force_optimal(jpath, jc, jspec.dims,
                                          jspec.sparse_indices)
        for bound in (None, 1):
            try:
                want_pf = jpf.best_partial_fusion(
                    jpath, order, jspec.dims, jspec.sparse_indices,
                    buffer_dim_bound=bound)
            except ValueError:
                with pytest.raises(ValueError):
                    tpf.best_partial_fusion(tpath, order, tspec.dims,
                                            tspec.sparse_indices,
                                            buffer_dim_bound=bound)
                continue
            assert tpf.best_partial_fusion(
                tpath, order, tspec.dims, tspec.sparse_indices,
                buffer_dim_bound=bound) == want_pf
        for barriers in tpf.enumerate_barrier_choices(len(tpath)):
            assert tpf.partial_fusion_metrics(
                tpath, order, barriers, tspec.dims,
                tspec.sparse_indices) == jpf.partial_fusion_metrics(
                jpath, order, barriers, jspec.dims, jspec.sparse_indices)


@pytest.mark.parametrize("modname", ["repro_torch.autotune.cache",
                                     "repro_torch.autotune.tuner",
                                     "repro_torch.core.planner"])
def test_docstring_examples_run(modname):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(modname),
                          optionflags=doctest.ELLIPSIS
                          | doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0
