"""Memory-budgeted sliced execution in the port, held to the reference.

``repro_torch.core.slicing`` against ``repro.core.slicing`` on the same
numpy inputs:

* the pricing (``plan_peak_bytes``, ``choose_slicing``,
  ``stamp_plan_slicing``, ``plan_decision``, ``chunk_footprints``) gives
  the reference's numbers and decisions, and raises where it raises, on
  the paper kernels, on Hypothesis-drawn dims, profiles and budgets, and
  at nell-2's dims with the level profile of the card's 16 M tensor;
* ``sliced_execute`` / ``execute_plan(memory_budget=)`` on the port's
  ``torch``, ``cuda`` and ``cuda-splitk`` engines (``device="cpu"``: each
  kernel wrapper runs its plain version) match the reference's sliced
  replay on ``xla`` and on ``pallas`` / ``pallas-gpu`` in interpret mode,
  output and contracted slices, tails included.  Tolerance: float32
  ``|port - ref| <= 1e-5 * max(1, max|ref|)``, float64 ``1e-12``
  relative;
* the edges: zero nonzeros, shards sliced within, one executor per
  chunk width, bad modes rejected with the reference's SPTTN codes, a
  stamped plan replayed from plan JSON, a budgeted ``tune`` whose disk
  entry stays unsliced, and the ``planner.autotune`` helper.
"""
import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import slicing as jslicing  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro.sparse.coo import from_coords as j_from_coords  # noqa: E402
from repro_torch.autotune import TunerConfig, tune  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import slicing as tslicing  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.sparse import build_csf  # noqa: E402
from repro_torch.sparse.coo import from_coords  # noqa: E402

# the paper kernels, at sizes whose dense modes chunk with a tail
PAPER = {"mttkrp": ("mttkrp", (30, 14, 10, 20)),
         "ttmc3": ("ttmc3", (24, 12, 10, 14, 7)),
         "tttp3": ("tttp3", (24, 12, 10, 19)),
         "tttc6": ("tttc6", (4, 3))}
# (port engine, reference engine)
ENGINES = [("torch", "xla"), ("cuda", "pallas"),
           ("cuda-splitk", "pallas-gpu")]
NELL2 = (12092, 9184, 28818)
NELL2_LEVELS = {0: 1, 1: 714, 2: 4_634_391, 3: 16_000_000}
GIB = 1 << 30


def _close(port, ref, rel=1e-5):
    port = np.asarray(port.cpu() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, rel * scale)


def _factors(spec, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(dtype)
        for t in spec.inputs if not t.is_sparse}


def _pair(jc, dtype=None):
    """The reference's CSF and the port's, built from the same COO."""
    coo = jc.coo
    values = coo.values if dtype is None else coo.values.astype(dtype)
    if dtype is not None:
        jc = j_build_csf(j_from_coords(coo.coords, values, coo.shape))
    return jc, build_csf(from_coords(coo.coords, values, coo.shape))


@functools.cache
def _case(name, density=0.08, seed=3):
    """Both packages' spec, CSF and the reference's plan, which the
    port replays through plan JSON (the same schedule in both)."""
    builder, args = PAPER[name]
    jspec = getattr(JS, builder)(*args)
    shape = tuple(jspec.dims[i] for i in jspec.sparse_indices)
    jc, tc = _pair(j_build_csf(j_random_sparse(shape, density, seed=seed)))
    jp = jplanner.plan(jspec, nnz_levels=jc.nnz_levels())
    return jspec, getattr(TS, builder)(*args), jc, tc, jp


def _port_plan(jp):
    return tex.plan_from_json(jex.plan_to_json(jp))


def _decision(mod, *args, **kw):
    """A decision as a tuple, or the exception's type name."""
    try:
        return dataclasses.astuple(mod.choose_slicing(*args, **kw))
    except ValueError as e:
        return type(e).__name__


# --------------------------------------------------------------------- #
# the pricing, number for number
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(PAPER))
def test_pricing_equals_reference(name):
    jspec, tspec, jc, tc, jp = _case(name)
    tp = _port_plan(jp)
    levels = jc.nnz_levels()
    assert tc.nnz_levels() == levels
    assert tslicing.nnz_levels_of(tex.CSFArrays.from_csf(tc, "cpu")) == \
        jslicing.nnz_levels_of(jex.CSFArrays.from_csf(jc))
    for lv in (levels, None):
        peak = tslicing.plan_peak_bytes(tspec, tp.path, tp.order, lv)
        assert peak == jslicing.plan_peak_bytes(jspec, jp.path, jp.order,
                                                lv)
        for budget in (peak + 1, peak, peak // 2, peak // 3, peak // 7,
                       64, 0, -5):
            want = _decision(jslicing, jspec, jp.path, jp.order, lv,
                             budget)
            assert _decision(tslicing, tspec, tp.path, tp.order, lv,
                             budget) == want
            if isinstance(want, str):
                continue
            js = jslicing.stamp_plan_slicing(jp, lv, budget)
            ts = tslicing.stamp_plan_slicing(tp, lv, budget)
            assert (ts.slice_mode, ts.slice_chunks) == \
                (js.slice_mode, js.slice_chunks)
            assert (ts is tp) == (js is jp)
            assert dataclasses.astuple(tslicing.plan_decision(ts, lv)) == \
                dataclasses.astuple(jslicing.plan_decision(js, lv))
            fps = tslicing.chunk_footprints(ts, lv)
            assert fps == jslicing.chunk_footprints(js, lv)
            assert len(fps) == ts.slice_chunks and max(fps) <= budget
    with pytest.raises(tslicing.MemoryBudgetError, match="shard"):
        tslicing.choose_slicing(tspec, tp.path, tp.order, levels, 64)
    with pytest.raises(ValueError, match="positive"):
        tslicing.choose_slicing(tspec, tp.path, tp.order, levels, 0)
    assert tslicing.stamp_plan_slicing(tp, levels, None) is tp


@settings(max_examples=30, deadline=None, derandomize=True)
@given(kind=st.sampled_from(["mttkrp", "tttp3", "ttmc3"]),
       dims=st.tuples(*[st.integers(2, 40)] * 3),
       rank=st.integers(1, 70),
       fill=st.tuples(*[st.floats(0.0, 1.0)] * 3),
       frac=st.floats(0.01, 1.2),
       itemsize=st.sampled_from([4, 8]))
def test_decisions_equal_reference_on_drawn_inputs(kind, dims, rank, fill,
                                                   frac, itemsize):
    args = (*dims, rank) if kind != "ttmc3" else (*dims, rank,
                                                  max(1, rank // 3))
    jspec, tspec = getattr(JS, kind)(*args), getattr(TS, kind)(*args)
    jp = jplanner.plan(jspec)
    tp = _port_plan(jp)
    # a monotone profile: level p holds between level p-1's fibers and
    # all of its prefix space
    levels, prev, space = {0: 1}, 1, 1
    for p, (ind, f) in enumerate(zip(jspec.sparse_indices, fill), 1):
        space *= jspec.dims[ind]
        prev = prev + int(f * (space - prev))
        levels[p] = prev
    peak = jslicing.plan_peak_bytes(jspec, jp.path, jp.order, levels,
                                    itemsize)
    assert tslicing.plan_peak_bytes(tspec, tp.path, tp.order, levels,
                                    itemsize) == peak
    budget = int(frac * peak)
    want = _decision(jslicing, jspec, jp.path, jp.order, levels, budget,
                     itemsize=itemsize)
    assert _decision(tslicing, tspec, tp.path, tp.order, levels, budget,
                     itemsize=itemsize) == want
    if not isinstance(want, str):
        ts = tslicing.stamp_plan_slicing(tp, levels, budget, itemsize)
        js = jslicing.stamp_plan_slicing(jp, levels, budget, itemsize)
        fps = tslicing.chunk_footprints(ts, levels, itemsize)
        assert fps == jslicing.chunk_footprints(js, levels, itemsize)
        assert max(fps) <= budget


@pytest.mark.parametrize("name,args,budget,want", [
    ("mttkrp", (*NELL2, 64), GIB,
     ("a", 2, "output", 1_263_228_160, 663_614_080)),
    ("tttp3", (*NELL2, 64), 2 * GIB,
     ("r", 3, "contracted", 5_423_228_160, 1_948_234_680)),
    ("ttmc3", (*NELL2, 16, 16), GIB,
     (None, 1, "none", 375_415_360, 375_415_360)),
], ids=["mttkrp", "tttp3", "ttmc3"])
def test_nell2_decisions(name, args, budget, want):
    """The decisions the card's smoke run checks, priced at nell-2's
    dims and the 16 M tensor's profile (no execution)."""
    jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jp = jplanner.plan(jspec, nnz_levels=NELL2_LEVELS)
    tp = tplanner.plan(tspec, nnz_levels=NELL2_LEVELS)
    pj = _port_plan(jp)
    assert (tp.path, tp.order) == (pj.path, pj.order)
    got = tslicing.choose_slicing(tspec, tp.path, tp.order, NELL2_LEVELS,
                                  budget)
    assert dataclasses.astuple(got) == want
    assert dataclasses.astuple(jslicing.choose_slicing(
        jspec, jp.path, jp.order, NELL2_LEVELS, budget)) == want
    stamped = tplanner.plan(tspec, nnz_levels=NELL2_LEVELS,
                            memory_budget=budget)
    assert (stamped.slice_mode, stamped.slice_chunks) == want[:2]
    ref = jplanner.plan(jspec, nnz_levels=NELL2_LEVELS,
                        memory_budget=budget)
    assert (ref.slice_mode, ref.slice_chunks) == want[:2]


# --------------------------------------------------------------------- #
# the sliced replay, against the reference's
# --------------------------------------------------------------------- #
@functools.cache
def _reference_sliced(name, jb, budget_div, dtype_name="float32"):
    jspec, _, jc, _, jp = _case(name)
    dtype = np.dtype(dtype_name)
    jc, _ = _pair(jc, None if dtype == np.float32 else dtype)
    factors = _factors(jspec, dtype=dtype)
    budget = jslicing.plan_peak_bytes(jspec, jp.path, jp.order,
                                      jc.nnz_levels()) // budget_div
    plan = jp if jb == "xla" else dataclasses.replace(jp, backend=jb,
                                                      block=8)
    kw = {} if jb == "xla" else {"interpret": True}
    with jax.enable_x64(dtype == np.float64):
        out = np.asarray(jex.execute_plan(plan, jex.CSFArrays.from_csf(jc),
                                          factors, memory_budget=budget,
                                          **kw))
        unsliced = np.asarray(jex.execute_plan(
            plan, jex.CSFArrays.from_csf(jc), factors, **kw))
    return out, unsliced, budget


@pytest.mark.parametrize("tb,jb", ENGINES, ids=[t for t, _ in ENGINES])
@pytest.mark.parametrize("name,kind", [("mttkrp", "output"),
                                       ("ttmc3", "output"),
                                       ("tttp3", "contracted")])
def test_sliced_replay_matches_reference(name, kind, tb, jb):
    jspec, tspec, jc, tc, jp = _case(name)
    ref, ref_unsliced, budget = _reference_sliced(name, jb, 2)
    tp = _port_plan(jp if jb == "xla"
                    else dataclasses.replace(jp, backend=jb, block=8))
    assert tp.backend == tb
    levels = tc.nnz_levels()
    stamped = tslicing.stamp_plan_slicing(tp, levels, budget)
    assert tslicing.plan_decision(stamped, levels).kind == kind
    assert stamped.slice_chunks > 1
    assert tspec.dims[stamped.slice_mode] % stamped.slice_chunks  # a tail
    factors = _factors(tspec)
    out = tex.execute_plan(tp, tc, factors, memory_budget=budget,
                           device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float32
    _close(out, ref)
    _close(out, ref_unsliced)
    direct = tslicing.sliced_execute(stamped,
                                     tex.CSFArrays.from_csf(tc, "cpu"),
                                     factors)
    assert torch.equal(direct, out)


@pytest.mark.parametrize("tb,jb", ENGINES[1:], ids=[t for t, _ in ENGINES[1:]])
@pytest.mark.parametrize("name", ["mttkrp", "tttp3"])
def test_sliced_replay_float64_at_1e12(name, tb, jb):
    jspec, tspec, jc, tc, jp = _case(name)
    ref, _, budget = _reference_sliced(name, jb, 3, "float64")
    _, tc64 = _pair(jc, np.float64)
    tp = _port_plan(dataclasses.replace(jp, backend=jb, block=8))
    out = tex.execute_plan(tp, tc64, _factors(tspec, dtype=np.float64),
                           memory_budget=budget, device="cpu")
    assert out.dtype == torch.float64
    _close(out, ref, rel=1e-12)


def test_zero_nnz_operand_slices_to_zeros():
    spec = TS.mttkrp(16, 8, 6, 12)
    empty = (np.zeros((0, 3), np.int32), np.zeros((0,), np.float32),
             (16, 8, 6))
    csf = build_csf(from_coords(*empty))
    jcsf = j_build_csf(j_from_coords(*empty))
    factors = _factors(spec)
    p = tplanner.plan(spec)
    peak = tslicing.plan_peak_bytes(spec, p.path, p.order, csf.nnz_levels())
    stamped = tslicing.stamp_plan_slicing(p, csf.nnz_levels(), peak // 2)
    assert stamped.slice_chunks > 1
    jstamped = jslicing.stamp_plan_slicing(
        jplanner.plan(JS.mttkrp(16, 8, 6, 12)), jcsf.nnz_levels(),
        peak // 2)
    ref = np.asarray(jslicing.sliced_execute(
        jstamped, jex.CSFArrays.from_csf(jcsf), factors))
    for backend in ("torch", "cuda", "cuda-splitk"):
        out = tslicing.sliced_execute(stamped, csf, factors,
                                      backend=backend, device="cpu")
        assert tuple(out.shape) == ref.shape == (16, 12)
        assert not out.any()


def test_sharded_and_sliced_together():
    jspec, tspec, jc, tc, jp = _case("mttkrp")
    coo = jc.coo
    mask = coo.coords[:, 0] < 15
    parts = [(coo.coords[m], coo.values[m]) for m in (mask, ~mask)]
    parts.append((np.zeros((0, 3), np.int32), np.zeros((0,), np.float32)))
    jshards = [jex.CSFArrays.from_csf(j_build_csf(j_from_coords(
        c, v, coo.shape))) for c, v in parts]
    tshards = [build_csf(from_coords(c, v, coo.shape)) for c, v in parts]
    factors = _factors(tspec)
    budget = jslicing.plan_peak_bytes(jspec, jp.path, jp.order,
                                      jc.nnz_levels()) // 2
    ref = np.asarray(jex.execute_plan(jp, jshards, factors,
                                      memory_budget=budget))
    tp = _port_plan(jp)
    for backend in ("torch", "cuda", "cuda-splitk"):
        out = tex.execute_plan(tp, tshards, factors, backend=backend,
                               memory_budget=budget, device="cpu")
        _close(out, ref)


def test_one_executor_per_chunk_width():
    jspec, tspec, jc, tc, jp = _case("mttkrp")     # a = 20: 7, 7, 6
    factors = _factors(tspec)
    jcache, tcache = {}, {}
    ref = jslicing.sliced_execute(jp, jex.CSFArrays.from_csf(jc), factors,
                                  mode="a", chunks=3, executor_cache=jcache)
    arrays = tex.CSFArrays.from_csf(tc, "cpu")
    out = tslicing.sliced_execute(_port_plan(jp), arrays, factors,
                                  mode="a", chunks=3, executor_cache=tcache)
    assert sorted(tcache) == sorted(jcache) == [6, 7]
    _close(out, np.asarray(ref))
    first = dict(tcache)
    tslicing.sliced_execute(_port_plan(jp), arrays, factors, mode="a",
                            chunks=3, executor_cache=tcache)
    assert all(tcache[w] is first[w] for w in first)   # reused


def test_bad_modes_get_the_reference_codes():
    jspec, tspec, jc, tc, jp = _case("mttkrp")
    factors = _factors(tspec)
    jarr = jex.CSFArrays.from_csf(jc)
    tarr = tex.CSFArrays.from_csf(tc, "cpu")
    tp = _port_plan(jp)
    codes = []
    for kw in ({}, {"mode": "i", "chunks": 2}, {"mode": "q", "chunks": 2}):
        with pytest.raises(ValueError) as jerr:
            jslicing.sliced_execute(jp, jarr, factors, **kw)
        with pytest.raises(ValueError) as terr:
            tslicing.sliced_execute(tp, tarr, factors, **kw)
        # the same message, up to the order a dims mapping lists
        tmsg, jmsg = str(terr.value), str(jerr.value)
        assert tmsg.split(" (")[0] == jmsg.split(" (")[0]
        assert tmsg[-13:] == jmsg[-13:]
        codes.append(tmsg[-11:-1])
    assert codes[1:] == ["SPTTN-E031", "SPTTN-E030"]


def test_stamped_plan_replays_sliced_from_plan_json(monkeypatch):
    jspec, tspec, jc, tc, jp = _case("tttp3")
    levels = jc.nnz_levels()
    budget = jslicing.plan_peak_bytes(jspec, jp.path, jp.order, levels) // 2
    jstamped = jslicing.stamp_plan_slicing(jp, levels, budget)
    assert jstamped.slice_chunks > 1 and jp.slice_chunks == 1
    factors = _factors(tspec)
    ref = np.asarray(jex.execute_plan(jstamped, jex.CSFArrays.from_csf(jc),
                                      factors))
    tstamped = tex.plan_from_json(jex.plan_to_json(jstamped))
    assert (tstamped.slice_mode, tstamped.slice_chunks) == \
        (jstamped.slice_mode, jstamped.slice_chunks)
    calls = []
    real = tslicing.sliced_execute
    monkeypatch.setattr(tslicing, "sliced_execute",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tex.execute_plan(_port_plan(jp), tc, factors, device="cpu")
    assert calls == []                       # unstamped: direct path
    out = tex.execute_plan(tstamped, tc, factors, device="cpu")
    assert calls == [1]                      # stamped: sliced path
    _close(out, ref)


def test_budgeted_tune_caches_one_unsliced_plan(tmp_path):
    jspec, tspec, jc, tc, jp = _case("mttkrp")
    arrays = tex.CSFArrays.from_csf(tc, "cpu")
    levels = tc.nnz_levels()
    fast = TunerConfig(max_paths=2, max_candidates=2, orders_per_path=1,
                       warmup=1, repeats=2)
    tuned0, s0 = tune(tspec, csf=arrays, cache_dir=str(tmp_path),
                      tuner=fast)
    assert not s0.cache_hit and tuned0.slice_chunks == 1
    budget = tslicing.plan_peak_bytes(tspec, tuned0.path, tuned0.order,
                                      levels) // 2
    tuned, s1 = tune(tspec, csf=arrays, cache_dir=str(tmp_path),
                     tuner=fast, memory_budget=budget)
    assert s1.cache_hit and tuned.slice_chunks > 1
    assert (tuned.path, tuned.order) == (tuned0.path, tuned0.order)
    # the reference stamps the same schedule the same way
    jtuned = jex.plan_from_json(tex.plan_to_json(tuned0).replace(
        '"torch"', '"xla"'))
    js = jslicing.stamp_plan_slicing(jtuned, levels, budget)
    assert (tuned.slice_mode, tuned.slice_chunks) == (js.slice_mode,
                                                      js.slice_chunks)
    entries = glob.glob(os.path.join(str(tmp_path), "plan-*.json"))
    assert len(entries) == 1
    with open(entries[0]) as f:
        doc = json.load(f)["plan"]
    assert doc["slice_mode"] is None and doc["slice_chunks"] == 1
    # measured planning stamps too, from the same cache entry
    p = tplanner.plan(tspec, autotune=True, csf=arrays,
                      cache_dir=str(tmp_path), tuner=fast,
                      memory_budget=budget)
    assert p.stats.cache_hit and p.slice_chunks == tuned.slice_chunks
    out = tex.execute_plan(tuned, arrays, _factors(tspec))
    _close(out, np.asarray(tex.execute_plan(tuned0, arrays,
                                            _factors(tspec))))


def test_planner_autotune_helper_ranks_every_candidate():
    jspec, tspec, jc, tc, jp = _case("mttkrp")
    from repro_torch.autotune import generate_candidates
    cands = []
    for c in generate_candidates(tspec, nnz_levels=tc.nnz_levels(),
                                 max_candidates=3):
        if (c.path, c.order) not in cands:
            cands.append((c.path, c.order))
    assert len(cands) > 1
    best, results = tplanner.autotune(
        tspec, tex.CSFArrays.from_csf(tc, "cpu"), _factors(tspec), cands,
        repeats=2)
    assert len(results) == len(cands)
    secs = [r[0] for r in results]
    assert secs == sorted(secs)
    assert best == results[0][1:]
    assert {(p, o) for _, p, o in results} == set(cands)
    # the reference's helper returns the same shape of answer
    jbest, jresults = jplanner.autotune(jspec, jc, _factors(jspec),
                                        [(jp.path, jp.order)], repeats=1)
    assert len(jresults) == 1 and jbest == (jp.path, jp.order)


@pytest.mark.parametrize("modname", ["repro_torch.core.slicing",
                                     "repro_torch.serve.serve_step"])
def test_docstring_examples_run(modname):
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(modname),
                          optionflags=doctest.ELLIPSIS
                          | doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0
