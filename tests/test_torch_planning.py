"""Planning-layer parity: the port's numpy modules against the reference.

The port keeps its own copies of the JAX package's numpy-only modules
(sparse formats, specs, paths, loop nests, cost models, the order DP,
the planner, block layouts, the verifier).  Held here to the reference
on the same seeded inputs: identical tensors, CSF arrays and layouts,
identical plans (path, order, cost, flops, depth), plan documents
written by the reference replaying in the port, and identical
diagnostic codes on illegal plans.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import verify_plan as j_verify  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.kernels import util as jutil  # noqa: E402
from repro.sparse import coo as jcoo  # noqa: E402
from repro.sparse import csf as jcsf  # noqa: E402
from repro_torch.analysis import verify_plan as t_verify  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.kernels import util as tutil  # noqa: E402
from repro_torch.sparse import coo as tcoo  # noqa: E402
from repro_torch.sparse import csf as tcsf  # noqa: E402

# (builder name, args, density): every spec builder of core/spec.py
SPECS = [
    ("mttkrp", (6, 7, 8, 4), 0.3),
    ("ttmc3", (6, 7, 8, 4, 3), 0.3),
    ("ttmc4", (4, 5, 3, 4, 3, 2, 2), 0.3),
    ("tttp3", (6, 7, 8, 4), 0.3),
    ("sddmm", (9, 7, 5), 0.4),
    ("tttc6", (4, 3), 0.02),
]
SPEC_IDS = [s[0] for s in SPECS]


def _tensor_pair(jspec, tspec, density, seed=3):
    shape = tuple(jspec.dims[i] for i in jspec.sparse_indices)
    return (jcsf.build_csf(jcoo.random_sparse(shape, density, seed=seed)),
            tcsf.build_csf(tcoo.random_sparse(shape, density, seed=seed)))


@functools.cache
def _planned(name):
    """Both packages' spec, CSF and plan for one SPECS entry (planning
    tttc6 takes seconds, so each is planned once per session)."""
    args, density = next((a, d) for n, a, d in SPECS if n == name)
    jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jc, tc = _tensor_pair(jspec, tspec, density)
    return (jspec, tspec, jc, tc,
            jplanner.plan(jspec, nnz_levels=jc.nnz_levels()),
            tplanner.plan(tspec, nnz_levels=tc.nnz_levels()))


def _plan_doc(doc):
    """A plan document without its backend (the two packages name their
    engines differently)."""
    return {k: v for k, v in doc.items() if k != "backend"}


@pytest.mark.parametrize("shape,density,dist", [
    ((6, 7, 8), 0.3, "uniform"), ((60, 50, 40), 0.01, "frostt"),
    ((300, 200, 100), 0.005, "frostt"), ((4,) * 6, 0.02, "uniform"),
    ((1, 1, 1), 0.5, "uniform"), ((9, 7), 0.4, "frostt"),
    # the main path's kind: nell-2's shape and skew, at 200 K nonzeros
    ((12092, 9184, 28818), 2e5 / (12092 * 9184 * 28818), "frostt")])
def test_random_sparse_is_bit_identical(shape, density, dist):
    a = jcoo.random_sparse(shape, density, seed=7, distribution=dist)
    b = tcoo.random_sparse(shape, density, seed=7, distribution=dist)
    assert a.shape == b.shape
    assert a.coords.dtype == b.coords.dtype
    assert a.values.dtype == b.values.dtype
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("name,args,density", SPECS, ids=SPEC_IDS)
def test_csf_arrays_and_segments_identical(name, args, density):
    jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jc, tc = _tensor_pair(jspec, tspec, density)
    assert jc.nfib == tc.nfib and jc.nnz_levels() == tc.nnz_levels()
    for p in range(1, jc.order + 1):
        for field in ("coord", "parent", "seg"):
            np.testing.assert_array_equal(getattr(jc, field)[p],
                                          getattr(tc, field)[p])
        np.testing.assert_array_equal(jc.fiber_coords(p), tc.fiber_coords(p))
        for par in range(p):
            np.testing.assert_array_equal(jcsf.level_segments(jc, p, par),
                                          tcsf.level_segments(tc, p, par))
    # the device copy holds the same arrays
    arrays = tex.CSFArrays.from_csf(tc, device="cpu")
    np.testing.assert_array_equal(arrays.values.numpy(), jc.values)
    for (child, par), seg in arrays.seg.items():
        np.testing.assert_array_equal(
            seg.numpy(), jcsf.level_segments(jc, child, par))


def test_build_csf_batch_identical():
    coos = [jcoo.random_sparse((5, 6, 7), d, seed=s)
            for s, d in ((0, 0.2), (1, 0.05), (2, 0.3))]
    tcoos = [tcoo.random_sparse((5, 6, 7), d, seed=s)
             for s, d in ((0, 0.2), (1, 0.05), (2, 0.3))]
    for a, b in zip(jcsf.build_csf_batch(coos), tcsf.build_csf_batch(tcoos)):
        assert a.nfib == b.nfib
        for p in range(1, 4):
            for field in ("coord", "parent", "seg"):
                np.testing.assert_array_equal(getattr(a, field)[p],
                                              getattr(b, field)[p])


@pytest.mark.parametrize("block", [1, 8, 16])
def test_padded_segment_layouts_identical(block):
    rng = np.random.default_rng(block)
    seg = np.sort(rng.integers(0, 9, size=60))
    a = jutil.padded_segment_layout(seg, 11, block)   # two empty tails
    b = tutil.padded_segment_layout(seg, 11, block)
    for lay_a, lay_b in ((a, b), (jutil.pad_segment_layout(a, a.padded_len
                                                           + 3 * block),
                                  tutil.pad_segment_layout(b, b.padded_len
                                                           + 3 * block))):
        assert dataclasses.astuple(lay_a)[4:] == dataclasses.astuple(
            lay_b)[4:]
        for field in ("gather", "mask", "block_seg", "block_first"):
            x, y = getattr(lay_a, field), getattr(lay_b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,args,density", SPECS, ids=SPEC_IDS)
def test_plans_identical(name, args, density):
    jspec, tspec, _, _, jp0, tp0 = _planned(name)
    pairs = [(jp0, tp0)]
    if name != "tttc6":      # the density-agnostic default profile too
        pairs.append((jplanner.plan(jspec), tplanner.plan(tspec)))
    for jp, tp in pairs:
        assert (jp.cost, jp.flops, jp.depth) == (tp.cost, tp.flops, tp.depth)
        assert jp.order == tp.order
        assert [str(t) for t in jp.path] == [str(t) for t in tp.path]
        assert _plan_doc(jex.plan_to_dict(jp)) == \
            _plan_doc(tex.plan_to_dict(tp))
    assert tplanner.cached_plan("ij,jr->ir", {"i": 5, "j": 4, "r": 3}) \
        .depth == jplanner.cached_plan("ij,jr->ir",
                                       {"i": 5, "j": 4, "r": 3}).depth


@pytest.mark.parametrize("jbackend,tbackend", [
    ("xla", "torch"), ("pallas", "cuda"), ("pallas-gpu", "cuda-splitk"),
    ("reference", "reference")])
@pytest.mark.parametrize("name,args,density", SPECS, ids=SPEC_IDS)
def test_reference_plan_json_replays_in_the_port(name, args, density,
                                                 jbackend, tbackend):
    _, _, _, _, jp0, tp0 = _planned(name)
    extra = {"block": 16} if jbackend.startswith("pallas") else {}
    jp = dataclasses.replace(jp0, backend=jbackend, **extra)
    tp = tex.plan_from_json(jex.plan_to_json(jp))
    assert tp == dataclasses.replace(tp0, backend=tbackend, **extra)
    # ... and the port's own documents round-trip exactly
    assert tex.plan_from_json(tex.plan_to_json(tp)) == tp
    assert json.loads(tex.plan_to_json(tp))["version"] == 6


def test_plan_json_version_and_backend_rejections_match():
    jp = jplanner.plan(JS.mttkrp(6, 7, 8, 4))
    doc = jex.plan_to_dict(jp)
    for bad in ({**doc, "version": 5}, {**doc, "backend": "tpu-magic"},
                {**doc, "block": 12}, {**doc, "slice_mode": "i",
                                       "slice_chunks": 2}):
        with pytest.raises(ValueError) as je:
            jex.plan_from_dict(bad)
        with pytest.raises(ValueError) as te:
            tex.plan_from_dict(bad)
        code = str(je.value).rsplit("[", 1)[-1]
        assert str(te.value).endswith(code)


# illegal mutations of a plan: (description, field overrides)
ILLEGAL = [
    ("sparse slice mode", {"slice_mode": "i", "slice_chunks": 4}),
    ("chunks without mode", {"slice_chunks": 3}),
    ("misaligned block", {"block": 12}),
    ("zero block", {"block": 0}),
    ("unknown backend", {"backend": "nope"}),
    ("fused without a chain", {"fused": True}),
    ("order not a permutation", "perm"),
    ("storage order violated", "storage"),
    ("short order", "short"),
]


def _mutate(plan, how):
    if isinstance(how, dict):
        return dataclasses.replace(plan, **how)
    order = list(plan.order)
    if how == "perm":
        order[0] = tuple(order[0][:-1]) + ("zz",)
    elif how == "storage":
        order[-1] = tuple(reversed(order[-1]))
    else:
        order = order[:-1]
    return dataclasses.replace(plan, order=tuple(order))


@pytest.mark.parametrize("how", [h for _, h in ILLEGAL],
                         ids=[d for d, _ in ILLEGAL])
@pytest.mark.parametrize("spec_name,args", [("mttkrp", (6, 7, 8, 4)),
                                            ("tttp3", (6, 7, 8, 4))])
def test_verify_plan_gives_the_same_codes(spec_name, args, how):
    jp = jplanner.plan(getattr(JS, spec_name)(*args))
    tp = tplanner.plan(getattr(TS, spec_name)(*args))
    for jb, tb in (("xla", "torch"), ("pallas", "cuda"),
                   ("pallas-gpu", "cuda-splitk")):
        jm = _mutate(dataclasses.replace(jp, backend=jb), how)
        tm = _mutate(dataclasses.replace(tp, backend=tb), how)
        jcodes = [c for c in j_verify(jm).codes if c != "SPTTN-W003"]
        assert j_verify(jm).ok is t_verify(tm).ok
        assert jcodes == list(t_verify(tm).codes)
        assert not t_verify(tm).ok or how in ({"fused": True},)


def test_unported_planner_hooks_raise(monkeypatch):
    """The planner hooks once left out now run: ``plan(memory_budget=)``
    stamps the reference's slice decision, on the model's plan and on a
    measured one.  Measured planning without a card refuses to fall back
    to the CPU unless given an operand there."""
    from repro.core.slicing import plan_peak_bytes
    from repro_torch.autotune import TunerConfig
    spec, jspec = TS.mttkrp(6, 7, 8, 4), JS.mttkrp(6, 7, 8, 4)
    jp = jplanner.plan(jspec)
    peak = plan_peak_bytes(jspec, jp.path, jp.order)
    for budget in (1 << 20, peak * 4 // 5, peak * 7 // 10):
        tp = tplanner.plan(spec, memory_budget=budget)
        jp = jplanner.plan(jspec, memory_budget=budget)
        assert (tp.slice_mode, tp.slice_chunks) == (jp.slice_mode,
                                                    jp.slice_chunks)
    assert tp.slice_mode == "a" and tp.slice_chunks > 1
    with pytest.raises(ValueError, match="shard") as jerr:
        jplanner.plan(jspec, memory_budget=peak // 2)
    with pytest.raises(ValueError, match="shard") as terr:
        tplanner.plan(spec, memory_budget=peak // 2)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    jc, tc = _tensor_pair(jspec, spec, 0.3)
    jp = jplanner.plan(jspec, nnz_levels=jc.nnz_levels())
    budget = plan_peak_bytes(jspec, jp.path, jp.order,
                             jc.nnz_levels()) * 3 // 5
    want = tex.plan_from_json(jex.plan_to_json(jplanner.plan(
        jspec, nnz_levels=jc.nnz_levels(), memory_budget=budget)))
    tuned = tplanner.plan(spec, autotune=True, memory_budget=budget,
                          csf=tex.CSFArrays.from_csf(tc, "cpu"),
                          tuner=TunerConfig(max_candidates=1, repeats=1))
    assert (tuned.path, tuned.order) == (want.path, want.order)
    assert (tuned.slice_mode, tuned.slice_chunks) == (want.slice_mode,
                                                      want.slice_chunks)
    assert want.slice_chunks > 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplanner.plan(spec, autotune=True)


@pytest.mark.parametrize("name", ["mttkrp", "ttmc3", "tttp3"])
def test_execute_unfactorized_matches_reference(name):
    """The unfactorized baseline schedule (every factor gathered to the
    leaves, one einsum, then the segment sum and the scatter) gives the
    reference's result on the same tensor and factors, and the dense
    oracle's (float32: ``1e-5 * max(1, max|ref|)``)."""
    args, density = next((a, d) for n, a, d in SPECS if n == name)
    jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jc, tc = _tensor_pair(jspec, tspec, density)
    rng = np.random.default_rng(1)
    factors = {t.name: rng.standard_normal(
        tuple(jspec.dims[i] for i in t.indices)).astype(np.float32)
        for t in jspec.inputs if not t.is_sparse}
    want = np.asarray(jex.execute_unfactorized(
        jspec, jex.CSFArrays.from_csf(jc), factors))
    got = tex.execute_unfactorized(tspec, tc, factors, device="cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if not tspec.output_is_sparse:
        oracle = tex.dense_oracle(tspec, tc, factors)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=tol)
