"""The slice as a whole: plan -> CSF -> stage kernels, port vs reference.

``execute_plan`` on the port's three engines (``torch``, ``cuda``,
``cuda-splitk``) with ``device="cpu"`` — so every kernel wrapper runs
its plain version — against the reference's Algorithm-2
``reference_execute`` and its ``pallas`` / ``pallas-gpu`` engines in
interpret mode, on the four paper kernels and on the degenerate layouts
of ``test_codegen_edges.py`` (zero nnz, one segment, all-singleton
segments).  Tolerance: float32 ``|port - ref| <= 1e-5 * max(1,
max|ref|)``, float64 ``1e-12`` relative.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro.sparse.coo import from_coords as j_from_coords  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.sparse import build_csf  # noqa: E402
from repro_torch.sparse.coo import from_coords  # noqa: E402
from tests.test_codegen_edges import (_single_segment_csf,  # noqa: E402
                                      _singleton_segment_csf)

KERNELS = {"mttkrp": ("mttkrp", (6, 7, 8, 4), 0.3),
           "ttmc": ("ttmc3", (6, 7, 8, 4, 3), 0.3),
           "tttp": ("tttp3", (6, 7, 8, 4), 0.3),
           "tttc": ("tttc6", (4, 3), 0.02)}
# (port engine, reference engine, strategy)
ENGINES = [("torch", "xla", None)] + [
    (t, j, s) for t, j in (("cuda", "pallas"), ("cuda-splitk", "pallas-gpu"))
    for s in ("row", "segsum", "auto")]
ENGINE_IDS = [f"{t}-{s}" if s else t for t, _, s in ENGINES]


def _close(port, ref, rel=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, rel * scale)


def _port_csf(jc):
    """The same tensor built by the port from the reference's COO."""
    coo = jc.coo
    return build_csf(from_coords(coo.coords, coo.values, coo.shape))


def _factors(spec, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(dtype)
        for t in spec.inputs if not t.is_sparse}


@functools.cache
def _case(kernel):
    builder, args, density = KERNELS[kernel]
    jspec = getattr(JS, builder)(*args)
    shape = tuple(jspec.dims[i] for i in jspec.sparse_indices)
    jc = j_build_csf(j_random_sparse(shape, density, seed=3))
    return (jspec, getattr(TS, builder)(*args), jc, _port_csf(jc),
            jplanner.plan(jspec, nnz_levels=jc.nnz_levels()))


@functools.cache
def _reference(kernel, backend, strategy):
    jspec, _, jc, _, jp = _case(kernel)
    factors = _factors(jspec)
    if backend == "reference":
        return jex.reference_execute(jspec, jp.path, jp.order, jc, factors)
    kw = {} if strategy is None else {"strategy": strategy, "block": 8,
                                      "interpret": True}
    return np.asarray(jex.execute_plan(jp, jex.CSFArrays.from_csf(jc),
                                       factors, backend=backend, **kw))


def _densify(spec, csf, out):
    if not spec.output_is_sparse:
        return np.asarray(out)
    dense = np.zeros([spec.dims[i] for i in spec.output.indices])
    dense[tuple(csf.coo.coords.T)] = np.asarray(out)
    return dense


@pytest.mark.parametrize("tb,jb,strategy", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_engines_match_reference_engines(kernel, tb, jb, strategy):
    jspec, tspec, jc, tc, jp = _case(kernel)
    tp = tex.plan_from_json(jex.plan_to_json(jp))       # the same plan
    kw = {} if strategy is None else {"strategy": strategy, "block": 8}
    out = tex.execute_plan(tp, tc, _factors(tspec), backend=tb,
                           device="cpu", **kw)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = out.numpy()
    _close(out, _reference(kernel, jb, strategy))
    _close(_densify(tspec, tc, out), _reference(kernel, "reference", None))


@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc"])
def test_float64_matches_reference_pallas_at_1e12(kernel):
    jspec, tspec, jc, tc, jp = _case(kernel)
    factors = _factors(jspec, dtype=np.float64)
    coo = jc.coo
    jc64 = j_build_csf(j_from_coords(coo.coords, coo.values.astype(
        np.float64), coo.shape))
    tc64 = build_csf(from_coords(coo.coords, coo.values.astype(np.float64),
                                 coo.shape))
    with jax.enable_x64(True):
        ref = np.asarray(jex.execute_plan(
            jp, jex.CSFArrays.from_csf(jc64), factors, backend="pallas",
            strategy="row", block=8, interpret=True))
    tp = tex.plan_from_json(jex.plan_to_json(jp))
    for backend in ("cuda", "cuda-splitk"):
        out = tex.execute_plan(tp, tc64, factors, backend=backend,
                               device="cpu", strategy="row", block=8)
        assert out.dtype == torch.float64
        _close(out.numpy(), ref, rel=1e-12)


def _zero_nnz_csf():
    return j_build_csf(j_from_coords(np.zeros((0, 3), np.int64),
                                     np.zeros((0,), np.float32), (6, 7, 8)))


@pytest.mark.parametrize("tb,jb,strategy", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("make_csf", [_zero_nnz_csf, _single_segment_csf,
                                      _singleton_segment_csf],
                         ids=["zero-nnz", "single-segment", "all-singleton"])
def test_edge_layouts_match_reference(make_csf, tb, jb, strategy):
    jspec, tspec = JS.mttkrp(6, 7, 8, 4), TS.mttkrp(6, 7, 8, 4)
    jc = make_csf()
    tc = _port_csf(jc)
    factors = _factors(jspec, seed=2)
    jp = jplanner.plan(jspec, nnz_levels=jc.nnz_levels())
    tp = tplanner.plan(tspec, nnz_levels=tc.nnz_levels())
    kw = {} if strategy is None else {"strategy": strategy, "block": 8}
    out = tex.execute_plan(tp, tc, factors, backend=tb, device="cpu",
                           **kw).numpy()
    ref = jex.reference_execute(jspec, jp.path, jp.order, jc, factors)
    if jc.nnz == 0:
        assert out.shape == (6, 4)
        np.testing.assert_array_equal(out, np.zeros((6, 4), np.float32))
    _close(out, ref)
    jkw = dict(kw, interpret=True) if strategy else {}
    _close(out, np.asarray(jex.execute_plan(
        jp, jex.CSFArrays.from_csf(jc), factors, backend=jb, **jkw)))


def test_sharded_operands_sum_to_the_global_result():
    jspec, tspec, jc, tc, jp = _case("mttkrp")
    coo = tc.coo
    rows = coo.coords[:, 0] % 2 == 0
    shards = [build_csf(from_coords(coo.coords[m], coo.values[m], coo.shape))
              for m in (rows, ~rows)]
    tp = tex.plan_from_json(jex.plan_to_json(jp))
    out = tex.execute_plan(tp, shards, _factors(tspec), backend="cuda",
                           device="cpu", block=8)
    _close(out.numpy(), _reference("mttkrp", "reference", None))


def test_reference_backend_runs_algorithm2():
    jspec, tspec, jc, tc, jp = _case("ttmc")
    tp = tex.plan_from_json(jex.plan_to_json(jp))
    out = tex.execute_plan(tp, tc, _factors(tspec), backend="reference")
    np.testing.assert_array_equal(out, _reference("ttmc", "reference", None))
