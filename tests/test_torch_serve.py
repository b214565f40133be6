"""The serving plan cache in the port, held to the reference.

``repro_torch.serve`` against ``repro.serve`` on the same numpy routing
patterns and inputs (``device="cpu"``: the port tunes and dispatches on
the CPU, where its kernel wrappers run their plain versions):

* ``moe_routing_coo`` and ``moe_dispatch_spec`` build the reference's
  pattern and spec;
* ``PlanService`` resolves a pattern stream through the reference's tiers
  (cold, bucket, exact; the tuner's disk tiers in a fresh service; a
  forced replan under ``bucket_tolerance=1e-9``), and its outputs equal
  the reference's and the dense einsum oracle (dispatch copies rows:
  ``1e-5 * max(1, max|ref|)``, and exactly for the oracle);
* a budgeted service slices as the reference's does and reuses its chunk
  executors; ``dispatch_batch`` equals sequential dispatch;
* every name the reference's facade exports resolves in the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.autotune.tuner import TunerConfig as JTunerConfig  # noqa: E402
from repro.core import slicing as jslicing  # noqa: E402
from repro.core.executor import plan_from_json as j_plan_from_json  # noqa: E402,E501
from repro.serve import PlanService as JPlanService  # noqa: E402
from repro.serve import moe_dispatch_spec as j_spec  # noqa: E402
from repro.serve import moe_routing_coo as j_routing  # noqa: E402
from repro_torch.autotune.tuner import TunerConfig  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import slicing as tslicing  # noqa: E402
from repro_torch.serve import (PlanService, ServeStats,  # noqa: E402
                               moe_dispatch_spec, moe_routing_coo)
from repro_torch.sparse import build_csf  # noqa: E402

N, E, K, C, D = 32, 4, 2, 16, 16


def _idx(seed, n=N, e=E, k=K):
    r = np.random.default_rng(seed)
    return np.argsort(-r.standard_normal((n, e)), axis=1)[:, :k]


def _x(seed=0, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _config(cls, bucket="log2", **kw):
    return cls(profile_bucket=bucket, max_paths=2, max_candidates=2,
               orders_per_path=1, warmup=0, repeats=1, **kw)


def _services(tmp_path, name, bucket="log2", **kw):
    port = PlanService(cache_dir=str(tmp_path / f"port-{name}"),
                       tuner=_config(TunerConfig, bucket, **kw),
                       device="cpu")
    ref = JPlanService(cache_dir=str(tmp_path / f"ref-{name}"),
                       tuner=_config(JTunerConfig, bucket, **kw))
    return port, ref


def _oracle(coo, x):
    return np.einsum("tec,td->ecd", coo.to_dense(), x)


def _close(port, ref, rel=1e-5):
    port = port.cpu().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(port - ref).max()) <= rel * scale


@pytest.mark.parametrize("n,e,k,c", [(3, 2, 2, 2), (N, E, K, C),
                                     (64, 8, 3, 64), (40, 5, 2, 3)])
def test_routing_and_spec_equal_reference(n, e, k, c):
    idx = _idx(7, n, e, k)
    got, want = moe_routing_coo(idx, e, c), j_routing(idx, e, c)
    assert got.shape == want.shape and got.nnz == want.nnz
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype
    ts, js = moe_dispatch_spec(n, e, c, 24), j_spec(n, e, c, 24)
    assert ts.dims == js.dims
    assert [(t.name, t.indices, t.is_sparse) for t in ts.inputs] == \
        [(t.name, t.indices, t.is_sparse) for t in js.inputs]
    assert ts.output.indices == js.output.indices


def test_tier_kinds_and_outputs_equal_reference(tmp_path):
    """cold -> bucket -> exact, then a fresh service over the same disk
    cache (exact, bucket), in both packages, with the same outputs."""
    port, ref = _services(tmp_path, "a")
    x = _x()
    stream = [0, 1, 1]
    for seed in stream:
        coo = moe_routing_coo(_idx(seed), E, C)
        out, st = port.dispatch(coo, x)
        jout, jst = ref.dispatch(j_routing(_idx(seed), E, C), x)
        assert isinstance(st, ServeStats) and st.kind == jst.kind
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        _close(out, np.asarray(jout))
        np.testing.assert_array_equal(out.numpy(), _oracle(coo, x))
    assert [s.kind for s in port.stats] == ["cold", "bucket", "exact"]
    assert [s.kind for s in port.stats] == [s.kind for s in ref.stats]
    port2 = PlanService(cache_dir=port.cache_dir, device="cpu",
                        tuner=_config(TunerConfig))
    ref2 = JPlanService(cache_dir=ref.cache_dir,
                        tuner=_config(JTunerConfig))
    for seed in (0, 2):
        port2.dispatch(moe_routing_coo(_idx(seed), E, C), x)
        ref2.dispatch(j_routing(_idx(seed), E, C), x)
    assert [s.kind for s in port2.stats] == ["exact", "bucket"]
    assert [s.kind for s in port2.stats] == [s.kind for s in ref2.stats]


def test_bucket_guard_forces_replan(tmp_path):
    port, ref = _services(tmp_path, "g")
    x = _x(2)
    port.dispatch(moe_routing_coo(_idx(0), E, C), x)
    ref.dispatch(j_routing(_idx(0), E, C), x)
    strict = PlanService(cache_dir=port.cache_dir, device="cpu",
                         tuner=_config(TunerConfig, bucket_tolerance=1e-9))
    jstrict = JPlanService(cache_dir=ref.cache_dir,
                           tuner=_config(JTunerConfig,
                                         bucket_tolerance=1e-9))
    coo = moe_routing_coo(_idx(1), E, C)
    out, st = strict.dispatch(coo, x)
    _, jst = jstrict.dispatch(j_routing(_idx(1), E, C), x)
    assert st.kind == jst.kind == "cold"
    np.testing.assert_array_equal(out.numpy(), _oracle(coo, x))


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda-splitk"])
def test_budgeted_service_slices_and_reuses_chunk_executors(tmp_path,
                                                            backend):
    cfg = _config(TunerConfig, backends=(backend,))
    x = _x(3)
    plain = PlanService(cache_dir=str(tmp_path), tuner=cfg, device="cpu")
    want, st = plain.dispatch(moe_routing_coo(_idx(0), E, C), x)
    assert st.kind == "cold"
    budgeted = PlanService(cache_dir=str(tmp_path), tuner=cfg,
                           memory_budget=4096, device="cpu")
    out, st = budgeted.dispatch(moe_routing_coo(_idx(0), E, C), x)
    assert st.kind == "exact"     # the entry the unbudgeted search wrote
    assert torch.equal(out, want)
    assert len(budgeted._chunk_executors) == 1
    plan_json, widths = next(iter(budgeted._chunk_executors.items()))
    plan = tex.plan_from_json(plan_json)
    assert plan.backend == backend and plan.slice_chunks > 1
    # the reference stamps the same schedule the same way
    levels = build_csf(moe_routing_coo(_idx(0), E, C)).nnz_levels()
    js = jslicing.stamp_plan_slicing(j_plan_from_json(
        tex.plan_to_json(plan).replace(f'"{backend}"', '"xla"')), levels,
        4096)
    assert (plan.slice_mode, plan.slice_chunks) == (js.slice_mode,
                                                    js.slice_chunks)
    w = -(-D // plan.slice_chunks)
    assert sorted(widths) == sorted({min(w, D - s) for s in range(0, D, w)})
    first = dict(widths)
    out2, _ = budgeted.dispatch(moe_routing_coo(_idx(0), E, C), x)
    assert len(budgeted._chunk_executors) == 1
    assert all(widths[w] is first[w] for w in first)
    assert torch.equal(out2, want)
    assert tslicing.plan_decision(plan, levels).kind == "output"


def test_budgeted_service_equals_reference(tmp_path):
    port = PlanService(cache_dir=str(tmp_path / "p"), device="cpu",
                       tuner=_config(TunerConfig), memory_budget=4096)
    ref = JPlanService(cache_dir=str(tmp_path / "r"),
                       tuner=_config(JTunerConfig), memory_budget=4096)
    x = _x(4)
    for seed in (0, 1, 1):
        out, st = port.dispatch(moe_routing_coo(_idx(seed), E, C), x)
        jout, jst = ref.dispatch(j_routing(_idx(seed), E, C), x)
        assert st.kind == jst.kind
        _close(out, np.asarray(jout))
    assert len(port._chunk_executors) == len(ref._chunk_executors) == 1


def test_dispatch_batch_equals_sequential(tmp_path):
    svc = PlanService(cache_dir=str(tmp_path), device="cpu",
                      tuner=_config(TunerConfig))
    coos = [moe_routing_coo(_idx(s), E, C) for s in range(4)]
    xs = [_x(s) for s in range(4)]
    batched = svc.dispatch_batch(coos, xs)
    seq = PlanService(cache_dir=str(tmp_path / "seq"), device="cpu",
                      tuner=_config(TunerConfig))
    for (out, _), coo, x in zip(batched, coos, xs):
        want, _ = seq.dispatch(coo, x)
        assert torch.equal(out, want)
        np.testing.assert_array_equal(out.numpy(), _oracle(coo, x))
    assert [s.kind for s in svc.stats] == [s.kind for s in seq.stats]


def test_a_service_with_no_card_refuses_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = PlanService(cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.dispatch(moe_routing_coo(_idx(0), E, C), _x())
    with pytest.raises(ValueError, match="both tuner= and config="):
        PlanService(tuner=TunerConfig(), config=TunerConfig())


def test_every_reference_export_resolves_in_the_port():
    missing = [n for n in repro._EXPORTS if not hasattr(repro_torch, n)]
    assert not missing
    assert set(repro._EXPORTS) <= set(repro_torch.__all__)
    assert repro_torch.PlanService is PlanService
    assert repro_torch.sliced_execute is tslicing.sliced_execute
