"""The port's distributed engines on four real gloo ranks, held to the
JAX package.

One group of four ranks (``torch.multiprocessing.spawn``, a ``file://``
store under ``tmp_path``, so parallel test workers never share a port)
runs every case once; each rank writes what it got and the tests below
hold it to the reference.  The group has an ``init_process_group``
timeout of 60 s and an outer limit of 120 s, so a hung rank fails the
tests instead of running the suite into its time limit.

* ``make_distributed`` (the ``torch`` engine) and ``make_distributed_cuda``
  (the code generator's ``cuda`` engine, its kernels' plain versions on
  the CPU) on meshes ``(4,)`` and ``(2, 2)`` (modes 0 and 1 partitioned,
  and mode 0 with replicas along ``model``), MTTKRP and TTMc3, against
  the reference's ``reference_execute`` and ``dense_oracle``; on the
  ``(2, 2)`` mesh also against the reference's own ``make_distributed``
  and ``make_distributed_pallas`` (interpret mode, four fake devices),
  output for output before ``undo_cyclic``;
* TTTP3's leaf values through ``gather_sparse_values``, against the
  reference's;
* ``make_distributed_tuned``'s routed mode under pinned backend axes
  (``("torch",)`` <-> ``("xla",)``, ``("cuda",)`` <-> ``("pallas",)``,
  ``collective-cuda`` <-> ``collective-pallas``), one cache entry per
  live shard carrying ``dist_mode``, and ``("cuda-splitk",)`` replaying;
* ``compressed_psum`` unbiased, ``reduce_scatter_grads`` equal to an
  ``all_reduce`` followed by the rank's slice.

Every rank must return the same output.  Tolerance: float32,
``|port - ref| <= 1e-5 * max(1, max|ref|)`` (relative, as ROADMAP's
ground rules ask).
"""
import datetime
import os
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
SHAPE = (16, 12, 10)
SPECS = {"mttkrp": (16, 12, 10, 8), "ttmc3": (16, 12, 10, 6, 5),
         "tttp3": (16, 12, 10, 8)}
# (label, mesh shape, mesh axes, mode -> axis)
MESHES = [("4", (4,), ("data",), {0: "data"}),
          ("2x2", (2, 2), ("data", "model"), {0: "data", 1: "model"}),
          ("2x2r", (2, 2), ("data", "model"), {0: "data"})]
# pinned backend axes: port -> (reference, port mode, reference mode)
TUNED = {"torch": ("xla", "collective", "collective"),
         "cuda": ("pallas", "collective-cuda", "collective-pallas"),
         "cuda-splitk": (None, "replay", None)}
TIMEOUT_S = 60
LIMIT_S = 120


def _tol(want):
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _inputs(outdir):
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as fh:
        return pickle.load(fh)


def _tuner(backend):
    from repro_torch.autotune import TunerConfig
    return TunerConfig(max_paths=2, max_candidates=1, orders_per_path=1,
                       warmup=1, repeats=2, backends=(backend,))


def _rank_cases(rank: int, outdir: str) -> dict:
    """Every case on this rank; returns what it got, as numpy."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import spec as TS
    from repro_torch.core.planner import plan
    from repro_torch.distributed import (make_distributed,
                                         make_distributed_cuda,
                                         make_distributed_tuned)
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     reduce_scatter_grads)
    from repro_torch.distributed.spttn_dist import gather_sparse_values
    from repro_torch.sparse import COOTensor
    inp = _inputs(outdir)
    coo = COOTensor(coords=inp["coords"], values=inp["values"],
                    shape=SHAPE)
    meshes = {}
    got = {}
    for name, args in SPECS.items():
        spec = getattr(TS, name)(*args)
        f = inp["factors"][name]
        p = plan(spec)
        for label, shape, axes, mode_axis in MESHES:
            if shape not in meshes:
                meshes[shape] = init_device_mesh("cpu", shape,
                                                 mesh_dim_names=axes)
            mesh = meshes[shape]
            d = make_distributed(spec, p, coo, mesh, mode_axis, device="cpu")
            out = d(f).numpy()
            got[name, label, "torch"] = out
            if spec.output_is_sparse:
                got[name, label, "values"] = gather_sparse_values(d, out)
                continue
            for engine, kw in (("cuda", {"block": 8}),
                               ("cuda-fused", {"block": 8,
                                               "strategy": "fused"})):
                d = make_distributed_cuda(spec, p, coo, mesh, mode_axis,
                                          device="cpu", **kw)
                got[name, label, engine] = d(f).numpy()
    spec = TS.mttkrp(*SPECS["mttkrp"])
    for backend in TUNED:
        cache = os.path.join(outdir, f"cache-{backend}")
        d = make_distributed_tuned(spec, coo, meshes[(4,)], {0: "data"},
                                   cache_dir=cache, tuner=_tuner(backend),
                                   device="cpu")
        got["tuned", backend] = (d.mode, d(inp["factors"]["mttkrp"]).numpy(),
                                 [sh.stats.cache_key if sh.stats else None
                                  for sh in d.shards])
    # compressed_psum: many draws of the rounding noise on fixed inputs
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        600).astype(np.float32))
    exact = x.clone()
    dist.all_reduce(exact)
    gen = torch.Generator().manual_seed(100 + rank)
    draws = torch.stack([compressed_psum(x, None, gen, block=128)
                         for _ in range(200)])
    got["psum"] = (exact.numpy(), draws.numpy(),
                   (x.reshape(-1)[:512].reshape(4, 128).abs().amax(1)
                    / 127.0).numpy())
    grads = {"w": torch.from_numpy(np.random.default_rng(10 + rank)
                                   .standard_normal((8, 3))),
             "b": torch.from_numpy(np.random.default_rng(20 + rank)
                                   .standard_normal(5).astype(np.float32))}
    sliced = reduce_scatter_grads(grads)
    full = {}
    for k, g in grads.items():
        full[k] = g.clone()
        dist.all_reduce(full[k])
    got["rs"] = ({k: v.numpy() for k, v in sliced.items()},
                 {k: v.numpy() for k, v in full.items()})
    return got


def _rank(rank: int, world: int, outdir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = _rank_cases(rank, outdir)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(got, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every case on four gloo ranks; returns the reference's tensor,
    the inputs, each rank's results and the ranks' directory."""
    import torch.multiprocessing as mp

    from repro.sparse import random_sparse
    from repro_torch.core import spec as TS
    outdir = str(tmp_path_factory.mktemp("dist"))
    T = random_sparse(SHAPE, 0.1, seed=2)
    rng = np.random.default_rng(0)
    factors = {}
    for name, args in SPECS.items():
        spec = getattr(TS, name)(*args)
        factors[name] = {t.name: rng.standard_normal(
            [spec.dims[i] for i in t.indices]).astype(np.float32)
            for t in spec.inputs if not t.is_sparse}
    inp = {"coords": T.coords, "values": T.values, "factors": factors}
    with open(os.path.join(outdir, "inputs.pkl"), "wb") as fh:
        pickle.dump(inp, fh)
    ctx = mp.start_processes(_rank, args=(WORLD, outdir), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + LIMIT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {LIMIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    got = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
            got.append(pickle.load(fh))
    return T, inp, got, outdir


def _reference(name, T, factors):
    from repro.core import spec as JS
    from repro.core.executor import dense_oracle, reference_execute
    from repro.core.planner import plan as j_plan
    from repro.sparse import build_csf
    spec = getattr(JS, name)(*SPECS[name])
    csf = build_csf(T)
    p = j_plan(spec)
    ref = reference_execute(spec, p.path, p.order, csf, factors)
    if spec.output_is_sparse:
        return ref[tuple(T.coords.T)], None
    return ref, dense_oracle(spec, csf, factors)


def _global(name, label, out):
    """A [part, local] output in global row order, trimmed."""
    from repro_torch.core import spec as TS
    from repro_torch.distributed.spttn_dist import undo_cyclic
    _, shape, axes, mode_axis = next(m for m in MESHES if m[0] == label)
    spec = getattr(TS, name)(*SPECS[name])
    return undo_cyclic(out, spec, mode_axis, dict(zip(axes, shape)),
                       SHAPE)[:SHAPE[0]]


@pytest.mark.parametrize("name", ["mttkrp", "ttmc3"])
def test_collective_engines_match_the_reference(ranks, name):
    T, inp, got, _ = ranks
    ref, oracle = _reference(name, T, inp["factors"][name])
    for label, *_ in MESHES:
        for engine in ("torch", "cuda", "cuda-fused"):
            outs = [g[name, label, engine] for g in got]
            for o in outs[1:]:
                np.testing.assert_array_equal(o, outs[0])
            out = _global(name, label, outs[0])
            np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref),
                                       err_msg=f"{label} {engine}")
            np.testing.assert_allclose(out, oracle, rtol=0,
                                       atol=_tol(oracle))


def test_tttp3_values_equal_the_reference(ranks):
    T, inp, got, _ = ranks
    ref, _ = _reference("tttp3", T, inp["factors"]["tttp3"])
    for label, *_ in MESHES:
        vals = [g["tttp3", label, "values"] for g in got]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        np.testing.assert_allclose(vals[0], ref, rtol=0, atol=_tol(ref))


def test_tuned_routing_equals_the_reference(ranks):
    from repro_torch.autotune.cache import PlanCache
    T, inp, got, outdir = ranks
    ref, _ = _reference("mttkrp", T, inp["factors"]["mttkrp"])
    for backend, (_, mode, _) in TUNED.items():
        modes = {g["tuned", backend][0] for g in got}
        assert modes == {mode}, backend
        out = got[0]["tuned", backend][1]
        for g in got[1:]:
            np.testing.assert_array_equal(g["tuned", backend][1], out)
        np.testing.assert_allclose(out[:SHAPE[0]], ref, rtol=0,
                                   atol=_tol(ref))
        keys = got[0]["tuned", backend][2]
        assert all(g["tuned", backend][2] == keys for g in got)
        cache = PlanCache(os.path.join(outdir, f"cache-{backend}"))
        live = [k for k in keys if k]
        assert len(set(live)) == len(live) == WORLD   # one entry a shard
        for k in live:
            assert cache.meta(k)["dist_mode"] == mode


def test_compressed_psum_is_unbiased(ranks):
    _, _, got, _ = ranks
    exact, draws, _ = got[0]["psum"]
    # every rank's 128-value blocks: the sum of their scale units bounds
    # each draw's error; the mean of 200 draws is within 5 standard
    # errors of the exact sum (variance per draw <= sum of units**2 / 4)
    units = np.stack([g["psum"][2] for g in got])          # (rank, block)
    unit = np.repeat(units.sum(0), 128)
    var = np.repeat((units ** 2).sum(0), 128) / 4
    err = draws[:, :512] - exact[:512]
    slack = 1e-5 * max(1.0, float(np.abs(exact).max()))   # float32 sums
    assert (np.abs(err) <= unit * (1 + 1e-5) + slack).all()
    mean = err.mean(0)
    assert (np.abs(mean) <= 5 * np.sqrt(var / len(draws)) + slack).all()
    for g in got[1:]:                      # every rank holds the same sum
        np.testing.assert_array_equal(g["psum"][0], exact)


def test_reduce_scatter_grads_is_all_reduce_then_slice(ranks):
    _, _, got, _ = ranks
    for rank, g in enumerate(got):
        sliced, full = g["rs"]
        np.testing.assert_allclose(sliced["w"], full["w"][2 * rank:
                                                          2 * rank + 2],
                                   rtol=0, atol=_tol(full["w"]))
        assert sliced["b"].shape == (5,)          # 5 rows: summed whole
        np.testing.assert_allclose(sliced["b"], full["b"], rtol=0,
                                   atol=_tol(full["b"]))


REFERENCE_2D = """
import pickle
import numpy as np
import jax
from repro.autotune import TunerConfig
from repro.core import spec as JS
from repro.core.planner import plan
from repro.distributed import (make_distributed, make_distributed_pallas,
                               make_distributed_tuned)
from repro.distributed.spttn_dist import gather_sparse_values
from repro.sparse.coo import COOTensor
outdir = {outdir!r}
inp = pickle.load(open(outdir + "/inputs.pkl", "rb"))
T = COOTensor(coords=inp["coords"], values=inp["values"], shape={shape!r})
mesh = jax.make_mesh((2, 2), ("data", "model"))
ma = {{0: "data", 1: "model"}}
res = {{}}
for name, args in {specs!r}.items():
    spec = getattr(JS, name)(*args)
    f = inp["factors"][name]
    p = plan(spec)
    d = make_distributed(spec, p, T, mesh, ma)
    out = np.asarray(d(f))
    res[name, "xla"] = out
    if spec.output_is_sparse:
        res[name, "values"] = gather_sparse_values(d, out)
        continue
    d = make_distributed_pallas(spec, p, T, mesh, ma, block=8)
    res[name, "pallas"] = np.asarray(d(f))
mesh4 = jax.make_mesh((4,), ("data",))
for backend in ("xla", "pallas"):
    cfg = TunerConfig(max_paths=2, max_candidates=1, orders_per_path=1,
                      warmup=1, repeats=2, backends=(backend,))
    d = make_distributed_tuned(JS.mttkrp(*{specs!r}["mttkrp"]), T, mesh4,
                               {{0: "data"}}, tuner=cfg)
    res["tuned", backend] = d.mode
pickle.dump(res, open(outdir + "/reference.pkl", "wb"))
print("DONE")
"""


def test_2d_mesh_equals_the_reference_engines(ranks):
    """On the (2, 2) mesh, each output before ``undo_cyclic`` equals the
    reference's ``make_distributed`` (``torch`` <-> XLA) and
    ``make_distributed_pallas`` (``cuda`` <-> Pallas, interpret mode),
    TTTP3's values its ``gather_sparse_values``, and the tuned routes
    its modes."""
    from tests.conftest import run_with_devices
    _, _, got, outdir = ranks
    out = run_with_devices(REFERENCE_2D.format(
        outdir=outdir, shape=SHAPE, specs=SPECS), n_devices=4)
    assert "DONE" in out
    with open(os.path.join(outdir, "reference.pkl"), "rb") as fh:
        ref = pickle.load(fh)
    for name in ("mttkrp", "ttmc3"):
        for port, jax_engine in (("torch", "xla"), ("cuda", "pallas"),
                                 ("cuda-fused", "pallas")):
            want = ref[name, jax_engine]
            np.testing.assert_allclose(got[0][name, "2x2", port], want,
                                       rtol=0, atol=_tol(want))
    want = ref["tttp3", "values"]
    np.testing.assert_allclose(got[0]["tttp3", "2x2", "values"], want,
                               rtol=0, atol=_tol(want))
    np.testing.assert_allclose(got[0]["tttp3", "2x2", "torch"],
                               ref["tttp3", "xla"], rtol=0, atol=_tol(want))
    for backend, (jax_backend, mode, jax_mode) in TUNED.items():
        if jax_backend is not None:
            assert ref["tuned", jax_backend] == jax_mode
            assert got[0]["tuned", backend][0] == mode
