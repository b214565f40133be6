"""Hygiene of the port: imports, devices, launch counts, unported parts.

* ``repro_torch`` (and ``chip_smoke.py``) import neither JAX nor the JAX
  package — checked statically over every source file (the model stack,
  ``serve``, ``launch`` and ``distributed/sharding.py`` included) and
  dynamically in a fresh interpreter that plans and runs a kernel, a
  model's forward, a ``Server`` and ``launch.serve`` on the CPU;
* every name of the reference's ``repro.core.__all__`` resolves in
  ``repro_torch.core``;
* on CPU tensors no kernel launches (every launch count stays 0), and a
  CUDA-less host never falls back to the CPU unless asked;
* what the port once left out and raised ``NotImplementedError`` for
  (sliced execution under a memory budget, the fused chain, measured
  planning) now runs, and the sliced calls agree with the reference.
"""
import ast
import ctypes
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import spec as S  # noqa: E402
from repro_torch.core.executor import (CSFArrays, execute_plan,  # noqa: E402
                                       make_executor)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.autotune import TunerConfig, tune  # noqa: E402
from repro_torch.core import slicing  # noqa: E402
from repro_torch.kernels import native, ops  # noqa: E402
from repro_torch.kernels.segment import segment_combine  # noqa: E402
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _mttkrp():
    spec = S.mttkrp(8, 6, 5, 4)
    csf = build_csf(random_sparse((8, 6, 5), 0.3, seed=0))
    rng = np.random.default_rng(0)
    factors = {"B": rng.standard_normal((6, 4)).astype(np.float32),
               "C": rng.standard_normal((5, 4)).astype(np.float32)}
    return spec, csf, factors, plan(spec, nnz_levels=csf.nnz_levels())


def _reference_csf(csf):
    """The JAX package's CSF of the same tensor."""
    from repro.sparse import build_csf as j_build_csf
    from repro.sparse.coo import from_coords as j_from_coords
    return j_build_csf(j_from_coords(csf.coo.coords, csf.coo.values,
                                     csf.coo.shape))


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_source_imports_jax_or_the_reference():
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_fresh_interpreter_runs_without_jax_or_repro():
    code = """
import sys
import numpy as np
import repro_torch
from repro_torch import (mttkrp, build_csf, random_sparse, plan,
                         execute_plan)
spec = mttkrp(8, 6, 5, 4)
csf = build_csf(random_sparse((8, 6, 5), 0.3, seed=0))
rng = np.random.default_rng(0)
f = {"B": rng.standard_normal((6, 4)).astype(np.float32),
     "C": rng.standard_normal((5, 4)).astype(np.float32)}
p = plan(spec, nnz_levels=csf.nnz_levels())
for backend in ("torch", "cuda", "cuda-splitk"):
    out = execute_plan(p, csf, f, backend=backend, device="cpu")
    assert tuple(out.shape) == (8, 4)
    out = execute_plan(p, csf, f, backend=backend, device="cpu",
                       memory_budget=600)
    assert tuple(out.shape) == (8, 4)
from repro_torch.serve import PlanService, moe_routing_coo
idx = np.argsort(-rng.standard_normal((16, 4)), axis=1)[:, :2]
svc = PlanService(device="cpu", memory_budget=1024)
out, st = svc.dispatch(moe_routing_coo(idx, 4, 8),
                       rng.standard_normal((16, 8)).astype(np.float32))
assert tuple(out.shape) == (4, 8, 8) and st.kind == "cold"
from repro_torch.configs import get_reduced, make_batch
from repro_torch.launch import serve
from repro_torch.models import forward, model_init
from repro_torch.serve import Request, Server
cfg = get_reduced("granite-moe-1b-a400m")
params, _ = model_init(cfg, 0, device="cpu")
batch = make_batch(cfg, "train_4k", batch_override=1, seq_override=6,
                   device="cpu")
assert tuple(forward(params, cfg, batch)[0].shape) == (1, 6, cfg.vocab)
srv = Server(cfg, params, slots=2, cache_len=16)
srv.submit(Request(prompt=np.arange(5, dtype=np.int32), max_new=3))
(req,) = srv.run()
assert len(req.out) == 3
assert len(serve.main(["--requests", "2", "--max-new", "2",
                       "--device", "cpu"])) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("CLEAN")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_the_model_stack_is_checked_by_the_import_scan():
    """The static scan above walks the modules of this slice."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for mod in ("models/__init__.py", "models/layers.py",
                "models/attention.py", "models/moe.py",
                "models/recurrent.py", "models/transformer.py",
                "models/weights.py", "serve/serve_step.py",
                "launch/__init__.py", "launch/serve.py",
                "distributed/sharding.py"):
        assert mod in scanned, mod


def test_the_training_slice_is_checked_by_the_import_scan():
    """The static scan walks the training slice's modules too."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for mod in ("train/__init__.py", "train/optimizer.py",
                "train/train_step.py", "train/checkpoint.py",
                "train/fault.py", "train/tree.py", "data/__init__.py",
                "data/pipeline.py", "launch/train.py"):
        assert mod in scanned, mod


def test_fresh_interpreter_trains_without_jax_or_repro(tmp_path):
    """A train step, a checkpoint round trip and the training driver on
    the CPU import neither JAX nor the JAX package."""
    code = f"""
import sys
import torch
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import model_init
from repro_torch.train import (checkpoint, init_train_state,
                               make_train_step)
cfg = get_reduced("granite-moe-1b-a400m")
state = init_train_state(model_init(cfg, 0, device="cpu")[0])
ds = SyntheticLM(cfg.vocab, 8, 2, device="cpu")
state, m = make_train_step(cfg, RunConfig(model=cfg, microbatches=2))(
    state, ds.batch_at(0))
assert torch.isfinite(m["loss"]) and int(state.opt.step) == 1
checkpoint.save(state, {str(tmp_path / "c")!r}, step=1)
back, at = checkpoint.restore(state, {str(tmp_path / "c")!r})
assert at == 1 and torch.equal(back.opt.m["embed"]["w"],
                               state.opt.m["embed"]["w"])
train.main(["--reduced", "--steps", "2", "--device", "cpu",
            "--ckpt-dir", {str(tmp_path / "d")!r}])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("CLEAN")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_every_reference_core_name_resolves_in_the_port():
    import repro.core as jcore
    import repro_torch.core as tcore
    missing = [n for n in jcore.__all__ if not hasattr(tcore, n)]
    assert not missing
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert tcore.execute_unfactorized is tcore.executor.execute_unfactorized


def test_cpu_tensors_launch_no_kernel():
    spec, csf, factors, p = _mttkrp()
    arrays = CSFArrays.from_csf(csf, device="cpu")
    native.reset_launch_counts()
    for backend in ("torch", "cuda", "cuda-splitk"):
        for strategy in ("row", "segsum", "fused"):
            kw = {} if backend == "torch" else {"strategy": strategy,
                                                "block": 8}
            execute_plan(p, arrays, factors, backend=backend, **kw)
    b, c = (torch.from_numpy(factors[k]) for k in ("B", "C"))
    ops.mttkrp(csf, b, c, block=8)
    ops.tttp(csf, torch.ones(8, 4), b, c, block=8)
    lay = ops.ttmc_fiber_layout(csf, block=8)
    ops.ttmc_fiber(torch.ones(csf.nfib[2], 2), torch.ones(csf.nfib[2], 3),
                   lay)
    x = torch.ones((2, 5, 3, 4))
    ops.grouped_matmul(x[0], x[1].transpose(1, 2))
    ops.local_attn(x, x, x, 2)
    ops.wkv6(x, x, x, x, x[0, 0])
    ops.rglru(x[0], x[1] / 2)
    assert native.launch_counts() == {s: 0 for s in native.KERNELS}


def test_no_cuda_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, csf, factors, p = _mttkrp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CSFArrays.from_csf(csf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_plan(p, csf, factors, backend="cuda")
    # a kernel wrapper given a tensor that is neither on the CPU nor on a
    # CUDA device raises instead of running its plain version
    rows = torch.zeros((3, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segment_combine(rows, torch.zeros(2, dtype=torch.int64,
                                          device="meta"), 1)


def test_unported_parts_raise_not_implemented():
    """Nothing of the port raises ``NotImplementedError`` any more: a
    memory budget slices (the JAX package's decision and result) in
    ``execute_plan``, ``plan``, ``plan(autotune=True)`` and ``tune``, and
    a plan stamped sliced replays sliced."""
    from repro.core import executor as jex
    from repro.core import planner as jplanner
    from repro.core import slicing as jslicing
    from repro.core import spec as JS
    spec, csf, factors, p = _mttkrp()
    arrays = CSFArrays.from_csf(csf, device="cpu")
    levels = csf.nnz_levels()
    budget = slicing.plan_peak_bytes(spec, p.path, p.order, levels) // 2
    jp = jplanner.plan(JS.mttkrp(8, 6, 5, 4), nnz_levels=levels)
    jarrays = jex.CSFArrays.from_csf(_reference_csf(csf))
    want = np.asarray(jex.execute_plan(jp, jarrays, factors,
                                       memory_budget=budget))
    got = execute_plan(p, csf, factors, device="cpu", memory_budget=budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    sliced = dataclasses.replace(p, slice_mode="a", slice_chunks=2)
    jsliced = dataclasses.replace(jp, slice_mode="a", slice_chunks=2)
    np.testing.assert_allclose(
        execute_plan(sliced, arrays, factors).numpy(),
        np.asarray(jex.execute_plan(jsliced, jarrays, factors)), atol=1e-5)
    stamped = plan(spec, nnz_levels=levels, memory_budget=budget)
    jstamped = jplanner.plan(JS.mttkrp(8, 6, 5, 4), nnz_levels=levels,
                             memory_budget=budget)
    assert (stamped.slice_mode, stamped.slice_chunks) == \
        (jstamped.slice_mode, jstamped.slice_chunks)
    assert stamped.slice_mode == "a" and stamped.slice_chunks > 1
    assert dataclasses.astuple(jslicing.plan_decision(jstamped, levels)) \
        == dataclasses.astuple(slicing.plan_decision(stamped, levels))
    fast = TunerConfig(max_candidates=1, repeats=1)
    tuned = plan(spec, autotune=True, csf=arrays, tuner=fast,
                 memory_budget=budget)
    assert tuned.slice_chunks == stamped.slice_chunks
    assert tuned.stats.candidates_timed >= 1
    tuned, _ = tune(spec, csf=arrays, tuner=fast, memory_budget=budget)
    assert tuned.slice_chunks == stamped.slice_chunks
    # what this port once left out now runs: the fused chain on both
    # code-generator engines, and measured planning
    for backend in ("cuda", "cuda-splitk"):
        fused = dataclasses.replace(p, backend=backend, fused=True, block=8)
        assert tuple(execute_plan(fused, arrays, factors).shape) == (8, 4)
    tuned = plan(spec, autotune=True, csf=arrays,
                 tuner=TunerConfig(max_candidates=1, repeats=1))
    assert tuned.stats.candidates_timed >= 1


def test_engine_kwargs_are_checked():
    spec, csf, factors, p = _mttkrp()
    with pytest.raises(ValueError, match="did you mean 'block'"):
        make_executor(spec, p.path, p.order, backend="cuda", blocks=8)
    with pytest.raises(ValueError, match="code-generator backends"):
        execute_plan(p, csf, factors, backend="torch", device="cpu",
                     block=8)
    with pytest.raises(ValueError, match="unknown strategy"):
        make_executor(spec, p.path, p.order, backend="cuda",
                      strategy="rows")


def test_kernel_registry_names_real_sources_and_tpu_kernels():
    """Every kernel names its CUDA source and the Pallas function it
    replaces (whose body reaches ``pl.pallas_call``)."""
    assert set(native.KERNELS) == {"reduce", "product", "splitk",
                                   "combine", "chain", "mttkrp", "ttmc",
                                   "tttp", "grouped_matmul", "local_attn",
                                   "wkv6", "rglru"}
    for info in native.KERNELS.values():
        assert os.path.exists(os.path.join(REPO, info.source))
        path, line = info.replaces.split(":")
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            lines = f.read().splitlines()
        assert lines[int(line) - 1].startswith("def "), info


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}


@pytest.mark.parametrize("stem", sorted(native.KERNELS))
def test_entry_point_signatures_match_the_ctypes_table(stem):
    """``native._SIGNATURES`` gives ctypes the argument types of every C
    entry point; a mismatch (an ``int`` passed where the entry point
    takes ``long long``) would reach the card unnoticed, so each
    precision's parameter list in the CUDA source is held to it."""
    info = native.KERNELS[stem]
    with open(os.path.join(REPO, info.source), encoding="utf-8") as f:
        src = f.read().replace("\\\n", "\n")
    found = re.findall(r'extern "C" int spttn_' + stem
                       + r"_(##)?(\w+)\(([^)]*)\)", src)
    assert found, stem
    for *_, params in found:
        types = [re.sub(r"\s*\b\w+$", "", p.strip())
                 for p in params.split(",")]
        assert [_C_TYPES[t] for t in types] == native._SIGNATURES[stem]


def test_build_digest_covers_sources_and_headers(tmp_path):
    """The kernel library's name hashes every ``csrc/*.cu`` and the
    headers they include (``csrc/*.cuh``): editing either in a copy of
    ``csrc/`` gives another digest, so a stale library is never
    reused."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh"))
    first = native.source_digest(csrc)
    assert first == native.source_digest(native.CSRC_DIR)
    for pattern in ("*.cuh", "*.cu"):
        src = sorted(csrc.glob(pattern))[0]
        src.write_text(src.read_text() + "\n// edited\n")
        edited = native.source_digest(csrc)
        assert edited != first
        first = edited


def test_product_kernel_shared_limit_is_the_wrappers():
    """K2's launcher sets the kernel's shared-memory limit once to the
    most ``stages.product_tiling`` may ask for, ``MAX_SHARED_BYTES``."""
    path = os.path.join(REPO, native.KERNELS["product"].source)
    with open(path, encoding="utf-8") as f:
        m = re.search(r"constexpr int kProductMaxSmem = (\d+);", f.read())
    assert m and int(m.group(1)) == native.MAX_SHARED_BYTES


def test_wkv6_wide_shared_limit_is_the_wrappers():
    """K10's launcher tiles a head wider than 128 channels within
    ``MAX_SHARED_BYTES``, the limit ``wkv6.fits_a_thread_block`` checks."""
    path = os.path.join(REPO, native.KERNELS["wkv6"].source)
    with open(path, encoding="utf-8") as f:
        m = re.search(r"constexpr int kWkv6MaxSmem = (\d+);", f.read())
    assert m and int(m.group(1)) == native.MAX_SHARED_BYTES


def test_grouped_matmul_f32_tile_is_the_kernels():
    """``grouped_matmul.TILES[torch.float32]``, the tile whose grid the
    wrapper hands ``native.check_grid``, is the float32 kernel's own
    (``GM_BM`` rows of C by ``GM_BN`` columns of F), the grid its entry
    point launches."""
    from repro_torch.kernels import grouped_matmul
    path = os.path.join(REPO, native.KERNELS["grouped_matmul"].source)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tile = tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("GM_BM", "GM_BN"))
    assert tile == grouped_matmul.TILES[torch.float32]


def test_local_attn_query_tiles_are_the_kernels():
    """``local_attn.QUERY_TILES``, whose grid the wrapper hands
    ``native.check_grid``, are the kernels' own query tiles: ``LA_B``
    rows in float32 and ``LT_BQ`` in bf16, the grids their entry points
    launch."""
    from repro_torch.kernels import local_attn
    path = os.path.join(REPO, native.KERNELS["local_attn"].source)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    rows = {name: int(re.search(rf"constexpr int {name} = (\d+)",
                                src).group(1))
            for name in ("LA_B", "LT_BQ")}
    assert local_attn.QUERY_TILES == {torch.float32: rows["LA_B"],
                                      torch.bfloat16: rows["LT_BQ"]}


@pytest.mark.parametrize("name,module,attr", [
    ("WKV6_GROUPS", "wkv6", "GROUPS"),
    ("WKV6_TILE", "wkv6", "CHUNK_ELEMENTS"),
    ("RGLRU_TILE", "rglru", "TILE"),
    ("RGLRU_STAGES", "rglru", "STAGES"),
    ("RGLRU_STAGE_BYTES", "rglru", "STAGE_BYTES"),
])
def test_recurrence_tilings_are_the_kernels(name, module, attr):
    """The tiling constants that K10's and K11's wrappers and CPU walks
    (``tests/test_torch_lm.py``) and the card tests' ring edges read are
    the CUDA kernels' own."""
    import importlib
    path = os.path.join(REPO, native.KERNELS[module].source)
    with open(path, encoding="utf-8") as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert m and int(m.group(1)) == getattr(mod, attr)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(script, encoding="utf-8").read())
    runs = [(str(lone), str(tmp_path), "the port is not here")]
    if not torch.cuda.is_available():
        runs.append((script, REPO, "no CUDA device"))
    for path, cwd, why in runs:
        out = subprocess.run([sys.executable, path], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
        assert why in out.stderr
