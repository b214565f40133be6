"""Hygiene of the port: imports, devices, launch counts, unported parts.

* ``repro_torch`` (and ``chip_smoke.py``) import neither JAX nor the JAX
  package — checked statically over every source file and dynamically in
  a fresh interpreter that plans and runs a kernel on the CPU;
* on CPU tensors no kernel launches (every launch count stays 0), and a
  CUDA-less host never falls back to the CPU unless asked;
* what the port has not ported yet (sliced execution under a memory
  budget) raises ``NotImplementedError`` instead of quietly running
  something else.
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
    spec, csf, factors, p = _mttkrp()
    arrays = CSFArrays.from_csf(csf, device="cpu")
    sliced = dataclasses.replace(p, slice_mode="i", slice_chunks=2)
    with pytest.raises(NotImplementedError, match="slicing"):
        execute_plan(p, csf, factors, device="cpu", memory_budget=1 << 20)
    with pytest.raises(NotImplementedError, match="slicing"):
        execute_plan(sliced, arrays, factors)
    with pytest.raises(NotImplementedError, match="slicing"):
        plan(spec, memory_budget=1 << 20)
    with pytest.raises(NotImplementedError, match="slicing"):
        plan(spec, autotune=True, csf=arrays, memory_budget=1 << 20)
    with pytest.raises(NotImplementedError, match="slicing"):
        tune(spec, csf=arrays, memory_budget=1 << 20)
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
