"""The port's plan-invariants lane (``repro_torch.analysis.plan_invariants``)
against the JAX package's (``scripts/check_plan_invariants.py``), on the
CPU.

* At its defaults the port's lane prints the reference script's lines,
  the engine names mapped (``xla+pallas+pallas-gpu`` ->
  ``torch+cuda+cuda-splitk``): 72 nests verified, 10 executed, 25
  seeded plans, ``OK``.
* At ``--exec-budget 72`` every enumerated nest runs on every engine.
  The reference's lane cannot: it compares a same-sparsity output's
  leaf values (TTTP3's) with the dense oracle and raises; the port's
  compares them with the oracle at the CSF's coordinates.
* An engine that returns a wrong answer, or raises, is reported as a
  ``FAIL`` line and the lane exits 1: it cannot pass vacuously.
* The E041 case takes the split-K lowering out of the registry and puts
  it back.
* ``python -m repro_torch.analysis.plan_invariants --device cpu`` in a
  fresh interpreter imports neither JAX nor the JAX package.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import plan_invariants  # noqa: E402
from repro_torch.kernels.codegen.ir import lowering_targets  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    pytest.importorskip("jax")
    path = os.path.join(REPO, "scripts", "check_plan_invariants.py")
    spec = importlib.util.spec_from_file_location("reference_lane", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_lane_prints_the_reference_lines():
    rc_ref, ref = _run(_reference().main, [])
    rc, got = _run(plan_invariants.main, ["--device", "cpu"])
    assert rc_ref == 0 and rc == 0, (ref, got)
    assert "parity: 72 nests verified, 10 executed" in got
    assert "battery: 25 seeded plans" in got
    assert got == ref.replace("xla+pallas+pallas-gpu",
                              "torch+cuda+cuda-splitk")


def test_lane_executes_every_nest():
    rc, out = _run(plan_invariants.main, ["--exec-budget", "72",
                                          "--device", "cpu"])
    assert rc == 0, out
    assert "parity: 72 nests verified, 72 executed" in out
    assert out.splitlines()[-1] == "check_plan_invariants: OK"


def test_same_sparsity_output_is_held_at_the_csf_coordinates():
    """One nest of MTTKRP, TTMc3 and TTTP3 each: the reference's parity
    check raises at TTTP3 (leaf values against a dense oracle), the
    port's executes all three."""
    with pytest.raises(ValueError, match="broadcast"):
        _reference().check_parity(1, 1, 3, [])
    fails = []
    assert plan_invariants.check_parity(1, 1, 3, fails, "cpu") == (4, 3)
    assert fails == []


def _faulty(monkeypatch, fault):
    real = plan_invariants.make_executor

    def make_executor(spec, path, order, backend="torch", **kw):
        ex = real(spec, path, order, backend=backend, **kw)
        if backend != "cuda":
            return ex

        def run(arrays, factors):
            if fault == "raises":
                raise RuntimeError("launch failed")
            return ex(arrays, factors) + 1.0
        return run

    monkeypatch.setattr(plan_invariants, "make_executor", make_executor)


@pytest.mark.parametrize("fault,line", [
    ("wrong", "FAIL parity/mttkrp/cuda: wrong answer"),
    ("raises", "FAIL parity/mttkrp/cuda: engine raised on a "
               "verifier-accepted nest: launch failed")])
def test_a_faulty_engine_fails_the_lane(monkeypatch, fault, line):
    _faulty(monkeypatch, fault)
    rc, out = _run(plan_invariants.main, ["--device", "cpu"])
    assert rc == 1
    assert line in out
    assert out.count("FAIL parity/") == 10      # every executed nest
    assert "/cuda-splitk" not in out and "/torch" not in out
    assert out.splitlines()[-1] == "check_plan_invariants: FAIL"


def test_battery_restores_the_lowering_registry():
    before = lowering_targets()
    assert "hopper-splitk" in before
    fails = []
    assert plan_invariants.check_battery(fails, "cpu") == 25
    assert fails == []
    assert lowering_targets() == before


def test_fresh_interpreter_runs_the_lane_without_jax_or_repro():
    code = """
import runpy, sys
sys.argv = ["plan_invariants", "--device", "cpu"]
try:
    runpy.run_module("repro_torch.analysis.plan_invariants",
                     run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("CLEAN")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "check_plan_invariants: OK" in out.stdout
    assert "CLEAN" in out.stdout
