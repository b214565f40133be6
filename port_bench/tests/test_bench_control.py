"""The comparison that decides ``correct`` fails what it must: the
control (the reference in TF32 in the program's place) and a run whose
timed path is broken underneath.  Sound runs pass."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from port_bench import bench
from port_bench.tests.cells import CELLS, run, tiny_cell

CALL_CELLS = [c for c in CELLS if c != "nell2.cp_als"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    checks = driver.control(cell.config, cell.traffic, 2**31 + 9, "cpu")
    assert any(v > limit for _, v, limit in checks), checks


def _halved(arrays):
    """Half of the nonzeros left out, the rest doubled (the mean kept)."""
    keep = torch.arange(arrays.values.shape[0]) % 2 == 0
    return dataclasses.replace(arrays, values=arrays.values * keep * 2)


def _altered(out):
    out = out.clone()
    flat = out.view(-1)
    i = int(flat.abs().argmax())
    flat[i] += 1e-3 * flat[i].abs() + 1e-3
    return out


@pytest.mark.parametrize("name", CALL_CELLS)
@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_broken_call_is_caught(name, fault, monkeypatch):
    from repro_torch.core import executor
    real = executor.execute_plan

    def broken(plan, arrays, factors, *a, **kw):
        if fault == "half_left_out":
            return real(plan, _halved(arrays), factors, *a, **kw)
        return _altered(real(plan, arrays, factors, *a, **kw))
    monkeypatch.setattr(executor, "execute_plan", broken)
    assert run(name)["correct"] is False


DECOMPOSITION_FAULTS = ["answer_altered", "half_left_out", "update_unchanged",
                        "a_update_unchanged", "mode_a_mttkrp_altered"]


@pytest.mark.parametrize("fault", DECOMPOSITION_FAULTS)
def test_broken_decomposition_is_caught(fault, monkeypatch):
    from repro_torch.examples import cp_als as app
    real = app.cp_als
    make = app.make_executor

    def broken(coo, rank, steps, *a, arrays=None, **kw):
        if fault == "half_left_out":
            return real(coo, rank, steps, *a,
                        arrays=[_halved(x) for x in arrays], **kw)
        (A, B, C), fits = real(coo, rank, steps, *a, arrays=arrays, **kw)
        if fault in ("update_unchanged", "a_update_unchanged"):
            # C's (or A's) last update does nothing
            (A1, _, C1), _ = real(coo, rank, steps - 1, *a, arrays=arrays,
                                  **kw)
            if fault == "update_unchanged":
                return (A, B, C1), fits
            return (A1, B, C), fits
        if fault == "answer_altered":
            return (A, B, _altered(C)), fits
        return (A, B, C), fits

    def make_broken(spec, path, order):
        """Mode A's MTTKRP (the CSF in the tensor's own order) altered."""
        ex = make(spec, path, order)

        def run(csf, operands):
            out = ex(csf, operands)
            if "F1" in operands and tuple(csf.shape) == tuple(
                    cell.config["shape"]):
                return _altered(out)
            return out
        return run
    cell = tiny_cell("nell2.cp_als")
    monkeypatch.setattr(app, "cp_als", broken)
    if fault == "mode_a_mttkrp_altered":
        monkeypatch.setattr(app, "make_executor", make_broken)
    assert run("nell2.cp_als", seconds=0.5, cell=cell)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    r = run(name, device="cuda", trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
