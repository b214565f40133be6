"""BENCHMARK.json and the files it names, and the harness's plumbing."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import bench
from port_bench.tests.cells import CELLS, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_names():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "port_bench/run.py"]
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert os.path.isfile(bench.ROOT / c["file"])
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for entry in b["configs"] + b["workloads"]:
        assert NAME.match(entry["name"]) and 1 <= len(entry["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = bench.find_cell(benchmark(), name)
    assert cell.chips == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= reported
    driver = bench.load_module("drivers", cell.traffic["driver"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(driver, fn))
    for m in cell.per_layer:
        assert callable(bench.load_module("metrics", m["name"]).read)
    if "work" in cell.traffic:
        assert callable(bench.load_module("work", cell.traffic["work"]).count)


def test_unknown_names_are_refused():
    with pytest.raises(bench.Refused):
        bench.find_cell(benchmark(), "no.such.cell")
    with pytest.raises(bench.Refused):
        bench.load_module("metrics", "no_such_metric")


def test_reservoir_is_seeded_and_uniform():
    def sample(seed):
        r = bench.Reservoir(3, seed)
        for i in range(1000):
            r.offer(i)
        return r.items
    assert sample(5) == sample(5) and sample(5) != sample(6)
    hits = [0] * 4
    for seed in range(400):
        for i in sample(seed):
            hits[i * 4 // 1000] += 1
    assert min(hits) > 200            # 300 a quarter if uniform


def test_p95_by_nearest_rank():
    assert bench.p95(range(1, 101)) == 95
    assert bench.p95([3.0]) == 3.0
    assert bench.p95(list(range(20, 0, -1))) == 19


def test_rel_err():
    import torch
    want = torch.tensor([[2.0, -4.0]], dtype=torch.float64)
    assert bench.rel_err(torch.tensor([[2.0, -4.0]]), want) == 0
    assert bench.rel_err(torch.tensor([[2.0, -3.0]]), want) == 0.25
    assert bench.rel_err(torch.tensor([[2.0, float("nan")]]), want) \
        == float("inf")
    assert bench.rel_err(torch.tensor([2.0, -4.0]), want) == float("inf")


def _run_cli(cwd, env_src=True):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    return proc


def test_no_card_no_result():
    """Here there is no card: the run fails and prints no result."""
    proc = _run_cli(bench.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_bare_benchmark_directory_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "src/repro_torch" in proc.stderr


def test_result_line_shape():
    from port_bench.tests.cells import run
    r = run("nell2.mttkrp")
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "call_ms", "call_p95_ms"}
    assert r["metrics"]["call_p95_ms"]["value"] >= 0
    json.dumps(r)
