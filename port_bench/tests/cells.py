"""The benchmark's cells at sizes a CPU test run holds."""
from __future__ import annotations

import copy
import time

from port_bench import bench

TINY = {"nell2": ([300, 200, 400], 60_000),
        "nips": ([60, 50, 70, 17], 20_000)}


def benchmark() -> dict:
    return bench.load_json(bench.ROOT / "BENCHMARK.json")


def tiny_cell(name: str) -> bench.Cell:
    """The cell ``name`` with its tensor cut to a tiny shape."""
    cell = copy.deepcopy(bench.find_cell(benchmark(), name))
    shape, nnz = TINY[next(w["config"] for w in benchmark()["workloads"]
                           if w["name"] == name)]
    cell.config.update(shape=shape, nnz=nnz)
    return cell


def run(name: str, seed: int = 2**31 + 5, seconds: float = 0.3,
        trace: bool = False, device: str = "cpu", cell=None) -> dict:
    return bench.run(cell or tiny_cell(name), seed, seconds, trace, device,
                     time.perf_counter())


CELLS = [w["name"] for w in benchmark()["workloads"]]
