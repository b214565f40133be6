"""Readings to set a cell's limits from, in one process on the card::

    python3 port_bench/calibrate.py --workload <cell> \
        --program-seeds 1 2 ... --control-seeds 7 8 9 [--seconds 2] \
        [--checked N]

For each program seed, one run of the cell as ``run.py`` makes it, with
a short window (its check's numbers); for each control seed, the same
numbers with the reference in TF32 put in the program's place.  One
JSON line per reading on standard output.  The benchmark's runs do not
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from port_bench import bench  # noqa: E402


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--checked", type=int, default=None,
                    help="outputs sampled for the check (the mix's own "
                         "number by default)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(bench.load_json(bench.ROOT / "BENCHMARK.json"),
                           args.workload)
    if args.checked is not None:
        cell.traffic["checked"] = args.checked
    driver = bench.load_module("drivers", cell.traffic["driver"])
    for seed in args.program_seeds:
        r = bench.run(cell, seed, args.seconds, False, "cuda",
                      time.perf_counter())
        print(json.dumps({"side": "program", "seed": seed,
                          "checks": r["checks"], "metrics": r["metrics"]}),
              flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        checks = driver.control(cell.config, cell.traffic, seed, "cuda")
        print(json.dumps({"side": "control", "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
