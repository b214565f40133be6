"""Run one cell of ``BENCHMARK.json`` once and report it as one JSON line.

A cell names a configuration (``configs/<config>.json``: the tensor's
shape, nonzeros and recipe) and a traffic mix
(``traffic/<traffic>.json``: the loop driver's name and its
parameters).  The driver (``drivers/<driver>.py``) sets the program up,
runs the window and checks what the window produced against the plain
reference (``reference/``).  Each per-layer metric is read by
``metrics/<metric>.py`` (``idle_share.call`` and ``idle_share.sweep`` by
``metrics/idle_share.py``); a call's work by ``work/<work>.py``.  All of
them are found by name, so a new cell, mix, driver or metric is a new
file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package (compared whole: ``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py``, loaded by its file name; a name
    with dots and no file of its own (``idle_share.call``) falls back to
    the file of its first part (``idle_share.py``), which reads the
    quantity whatever unit the run counts."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise Refused(f"no {kind} named {name!r} ({path})")
    name = path.stem
    module = f"port_bench.{kind}.{name.replace('.', '__')}"
    if module not in sys.modules:
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module] = mod
        spec.loader.exec_module(mod)
    return sys.modules[module]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def find_cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json``, its files
    loaded, with the metrics it reports: those that list it under
    ``workloads``, and those with no such list."""
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise Refused(f"no configuration named {w['config']!r}")
    def listed(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT / conf[0]["file"]),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{w['traffic']}.json"),
                end_to_end=listed(bench["end_to_end"]),
                per_layer=listed(bench["per_layer"]))


@dataclasses.dataclass
class Window:
    """What a driver's window did: ``count`` units (calls or sweeps) in
    ``seconds`` of the host clock; ``attempted`` and ``failed`` count the
    driver's requests (calls or decompositions); ``kept`` is the sample
    of their outputs that the check compares; ``latencies`` holds each
    unit's host seconds, where the driver times them one by one."""

    unit: str
    count: int
    seconds: float
    attempted: int
    failed: int
    kept: list
    latencies: list = dataclasses.field(default_factory=list)  # seconds


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader sees."""

    unit: str
    count: int
    window_s: float
    spans: dict
    trace: object            # trace.Summary, or None
    work: dict | None        # {"bytes": ..., "ops": ...} of one call


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from
    ``seed`` (the window's length is not known in advance)."""

    def __init__(self, k: int, seed: int):
        import numpy as np
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def rel_err(got, want) -> float:
    """``max |got - want| / max |want|`` in float64 (infinite where the
    shapes differ or ``got`` is not finite)."""
    import torch
    got = torch.as_tensor(got).to(want.device, torch.float64)
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        return math.inf
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / (scale or 1.0)


def p95(values) -> float:
    """The 95th percentile by nearest rank: the least value that at least
    95 % of ``values`` do not exceed."""
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


def loaded_forbidden() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """One run of ``cell``: set-up, the window of ``seconds``, the check.
    ``t0`` is the host clock at the process's start (set-up is measured
    from it).  Returns the result line as a dict."""
    import torch

    from port_bench import trace as tr
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 as stated
    torch.backends.cudnn.allow_tf32 = False
    driver = load_module("drivers", cell.traffic["driver"])
    spans: dict = {}
    state = driver.setup(cell.config, cell.traffic, seed, dev, spans, trace)
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tr.profiler() if trace else contextlib.nullcontext()
    with prof:
        win = driver.window(state, seconds)
        sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tr.summarize(prof) if trace else None
    found = loaded_forbidden()
    if found:
        raise Refused(f"modules of JAX or of the JAX package are loaded: "
                      f"{found}")
    work = driver.work(state) if hasattr(driver, "work") else None
    checks = driver.check(state, win)
    correct = win.failed == 0 and all(
        math.isfinite(v) and v <= limit for _, v, limit in checks)
    metrics = {}
    if trace:
        ctx = Run(unit=win.unit, count=win.count, window_s=win.seconds,
                  spans=spans, trace=summary, work=work)
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        have = {"setup_s": setup_s}
        if win.count:
            have[f"{win.unit}_ms"] = win.seconds / win.count * 1e3
        if win.latencies:
            have[f"{win.unit}_p95_ms"] = p95(win.latencies) * 1e3
        for m in cell.end_to_end:
            if m["name"] not in have:
                raise Refused(f"{cell.name}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": have[m["name"]],
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=win.seconds)
        out["breakdown"] = summary.breakdown()
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, v, limit in checks}
    return out


def main(argv: list[str], t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        cell = find_cell(bench, args.workload)
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise Refused(f"the port (src/repro_torch) is not in {ROOT}")
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t0)
        found = loaded_forbidden()
        if found:
            raise Refused(f"modules of JAX or of the JAX package are "
                          f"loaded: {found}")
    except (Refused, OSError, KeyError, ValueError) as exc:
        print(f"port_bench: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
