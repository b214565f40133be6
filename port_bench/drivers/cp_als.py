"""CP-ALS decompositions back to back:
``repro_torch.examples.cp_als.cp_als(coo, rank, steps, seed=seed + k,
arrays=three_csfs)``, the three mode-permuted CSFs built once in
set-up.  The window holds whole decompositions; the last one runs to
its end.

Traffic keys: ``rank``, ``steps`` (sweeps a decomposition),
``warmup_steps`` (the set-up's decomposition), ``checked``
(decompositions sampled for the check) and ``limits``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import torch

from port_bench import bench
from port_bench.drivers import common
from port_bench.reference.cp_als import als


@dataclasses.dataclass
class State:
    dev: torch.device
    traffic: dict
    seed: int
    coo: object               # generate.Coo, the harness's copy
    program: dict | None      # the port's tensor and its three CSFs


@contextlib.contextmanager
def _quiet():
    """``cp_als`` prints its fits; a run's standard output ends in its
    result line alone."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def setup(config, traffic, seed, dev, spans, trace) -> State:
    from repro_torch import CSFArrays, build_csf
    from repro_torch.examples import cp_als as app
    common.load_kernels(dev)
    coo, _, host = common.tensor(config, seed, dev)
    with common.Timer(dev) as t:
        arrays = [CSFArrays.from_csf(build_csf(host.permute_modes(
            (mode,) + tuple(m for m in range(3) if m != mode))), dev)
            for mode in range(3)]
    spans["csf_build_s"] = t.seconds
    with _quiet():
        app.cp_als(host, rank=int(traffic["rank"]),
                   steps=int(traffic["warmup_steps"]), seed=seed,
                   arrays=arrays, device=dev)
    common.sync(dev)
    return State(dev=dev, traffic=traffic, seed=seed, coo=coo,
                 program={"coo": host, "arrays": arrays})


def window(state: State, seconds: float) -> bench.Window:
    from repro_torch.examples import cp_als as app
    host, arrays = state.program["coo"], state.program["arrays"]
    rank, steps = int(state.traffic["rank"]), int(state.traffic["steps"])
    kept = bench.Reservoir(int(state.traffic["checked"]), state.seed)
    n, failed = 0, 0
    t0 = time.perf_counter()
    with _quiet():
        while True:
            try:
                factors, _ = app.cp_als(
                    host, rank=rank, steps=steps, seed=state.seed + n,
                    arrays=arrays, device=state.dev)
                common.sync(state.dev)
            except RuntimeError as exc:
                print(f"decomposition {n} failed: {exc!r}",
                      file=sys.stderr, flush=True)
                failed, n = 1, n + 1
                break
            kept.offer((state.seed + n, factors))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
    return bench.Window(unit="sweep", count=(n - failed) * steps,
                        seconds=time.perf_counter() - t0, attempted=n,
                        failed=failed, kept=kept.items)


def check(state: State, win: bench.Window) -> list[tuple]:
    """Each sampled decomposition's factors against the float64 ALS from
    the same start.  Its fits are not compared: on these tensors a fit
    is ~1e-4, the difference of two nearly equal norms, which float32's
    own evaluation rounds at ~1e-3 of its value, more than TF32 moves
    it."""
    state.program = None
    common.free(state.dev)
    return _numbers(state.coo.to(state.dev), win.kept, state.traffic)


def _numbers(coo, got, traffic) -> list[tuple]:
    """The worst relative gap of A, B and C from the reference's, over
    the decompositions ``got`` (start seed, factors)."""
    rank, steps = int(traffic["rank"]), int(traffic["steps"])
    worst = 0.0 if got else float("inf")
    for seed, factors in got:
        want = als(coo.coords, coo.values, coo.shape, rank, steps, seed)
        worst = max(worst, *(bench.rel_err(g, w)
                             for g, w in zip(factors, want)))
    return [("max_rel_err", worst, traffic["limits"]["max_rel_err"])]


def control(config: dict, traffic: dict, seed: int, dev) -> list[tuple]:
    """The check's number with the reference ALS in TF32 put in the
    program's place, on ``checked`` decompositions."""
    from port_bench import generate
    coo = generate.frostt_like(config, seed, dev)
    rank, steps = int(traffic["rank"]), int(traffic["steps"])
    got = [(seed + k, als(coo.coords, coo.values, coo.shape, rank, steps,
                          seed + k, precision="tf32"))
           for k in range(int(traffic["checked"]))]
    return _numbers(coo, got, traffic)
