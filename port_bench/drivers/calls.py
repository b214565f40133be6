"""One caller in a closed loop of SpTTN calls: each
``repro_torch.execute_plan`` is issued after the previous call's output
has synchronized, and timed on the host clock from its issue to that
synchronization.  The factors rotate through a pool drawn from the
seed on the device, so no call repeats its predecessor's inputs.

Traffic keys: ``spec`` (einsum, the sparse tensor first), ``names``
(the operands'), ``ranks`` (the dense indices' sizes), ``work`` (the
``work/`` file that counts a call), ``pool``, ``plan`` (fields replaced
in the default plan), ``checked`` (calls sampled for the check) and
``limits``.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from port_bench import bench
from port_bench.drivers import common
from port_bench.reference.spttn import contract, parse

PLAN_REPEAT_S = 0.25       # plan_ms is a mean over at least this long


def _dims(traffic: dict, shape) -> tuple[list[str], dict[str, int]]:
    """The spec's operands and every index's size."""
    ins, _ = parse(traffic["spec"])
    return ins, {**dict(zip(ins[0], shape)), **traffic["ranks"]}


def factor_pool(traffic: dict, shape, seed: int, dev) -> list[dict]:
    """``pool`` sets of standard normal dense factors, drawn on ``dev``
    from ``seed`` (a stream apart from the tensor's)."""
    ins, dims = _dims(traffic, shape)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + (1 << 62))
    return [{name: torch.randn([dims[c] for c in ind], generator=g,
                               device=dev)
             for ind, name in zip(ins[1:], traffic["names"][1:])}
            for _ in range(int(traffic["pool"]))]


@dataclasses.dataclass
class State:
    dev: torch.device
    traffic: dict
    seed: int
    coo: object               # generate.Coo, the harness's copy
    levels: dict
    pool: list
    program: dict | None      # the port's operand and plan


def setup(config, traffic, seed, dev, spans, trace) -> State:
    from repro_torch import CSFArrays, build_csf, parse as parse_spec, plan
    common.load_kernels(dev)
    coo, levels, host = common.tensor(config, seed, dev)
    with common.Timer(dev) as t:
        csf = build_csf(host)
        arrays = CSFArrays.from_csf(csf, dev)
    spans["csf_build_s"] = t.seconds
    _, dims = _dims(traffic, coo.shape)
    spec = parse_spec(traffic["spec"], dims=dims, sparse=0,
                      names=traffic["names"])
    levels_p = csf.nnz_levels()
    p = plan(spec, nnz_levels=levels_p)
    if trace:
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < PLAN_REPEAT_S:
            plan(spec, nnz_levels=levels_p)
            n += 1
        spans["plan_ms"] = (time.perf_counter() - t0) / n * 1e3
    if traffic.get("plan"):
        p = dataclasses.replace(p, **traffic["plan"])
    pool = factor_pool(traffic, coo.shape, seed, dev)
    from repro_torch.core import executor
    for f in pool:                           # every layout and kernel
        executor.execute_plan(p, arrays, f)
    common.sync(dev)
    return State(dev=dev, traffic=traffic, seed=seed, coo=coo,
                 levels=levels, pool=pool,
                 program={"plan": p, "arrays": arrays})


def window(state: State, seconds: float) -> bench.Window:
    from repro_torch.core import executor
    p, arrays = state.program["plan"], state.program["arrays"]
    kept = bench.Reservoir(int(state.traffic["checked"]), state.seed)
    n, failed, latencies = 0, 0, []
    t0 = time.perf_counter()
    while True:
        k = n % len(state.pool)
        issued = time.perf_counter()
        try:
            out = executor.execute_plan(p, arrays, state.pool[k])
            common.sync(state.dev)
        except RuntimeError as exc:
            print(f"call {n} failed: {exc!r}", file=sys.stderr,
                  flush=True)
            failed, n = 1, n + 1
            break
        now = time.perf_counter()
        latencies.append(now - issued)
        kept.offer((k, out))
        n += 1
        if now - t0 >= seconds:
            break
    return bench.Window(unit="call", count=n - failed,
                        seconds=time.perf_counter() - t0, attempted=n,
                        failed=failed, kept=kept.items,
                        latencies=latencies)


def work(state: State) -> dict:
    mod = bench.load_module("work", state.traffic["work"])
    return mod.count(state.coo.shape, state.traffic["ranks"],
                     state.levels)


def check(state: State, win: bench.Window) -> list[tuple]:
    """The worst relative gap of the sampled calls' outputs from the
    float64 reference."""
    state.program = None
    common.free(state.dev)
    coo = state.coo.to(state.dev)
    worst = 0.0 if win.kept else float("inf")
    for k, out in win.kept:
        want = contract(state.traffic["spec"], state.traffic["names"],
                        coo.coords, coo.values, coo.shape, state.pool[k])
        worst = max(worst, bench.rel_err(out, want))
    return [("max_rel_err", worst, state.traffic["limits"]["max_rel_err"])]


def control(config: dict, traffic: dict, seed: int, dev) -> list[tuple]:
    """The check's numbers with the reference in TF32 put in the
    program's place, on ``checked`` sets of the pool."""
    from port_bench import generate
    coo = generate.frostt_like(config, seed, dev)
    pool = factor_pool(traffic, coo.shape, seed, dev)
    worst = 0.0
    for f in pool[:int(traffic["checked"])]:
        args = (traffic["spec"], traffic["names"], coo.coords, coo.values,
                coo.shape, f)
        worst = max(worst, bench.rel_err(contract(*args, precision="tf32"),
                                         contract(*args)))
    return [("max_rel_err", worst, traffic["limits"]["max_rel_err"])]
