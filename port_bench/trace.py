"""The device trace of a window: ``torch.profiler`` over CPU and CUDA,
exported as a Chrome trace and reduced to device time by operation,
the device's busy time, and its idle gaps by what the host was doing.

Device time is read from the device's events (kernels, copies, fills);
busy time is their union, so nothing counts twice.  A gap is charged to
the host operation that launched the device event ending it: the host
was on its way to that launch while the device waited."""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_MARK = "spttn::"          # the port's own CUDA kernels
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    span_s: float                    # first device event's start to last end
    device_s: dict[str, float]       # device time by operation name
    gaps_s: dict[str, float]         # idle time by the launching host op

    def kernel_s(self) -> float:
        return sum(t for k, t in self.device_s.items() if KERNEL_MARK in k)

    def engine_s(self) -> float:
        return sum(t for k, t in self.device_s.items()
                   if KERNEL_MARK not in k)

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:160], v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_s),
                "idle_gaps": top(self.gaps_s)}


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize(prof) -> Summary:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return summarize_events(events)


def _launcher(ops_by_thread: dict, runtime: dict, corr) -> str:
    """The innermost host op around the runtime call of ``corr``."""
    call = runtime.get(corr)
    if call is None:
        return "unknown"
    starts, ops = ops_by_thread.get((call["pid"], call["tid"]), ([], []))
    t = call["ts"]
    i = bisect.bisect_right(starts, t)
    for op in reversed(ops[max(0, i - 64):i]):
        if op["ts"] + op.get("dur", 0) >= t:
            return op["name"]
    return call["name"]


def summarize_events(events: list[dict]) -> Summary:
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    device_s: dict[str, float] = collections.defaultdict(float)
    for e in dev:
        device_s[e["name"]] += e.get("dur", 0) / 1e6
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("ph") == "X" and e.get("cat") in (
                   "cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    by_thread: dict = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                   "user_annotation"):
            by_thread[(e["pid"], e["tid"])].append(e)
    ops_by_thread = {}
    for key, ops in by_thread.items():
        ops.sort(key=lambda e: e["ts"])
        ops_by_thread[key] = ([e["ts"] for e in ops], ops)
    busy = 0.0
    gaps: dict[str, float] = collections.defaultdict(float)
    end = None
    first = dev[0]["ts"] if dev else 0.0
    for e in dev:
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
        if end is None or lo > end:
            if end is not None:
                name = _launcher(ops_by_thread, runtime,
                                 e.get("args", {}).get("correlation"))
                gaps[name] += (lo - end) / 1e6
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    span = (end - first) if dev else 0.0
    return Summary(busy_s=busy / 1e6, span_s=span / 1e6,
                   device_s=dict(device_s),
                   gaps_s=dict(gaps))
