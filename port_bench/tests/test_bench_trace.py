"""The trace's reduction, on a hand-made Chrome trace."""
from __future__ import annotations

import pytest

from port_bench import bench, trace


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": kw.pop("pid", 1), "tid": kw.pop("tid", 1), "args": kw}


EVENTS = [
    _x("cpu_op", "aten::index", 0, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 40, 5, correlation=1),
    _x("cpu_op", "aten::mul", 100, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 126, 2, correlation=3),
    _x("kernel", "index_kernel", 60, 40, pid=0, tid=7, correlation=1),
    _x("kernel", "void spttn::combine_kernel<float>", 130, 20, pid=0,
       tid=7, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoH", 140, 30, pid=0, tid=7, correlation=3),
]


def test_busy_is_the_union_and_gaps_go_to_the_launcher():
    s = trace.summarize_events(EVENTS)
    assert abs(s.busy_s - (40 + 40) / 1e6) < 1e-12      # 60-100, 130-170
    assert abs(s.span_s - 110e-6) < 1e-12                # 60-170
    assert abs(s.kernel_s() - 20e-6) < 1e-12
    assert abs(s.engine_s() - 70e-6) < 1e-12
    assert set(s.gaps_s) == {"aten::mul"}
    assert abs(s.gaps_s["aten::mul"] - 30e-6) < 1e-12
    b = s.breakdown()
    assert b["device_ops"][0] == ["index_kernel", 40e-6]
    assert b["idle_gaps"] == [["aten::mul", s.gaps_s["aten::mul"]]]


@pytest.mark.parametrize("unit", ["call", "sweep"])
def test_device_readers(unit):
    """``<quantity>.call`` and ``<quantity>.sweep`` share one reader,
    which divides by the window's count whatever it counts."""
    s = trace.summarize_events(EVENTS)
    run = bench.Run(unit=unit, count=2, window_s=200e-6, spans={},
                    trace=s, work=None)

    def read(name):
        return bench.load_module("metrics", f"{name}.{unit}").read(run)
    assert abs(read("kernel_device_ms") - 0.01) < 1e-12
    assert abs(read("engine_device_ms") - 0.035) < 1e-12
    assert abs(read("idle_share") - 60.0) < 1e-9
    empty = bench.Run(unit=unit, count=2, window_s=1.0, spans={},
                      trace=trace.summarize_events([]), work=None)
    for name in ("kernel_device_ms", "engine_device_ms", "idle_share"):
        assert bench.load_module("metrics", f"{name}.{unit}").read(
            empty) is None
