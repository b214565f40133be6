"""The work counts on tensors counted by hand, and the roofline reader."""
from __future__ import annotations

from port_bench import bench, roofline


def test_csf_bytes_by_hand():
    # nonzeros (0,0,0), (0,0,1), (1,1,0): 2 slices, 2 fibers, 3 leaves
    levels = {1: 2, 2: 2, 3: 3}
    # coords 2 + 2 + 3, pointers (2 + 1) + (2 + 1), values 3
    assert roofline.csf_bytes(levels) == 4 * 7 + 4 * 6 + 4 * 3


def test_mttkrp_by_hand():
    mod = bench.load_module("work", "mttkrp")
    w = mod.count((2, 2, 2), {"a": 1}, {1: 2, 2: 2, 3: 3})
    # the CSF's 64 bytes; B, C and A of 2 x 1 floats each
    assert w == {"bytes": 64 + 4 * 6, "ops": 2 * (3 + 2)}


def test_ttmc4_by_hand():
    mod = bench.load_module("work", "ttmc4")
    # nonzeros (0,0,0,0), (0,0,0,1), (0,1,0,0): levels 1, 2, 2, 3
    levels = {1: 1, 2: 2, 3: 2, 4: 3}
    w = mod.count((1, 2, 1, 2), {"r": 2, "s": 3, "t": 4}, levels)
    csf = 4 * (1 + 2 + 2 + 3) + 4 * (2 + 3 + 3) + 4 * 3
    dense = 4 * (2 * 2 + 1 * 3 + 2 * 4 + 1 * 2 * 3 * 4)
    assert w == {"bytes": csf + dense,
                 "ops": 2 * (3 * 4 + 2 * 3 * 4 + 2 * 2 * 3 * 4)}


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == 1.0
    assert roofline.least_seconds(0, 67e12) == 1.0
    assert roofline.least_seconds(3.35e12, 134e12) == 2.0


def test_roofline_reader():
    from port_bench import trace
    read = bench.load_module("metrics", "spttn_roofline.call").read
    span = trace.Summary(busy_s=0.5, span_s=1.0, device_s={}, gaps_s={})
    run = bench.Run(unit="call", count=100, window_s=1.2, spans={},
                    trace=span, work={"bytes": 3.35e9, "ops": 0})
    assert abs(read(run) - 10.0) < 1e-9          # 1 ms of 10 ms traced
    run.work = None                              # a sweep has no count
    assert read(run) is None
