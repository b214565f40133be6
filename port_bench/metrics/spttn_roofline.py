"""A call's least time over its measured time, in %
(``spttn_roofline.call``).  The least time is the larger of the call's
bytes over 3.35 TB/s and its operations over 67 TFLOP/s
(``roofline.least_seconds``), both counted by the spec's ``work/`` file
from the spec and the generated tensor's level counts alone; the
measured time is the device trace's span, from the window's first
device operation to its last, over the window's calls."""
from port_bench import roofline


def read(run):
    if run.work is None or run.trace is None or not run.count \
            or not run.trace.span_s:
        return None
    least = roofline.least_seconds(run.work["bytes"], run.work["ops"])
    return 100.0 * least / (run.trace.span_s / run.count)
