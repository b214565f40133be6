"""Device milliseconds per call or sweep (``engine_device_ms.call``,
``.sweep``) of every operation that is not one of the port's own kernels
(gathers, einsums, elementwise, copies; in CP-ALS the solves and the
fit's too), from the traced window."""


def read(run):
    if run.trace is None or not run.count:
        return None
    t = run.trace.engine_s()
    return t / run.count * 1e3 if t else None
