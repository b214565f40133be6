"""Device milliseconds per call or sweep (``kernel_device_ms.call``,
``.sweep``) of the port's own CUDA kernels (``spttn::*_kernel<``), from
the traced window."""


def read(run):
    if run.trace is None or not run.count:
        return None
    t = run.trace.kernel_s()
    return t / run.count * 1e3 if t else None
