"""The device's idle share of the traced window, in %: 1 - busy / wall
(``idle_share.call``, ``.sweep``)."""


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
