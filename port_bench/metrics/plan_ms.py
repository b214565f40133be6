"""Host milliseconds of one ``repro_torch.plan`` of the cell's spec: the
mean of calls repeated for at least a quarter of a second in set-up."""


def read(run):
    return run.spans.get("plan_ms")
