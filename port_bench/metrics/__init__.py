"""Per-layer metric readers, one file each, named as the metric:
``read(run) -> float | None`` (``run`` is a ``bench.Run``); ``None``
where the run holds nothing to read."""
