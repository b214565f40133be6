"""Fault tolerance & elasticity logic (cluster-control plane, unit-testable;
a copy of the JAX package's ``train/fault.py``, which imports no JAX).

On a real fleet the runner wraps each step in ``guarded_step``; on failure
it (1) restores the latest complete checkpoint, (2) rebuilds the mesh from
the surviving device set via ``elastic_mesh_plan``, and (3) resumes the data
stream deterministically from the restored step (data/pipeline.py is
stateless-per-step, so no replay buffer is needed).

Straggler mitigation: ``StragglerMonitor`` keeps an EWMA of step times and
flags outliers; the launcher's response (the JAX package's DESIGN.md §6) is to
re-shard around the slow host at the next checkpoint boundary — here we
implement and test the detection + re-plan math, which is all that can run
without a cluster.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Callable

import numpy as np


@dataclasses.dataclass
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    dropped: int


def elastic_mesh_plan(n_devices: int, want_model: int = 16,
                      multi_pod: bool = False) -> MeshPlan:
    """Largest usable mesh for a (possibly degraded) device count.

    Keeps the model axis fixed (TP degree is architectural) and shrinks the
    data axis; devices beyond data*model are left idle — the plan reports
    how many.  A 511-device pod therefore yields (31, 16) + 15 idle, and the
    batch keeps its global size via larger per-device microbatching.
    """
    model = want_model
    while model > 1 and n_devices < model:
        model //= 2
    data = n_devices // model
    if multi_pod and data % 2 == 0 and data >= 2:
        return MeshPlan(shape=(2, data // 2, model),
                        axes=("pod", "data", "model"),
                        dropped=n_devices - data * model)
    return MeshPlan(shape=(data, model), axes=("data", "model"),
                    dropped=n_devices - data * model)


def rebalance_batch(global_batch: int, old_data: int, new_data: int
                    ) -> tuple[int, int]:
    """(per_device_batch, grad_accum) preserving the global batch size."""
    per = global_batch // new_data
    accum = 1
    while per > 0 and per % 2 == 0 and per > global_batch // old_data:
        per //= 2
        accum *= 2
    return max(per, 1), accum


class StragglerMonitor:
    """EWMA step-time outlier detector (z-score on log times)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0):
        self.alpha = alpha
        self.threshold = threshold
        self.mean = None
        self.var = 0.0

    def observe(self, dt: float) -> bool:
        x = math.log(max(dt, 1e-9))
        if self.mean is None:
            self.mean = x
            return False
        z = (x - self.mean) / math.sqrt(self.var + 1e-12)
        a = self.alpha
        self.var = (1 - a) * (self.var + a * (x - self.mean) ** 2)
        self.mean = (1 - a) * self.mean + a * x
        return z > self.threshold


class TransientError(RuntimeError):
    pass


def guarded_step(step_fn: Callable, state, batch, retries: int = 2,
                 on_failure: Callable | None = None):
    """Retry transient failures; escalate to checkpoint-restore via
    ``on_failure`` when retries are exhausted.  Only ``TransientError`` is
    retried: a CUDA error is sticky (every later call on the context
    fails), so it propagates at once."""
    for attempt in range(retries + 1):
        try:
            return step_fn(state, batch)
        except TransientError:
            if attempt == retries:
                if on_failure is not None:
                    return on_failure(state, batch)
                raise
            time.sleep(0.01 * (2 ** attempt))
    raise AssertionError("unreachable")


def simulate_failure_schedule(n_steps: int, mtbf_steps: float,
                              seed: int = 0) -> np.ndarray:
    """Poisson failure injection schedule for the integration test."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mtbf_steps, size=max(4, int(n_steps / mtbf_steps)
                                                + 4))
    times = np.cumsum(gaps).astype(np.int64)
    return times[times < n_steps]
