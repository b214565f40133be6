"""AdamW with float32 moments, cosine schedule with linear warmup,
global-norm clipping (the JAX package's ``train/optimizer.py``).

Params may be bf16: the moments and the update math stay float32 and the
new params are cast back to each param's dtype.  The learning rate, the
bias corrections and the norm are float32 tensors on the params' device,
computed as the reference computes them, so a step reads nothing back to
the host.  ``torch.optim.AdamW`` is not this function: it updates bf16
params in bf16 and decays them before the step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.tree import key_paths


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    step: torch.Tensor


def init_opt_state(params) -> AdamWState:
    """Zero float32 moments beside each param (a DTensor param gets a
    DTensor moment with its placements, holding only its shard), and
    step 0 (an int32 0-d tensor on the params' device)."""
    from repro_torch.distributed.sharding import (as_dtensor, is_dtensor,
                                                  sharding_of)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        if is_dtensor(p):
            local = p.to_local()
            return as_dtensor(torch.zeros(local.shape, dtype=torch.float32,
                                          device=local.device),
                              sharding_of(p))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(run: RunConfig, step):
    """Linear warmup to ``run.learning_rate``, then a cosine decay to a
    tenth of it at step 10,000, in float32 (``step``: a number or a
    tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    decay = 0.5 * (1 + torch.cos(math.pi * torch.clamp(step / 10_000.0,
                                                       max=1.0)))
    return run.learning_rate * warm * (0.1 + 0.9 * decay)


def clip_by_global_norm(grads, max_norm: float, leaf_squares=None):
    """(float32 grads scaled to a global norm of at most ``max_norm``,
    the norm before scaling); the squares are summed leaf by leaf in the
    reference's leaf order.  ``leaf_squares`` (sharded grads) maps the
    list of each leaf's local sum of squares to the whole leaves'."""
    leaves = [g for _, g in key_paths(grads)]
    squares = [torch.sum(torch.square(g.float())) for g in leaves]
    if leaf_squares is not None:
        squares = leaf_squares(squares)
    gn = torch.sqrt(sum(squares))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_update(params, grads, state: AdamWState, run: RunConfig,
                 b1=0.9, b2=0.95, eps=1e-8, leaf_squares=None):
    """One AdamW step: (new params, new state, {"lr", "grad_norm"}).
    ``leaf_squares``: see :func:`clip_by_global_norm`."""
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip, leaf_squares)
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr = lr_schedule(run, stepf)
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / c1
        vh = v2 / c2
        delta = mh / (torch.sqrt(vh) + eps) + run.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    triples = [upd(*a) for a in zip(*(tree_leaves(t) for t in
                                       (params, grads, state.m, state.v)))]

    def pick(i):
        it = iter(t[i] for t in triples)
        return tree_map(lambda _: next(it), params)

    return pick(0), AdamWState(m=pick(1), v=pick(2), step=step), {
        "lr": lr, "grad_norm": gnorm}
