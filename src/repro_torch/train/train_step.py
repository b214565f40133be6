"""Training step: microbatched grad accumulation + AdamW + metrics (the
JAX package's ``train/train_step.py``).

The params are the leaves of a plain tree with the reference's keys (the
model stack is functional): a step takes the gradient of ``loss_fn`` over
those leaves with ``torch.autograd.grad``, leaving no ``.grad`` on them,
and returns a new state; the state it was given stays as it was.  With
``run.microbatches == 1`` the grads keep the params' dtype, as
``jax.value_and_grad`` gives them; with ``k > 1`` the batch's leading axis
is split into ``k`` microbatches whose grads are summed in float32 in
microbatch order (the reference's ``lax.scan``), then loss and grads are
divided by ``k``.  The metrics (``loss``, ``lr``, ``grad_norm``) stay
tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import loss_fn
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         init_opt_state)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(params))


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """Returns step(state, batch) -> (state, metrics)."""
    k = run.microbatches

    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, cfg, batch, remat=run.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return loss.detach(), metrics, tree_map(lambda _: next(it), params)

    def step(state: TrainState, batch):
        params = state.params
        if k == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                     for name, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(k):
                mb_loss, metrics, mb_grads = grads_of(
                    params, {name: x[i] for name, x in micro.items()})
                tree_map(lambda a, g: a.add_(g), grads, mb_grads)
                loss = loss + mb_loss
                del mb_grads
            loss = loss / k
            tree_map(lambda g: g.div_(k), grads)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state.opt, run)
        m = {"loss": loss, **opt_metrics}
        return TrainState(params=new_params, opt=new_opt), m

    return step
