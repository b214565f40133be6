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

A state whose params are DTensors (``distributed.sharding``'s
``distribute_params``; ``m`` and ``v`` follow them) takes the sharded
step, inside a ``mesh_context``, on the *global* batch (every rank
passes the same one, as the reference's jitted step takes the global
array): each rank keeps its rows (the batch split over the rules'
``act_batch`` axes), gathers the full weights, takes the gradient of its
rows' loss over the split's part count, and the gather's backward sums
those over the batch axes into each rank's shard.  The global norm sums
each leaf's squares once over the mesh, and AdamW updates the shards.
So the step computes the single device's function: the loss is the
whole batch's mean, and the MoE's capacity, slot order and aux loss are
the whole batch's (``models/moe.py``).  At rest each rank holds only its
shards of params, ``m`` and ``v``; during the forward and backward it
also holds the full weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import loss_fn
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         init_opt_state)
from repro_torch.train.tree import key_paths


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
        if any(SH.is_dtensor(t) for t in tree_leaves(params)):
            return sharded_step(state, batch)
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

    def sharded_step(state: TrainState, batch):
        mesh, rules = SH.current_mesh()
        if mesh is None:
            raise RuntimeError("a sharded state steps inside "
                               "sharding.mesh_context(mesh, rules)")
        dts = tree_leaves(state.params)
        shardings = [SH.sharding_of(t) for t in dts]
        B = next(iter(batch.values())).shape[0]
        split = SH.batch_split_for(mesh, rules, B // k)
        local = [t.to_local() for t in dts]
        micro = {name: x.reshape((k, B // k) + x.shape[1:])
                 for name, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=local[0].device)
        grads: list = []
        for i in range(k):
            leaves = [t.detach().requires_grad_(True) for t in local]
            rows = {name: split.rows(x[i]) for name, x in micro.items()}
            with torch.enable_grad(), SH.batch_split(split):
                full = SH.gather_params(leaves, shardings, split.dims)
                it = iter(full)
                live = tree_map(lambda _: next(it), state.params)
                mb_loss, _ = loss_fn(live, cfg, rows, remat=run.remat)
                mb = torch.autograd.grad(mb_loss / split.n, leaves,
                                         allow_unused=True,
                                         materialize_grads=True)
            del full, live
            loss = loss + split.all_reduce(mb_loss.detach().float()) / split.n
            if k == 1:
                grads = list(mb)
            elif not grads:
                grads = [g.float() for g in mb]
            else:
                for a, g in zip(grads, mb):
                    a.add_(g)
        if k > 1:
            loss = loss / k
            grads = [g.div_(k) for g in grads]
        # in the order the norm sums the leaves (the reference's)
        weights = torch.tensor(
            [1.0 / _copies(SH.sharding_of(t))
             for _, t in key_paths(state.params)], device=local[0].device)

        def leaf_squares(squares):
            # each distinct shard's squares once: a replicated leaf's
            # copies are equal, so each adds 1/copies of its squares
            total = torch.stack(squares) * weights
            for i in range(mesh.ndim):
                total = SH.all_reduce(total, mesh.get_group(i))
            return list(total.unbind(0))

        it_p, it_g = iter(local), iter(grads)
        new_local, new_opt, opt_metrics = adamw_update(
            tree_map(lambda _: next(it_p), state.params),
            tree_map(lambda _: next(it_g), state.params),
            AdamWState(m=tree_map(lambda t: t.to_local(), state.opt.m),
                       v=tree_map(lambda t: t.to_local(), state.opt.v),
                       step=state.opt.step), run, leaf_squares=leaf_squares)

        def wrap(tree):
            it = iter(SH.as_dtensor(t, sh) for t, sh in
                      zip(tree_leaves(tree), shardings))
            return tree_map(lambda _: next(it), tree)

        opt = AdamWState(m=wrap(new_opt.m), v=wrap(new_opt.v),
                         step=new_opt.step)
        return TrainState(params=wrap(new_local), opt=opt), {
            "loss": loss, **opt_metrics}

    return step


def _copies(sharding) -> int:
    """How many ranks of the mesh hold the same shard of a leaf."""
    n = 1
    for size, p in zip(sharding.mesh.shape, sharding.placements):
        if p.is_replicate():
            n *= size
    return n
