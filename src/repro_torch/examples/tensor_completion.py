"""Tensor completion with Adam on observed entries: the gradient's
cost-dominant kernels are TTTP (residual, Eq. 3) and MTTKRP-like products
(paper §3) — all planned by the framework (the JAX package's
``examples/tensor_completion.py``; ``jax.value_and_grad`` becomes
``torch.autograd`` through the executor).

    python -m repro_torch.examples.tensor_completion [--steps 300]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import (COOTensor, CSFArrays, build_csf, make_executor,
                         plan, random_sparse, tttp3)


def complete(omega: COOTensor, truth: np.ndarray, rank: int = 12,
             steps: int = 300, lr: float = 0.05, device: str = "cuda",
             rng: np.random.Generator | None = None, *,
             stats: dict | None = None, on_step=None) -> list[float]:
    """Fit a rank-``rank`` CP model to ``truth`` (one value per entry of
    ``omega``, in its coordinate order) by ``steps`` Adam steps on the
    mean squared error; returns the loss of every step.  The initial
    factors are ``0.4 *`` normal draws from ``rng`` (default: seed 0).
    ``stats``, when given, receives ``setup_s``, ``steps_s`` and
    ``first_step_s`` (step 0, whose loss is printed: the host waits);
    ``on_step(step, loss, params, grads)``, when given, sees each step's
    loss and gradients before the update."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    I, J, K = omega.shape
    csf = build_csf(omega)
    arrays = CSFArrays.from_csf(csf, dev)
    obs = torch.from_numpy(np.asarray(truth)).to(dev)

    spec = tttp3(I, J, K, rank)
    p = plan(spec, nnz_levels=csf.nnz_levels())
    ex = make_executor(spec, p.path, p.order)
    ones_arrays = dataclasses.replace(
        arrays, values=torch.ones_like(arrays.values))

    def loss(params):
        A, B, C = params
        est = ex(ones_arrays, {"U": A, "V": B, "W": C})
        return 0.5 * torch.mean((est - obs) ** 2)

    params = tuple(torch.from_numpy(rng.standard_normal((n, rank))
                                    .astype(np.float32)).to(dev) * 0.4
                   for n in (I, J, K))
    m = tuple(torch.zeros_like(p_) for p_ in params)
    vv = tuple(torch.zeros_like(p_) for p_ in params)
    t1 = time.perf_counter()
    losses = []
    first = None
    for it in range(steps):
        params = tuple(p_.requires_grad_() for p_ in params)
        v = loss(params)
        g = torch.autograd.grad(v, params)
        v = v.detach()
        losses.append(v)
        if on_step is not None:
            on_step(it, v, params, g)
        with torch.no_grad():
            m = tuple(0.9 * m_ + 0.1 * g_ for m_, g_ in zip(m, g))
            vv = tuple(0.99 * v_ + 0.01 * g_ * g_ for v_, g_ in zip(vv, g))
            t = it + 1
            params = tuple(
                p_ - lr * (m_ / (1 - 0.9 ** t))
                / (torch.sqrt(v_ / (1 - 0.99 ** t)) + 1e-8)
                for p_, m_, v_ in zip(params, m, vv))
        if it % 25 == 0 or it == steps - 1:
            print(f"step {it:4d}  mse {float(v):.5f}", flush=True)
        if it == 0:
            first = time.perf_counter() - t1
    losses = [float(v) for v in losses]
    if stats is not None:
        stats.update(setup_s=t1 - t0, steps_s=time.perf_counter() - t1,
                     first_step_s=first)
    return losses


def main(steps: int = 300, rank: int = 12, lr: float = 0.05,
         device: str = "cuda") -> list[float]:
    """The reference's run: rank-12 truth on 8e-3 of a 96 x 80 x 64
    tensor; the loss must fall below a quarter of the first."""
    I, J, K = 96, 80, 64
    rng = np.random.default_rng(0)
    A0, B0, C0 = (rng.standard_normal((n, rank)).astype(np.float32) * 0.5
                  for n in (I, J, K))
    omega = random_sparse((I, J, K), 8e-3, seed=4)   # observed entries
    truth = (A0[omega.coords[:, 0]] * B0[omega.coords[:, 1]]
             * C0[omega.coords[:, 2]]).sum(1)
    losses = complete(omega, truth, rank, steps, lr, device, rng)
    v, v0 = losses[-1], losses[0]
    assert v < 0.25 * v0, (v, v0)
    print("completion converged")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
