"""Quickstart: declare an SpTTN kernel, let the planner find the minimum
cost loop nest, execute it, and inspect the schedule — all through the
top-level ``repro_torch`` facade (the JAX package's
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]
    EX_SCALE=0.1 python -m repro_torch.examples.quickstart   # CI smoke

On the card the plan's segment sums launch the combine kernel.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import (CSFArrays, build_csf, dense_oracle, execute_plan,
                         make_executor, mttkrp, plan, plan_peak_bytes,
                         random_sparse)


def main(scale: float | None = None, device: str = "cuda"):
    """Plan, run and replay MTTKRP at ``scale`` (default ``EX_SCALE``, 1)
    of 256 x 128 x 64, rank 32; returns ``(out, sliced, oracle)``."""
    if scale is None:
        scale = float(os.environ.get("EX_SCALE", "1.0"))
    # MTTKRP (paper Eq. 1): A(i,a) = sum_jk T(i,j,k) B(j,a) C(k,a)
    I, J, K, R = (max(8, int(n * scale)) for n in (256, 128, 64, 32))
    spec = mttkrp(I, J, K, R)

    T = random_sparse((I, J, K), density=1e-3, seed=0)
    csf = build_csf(T)
    print(f"T: shape={T.shape} nnz={T.nnz} "
          f"nnz^(IJ)={csf.nnz_level(2)} nnz^(I)={csf.nnz_level(1)}")

    # plan: enumerate min-depth contraction paths, run Algorithm 1 per path
    p = plan(spec, nnz_levels=csf.nnz_levels())
    print("\nchosen loop nest (factorize-and-fuse):")
    print(p.describe())

    rng = np.random.default_rng(0)
    host = {"B": rng.standard_normal((J, R)).astype(np.float32),
            "C": rng.standard_normal((K, R)).astype(np.float32)}
    factors = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    arrays = CSFArrays.from_csf(csf, device)
    out = make_executor(spec, p.path, p.order)(arrays, factors)
    oracle = dense_oracle(spec, csf, host)
    err = float(np.abs(out.cpu().numpy() - oracle).max())
    print("\nmax |out - dense einsum oracle| =", err)
    assert err < 1e-3

    # out-of-core replay: cap the working set at half the unsliced peak and
    # the same plan streams chunk by chunk, exactly
    peak = plan_peak_bytes(spec, p.path, p.order, csf.nnz_levels())
    sliced = execute_plan(p, arrays, factors, memory_budget=peak // 2)
    delta = float(np.abs(sliced.cpu().numpy() - oracle).max())
    print(f"peak working set {peak} B; replayed under {peak // 2} B budget, "
          f"max delta = {delta:.2e}")
    assert np.allclose(sliced.cpu().numpy(), out.cpu().numpy(), atol=1e-4)
    return out, sliced, oracle


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
