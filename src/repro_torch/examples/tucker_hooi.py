"""Tucker decomposition via HOOI: the TTMc kernel (paper Eq. 2) planned and
executed by the framework, one mode-permuted CSF per mode (as SPLATT does;
the JAX package's ``examples/tucker_hooi.py``).

    python -m repro_torch.examples.tucker_hooi [--steps 8] [--autotune]
        [--cache-dir .plans] [--device cpu]

On the card each TTMc's segment sums launch the combine kernel; the SVD
of each ``Y`` runs on the host (numpy), as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import (COOTensor, CSFArrays, build_csf, make_executor,
                         parse, plan, random_sparse)


def hooi(coo: COOTensor, ranks=(8, 6, 4), steps: int = 8,
         autotune: bool = False, cache_dir: str | None = None,
         device: str = "cuda", seed: int = 0, *,
         stats: dict | None = None, on_mode=None, arrays=None):
    """``steps`` HOOI sweeps of ``coo`` to a Tucker core of ``ranks`` on
    ``device``; returns ``(U, core_norms)``: the three factors and the
    captured core norm of each sweep.  The initial factors are the QR of
    normal draws from ``seed``.  ``stats``, when given, receives
    ``setup_s``, ``steps_s`` and ``first_step_s`` (the first sweep);
    ``on_mode(sweep, mode, Y, U)``, when given, sees each TTMc's result
    before its SVD, beside the factors it was computed from.
    ``arrays``, when given, are ``coo``'s three mode-permuted CSFs on
    ``device`` (mode ``m`` leading, the others in order), which are
    built here otherwise."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    U = [torch.linalg.qr(torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev))[0]
        for n, r in zip(coo.shape, ranks)]

    if arrays is None:
        arrays = [CSFArrays.from_csf(build_csf(coo.permute_modes(
            (mode,) + tuple(m for m in range(3) if m != mode))), dev)
            for mode in range(3)]
    execs = []
    for mode in range(3):
        others = [m for m in range(3) if m != mode]
        csf_m = arrays[mode]
        dims = dict(zip("ijk", csf_m.shape))
        r1, r2 = [ranks[m] for m in others]
        spec = parse("ijk,jr,ks->irs",
                     dims={**dims, "r": r1, "s": r2}, sparse=0,
                     names=["T", "U1", "U2"])
        p = plan(spec, nnz_levels=csf_m.host.nnz_levels(),
                 autotune=autotune, cache_dir=cache_dir, csf=csf_m)
        if autotune and p.stats is not None:
            how = "cache" if p.stats.cache_hit else (
                f"search ({p.stats.candidates_timed} timed)")
            print(f"mode {mode}: plan from {how}", flush=True)
        ex = make_executor(spec, p.path, p.order)
        execs.append(lambda u1, u2, ex=ex, csf_m=csf_m: ex(
            csf_m, {"U1": u1, "U2": u2}))

    t1 = time.perf_counter()
    norms = []
    first = None
    for it in range(steps):
        for mode in range(3):
            others = [m for m in range(3) if m != mode]
            Y = execs[mode](U[others[0]], U[others[1]])   # (I_m, r1, r2)
            if on_mode is not None:
                on_mode(it, mode, Y, list(U))
            Ym = Y.cpu().numpy().reshape(Y.shape[0], -1)
            u, s, _ = np.linalg.svd(Ym, full_matrices=False)
            U[mode] = torch.from_numpy(
                np.ascontiguousarray(u[:, : ranks[mode]])).to(dev)
        core_norm = float(np.linalg.norm(s[: ranks[2]]))
        norms.append(core_norm)
        print(f"sweep {it}: captured core norm {core_norm:.4f}", flush=True)
        if it == 0:
            first = time.perf_counter() - t1
    if stats is not None:
        stats.update(setup_s=t1 - t0, steps_s=time.perf_counter() - t1,
                     first_step_s=first)
    return U, norms


def main(steps: int = 8, ranks=(8, 6, 4), autotune: bool = False,
         cache_dir: str | None = None, device: str = "cuda"):
    """The reference's run on a 96 x 80 x 64 tensor of density 5e-3;
    returns what :func:`hooi` returns."""
    T = random_sparse((96, 80, 64), 5e-3, seed=3)
    out = hooi(T, ranks, steps, autotune, cache_dir, device)
    print("HOOI done")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--autotune", action="store_true",
                    help="measured loop-nest search instead of model-only")
    ap.add_argument("--cache-dir", default=None,
                    help="persist tuned plans here (skips re-search)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(steps=args.steps, autotune=args.autotune,
         cache_dir=args.cache_dir, device=args.device)
