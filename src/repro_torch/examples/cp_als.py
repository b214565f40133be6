"""End-to-end driver: sparse CP decomposition via ALS, every MTTKRP planned
by the SpTTN framework (the paper's flagship application; the JAX
package's ``examples/cp_als.py``).

    python -m repro_torch.examples.cp_als [--steps 200] [--device cpu]
    python -m repro_torch.examples.cp_als --autotune --cache-dir .plans
        # measured search per mode-permuted MTTKRP; a re-run (or any later
        # tensor with the same sparsity profile) loads the plans from disk

On the card, each MTTKRP's segment sums launch the combine kernel; with
``--autotune`` the search also runs the candidates of the code-generator
engines.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import (COOTensor, CSFArrays, build_csf, make_executor,
                         parse, plan, random_sparse, tttp3)


def cp_als(coo: COOTensor, rank: int, steps: int, seed: int = 0,
           autotune: bool = False, cache_dir: str | None = None,
           device: str = "cuda", *, stats: dict | None = None,
           arrays=None):
    """Rank-``rank`` CP of ``coo`` by ``steps`` ALS sweeps on ``device``;
    returns ``(A, B, C), hist`` (the fit after sweep 0, every tenth and
    the last).  ``stats``, when given, receives ``setup_s`` (CSF builds,
    uploads and plans), ``steps_s`` and ``first_step_s`` (the first
    sweep, its fit included: the first point the host waits for the
    device).  ``arrays``, when given, are ``coo``'s three mode-permuted
    CSFs on ``device`` (mode ``m`` leading, the others in order), which
    are built here otherwise."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    I, J, K = coo.shape
    rng = np.random.default_rng(seed)

    def draw(n):
        return torch.from_numpy(rng.standard_normal((n, rank))
                                .astype(np.float32)).to(dev) * .1

    A, B, C = draw(I), draw(J), draw(K)

    # one planned MTTKRP per mode: permute storage so the output mode leads
    if arrays is None:
        arrays = [CSFArrays.from_csf(build_csf(coo.permute_modes(
            (mode,) + tuple(m for m in range(3) if m != mode))), dev)
            for mode in range(3)]
    execs = {}
    for mode, name in ((0, "A"), (1, "B"), (2, "C")):
        csf_m = arrays[mode]
        dims = dict(zip("ijk", csf_m.shape))
        spec = parse("ijk,ja,ka->ia", dims={**dims, "a": rank}, sparse=0,
                     names=["T", "F1", "F2"])
        p = plan(spec, nnz_levels=csf_m.host.nnz_levels(),
                 autotune=autotune, cache_dir=cache_dir, csf=csf_m)
        if autotune and p.stats is not None:
            how = "cache" if p.stats.cache_hit else (
                f"search ({p.stats.candidates_timed} timed)")
            print(f"mode {name}: plan from {how}", flush=True)
        ex = make_executor(spec, p.path, p.order)
        execs[name] = (lambda f1, f2, ex=ex, csf_m=csf_m:
                       ex(csf_m, {"F1": f1, "F2": f2}))

    # TTTP-style residual on the observed entries, over mode A's CSF (the
    # tensor's own order)
    spec_r = tttp3(I, J, K, rank)
    arrays_r = arrays[0]
    pr = plan(spec_r, nnz_levels=arrays_r.host.nnz_levels(),
              autotune=autotune, cache_dir=cache_dir, csf=arrays_r)
    exr = make_executor(spec_r, pr.path, pr.order)
    vals = arrays_r.values
    ones_arrays = dataclasses.replace(arrays_r, values=torch.ones_like(vals))

    def fit(A, B, C):
        """Standard sparse-CP fit = 1 - ||T - est||_F / ||T||_F, with
        ||est||^2 via the Hadamard-Gram identity (zeros included — sparse
        CP fits the zeros as true zeros, as in SPLATT)."""
        est_obs = exr(ones_arrays, {"U": A, "V": B, "W": C})
        t2 = torch.sum(vals ** 2)
        cross = torch.sum(vals * est_obs)
        gram = (A.T @ A) * (B.T @ B) * (C.T @ C)
        est2 = torch.sum(gram)
        resid = torch.sqrt(torch.clamp(t2 - 2 * cross + est2, min=0.0))
        return 1.0 - resid / torch.sqrt(t2)

    eye = torch.eye(rank, device=dev)

    def solve(mttkrp_out, F1, F2):
        G = (F1.T @ F1) * (F2.T @ F2) + 1e-6 * eye
        return torch.linalg.solve(G, mttkrp_out.T).T

    t1 = time.perf_counter()
    hist = []
    first = None
    for it in range(steps):
        A = solve(execs["A"](B, C), B, C)
        B = solve(execs["B"](A, C), A, C)
        C = solve(execs["C"](A, B), A, B)
        if it % 10 == 0 or it == steps - 1:
            r = float(fit(A, B, C))
            hist.append(r)
            print(f"iter {it:4d}  fit {r:.4f}", flush=True)
        if it == 0:
            first = time.perf_counter() - t1
    if stats is not None:
        stats.update(setup_s=t1 - t0, steps_s=time.perf_counter() - t1,
                     first_step_s=first)
    return (A, B, C), hist


def main(argv=None) -> list[float]:
    """The reference's run: a 128 x 96 x 80 tensor of known rank-8
    structure plus noise; returns the fit history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--autotune", action="store_true",
                    help="measured loop-nest search instead of model-only")
    ap.add_argument("--cache-dir", default=None,
                    help="persist tuned plans here (skips re-search)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # synthesize a tensor with known rank-8 structure + noise
    rng = np.random.default_rng(1)
    I, J, K, r0 = 128, 96, 80, 8
    A0, B0, C0 = (rng.standard_normal((n, r0)) for n in (I, J, K))
    T = random_sparse((I, J, K), 5e-3, seed=2)
    vals = (A0[T.coords[:, 0]] * B0[T.coords[:, 1]]
            * C0[T.coords[:, 2]]).sum(1).astype(np.float32)
    T.values[:] = vals + 0.01 * rng.standard_normal(len(vals))
    t0 = time.time()
    st = {}
    _, hist = cp_als(T, rank=args.rank, steps=args.steps,
                     autotune=args.autotune, cache_dir=args.cache_dir,
                     device=args.device, stats=st)
    print(f"done in {time.time()-t0:.1f}s (setup {st['setup_s']:.2f}s, "
          f"steps {st['steps_s']:.2f}s); fit {hist[0]:.3f} -> "
          f"{hist[-1]:.3f}")
    assert hist[-1] > hist[0]
    return hist


if __name__ == "__main__":
    main()
