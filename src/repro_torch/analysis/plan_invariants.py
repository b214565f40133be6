"""CI lane: the static verifier agrees with the engines on every nest
(the JAX package's ``scripts/check_plan_invariants.py``).

    python -m repro_torch.analysis.plan_invariants [--max-paths 6]
        [--max-orders 4] [--exec-budget 10] [--device cuda]

Two phases over the paper's kernels (mttkrp / ttmc3 / tttp3 / tttc6):

* **Parity** — enumerate contraction paths and valid loop orders and
  assert ``verify_plan`` accepts each one (the planner/engines accept
  exactly these); then execute a bounded sample on the ``torch``,
  ``cuda`` and ``cuda-splitk`` engines against the dense oracle, so
  "verifier-accepts" provably implies "engine-accepts *and computes
  the right answer*" on every registered engine.  Operands and factors
  live on ``--device``: on the card the code-generator engines launch
  their stage kernels (K1, K2, K4 and the segment combine, as each
  nest's stages need them); on the CPU they run the kernels' plain
  versions.

* **Mutation battery** — seeded illegal plans (permuted sparse levels,
  sparse slice modes, mis-blocked tiles, doctored plan JSON, malformed
  mesh context, ...), each of which must be rejected with its stable
  ``SPTTN-E*`` code.  A battery row failing means either an invariant
  regressed or a diagnostic code silently changed — both are breaking.

Exit status 0 iff every check passes.  Runtime is bounded by
``--exec-budget`` (engine executions are the only expensive part).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

import numpy as np

from repro_torch.analysis import (PlanVerificationError, check_block_grid,
                                  stackable_diagnostics, verify_plan)
from repro_torch.core import spec as S
from repro_torch.core.executor import (CSFArrays, dense_oracle,
                                       execute_plan, factors_to_torch,
                                       make_executor, plan_from_json,
                                       plan_to_json)
from repro_torch.core.loopnest import enumerate_orders
from repro_torch.core.paths import Operand, Term, min_depth_paths
from repro_torch.core.planner import plan as make_plan
from repro_torch.kernels.codegen import ir as codegen_ir
from repro_torch.sparse import build_csf, random_sparse

ENGINES = ("torch", "cuda", "cuda-splitk")

KERNELS = {
    # name -> constructor args chosen tiny: enumeration is exhaustive,
    # execution takes milliseconds, and every structural case (deep CSF,
    # same-sparsity output, 6-term network) still appears
    "mttkrp": ("mttkrp", (6, 5, 4, 3)),
    "ttmc3": ("ttmc3", (5, 4, 3, 3, 2)),
    "tttp3": ("tttp3", (5, 4, 3, 3)),
    "tttc6": ("tttc6", (3, 2)),
}


def _spec_for(name):
    ctor, args = KERNELS[name]
    return getattr(S, ctor)(*args)


def _factors_for(spec, rng):
    return {t.name: rng.standard_normal(
                [spec.dims[i] for i in t.indices]).astype(np.float32)
            for t in spec.inputs if not t.is_sparse}


def _operand_for(spec, rng_seed=0):
    shape = tuple(spec.dims[i] for i in spec.sparse_indices)
    return build_csf(random_sparse(shape, 0.3, seed=rng_seed))


def check_parity(max_paths: int, max_orders: int, exec_budget: int,
                 fails: list, device: str) -> tuple[int, int]:
    """Verifier accepts every enumerated nest; a bounded sample executes
    correctly on every engine."""
    rng = np.random.default_rng(0)
    verified = executed = 0
    for name in KERNELS:
        spec = _spec_for(name)
        csf = _operand_for(spec)
        arrays = CSFArrays.from_csf(csf, device)
        host = _factors_for(spec, rng)
        factors = factors_to_torch(host, device)
        oracle = np.asarray(dense_oracle(spec, csf, host), dtype=np.float64)
        if spec.output_is_sparse:      # the engines return leaf values
            oracle = oracle[tuple(csf.coo.coords.T)]
        for path in itertools.islice(
                min_depth_paths(spec, max_paths=max_paths, slack=1),
                max_paths):
            for order in itertools.islice(
                    enumerate_orders(path, spec.sparse_indices), max_orders):
                rep = verify_plan(spec, path, order)
                verified += 1
                if not rep.ok:
                    fails.append(f"parity/{name}: verifier rejected an "
                                 f"enumerated nest: {rep.codes}")
                    continue
                if executed >= exec_budget:
                    continue
                for backend in ENGINES:
                    try:
                        ex = make_executor(spec, path, order,
                                           backend=backend)
                        out = ex(arrays, factors).cpu().double().numpy()
                    except Exception as e:  # engine rejected a verified nest
                        fails.append(f"parity/{name}/{backend}: engine "
                                     f"raised on a verifier-accepted nest: "
                                     f"{e}")
                        continue
                    if not np.allclose(out, oracle, rtol=1e-3, atol=1e-3):
                        fails.append(f"parity/{name}/{backend}: wrong "
                                     f"answer on a verifier-accepted nest")
                executed += 1
    return verified, executed


def _swap_sparse(order, sparse):
    """Swap the first two sparse indices found in some term's order."""
    out = []
    done = False
    for a in order:
        sp = [i for i in a if i in sparse]
        if not done and len(sp) >= 2:
            b = list(a)
            i, j = b.index(sp[0]), b.index(sp[1])
            b[i], b[j] = b[j], b[i]
            out.append(tuple(b))
            done = True
        else:
            out.append(tuple(a))
    return tuple(out) if done else None


def check_battery(fails: list, device: str) -> int:
    """Every seeded illegal plan is rejected with its stable code."""
    p = make_plan(_spec_for("mttkrp"))
    spec = p.spec
    p_sp = make_plan(_spec_for("tttp3"))     # same-sparsity output, no chain

    swapped = _swap_sparse(p.order, set(spec.sparse_indices))
    cases = [
        ("permuted-levels", "SPTTN-E001",
         lambda: verify_plan(spec, p.path, swapped)),
        ("not-a-permutation", "SPTTN-E002",
         lambda: verify_plan(spec, p.path,
                             (p.order[0][:-1],) + p.order[1:])),
        ("order-length", "SPTTN-E003",
         lambda: verify_plan(spec, p.path, p.order[:-1])),
        ("wrong-final-output", "SPTTN-E004",
         lambda: verify_plan(spec, p.path[:-1], p.order[:-1])),
        ("fused-without-chain", "SPTTN-E010",
         lambda: verify_plan(p_sp, fused=True)),
        ("block-not-positive", "SPTTN-E020",
         lambda: verify_plan(dataclasses.replace(p, block=0))),
        ("block-misaligned", "SPTTN-E021",
         lambda: verify_plan(dataclasses.replace(p, block=100))),
        ("slice-unknown-mode", "SPTTN-E030",
         lambda: verify_plan(dataclasses.replace(
             p, slice_mode="q", slice_chunks=2))),
        ("slice-sparse-mode", "SPTTN-E031",
         lambda: verify_plan(dataclasses.replace(
             p, slice_mode=spec.sparse_indices[0], slice_chunks=2))),
        ("slice-chunks-range", "SPTTN-E032",
         lambda: verify_plan(dataclasses.replace(
             p, slice_mode="a", slice_chunks=10**6))),
        ("slice-chunks-no-mode", "SPTTN-E033",
         lambda: verify_plan(dataclasses.replace(p, slice_chunks=4))),
        ("unknown-backend", "SPTTN-E040",
         lambda: verify_plan(p, backend="tpu")),
        ("mesh-malformed", "SPTTN-E050",
         lambda: verify_plan(dataclasses.replace(
             p, mesh={"mesh_shape": 3}))),
        ("sparse-output-stacked", "SPTTN-E052",
         lambda: verify_plan(p_sp, stacked=True)),
    ]
    ran = 0
    for label, code, run in cases:
        rep = run()
        ran += 1
        if code not in rep.codes or rep.ok:
            fails.append(f"battery/{label}: expected {code}, got "
                         f"{rep.codes} (ok={rep.ok})")

    # mis-blocked tiles: the stage-grid invariant directly
    d = check_block_grid(130, 128)
    ran += 1
    if d is None or d.code != "SPTTN-E022":
        fails.append(f"battery/block-grid: expected SPTTN-E022, got {d}")

    # backend whose stage lowering is unregistered on this host (E041):
    # pop the split-K target from the registry, verify, restore
    p_gpu = dataclasses.replace(p, backend="cuda-splitk")
    saved = codegen_ir._LOWERINGS.pop("hopper-splitk")
    try:
        rep = verify_plan(p_gpu)
        ran += 1
        if "SPTTN-E041" not in rep.codes or rep.ok:
            fails.append(f"battery/unregistered-lowering: expected "
                         f"SPTTN-E041, got {rep.codes} (ok={rep.ok})")
    finally:
        codegen_ir._LOWERINGS["hopper-splitk"] = saved

    # device-kind mismatch is a warning, never a block (W005)
    rep = verify_plan(p_gpu, device_kind="cpu")
    ran += 1
    if "SPTTN-W005" not in rep.codes or not rep.ok:
        fails.append(f"battery/device-kind: expected non-blocking "
                     f"SPTTN-W005, got {rep.codes} (ok={rep.ok})")

    # broadcast-down lift: a doctored path whose second stage consumes a
    # level-1 FiberVal at level 2 with storage-prefix intact — no
    # same-level zero operand, so the stacked engine's zero-on-pads
    # induction fails (no enumerable paper path trips this: the
    # induction holds on all of them, which is why the stacked engine
    # covers them — the battery must doctor one)
    T = Operand(spec.sparse_input.name, ("i", "j", "k"), is_sparse=True)
    B, C = Operand("B", ("j", "a")), Operand("C", ("k", "a"))
    t0 = Operand("t0", ("i", "a"))
    bad_path = (Term(lhs=T, rhs=C, out=t0),
                Term(lhs=t0, rhs=B, out=Operand("OUT", ("i", "a"))))
    bad_order = (("i", "j", "k", "a"), ("i", "j", "a"))
    sd = stackable_diagnostics(spec, bad_path)
    ran += 1
    if [x.code for x in sd] != ["SPTTN-E051"]:
        fails.append(f"battery/not-stackable: expected SPTTN-E051, got "
                     f"{[x.code for x in sd]}")
    rep = verify_plan(spec, bad_path, bad_order, stacked=True)
    ran += 1
    if "SPTTN-E051" not in rep.codes:
        fails.append(f"battery/not-stackable-verify: expected SPTTN-E051 "
                     f"in {rep.codes}")

    # doctored plan JSON: the load path must refuse with the same codes
    doc_cases = [
        ("json-version", {"version": 5}, "SPTTN-E060"),
        ("json-block", {"block": 100}, "SPTTN-E021"),
        ("json-slice-sparse",
         {"slice_mode": spec.sparse_indices[0], "slice_chunks": 2},
         "SPTTN-E031"),
        ("json-backend", {"backend": "tpu"}, "SPTTN-E040"),
        ("json-mesh", {"mesh": {"mesh_shape": 3}}, "SPTTN-E050"),
    ]
    for label, patch, code in doc_cases:
        doc = json.loads(plan_to_json(p))
        doc.update(patch)
        ran += 1
        try:
            plan_from_json(json.dumps(doc))
        except ValueError as e:
            if code not in str(e):
                fails.append(f"battery/{label}: rejected without {code}: "
                             f"{e}")
        else:
            fails.append(f"battery/{label}: doctored doc was accepted")

    # pre-flight: execute_plan refuses a doctored in-memory plan before
    # any engine is built
    csf = _operand_for(p_sp.spec)
    rng = np.random.default_rng(1)
    ran += 1
    try:
        execute_plan(dataclasses.replace(p_sp, fused=True),
                     CSFArrays.from_csf(csf, device),
                     factors_to_torch(_factors_for(p_sp.spec, rng), device))
    except PlanVerificationError as e:
        if "SPTTN-E010" not in str(e):
            fails.append(f"battery/preflight: missing SPTTN-E010: {e}")
    else:
        fails.append("battery/preflight: execute_plan ran a doctored plan")
    return ran


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-paths", type=int, default=6,
                    help="paths enumerated per kernel (min-depth first)")
    ap.add_argument("--max-orders", type=int, default=4,
                    help="valid loop orders verified per path")
    ap.add_argument("--exec-budget", type=int, default=10,
                    help="nests executed on every engine vs the oracle")
    ap.add_argument("--device", default="cuda",
                    help="where operands and factors live")
    args = ap.parse_args(argv)

    fails: list[str] = []
    verified, executed = check_parity(args.max_paths, args.max_orders,
                                      args.exec_budget, fails, args.device)
    ran = check_battery(fails, args.device)

    print(f"parity: {verified} nests verified, {executed} executed on "
          f"{'+'.join(ENGINES)} vs the dense oracle")
    print(f"battery: {ran} seeded plans, each required to produce "
          f"its stable SPTTN-E*/W* code")
    for f in fails:
        print(f"FAIL {f}")
    print("check_plan_invariants:", "FAIL" if fails else "OK")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
