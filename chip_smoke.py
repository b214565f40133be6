#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--seed N]

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
2. A small tensor (60 x 50 x 40, density 0.01) through every engine and
   strategy, against the port's numpy Algorithm-2 ``reference_execute``.
3. The main path at full size: a synthetic tensor of nell-2's shape
   (12092 x 9184 x 28818) with the generator's FROSTT-like skew and
   16,000,000 nonzeros.  MTTKRP (R=64), TTMc3 (R=S=16) and TTTP3 (R=64)
   run through ``execute_plan`` on ``"cuda"`` (MTTKRP also on
   ``"cuda-splitk"``), each held against the eager ``"torch"`` engine.
   Each path is timed, its peak memory read and one call traced with
   ``torch.profiler`` (device time by kernel and the device's idle share:
   ``PROFILE`` lines) with nothing recorded; then one counted run, with
   the launch counts zeroed just before it and read just after, records
   the inputs of every kernel it launches.
4. Per kernel, on the inputs the main path gave it — every stage the
   lowerings ran and every segment-combine call (the split-K combine and
   the sorted segment sums of the ``segsum`` strategy and the ``torch``
   engine): the kernel against
   its plain PyTorch version (tolerance ``1e-4 * max(1, max|plain|)``:
   float32 with another summation order), kernel / plain / library-call
   times (CUDA events, median of 10 after 2 warm-ups), and the least time
   the card could take for the same work (bytes over 3.35 TB/s, or
   operations over 67 TFLOP/s float32, whichever is larger).

Float32 products run in full float32: TF32 is switched off for matmul
and cuDNN.  The last two lines are the card's name and power limit from
``nvidia-smi`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NELL2_SHAPE = (12092, 9184, 28818)
NNZ = 16_000_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> tuple[float, float]:
    """Max |got - want| and the tolerance 1e-4 * max(1, max|want|)."""
    import torch
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values in a result")
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err, 1e-4 * scale


def check(name: str, got, want) -> float:
    err, tol = max_err(got, want)
    ok = err <= tol
    log(f"check {name}: max_abs_err={err!r} tol={tol!r} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def profile_path(label: str, fn, event_ms: float) -> None:
    """Device time by kernel for one call of ``fn`` (torch.profiler), and
    the device's idle share of the call's unprofiled CUDA-event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
    except Exception as e:     # instrumentation only: report, do not fail
        log(f"PROFILE {label}: not measured ({type(e).__name__}: {e})")
        return
    busy = sum(r[0] for r in rows)
    log("PROFILE " + json.dumps({
        "path": label, "event_ms": event_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / event_ms if rows else None,
        "top": [{"kernel": k[:100], "calls": c, "device_ms": t}
                for t, c, k in rows[:12]]}))


# --------------------------------------------------------------------- #
# capture the main path's kernel inputs through the lowering registry
# --------------------------------------------------------------------- #
def recording_lowerings(sink: dict):
    """Shadow the two registered Hopper lowerings with recorders that
    keep the first inputs of each (kind, target, expr) and delegate."""
    from repro_torch.kernels.codegen.ir import (Lowering, get_lowering,
                                                register_lowering)

    # the sink lives on the instances, which ``restore`` drops: a class
    # sits in a reference cycle, so methods closing over ``sink`` would
    # keep the recorded tensors alive until a gc pass
    class Recorder(Lowering):
        def __init__(self, inner, sink):
            self.inner, self.target, self.sink = inner, inner.target, sink

        def reduce(self, ir, *args):
            self.sink.setdefault(("reduce", self.target, ir.stage.expr),
                                 (ir, *args))
            return self.inner.reduce(ir, *args)

        def product(self, ir, *args):
            self.sink.setdefault(("product", self.target, ir.stage.expr),
                                 (ir, *args))
            return self.inner.product(ir, *args)

    inners = [get_lowering(t) for t in ("hopper", "hopper-splitk")]
    for inner in inners:
        register_lowering(Recorder(inner, sink))
    return lambda: [register_lowering(i) for i in inners]


# every module that calls the segment-combine kernel, and what it sums
COMBINE_CALLERS = {"repro_torch.core.executor": "segment sum",
                   "repro_torch.kernels.codegen.lower_gpu": "split-K"}


def recording_combines(sink: dict):
    """Shadow ``segment_combine`` in each module that calls it with a
    recorder that keeps the first inputs of each (caller, rows shape,
    nseg) and delegates.  The returned ``restore()`` puts the kernel
    wrapper back and returns how many recorded calls launched the
    kernel."""
    import importlib
    mods = [importlib.import_module(m) for m in COMBINE_CALLERS]
    inner = mods[0].segment_combine
    launched = [0]

    def recorder(site):
        def combine(rows, ptr, nseg):
            sink.setdefault((site, tuple(rows.shape), nseg),
                            (rows, ptr, nseg))
            launched[0] += bool(rows.is_cuda and nseg * rows.shape[1])
            return inner(rows, ptr, nseg)
        return combine

    for mod in mods:
        if mod.segment_combine is not inner:
            raise AssertionError(f"{mod.__name__} calls another combine")
        mod.segment_combine = recorder(COMBINE_CALLERS[mod.__name__])

    def restore() -> int:
        for mod in mods:
            mod.segment_combine = inner
        return launched[0]
    return restore


def stage_nbytes(stage, nrows: int, itemsize: int) -> int:
    return sum((nrows if op.fiber else 1) * op.flat_dim * itemsize
               for op in stage.operands)


def table_nbytes(tables) -> int:
    return sum(t.numel() * 4 for t in (tables.out_ptr, tables.a_idx,
                                       tables.b_idx))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_entries(captured: dict) -> list[tuple]:
    """Each captured stage call as (stem, name, stage, target, kernel,
    plain, library or None, bytes, operations)."""
    import torch
    from repro_torch.kernels.codegen import lower_gpu, stages
    out = []
    for (kind, target, expr), (ir, *args) in captured.items():
        if kind == "product" and target == "hopper-splitk":
            continue                  # the same K2 as on "hopper"
        st = ir.stage
        w = st.out_flat_dim
        if kind == "product":
            tables, rows, dtype = args
            nrows = next(r.shape[0] for r, op in zip(rows, st.operands)
                         if op.fiber)
            isz = torch.empty((), dtype=dtype).element_size()
            nterms = int(tables.a_idx.numel())
            vals = [r.reshape(((nrows,) if op.fiber else ()) + op.shape)
                    for r, op in zip(rows, st.operands)]

            def kern(st=st, tables=tables, rows=rows, dtype=dtype):
                return stages.run_product_stage(st, tables, rows, dtype)

            def plain(st=st, rows=rows, dtype=dtype):
                return stages.run_product_stage_plain(st, rows, dtype)

            def lib(st=st, vals=vals):
                return torch.einsum(st.expr, *vals)

            nbytes = stage_nbytes(st, nrows, isz) + \
                table_nbytes(tables) + nrows * w * isz
            out.append(("product", "K2 product", expr, target, kern, plain,
                        lib, nbytes, 2 * nrows * nterms))
            continue
        tables, block_ptr, mask, padded, dtype = args
        P = mask.shape[0]
        isz = torch.empty((), dtype=dtype).element_size()
        nterms = int(tables.a_idx.numel())
        in_bytes = stage_nbytes(st, P, isz) + P * 4 + table_nbytes(tables)
        ops = 2 * P * nterms + P * w
        if target == "hopper":
            def kern(st=st, tables=tables, block_ptr=block_ptr, mask=mask,
                     padded=padded, dtype=dtype):
                return stages.run_reduce_stage(st, tables, block_ptr, mask,
                                               padded, dtype)

            def plain(st=st, block_ptr=block_ptr, mask=mask, padded=padded,
                      dtype=dtype):
                return stages.run_reduce_stage_plain(st, block_ptr, mask,
                                                     padded, dtype)

            out.append(("reduce", "K1 reduce", expr, target, kern, plain,
                        None, in_bytes + block_ptr.numel() * 8
                        + st.nseg * w * isz, ops))
        else:
            def kern(st=st, tables=tables, mask=mask, padded=padded):
                return lower_gpu.splitk_partials(st, tables, mask, padded)

            def plain(st=st, mask=mask, padded=padded):
                return stages.block_partials_plain(st, mask, padded)

            out.append(("splitk", "K4 split-K partials", expr, target, kern,
                        plain, None,
                        in_bytes + P // st.block * w * isz, ops))
    return out


def combine_entries(captured: dict, backend: str) -> list[tuple]:
    """Each captured segment-combine call, as :func:`stage_entries`."""
    import torch
    from repro_torch.kernels.segment import (segment_combine,
                                             segment_combine_plain)
    out = []
    for (site, (n, w), _), (rows, ptr, nseg) in captured.items():

        def kern(rows=rows, ptr=ptr, nseg=nseg):
            return segment_combine(rows, ptr, nseg)

        def plain(rows=rows, ptr=ptr, nseg=nseg):
            return segment_combine_plain(rows, ptr, nseg)

        def lib(rows=rows, ptr=ptr):
            return torch.segment_reduce(rows, "sum", offsets=ptr, axis=0)

        nbytes = (n + nseg) * w * rows.element_size() + ptr.numel() * 8
        out.append(("combine", "K4 segment combine",
                    f"{site} ({n}, {w}) -> ({nseg}, {w})",
                    backend, kern, plain, lib, nbytes, n * w))
    return out


def measure(entries: list[tuple], spec_name: str) -> list[dict]:
    """Each entry: kernel vs plain on the same inputs, then kernel /
    plain / library times and the bound."""
    import torch
    out = []
    for stem, name, stage, where, kern, plain, lib, nbytes, ops in entries:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = check(f"{name} {stage} ({spec_name}, {where})", got, want)
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, ops)
        rec = {"stem": stem, "name": name, "stage": stage,
               "spec": spec_name, "where": where,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "bytes": nbytes, "ops": ops}
        log("KERNEL_PHASE " + json.dumps(rec))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.core import spec as S
        from repro_torch.core.executor import (CSFArrays, execute_plan,
                                               factors_to_torch,
                                               reference_execute)
        from repro_torch.core.planner import plan
        from repro_torch.kernels import native
        from repro_torch.sparse import build_csf, random_sparse
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if {"jax", "repro"} & set(sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} torch {torch.__version__} "
        f"cuda {torch.version.cuda} numpy {np.__version__}")

    # -- 1. build ------------------------------------------------------ #
    path, secs, report = native.build()
    native.load_library()
    log(f"build: {secs:.1f} s -> {os.path.relpath(path, REPO)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    rng = np.random.default_rng(args.seed)

    def factors_for(spec):
        return {t.name: rng.standard_normal(
            [spec.dims[i] for i in t.indices]).astype(np.float32)
            for t in spec.inputs if not t.is_sparse}

    # -- 2. small tensor through every engine vs Algorithm 2 ----------- #
    small = build_csf(random_sparse((60, 50, 40), 0.01, seed=args.seed))
    small_arrays = CSFArrays.from_csf(small)
    for spec in (S.mttkrp(60, 50, 40, 16), S.ttmc3(60, 50, 40, 8, 8),
                 S.tttp3(60, 50, 40, 16)):
        f = factors_for(spec)
        p = plan(spec, nnz_levels=small.nnz_levels())
        ref = reference_execute(spec, p.path, p.order, small, f)
        if spec.output_is_sparse:
            ref = ref[tuple(small.coo.coords.T)]
        runs = [("torch", {})] + [
            (b, {"strategy": s, "block": 8})
            for b in ("cuda", "cuda-splitk")
            for s in ("row", "segsum", "auto")]
        for backend, kw in runs:
            out = execute_plan(p, small_arrays, f, backend=backend, **kw)
            torch.cuda.synchronize()
            check(f"small {spec.output.indices} {backend} "
                  f"{kw.get('strategy', '')}", out, ref)

    # -- 3. the main path at full size --------------------------------- #
    t0 = time.perf_counter()
    total = int(np.prod([float(s) for s in NELL2_SHAPE]))
    coo = random_sparse(NELL2_SHAPE, NNZ / total, seed=args.seed,
                        distribution="frostt")
    csf = build_csf(coo)
    log(f"tensor: shape {NELL2_SHAPE} nnz {coo.nnz} levels "
        f"{csf.nnz_levels()} built in {time.perf_counter() - t0:.1f} s")
    if coo.nnz != NNZ:
        raise AssertionError(f"expected {NNZ} nonzeros, got {coo.nnz}")
    arrays = CSFArrays.from_csf(csf, dev)
    torch.cuda.synchronize()

    launches = {stem: 0 for stem in native.KERNELS}
    kernel_recs: list[dict] = []
    I, J, K = NELL2_SHAPE
    cases = [("MTTKRP", S.mttkrp(I, J, K, 64), ("cuda", "cuda-splitk")),
             ("TTMc3", S.ttmc3(I, J, K, 16, 16), ("cuda",)),
             ("TTTP3", S.tttp3(I, J, K, 64), ("cuda",))]
    for name, spec, backends in cases:
        p = plan(spec, nnz_levels=csf.nnz_levels())
        f = factors_to_torch(factors_for(spec), dev)
        seen: set = set()              # combine shapes measured already
        for backend in ("torch",) + backends:
            def run():
                return execute_plan(p, arrays, f, backend=backend)

            # the path as a user runs it: peak memory, time, trace
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = time_ms(run)
            profile_path(f"{name} {backend}", run, ms)
            # the counted run, recording every kernel's inputs
            captured: dict = {}
            combines: dict = {}
            restore = recording_lowerings(captured)
            restore_combines = recording_combines(combines)
            native.reset_launch_counts()
            got = run()
            torch.cuda.synchronize()
            counts = native.launch_counts()
            restore()
            recorded = restore_combines()
            if recorded != counts["combine"]:
                raise AssertionError(
                    f"{counts['combine']} combine launches, {recorded} "
                    f"recorded: a caller of the combine is not recorded")
            for stem, n in counts.items():
                launches[stem] += n
            if backend == "torch":
                want = got
            else:
                check(f"path {name} {backend} vs torch", got, want)
            del got
            log(f"path {name} {backend}: {ms!r} ms, launches {counts}, "
                f"peak {peak:.2f} GiB")
            fresh = {k: v for k, v in combines.items() if k not in seen}
            seen.update(fresh)
            kernel_recs += measure(stage_entries(captured)
                                   + combine_entries(fresh, backend), name)
            del captured, combines, fresh
        del want, f
        torch.cuda.empty_cache()

    missing = [s for s, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # -- 4. summary ---------------------------------------------------- #
    summary = []                       # each kernel at its largest input
    for stem, info in native.KERNELS.items():
        rec = max((r for r in kernel_recs if r["stem"] == stem),
                  key=lambda r: r["bytes"])
        summary.append({
            "name": info.name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": launches[stem],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": f"{rec['stage']} ({rec['spec']})"})
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
