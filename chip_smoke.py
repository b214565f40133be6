#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--seed N]

Phases (each ends in ``torch.cuda.synchronize()``, prints its seconds;
any failure exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together; sm_90a); a ``PTXAS`` line per kernel
   gives its registers, spills and static shared memory.
2. A small tensor (60 x 50 x 40, density 0.01) through every engine and
   strategy (the fused chain included), against the port's numpy
   Algorithm-2 ``reference_execute``.
3. The main path at full size: a synthetic tensor of nell-2's shape
   (12092 x 9184 x 28818) with the generator's FROSTT-like skew and
   16,000,000 nonzeros.  MTTKRP (R=64), TTMc3 (R=S=16) and TTTP3 (R=64)
   run through ``execute_plan`` on ``"cuda"`` (MTTKRP also on
   ``"cuda-splitk"``), each held against the eager ``"torch"`` engine.
4. The autotuned path: ``plan(autotune=True)`` for MTTKRP and TTMc3 on
   the same tensor over the ``torch``, ``cuda`` and ``cuda-splitk``
   engines with block 8, each candidate printed with its largest buffer
   and its time; the winner replayed against ``torch``; a second call
   must be a cache hit with no execution.
5. The fused chain forced on ``cuda`` (K3) and ``cuda-splitk``: MTTKRP
   and TTMc3 on the same tensor, and TTMc4 (ranks 8) on a synthetic
   tensor of FROSTT nips's shape (2482 x 2862 x 14036 x 17, 3,101,609
   nonzeros), each against ``torch``.
6. The paper kernels through ``kernels/ops.py`` on the 16 M tensor:
   ``mttkrp`` (K5, block 256), ``ttmc_fiber`` (K6, block 128) and
   ``tttp`` (K7, block 512), each against the ``torch`` engine's result.
7. The LM kernels through ``kernels/ops.py``, at the widths of
   ``repro_torch.configs``, on data drawn from ``--seed`` by a
   ``torch.Generator`` on the card, each path against its
   ``use_kernel=False`` oracle: granite-moe-1b-a400m's expert FFN (the
   three expert GEMMs of K8, E = 32, D = 1024, F = 512, 4,096 tokens at
   the dropless capacity C = 4,096; bf16, and f32 once);
   recurrentgemma-9b's local attention (K9, B = 1, T = 32,768, 16 heads
   of 256, window 2,048, the single kv head expanded to 16; bf16, and
   f32 once) and gemma3-1b's (4 heads, window 512; bf16); rwkv6-3b's
   WKV6 (K10, B = 8,
   T = 4,096, 40 heads of 64; bf16 and f32); recurrentgemma-9b's RG-LRU
   (K11, B = 8, T = 4,096, D = 4,096; bf16 and f32).

Every path is timed (CUDA events, median of 10 after 2 warm-ups) and its
peak memory read.  Then one counted run, with the launch counts zeroed
just before it and read just after, records the inputs of every kernel
it launches and how many calls each made; it fails if a kernel the path
runs was not launched, or if the recorded calls do not account for
every launch.  Then one call is traced with ``torch.profiler`` after a
warm-up step with every event kept (device time by kernel and the
device's idle share: ``PROFILE`` lines); a trace that holds another
number of launches of a kernel than the launch counts, or less device
time for a kernel than the sum of its launches' bounds (the profiler's
clock drifts), is taken again with twice the idle padding around the
traced call (from 0.25 s for each path), and the run fails after six
such traces.  The fused chain on ``cuda`` launches K3 over the chain's
work items and the combine of their partial rows.  Per kernel, on the
inputs the path gave it: the kernel against its plain PyTorch version
(tolerance ``1e-4 * max(1, max|plain|)``: float32 with another
summation order; for bf16 results, where a float32 sum in another order
can move a value across a bf16 rounding boundary, element by element the
smaller of ``1e-2 * max(1, max|plain|)`` and ``2**-7 * |plain| + 2**-4
* rms(plain)``: :func:`max_err`), kernel / plain / library-call times,
for every kernel with a library call also its time and the library
call's over ten calls back to back (``ms_back_to_back``,
``library_ms_back_to_back``: the host's work to launch one call then
overlaps the device's work on the one before), achieved rates
(``achieved_tflop_s``, ``achieved_tb_s``; a ``TENSOR_CORES`` line beside
the bound for K8 in bf16, on wgmma),
and the least time the card could take for the same work (bytes over
3.35 TB/s, or operations over the peak for their type, whichever is
larger: 989 TFLOP/s for bf16 matrix products on the tensor cores (K8,
K9), 67 TFLOP/s float32 for everything else, which runs on the CUDA
cores).

Float32 products run in full float32: TF32 is switched off for matmul
and cuDNN.  The last three lines are the ``kernels`` summary, the card's
name and power limit from ``nvidia-smi`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))
NELL2_SHAPE = (12092, 9184, 28818)
NNZ = 16_000_000
NIPS_SHAPE = (2482, 2862, 14036, 17)     # FROSTT nips
NIPS_NNZ = 3_101_609
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
MOE_TOKENS = 4096                # K8's tokens per expert-FFN call
# the autotuned phase keeps the longest head of the model ranking whose
# every candidate's largest buffer stays under this (the card has 80 GB;
# the operand, its layouts and the other buffers of a call need the rest)
FIT_BYTES = 24 * 2**30
# kernel stem -> its name in a profiler trace
TRACE_NAMES = {stem: f"spttn::{stem}_kernel<" for stem in (
    "reduce", "product", "splitk", "combine", "chain", "mttkrp", "ttmc",
    "tttp", "grouped_matmul", "local_attn", "wkv6", "rglru")}
# the kernels whose work is a matrix product (bound by the tensor cores
# in bf16); the LM wrappers' modules
MATMUL_STEMS = ("grouped_matmul", "local_attn")
LM_STEMS = ("grouped_matmul", "local_attn", "wkv6", "rglru")


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2, calls: int = 1) -> float:
    """Median CUDA-event time of ``fn`` in ms: of one call (the host's
    work to launch it included), or with ``calls`` > 1 of that many calls
    back to back, over their count (the host's work then overlaps the
    device's)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def max_err(got, want) -> tuple[float, float]:
    """Max |got - want| and the largest ratio of |got - want| to its
    tolerance.  The tolerance is 1e-4 * max(1, max|want|); for a bf16
    result, the smaller of 1e-2 * max(1, max|want|) and, element by
    element, 2**-7 * |want| + 2**-4 * rms(want): one bf16 ulp of the
    value, and a floor far below a typical value for the float32 sums
    that a bf16 rounding turns into ulps (K9's plain version rounds
    ``p`` after another running maximum than the kernel's)."""
    import torch
    got = torch.as_tensor(got)
    bf16 = got.dtype == torch.bfloat16
    got = got.double().cpu()
    want = torch.as_tensor(want).double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values in a result")
    if not want.numel():
        return 0.0, 0.0
    diff = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    tol = torch.full_like(want, (1e-2 if bf16 else 1e-4) * scale)
    if bf16:
        rms = float(want.square().mean().sqrt())
        tol = torch.minimum(tol, 2.0 ** -7 * want.abs() + 2.0 ** -4 * rms)
    ratio = torch.where(diff > 0, diff / tol, 0.0)
    return float(diff.max()), float(ratio.max())


def check(name: str, got, want) -> float:
    err, ratio = max_err(got, want)
    ok = ratio <= 1.0
    log(f"check {name}: max_abs_err={err!r} worst_err/tol={ratio!r} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: an error is {ratio} times its "
                             f"tolerance (max_abs_err {err})")
    return err


def ptxas_kernels(report: str) -> list[dict]:
    """Registers, spills and static shared memory of every kernel in the
    build's ``ptxas -v`` report, by the kernel's stem (its mangled name
    holds ``<len><stem>_kernel``) and its mangled name."""
    import re
    recs, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            stem = next((st for st in TRACE_NAMES
                         if f"{len(st) + 7}{st}_kernel" in name), None)
            cur = {"stem": stem, "kernel": name}
            recs.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(m.group(1)) if m else 0
    return recs


def profile_path(label: str, fn, event_ms: float, need_ms: dict,
                 pad_s: float = 0.25, attempts: int = 6) -> None:
    """Device time by kernel for one call of ``fn`` (torch.profiler), and
    the device's idle share of the call's unprofiled CUDA-event time.

    One warm-up step runs under the profiler before the traced step (the
    first profiled call lost launches), and every event is kept
    (``acc_events``).  A trace is complete when, for every kernel of
    this package, the traced step's launches equal its launch count over
    the same call, and its traced device time is at least ``need_ms``,
    the sum of its launches' bounds (the least time the card could take
    for their work).  The profiler places device events by a clock that
    drifts from the host's during a run (its own warnings read "GPU op
    timestamp < runtime timestamp" by 30 ms, then 105 ms 13 s later): it
    drops what falls outside the traced step, and once put a kernel's
    device time under its bound.  So the traced call is padded with
    ``pad_s`` of idle host time on both sides, and an incomplete trace is
    taken again with twice the padding, up to ``attempts`` times; each
    retake is logged with the check that failed (``launches`` or
    ``clock``).  The ``PROFILE`` line gives the attempts and the padding;
    the run fails when no trace was complete."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import native
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pad_s)
            native.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            prof.step()
        counts = native.launch_counts()
        # the step annotation spans the whole step: it is no device work
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        traced = {stem: sum(e.count for e in events if name in e.key)
                  for stem, name in TRACE_NAMES.items()}
        device_ms = {stem: sum(e.self_device_time_total for e in events
                               if name in e.key) / 1e3
                     for stem, name in TRACE_NAMES.items()}
        short = {stem: [device_ms[stem], need]
                 for stem, need in need_ms.items()
                 if counts[stem] and device_ms[stem] < need}
        why = (["launches"] if traced != counts else []) + \
            (["clock"] if short else [])
        if not why:
            break
        log(f"PROFILE {label}: attempt {attempt} (padding {pad_s} s) "
            f"retaken for its {' and '.join(why)}: {len(events)} kinds of "
            f"device event; the trace holds launches {traced}, the launch "
            f"counts say {counts}; [traced ms, launches x bound ms] under "
            f"the bound: {short}")
        pad_s *= 2
    else:
        raise AssertionError(f"PROFILE {label}: no complete trace in "
                             f"{attempts} attempts")
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events), reverse=True)
    busy = sum(r[0] for r in rows)
    log("PROFILE " + json.dumps({
        "path": label, "event_ms": event_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / event_ms if rows else None,
        "launches": counts, "attempts": attempt, "padding_s": pad_s,
        "kernel_device_ms": {s: device_ms[s] for s in need_ms},
        "kernel_bound_ms": need_ms,
        "top": [{"kernel": k[:100], "calls": c, "device_ms": t}
                for t, c, k in rows[:12]]}))


# --------------------------------------------------------------------- #
# capture the kernels' inputs through the lowering registry and wrappers
# --------------------------------------------------------------------- #
def recording_lowerings(sink: dict, calls: collections.Counter):
    """Shadow the two registered Hopper lowerings with recorders that
    keep the first inputs of each (kind, target, expr), count its calls
    in ``calls`` and delegate."""
    from repro_torch.kernels.codegen.ir import (Lowering, get_lowering,
                                                register_lowering)

    # the sink lives on the instances, which ``restore`` drops: a class
    # sits in a reference cycle, so methods closing over ``sink`` would
    # keep the recorded tensors alive until a gc pass
    class Recorder(Lowering):
        def __init__(self, inner, sink, calls):
            self.inner, self.target = inner, inner.target
            self.sink, self.calls = sink, calls

        def record(self, key, ir, args):
            self.sink.setdefault(key, (ir, *args))
            self.calls[key] += 1

        def reduce(self, ir, *args):
            self.record(("reduce", self.target, ir.stage.expr), ir, args)
            return self.inner.reduce(ir, *args)

        def product(self, ir, *args):
            self.record(("product", self.target, ir.stage.expr), ir, args)
            return self.inner.product(ir, *args)

        def chain(self, ir, *args):
            self.record(("chain", self.target, chain_expr(ir)), ir, args)
            return self.inner.chain(ir, *args)

    inners = [get_lowering(t) for t in ("hopper", "hopper-splitk")]
    for inner in inners:
        register_lowering(Recorder(inner, sink, calls))
    return lambda: [register_lowering(i) for i in inners]


def chain_expr(ir) -> str:
    return " -> ".join([ir.stage.expr] + [link.expr for link in ir.links])


# every module that calls the segment-combine kernel, and what it sums
COMBINE_CALLERS = {"repro_torch.core.executor": "segment sum",
                   "repro_torch.kernels.codegen.lower_gpu": "split-K",
                   "repro_torch.kernels.codegen.stages": "K3 items"}


def recording_combines(sink: dict, calls: collections.Counter):
    """Shadow ``segment_combine`` in each module that calls it with a
    recorder that keeps the first inputs of each (caller, rows shape,
    nseg), counts the calls that launch the kernel in ``calls`` and
    delegates.  The returned ``restore()`` puts the kernel wrapper back
    and returns how many recorded calls launched the kernel."""
    import importlib
    mods = [importlib.import_module(m) for m in COMBINE_CALLERS]
    inner = mods[0].segment_combine
    launched = [0]

    def recorder(site):
        def combine(rows, ptr, nseg):
            key = (site, tuple(rows.shape), nseg)
            sink.setdefault(key, (rows, ptr, nseg))
            launches = bool(rows.is_cuda and nseg * rows.shape[1])
            calls[key] += launches
            launched[0] += launches
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


PAPER_WRAPPERS = ("mttkrp_kernel", "ttmc_kernel", "tttp_kernel")


def recording_paper(sink: dict, calls: collections.Counter):
    """Shadow the K5-K7 wrappers (which ``kernels/ops.py`` calls through
    ``kernels.paper``) with recorders of their first inputs and their
    number of calls."""
    from repro_torch.kernels import paper
    inners = {n: getattr(paper, n) for n in PAPER_WRAPPERS}

    def recorder(name):
        def wrapper(*args, **kwargs):
            sink.setdefault(name, (args, kwargs))
            calls[name] += 1
            return inners[name](*args, **kwargs)
        return wrapper

    for name in PAPER_WRAPPERS:
        setattr(paper, name, recorder(name))
    return lambda: [setattr(paper, n, f) for n, f in inners.items()]


def recording_lm(sink: dict, calls: collections.Counter):
    """Shadow the K8-K11 wrappers (which ``kernels/ops.py`` calls through
    their modules) with recorders of the first inputs of each (stem,
    shapes, dtype) and its number of calls."""
    import importlib
    mods = {stem: importlib.import_module(f"repro_torch.kernels.{stem}")
            for stem in LM_STEMS}
    inners = {stem: getattr(m, f"{stem}_kernel") for stem, m in mods.items()}

    def recorder(stem):
        def wrapper(*args):
            key = (stem, tuple(tuple(a.shape) for a in args
                               if hasattr(a, "shape")), args[0].dtype)
            sink.setdefault(key, args)
            calls[key] += 1
            return inners[stem](*args)
        return wrapper

    for stem, mod in mods.items():
        setattr(mod, f"{stem}_kernel", recorder(stem))
    return lambda: [setattr(mods[s], f"{s}_kernel", f)
                    for s, f in inners.items()]


def band_keys(T: int, window: int) -> int:
    """Keys inside the causal band of width ``window``, summed over the
    ``T`` query positions."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def sdpa_band(q, k, v, window: int):
    """The library yardstick of K9: ``scaled_dot_product_attention`` on
    the memory-efficient backend with the band as a boolean mask (the
    math backend would materialize the (BH, T, T) logits), or None and
    the reason when no backend takes it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[1]
    i = torch.arange(T, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def lib():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask)[0]
    try:                       # the yardstick only: the port never calls it
        lib()
        torch.cuda.synchronize()
    except (RuntimeError, torch.OutOfMemoryError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return lib, "F.scaled_dot_product_attention, EFFICIENT_ATTENTION, " \
        "boolean band mask"


def lm_entries(captured: dict, calls: collections.Counter) -> list:
    """Each captured K8-K11 call, as :func:`stage_entries`."""
    import importlib

    import torch
    from repro_torch.kernels import native
    out = []
    for (stem, shapes, dtype), args in captured.items():
        mod = importlib.import_module(f"repro_torch.kernels.{stem}")
        kern = getattr(mod, f"{stem}_kernel")
        plain = getattr(mod, f"{stem}_plain")
        isz = args[0].element_size()
        lib, note = None, "no single PyTorch call computes it"
        if stem == "grouped_matmul":
            x, w = args
            E, C, D = x.shape
            F = w.shape[2]
            nbytes = (E * C * D + E * D * F + E * C * F) * isz
            ops = 2 * E * C * D * F

            def lib(x=x, w=w):
                return torch.bmm(x, w)
            note = "torch.bmm"
        elif stem == "local_attn":
            q, k, v, window = args
            BH, T, D = q.shape
            nbytes = 4 * BH * T * D * isz
            ops = 4 * D * BH * band_keys(T, window)   # QK and PV
            lib, note = sdpa_band(q, k, v, window)
        elif stem == "wkv6":
            r = args[0]
            BH, T, K = r.shape
            nbytes = (5 * BH * T * K + BH * K) * isz
            # per step: r S (2K^2), the state's multiply and FMA (3K^2);
            # r u k summed (3K), its product with v added (2K) and the
            # decay exp(-exp(w)) (2K)
            ops = BH * T * (5 * K * K + 7 * K)
        else:
            B, T, D = args[0].shape
            nbytes = 3 * B * T * D * isz
            ops = 8 * B * T * D
        log(f"library {stem} {shapes}: {note}")
        label = " ".join(map(str, shapes)) + f" {str(dtype)[6:]}"
        out.append(Entry(stem, native.KERNELS[stem].name, label, "ops",
                         lambda kern=kern, a=args: kern(*a),
                         lambda plain=plain, a=args: plain(*a),
                         lib, nbytes, ops, dtype,
                         calls[stem, shapes, dtype]))
    return out


def stage_nbytes(stage, nrows: int, itemsize: int) -> int:
    return sum((nrows if op.fiber else 1) * op.flat_dim * itemsize
               for op in stage.operands)


def table_nbytes(tables) -> int:
    return sum(t.numel() * 4 for t in (tables.out_ptr, tables.a_idx,
                                       tables.b_idx))


def peak(stem: str, dtype) -> tuple[float, str]:
    """The operation rate that bounds kernel ``stem`` in ``dtype``."""
    import torch
    if dtype == torch.bfloat16 and stem in MATMUL_STEMS:
        return BF16_TENSOR_OPS_PER_S, "989 TFLOP/s bf16 tensor cores"
    return FP32_OPS_PER_S, "67 TFLOP/s float32"


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Entry(NamedTuple):
    """One kernel call of a counted run, on the inputs it was given:
    ``kern`` and ``plain`` run it again, ``lib`` is one PyTorch call for
    the same function or None, and ``nbytes`` and ``ops`` are the work
    of ``kern`` (its ``KERNEL_PHASE`` bound).  The counted run made
    ``calls`` such calls, each one launch of ``stem`` whose own work is
    ``launch_work`` (``(nbytes, ops)`` when None; K3's wrapper launches
    the combine too).  ``measured`` False marks a launch that gets no
    record of its own (a K2 already measured on the other target, the
    K4 inside the split-K chain): it counts only towards the trace's
    bound."""

    stem: str
    name: str
    stage: str
    where: str
    kern: Callable
    plain: Callable | None
    lib: Callable | None
    nbytes: int
    ops: int
    dtype: object
    calls: int
    launch_work: tuple[int, int] | None = None
    measured: bool = True

    def launch_bound_ms(self) -> float:
        """The least time the card could take for one launch of ``stem``
        of this call."""
        nbytes, ops = self.launch_work or (self.nbytes, self.ops)
        return bound(nbytes, ops, peak(self.stem, self.dtype)[0])[0]


def chain_entry(ir, args, target: str, calls: int) -> Entry:
    """A captured K3 call as a :func:`stage_entries` entry: the chain
    kernel over the work items, which writes one partial row an item,
    and the combine that reads them back and writes the output."""
    import torch
    from repro_torch.kernels.codegen import stages
    layout, tables, link_tables, padded, link_arrays, dtype = args
    st, items = ir.stage, layout.items
    P = layout.padded_len
    isz = torch.empty((), dtype=dtype).element_size()
    w_out = ir.links[-1].out_flat_dim
    part_bytes = items.nitems * w_out * isz
    nbytes = (stage_nbytes(st, P, isz) + P * 4 + table_nbytes(tables)
              + layout.levels.numel() * 4 + items.item_block.numel() * 8
              + part_bytes)
    ops = 2 * P * int(tables.a_idx.numel()) + P * st.out_flat_dim
    for j, (link, arr, tab) in enumerate(zip(ir.links, link_arrays,
                                             link_tables)):
        nbytes += arr.numel() * isz + table_nbytes(tab)
        ops += 2 * ir.nseg_lvls[j] * int(tab.a_idx.numel())
    launch_work = (nbytes, ops)
    nbytes += (part_bytes + items.item_ptr.numel() * 8
               + ir.nseg_out * w_out * isz)
    ops += items.nitems * w_out

    def kern():
        return stages.run_fused_chain_stage(ir, *args)

    def plain():
        return stages.run_fused_chain_stage_plain(ir, layout, padded,
                                                  link_arrays, dtype)

    return Entry("chain", "K3 fused chain", chain_expr(ir), target, kern,
                 plain, None, nbytes, ops, dtype, calls, launch_work)


def splitk_entry(st, tables, mask, padded, dtype, expr, target,
                 calls: int, measured: bool = True) -> Entry:
    """K4's partials of ``st`` as a :func:`stage_entries` entry."""
    import torch
    from repro_torch.kernels.codegen import lower_gpu, stages
    P = mask.shape[0]
    isz = torch.empty((), dtype=dtype).element_size()
    w = st.out_flat_dim
    nbytes = (stage_nbytes(st, P, isz) + P * 4 + table_nbytes(tables)
              + P // st.block * w * isz)

    def kern():
        return lower_gpu.splitk_partials(st, tables, mask, padded)

    def plain():
        return stages.block_partials_plain(st, mask, padded)

    return Entry("splitk", "K4 split-K partials", expr, target, kern, plain,
                 None, nbytes, 2 * P * int(tables.a_idx.numel()) + P * w,
                 dtype, calls, measured=measured)


def stage_entries(captured: dict, calls: collections.Counter) -> list:
    """Each captured stage call as an :class:`Entry`."""
    import torch
    from repro_torch.kernels.codegen import stages
    from repro_torch.kernels.codegen.ir import get_lowering
    out = []
    for key, (ir, *args) in captured.items():
        kind, target, expr = key
        n = calls[key]
        if kind == "chain":
            if target == "hopper":
                out.append(chain_entry(ir, args, target, n))
            else:   # K4 + combine + einsum: no kernel of its own
                layout, tables, _, padded, link_arrays, dtype = args
                check(f"split-K chain {expr}",
                      get_lowering(target).chain(ir, *args),
                      stages.run_fused_chain_stage_plain(
                          ir, layout, padded, link_arrays, dtype))
                out.append(splitk_entry(ir.stage, tables, layout.mask,
                                        padded, dtype, expr, target, n,
                                        measured=False))
            continue
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
            # on "hopper-splitk" the same K2 as on "hopper"
            out.append(Entry("product", "K2 product", expr, target, kern,
                             plain, lib, nbytes, 2 * nrows * nterms, dtype,
                             n, measured=target == "hopper"))
            continue
        tables, block_ptr, mask, padded, dtype = args
        if target != "hopper":
            out.append(splitk_entry(st, tables, mask, padded, dtype, expr,
                                    target, n))
            continue
        P = mask.shape[0]
        isz = torch.empty((), dtype=dtype).element_size()

        def kern(st=st, tables=tables, block_ptr=block_ptr, mask=mask,
                 padded=padded, dtype=dtype):
            return stages.run_reduce_stage(st, tables, block_ptr, mask,
                                           padded, dtype)

        def plain(st=st, block_ptr=block_ptr, mask=mask, padded=padded,
                  dtype=dtype):
            return stages.run_reduce_stage_plain(st, block_ptr, mask,
                                                 padded, dtype)

        nbytes = (stage_nbytes(st, P, isz) + P * 4 + table_nbytes(tables)
                  + block_ptr.numel() * 8 + st.nseg * w * isz)
        out.append(Entry("reduce", "K1 reduce", expr, target, kern, plain,
                         None, nbytes,
                         2 * P * int(tables.a_idx.numel()) + P * w, dtype,
                         n))
    return out


def combine_entries(captured: dict, calls: collections.Counter,
                    backend: str, seen: set) -> list:
    """Each captured segment-combine call, as :func:`stage_entries`; a
    shape measured on an earlier path (in ``seen``) is not measured
    again."""
    import torch
    from repro_torch.kernels.segment import (segment_combine,
                                             segment_combine_plain)
    out = []
    for key, (rows, ptr, nseg) in captured.items():
        site, (n, w), _ = key

        def kern(rows=rows, ptr=ptr, nseg=nseg):
            return segment_combine(rows, ptr, nseg)

        def plain(rows=rows, ptr=ptr, nseg=nseg):
            return segment_combine_plain(rows, ptr, nseg)

        def lib(rows=rows, ptr=ptr):
            return torch.segment_reduce(rows, "sum", offsets=ptr, axis=0)

        nbytes = (n + nseg) * w * rows.element_size() + ptr.numel() * 8
        out.append(Entry("combine", "K4 segment combine",
                         f"{site} ({n}, {w}) -> ({nseg}, {w})", backend,
                         kern, plain, lib, nbytes, n * w, rows.dtype,
                         calls[key], measured=key not in seen))
    return out


def paper_entries(captured: dict, calls: collections.Counter) -> list:
    """Each captured K5-K7 call, as :func:`stage_entries`."""
    import torch
    from repro_torch.kernels import native, paper
    out = []
    for name, (args, kwargs) in captured.items():
        kern = getattr(paper, name)
        plain = getattr(paper, name + "_plain")
        if name == "mttkrp_kernel":
            vals, bg, cg, mask, block_ptr, nseg, block = args
            P, R = bg.shape
            isz = bg.element_size()
            nbytes = (P * isz + 2 * P * R * isz + P * 4
                      + block_ptr.numel() * 8 + nseg * R * isz)
            ops, lib = 3 * P * R + P, None
            stem, label = "mttkrp", f"({P}, {R}) -> ({nseg}, {R})"
        elif name == "ttmc_kernel":
            ug, xf, block_ptr, nseg, block = args
            P, R = ug.shape
            S = xf.shape[1]
            isz = ug.element_size()
            nbytes = (P * (R + S) * isz + block_ptr.numel() * 8
                      + nseg * R * S * isz)
            ops, lib = 2 * P * R * S, None
            stem, label = "ttmc", f"({P}, {R}) x ({P}, {S}) -> " \
                f"({nseg}, {R}, {S})"
        else:
            vals, ug, vg, wg = args
            n, R = ug.shape
            isz = ug.element_size()
            nbytes = n * isz + 3 * n * R * isz + n * isz
            ops = 3 * n * R + n
            stem, label = "tttp", f"3 x ({n}, {R}) -> ({n},)"

            def lib(vals=vals, ug=ug, vg=vg, wg=wg):
                return torch.einsum("n,nr,nr,nr->n", vals, ug, vg, wg)

        out.append(Entry(stem, native.KERNELS[stem].name, label, "ops",
                         lambda kern=kern, a=args, k=kwargs: kern(*a, **k),
                         lambda plain=plain, a=args: plain(*a),
                         lib, nbytes, ops, args[1].dtype, calls[name]))
    return out


def measure(entries: list, spec_name: str) -> list[dict]:
    """Each measured entry: kernel vs plain on the same inputs, then
    kernel / plain / library times and the bound."""
    import torch
    out = []
    for e in entries:
        if not e.measured:
            continue
        stem, name, stage, where, kern, plain, lib, nbytes, ops = e[:9]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = check(f"{name} {stage} ({spec_name}, {where})", got, want)
        dtype = got.dtype
        ops_per_s, peak_name = peak(stem, e.dtype)
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, ops, ops_per_s)
        rec = {"stem": stem, "name": name, "stage": stage,
               "spec": spec_name, "where": where, "dtype": str(dtype),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "peak": peak_name, "library_ms": lib_ms, "bytes": nbytes,
               "ops": ops, "achieved_tflop_s": ops / ms / 1e9,
               "achieved_tb_s": nbytes / ms / 1e9}
        # beside a library call, both again over ten calls back to back
        rec["ms_back_to_back"], rec["library_ms_back_to_back"] = (
            (time_ms(kern, reps=3, warmup=1, calls=10),
             time_ms(lib, reps=3, warmup=1, calls=10))
            if lib is not None else (None, None))
        log("KERNEL_PHASE " + json.dumps(rec))
        if stem == "grouped_matmul" and dtype == torch.bfloat16:
            log(f"TENSOR_CORES {name} {stage}: {ops / ms / 1e9!r} TFLOP/s "
                f"achieved in {ms!r} ms; the bound is {bound_ms!r} ms "
                f"({ops_per_s / 1e12:g} TFLOP/s bf16, {bound_by})")
        out.append(rec)
    return out


class Driver:
    """Drives one path after another and keeps what the summary needs:
    the launches of every counted run and the per-kernel records."""

    def __init__(self):
        from repro_torch.kernels import native
        self.launches = {stem: 0 for stem in native.KERNELS}
        self.records: list[dict] = []
        self.seen: set = set()         # combine calls measured already

    def drive(self, label: str, run, expect=(), measure_as=None):
        """Run ``run`` as a user would (peak memory, time), then once
        counted with every kernel's inputs recorded, then traced (the
        trace is held to the counted run's launches and their bounds).
        Fails unless each stem in ``expect`` launched in the counted run,
        and unless the recorded calls account for every launch.  Returns
        the counted run's result (a tuple in ``expect`` needs any one of
        its stems)."""
        import torch

        from repro_torch.kernels import native
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = time_ms(run)
        sinks = {k: ({}, collections.Counter())
                 for k in ("stage", "combine", "paper", "lm")}
        restore = recording_lowerings(*sinks["stage"])
        restore_combines = recording_combines(*sinks["combine"])
        restore_paper = recording_paper(*sinks["paper"])
        restore_lm = recording_lm(*sinks["lm"])
        native.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        counts = native.launch_counts()
        restore()
        restore_paper()
        restore_lm()
        recorded = restore_combines()
        if recorded != counts["combine"]:
            raise AssertionError(
                f"{counts['combine']} combine launches, {recorded} "
                f"recorded: a caller of the combine is not recorded")
        missing = [s for s in expect
                   if not any(counts[x] for x in
                              (s if isinstance(s, tuple) else (s,)))]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} of this "
                                 f"path were not launched")
        for stem, n in counts.items():
            self.launches[stem] += n
        log(f"path {label}: {ms!r} ms, launches {counts}, "
            f"peak {peak:.2f} GiB")
        entries = (stage_entries(*sinks["stage"])
                   + combine_entries(*sinks["combine"], label, self.seen)
                   + paper_entries(*sinks["paper"])
                   + lm_entries(*sinks["lm"]))
        self.seen.update(sinks["combine"][0])
        need = {}
        for stem, n in counts.items():
            mine = [e for e in entries if e.stem == stem]
            if sum(e.calls for e in mine) != n:
                raise AssertionError(
                    f"{label}: {n} launches of {stem}, but its recorded "
                    f"calls account for {[e.calls for e in mine]}")
            if n:
                need[stem] = sum(e.calls * e.launch_bound_ms()
                                 for e in mine)
        profile_path(label, run, ms, need)
        self.records += measure(entries, measure_as or label)
        del sinks, entries
        return got


def largest_buffer_bytes(spec, cand, levels, itemsize: int = 4) -> int:
    """The largest array one call of candidate ``cand`` makes, from the
    engines' rules: a term over a CSF prefix works on fiber rows (padded
    per segment to block multiples by the code generator's row and chain
    layouts: at most ``nfib + nseg * block`` rows); any other term runs
    densely, on every operand materialized over its whole index space."""
    import math

    from repro_torch.analysis.invariants import fusible_chains
    dims = spec.dims
    spos = {s: i for i, s in enumerate(spec.sparse_indices)}

    def slv(inds):
        return max((spos[i] + 1 for i in inds if i in spos), default=0)

    def prefix(inds):
        sp = sorted(spos[i] for i in inds if i in spos)
        return sp == list(range(len(sp)))

    def dense(inds):
        return math.prod(dims[i] for i in inds if i not in spos)

    def nfib(lvl):
        return levels[lvl] if lvl > 0 else 1

    block = cand.block or 0
    fiber = {t.name for t in spec.inputs if t.is_sparse}
    chain_terms = {k for tids in (fusible_chains(spec, cand.path).values()
                                  if cand.fused else ()) for k in tids}
    biggest = 0
    for tid, term in enumerate(cand.path):
        lvl, out_lvl = slv(term.indices), slv(term.out.indices)
        ops = (term.lhs, term.rhs)
        on_fibers = (lvl and prefix(term.indices)
                     and any(o.name in fiber for o in ops))
        if on_fibers and (prefix(term.out.indices)
                          or term.out.name == "OUT"):
            rows = nfib(lvl)
            if block and (tid in chain_terms or out_lvl < lvl):
                rows += nfib(out_lvl) * block       # padded layout
            sizes = [rows * dense(o.indices) for o in ops]
            sizes.append(nfib(out_lvl) * dense(term.out.indices))
            if out_lvl > 0 and term.out.name != "OUT":
                fiber.add(term.out.name)
        else:
            sizes = [math.prod(dims[i] for i in o.indices) for o in ops]
            sizes.append(math.prod(dims[i] for i in term.out.indices))
        biggest = max(biggest, *sizes)
    return biggest * itemsize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.autotune import TunerConfig, generate_candidates
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.core import spec as S
        from repro_torch.core.executor import (CSFArrays, execute_plan,
                                               factors_to_torch,
                                               reference_execute,
                                               segment_sum)
        from repro_torch.core.planner import plan
        from repro_torch.kernels import native, ops
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
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        log(f"PHASE {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # -- 1. build ------------------------------------------------------ #
    path, secs, report = native.build()
    native.load_library()
    log(f"build: {secs:.1f} s -> {os.path.relpath(path, REPO)}")
    for rec in ptxas_kernels(report):
        log("PTXAS " + json.dumps(rec))
    phase_done("1 build")

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
            for s in ("row", "segsum", "auto", "fused")]
        for backend, kw in runs:
            out = execute_plan(p, small_arrays, f, backend=backend, **kw)
            torch.cuda.synchronize()
            check(f"small {spec.output.indices} {backend} "
                  f"{kw.get('strategy', '')}", out, ref)
    phase_done("2 small tensor")

    # -- 3. the main path at full size --------------------------------- #
    t0 = time.perf_counter()
    total = int(np.prod([float(s) for s in NELL2_SHAPE]))
    coo = random_sparse(NELL2_SHAPE, NNZ / total, seed=args.seed,
                        distribution="frostt")
    csf = build_csf(coo)
    levels = csf.nnz_levels()
    log(f"tensor: shape {NELL2_SHAPE} nnz {coo.nnz} levels {levels} "
        f"built in {time.perf_counter() - t0:.1f} s")
    if coo.nnz != NNZ:
        raise AssertionError(f"expected {NNZ} nonzeros, got {coo.nnz}")
    arrays = CSFArrays.from_csf(csf, dev)
    phase_done("3a tensor")

    drv = Driver()
    I, J, K = NELL2_SHAPE
    specs = {"MTTKRP": S.mttkrp(I, J, K, 64),
             "TTMc3": S.ttmc3(I, J, K, 16, 16),
             "TTTP3": S.tttp3(I, J, K, 64)}
    factors = {name: factors_to_torch(factors_for(spec), dev)
               for name, spec in specs.items()}
    cases = [("MTTKRP", ("cuda", "cuda-splitk")), ("TTMc3", ("cuda",)),
             ("TTTP3", ("cuda",))]
    expect = {("MTTKRP", "torch"): ("combine",),
              ("MTTKRP", "cuda"): ("product", "combine", "reduce"),
              ("MTTKRP", "cuda-splitk"): ("product", "combine", "splitk"),
              ("TTMc3", "torch"): ("combine",),
              ("TTMc3", "cuda"): ("product", "combine", "reduce"),
              ("TTTP3", "torch"): (), ("TTTP3", "cuda"): ("product",)}
    torch_out = {}
    for name, backends in cases:
        spec, f = specs[name], factors[name]
        p = plan(spec, nnz_levels=levels)
        for backend in ("torch",) + backends:
            def run(p=p, f=f, backend=backend):
                return execute_plan(p, arrays, f, backend=backend)

            got = drv.drive(f"{name} {backend}", run,
                            expect=expect[name, backend], measure_as=name)
            if backend == "torch":
                torch_out[name] = got
            else:
                check(f"path {name} {backend} vs torch", got,
                      torch_out[name])
            del got
        torch.cuda.empty_cache()
    phase_done("3b main path")

    # -- 4. the autotuned path ----------------------------------------- #
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="plans-", dir=native.BUILD_DIR)
    blocks = (8,)
    for name in ("MTTKRP", "TTMc3"):
        spec, f = specs[name], factors[name]
        full = generate_candidates(spec, nnz_levels=levels, blocks=blocks,
                                   backends=("torch", "cuda",
                                             "cuda-splitk"))
        sizes = {c.key: largest_buffer_bytes(spec, c, levels)
                 for c in full}
        schedules: list = []
        for c in full:
            if (c.path, c.order) not in schedules:
                schedules.append((c.path, c.order))
        keep = 0
        for m in range(1, len(schedules) + 1):
            if all(sizes[c.key] <= FIT_BYTES for c in full
                   if (c.path, c.order) in schedules[:m]):
                keep = m
            else:
                break
        if keep == 0:
            raise AssertionError(f"{name}: the model's first schedule "
                                 f"does not fit")
        for c in full:
            log("CANDIDATE " + json.dumps({
                "spec": name, "path": [str(t) for t in c.path],
                "order": [list(a) for a in c.order],
                "backend": c.backend, "fused": c.fused, "block": c.block,
                "largest_GiB": sizes[c.key] / 2**30,
                "kept": (c.path, c.order) in schedules[:keep]}))
        cfg = TunerConfig(backends=("torch", "cuda", "cuda-splitk"),
                          blocks=blocks, max_candidates=keep)
        log(f"tune {name}: max_candidates={keep} of {len(schedules)} "
            f"schedules (every kept candidate under "
            f"{FIT_BYTES / 2**30:.0f} GiB)")
        native.reset_launch_counts()
        t0 = time.perf_counter()
        tuned = plan(spec, nnz_levels=levels, autotune=True, csf=arrays,
                     factors=f, cache_dir=cache_dir, tuner=cfg)
        torch.cuda.synchronize()
        st = tuned.stats
        log(f"tune {name}: {time.perf_counter() - t0:.1f} s, "
            f"{st.candidates_timed} timed, {st.executions} executions, "
            f"{st.pruned} pruned, launches {native.launch_counts()}")
        for m in st.measurements:
            c = m.candidate
            log("TUNED " + json.dumps({
                "spec": name, "path": [str(t) for t in c.path],
                "order": [list(a) for a in c.order], "backend": c.backend,
                "fused": c.fused, "block": c.block,
                "largest_GiB": sizes[c.key] / 2**30,
                "ms": m.seconds * 1e3, "pruned": m.pruned}))
        log(f"tune {name}: winner backend={tuned.backend} "
            f"fused={tuned.fused} block={tuned.block} "
            f"path={[str(t) for t in tuned.path]}")
        replay = {"torch": ("combine",),
                  "cuda": (("chain", "combine") if tuned.fused
                           else (("reduce", "product"),)),
                  "cuda-splitk": ("splitk", "combine")}[tuned.backend]

        def run(tuned=tuned, f=f):
            return execute_plan(tuned, arrays, f)

        got = drv.drive(f"{name} tuned ({tuned.backend}"
                        f"{' fused' if tuned.fused else ''})", run,
                        expect=replay, measure_as=name)
        check(f"path {name} tuned winner vs torch", got, torch_out[name])
        del got
        again = plan(spec, nnz_levels=levels, autotune=True, csf=arrays,
                     factors=f, cache_dir=cache_dir, tuner=cfg)
        if not again.stats.cache_hit or again.stats.executions != 0 \
                or again != tuned:
            raise AssertionError(
                f"{name}: the second plan(autotune=True) was no cache hit "
                f"with 0 executions: {again.stats}")
        log(f"tune {name}: second call cache_hit="
            f"{again.stats.cache_hit} executions={again.stats.executions}")
        torch.cuda.empty_cache()
    phase_done("4 autotuned path")

    # -- 5. the fused chain forced, on both code-generator engines ----- #
    def fused_paths(name, spec, arrays_, f, want, block):
        p = plan(spec, nnz_levels=arrays_.host.nnz_levels())
        for backend in ("cuda", "cuda-splitk"):
            fused = dataclasses.replace(p, backend=backend, fused=True,
                                        block=block)

            def run(fused=fused, f=f):
                return execute_plan(fused, arrays_, f)

            got = drv.drive(f"{name} {backend} fused", run,
                            expect=("chain", "combine") if backend == "cuda"
                            else ("splitk", "combine"), measure_as=name)
            check(f"path {name} {backend} fused vs torch", got, want)
            del got
        for key, entry in arrays_.cache.items():
            if key[0] == "chain" and key[-1] == block:
                _, lvl0, chain_levels, _ = key
                lay, items = entry[0], entry[2].items
                log(f"chain {name}: levels {lvl0} -> {list(chain_levels)}"
                    f", block {block}: P = {lay.padded_len} padded rows "
                    f"({lay.nblocks} blocks) for {arrays_.nfib[lvl0]} "
                    f"fibers; nitems {items.nitems}, cap {items.cap}")

    for name in ("MTTKRP", "TTMc3"):
        fused_paths(name, specs[name], arrays, factors[name],
                    torch_out[name], 8)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total = int(np.prod([float(s) for s in NIPS_SHAPE]))
    nips_coo = random_sparse(NIPS_SHAPE, NIPS_NNZ / total, seed=args.seed,
                             distribution="frostt")
    nips = build_csf(nips_coo)
    log(f"tensor nips: shape {NIPS_SHAPE} nnz {nips_coo.nnz} levels "
        f"{nips.nnz_levels()} built in {time.perf_counter() - t0:.1f} s")
    if nips_coo.nnz != NIPS_NNZ:
        raise AssertionError(f"expected {NIPS_NNZ} nonzeros, got "
                             f"{nips_coo.nnz}")
    nips_arrays = CSFArrays.from_csf(nips, dev)
    spec4 = S.ttmc4(*NIPS_SHAPE, 8, 8, 8)
    f4 = factors_to_torch(factors_for(spec4), dev)
    p4 = plan(spec4, nnz_levels=nips.nnz_levels())
    want4 = drv.drive("TTMc4 torch",
                      lambda: execute_plan(p4, nips_arrays, f4,
                                           backend="torch"),
                      expect=("combine",), measure_as="TTMc4")
    fused_paths("TTMc4", spec4, nips_arrays, f4, want4, 8)
    del want4, nips_arrays, f4
    torch.cuda.empty_cache()
    phase_done("5 fused chain")

    # -- 6. the paper kernels through kernels/ops.py ------------------- #
    b, c = factors["MTTKRP"]["B"], factors["MTTKRP"]["C"]
    lay5 = ops.mttkrp_layout(csf, 256)
    rows1 = arrays.fiber_coord[1][0]
    got = drv.drive("ops.mttkrp", lambda: ops.mttkrp(csf, b, c,
                                                     layout=lay5),
                    expect=("mttkrp",), measure_as="ops")
    check("ops.mttkrp vs MTTKRP torch", got, torch_out["MTTKRP"][rows1])
    f3 = factors["TTMc3"]
    u_name, v_name = (t.name for t in specs["TTMc3"].inputs
                      if not t.is_sparse)
    U, V = f3[u_name], f3[v_name]
    kidx = arrays.fiber_coord[3][2]
    xf = segment_sum(arrays, arrays.values[:, None] * V[kidx], 3, 2)
    ug = U[arrays.fiber_coord[2][1]]
    lay6 = ops.ttmc_fiber_layout(csf, 128)
    got = drv.drive("ops.ttmc_fiber",
                    lambda: ops.ttmc_fiber(ug, xf, lay6),
                    expect=("ttmc",), measure_as="ops")
    check("ops.ttmc_fiber vs TTMc3 torch", got, torch_out["TTMc3"][rows1])
    del xf, ug
    f7 = factors["TTTP3"]
    u7, v7, w7 = (f7[t.name] for t in specs["TTTP3"].inputs
                  if not t.is_sparse)
    got = drv.drive("ops.tttp", lambda: ops.tttp(csf, u7, v7, w7,
                                                 block=512),
                    expect=("tttp",), measure_as="ops")
    check("ops.tttp vs TTTP3 torch", got, torch_out["TTTP3"])
    del got
    phase_done("6 paper kernels")

    # -- 7. the LM kernels through kernels/ops.py ---------------------- #
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def rand(shape, dtype, lo, hi):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo)
                + lo).to(dtype)

    def lm_path(label, run, stem, measure_as):
        got = drv.drive(label, run, expect=(stem,), measure_as=measure_as)
        check(f"path {label} vs use_kernel=False", got,
              run(use_kernel=False))
        del got
        torch.cuda.empty_cache()

    # K8: granite-moe-1b-a400m's expert SwiGLU (src/repro/models/moe.py:
    # 91-95), MOE_TOKENS tokens at the dropless serving capacity C = N
    # (moe.py:114)
    moe = get_config("granite-moe-1b-a400m")
    E, D, Fe = moe.moe.n_experts, moe.d_model, moe.moe.d_expert
    C = max(8, -(-MOE_TOKENS // 8) * 8)
    for dtype in (moe.compute_dtype, torch.float32):
        xe = randn((E, C, D), dtype)
        wg, wu = (randn((E, D, Fe), dtype, D ** -0.5) for _ in range(2))
        wd = randn((E, Fe, D), dtype, Fe ** -0.5)

        def ffn(use_kernel=True, xe=xe, wg=wg, wu=wu, wd=wd):
            h = F.silu(ops.grouped_matmul(xe, wg, use_kernel)) \
                * ops.grouped_matmul(xe, wu, use_kernel)
            return ops.grouped_matmul(h, wd, use_kernel)

        lm_path(f"{moe.name} expert FFN {str(dtype)[6:]}", ffn,
                "grouped_matmul", moe.name)
        del xe, wg, wu, wd, ffn
    # K9: local attention at prefill_32k's length, batch cut to 1; the
    # kv heads expanded to the query heads inside the timed path
    # (recurrentgemma's band once in float32 too, held at 1e-4)
    T9 = SHAPES["prefill_32k"].seq_len
    for arch, dtype in (("recurrentgemma-9b", None),
                        ("recurrentgemma-9b", torch.float32),
                        ("gemma3-1b", None)):
        cfg = get_config(arch)
        dtype = dtype or cfg.compute_dtype
        q = randn((1, T9, cfg.n_heads, cfg.hd), dtype)
        k, v = (randn((1, T9, cfg.n_kv_heads, cfg.hd), dtype)
                for _ in range(2))

        def attn(use_kernel=True, q=q, k=k, v=v, H=cfg.n_heads,
                 window=cfg.window):
            return ops.local_attn(q, k.expand(-1, -1, H, -1),
                                  v.expand(-1, -1, H, -1), window,
                                  use_kernel)

        lm_path(f"{arch} local attention {str(dtype)[6:]}", attn,
                "local_attn", arch)
        del q, k, v, attn
    # K10: rwkv6-3b's WKV6 at train_4k's length, batch cut to 8
    rwkv = get_config("rwkv6-3b")
    B10, T10, H10, K10 = 8, SHAPES["train_4k"].seq_len, rwkv.n_heads, rwkv.hd
    for dtype in (rwkv.compute_dtype, torch.float32):
        r, k, v = (randn((B10, T10, H10, K10), dtype, 0.5) for _ in range(3))
        w = randn((B10, T10, H10, K10), dtype, 0.5, -1.0)
        u = randn((H10, K10), dtype, 0.5)

        def wkv(use_kernel=True, r=r, k=k, v=v, w=w, u=u):
            return ops.wkv6(r, k, v, w, u, use_kernel=use_kernel)

        lm_path(f"rwkv6-3b wkv6 {str(dtype)[6:]}", wkv, "wkv6", rwkv.name)
        del r, k, v, w, u, wkv
    # K11: recurrentgemma-9b's RG-LRU (width d_model) at train_4k's
    # length, batch cut to 8
    rg = get_config("recurrentgemma-9b")
    shape11 = (8, SHAPES["train_4k"].seq_len, rg.d_model)
    for dtype in (rg.compute_dtype, torch.float32):
        x11, a11 = randn(shape11, dtype), rand(shape11, dtype, 0.05, 0.98)

        def lru(use_kernel=True, x=x11, a=a11):
            return ops.rglru(x, a, use_kernel=use_kernel)

        lm_path(f"recurrentgemma-9b rglru {str(dtype)[6:]}", lru, "rglru",
                rg.name)
        del x11, a11, lru
    phase_done("7 LM kernels")

    missing = [s for s, n in drv.launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # -- summary ------------------------------------------------------- #
    # each kernel at its largest input in its configuration's own dtype
    # (the sparse specs' is float32)
    own = {cfg.name: str(cfg.compute_dtype)
           for cfg in (moe, get_config("gemma3-1b"), rwkv, rg)}
    summary = []
    for stem, info in native.KERNELS.items():
        rec = max((r for r in drv.records if r["stem"] == stem),
                  key=lambda r: (r["dtype"] == own.get(r["spec"],
                                                       str(torch.float32)),
                                 r["bytes"]))
        summary.append({
            "name": info.name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": drv.launches[stem],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "peak": rec["peak"], "shape": f"{rec['stage']} ({rec['spec']})"})
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
