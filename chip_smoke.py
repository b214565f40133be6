#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--seed N]

Phases (each ends in ``torch.cuda.synchronize()``, prints its seconds;
any failure exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together; sm_90a); a ``PTXAS`` line per kernel
   gives its registers, spills and static shared memory (a spill in a
   kernel of K10 or K11, or of K8 or K9 in either precision, fails the
   run; a ``PTXAS_NOTE`` line repeats each performance note, such as
   wgmma instructions serialized); a ``SASS`` line per bf16 kernel of K8 and
   K9 counts its wgmma (HGMMA) and TMA load (UTMALDG) instructions in
   the built library (``cuobjdump -sass``), and a kernel with none of
   either fails the run.
2. A small tensor (60 x 50 x 40, density 0.01) through every engine and
   strategy (the fused chain included), against the port's numpy
   Algorithm-2 ``reference_execute``; then (2b) K1 over the work items
   of a skewed layout, on each of its three paths, against its plain
   version (``K1 items`` lines), and (2c) K6 so, on its register-block
   path (16 x 16, and 128 x 128 in four column tiles) and its scalar
   walk (5 x 7) (``K6 items`` lines).
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
   ``mttkrp`` (K5 over its work items, then the combine of their
   partial rows; block 256), ``ttmc_fiber`` (K6 over K1's work items,
   then the combine; block 128; a ``HOST`` line gives the host-clock
   medians of the call's parts: layout upload, item cut, gathers,
   wrapper) and ``tttp`` (K7, block 512), each against the ``torch``
   engine's result.
7. The LM kernels through ``kernels/ops.py``, at the widths of
   ``repro_torch.configs``, on data drawn from ``--seed`` by a
   ``torch.Generator`` on the card, each path against its
   ``use_kernel=False`` oracle: granite-moe-1b-a400m's expert FFN (the
   three expert GEMMs of K8, E = 32, D = 1024, F = 512, 4,096 tokens at
   the dropless capacity C = 4,096; bf16, and f32 once);
   recurrentgemma-9b's local attention (K9, B = 1, T = 32,768, 16 heads
   of 256, window 2,048, the single kv head expanded to 16) and
   gemma3-1b's (4 heads, window 512), each in bf16 and f32; rwkv6-3b's
   WKV6 (K10, B = 8,
   T = 4,096, 40 heads of 64; bf16 and f32); recurrentgemma-9b's RG-LRU
   (K11, B = 8, T = 4,096, D = 4,096; bf16 and f32).
8. Memory-budgeted sliced execution on the 16 M tensor: MTTKRP at a
   1 GiB budget and TTTP3 at 2 GiB through ``execute_plan(...,
   memory_budget=)`` on ``"cuda"`` and ``"cuda-splitk"``.  The priced
   decisions must be MTTKRP ``a`` in 2 output chunks and TTTP3 ``r`` in 3
   contracted chunks; every kernel of the unsliced path must launch once
   a chunk; each result is held against the ``torch`` engine's unsliced
   one, and its peak memory must stay under the unsliced path's.  A
   ``SLICED`` line per run gives the decision (priced bytes), the sliced
   and unsliced path ms, both measured peaks and the launches.
9. The plan service (``PlanService``) dispatching MoE routing at
   granite-moe-1b-a400m's widths (4,096 tokens, 32 experts, top-8,
   d_model 1,024, dropless C = 4,096): 8 requests, the top-8 of normal
   logits from ``--seed``, 1 % of the tokens redrawn in requests 2-7,
   request 8 repeating request 1.  A ``SERVE`` line per request gives its
   tier (request 1 must be ``cold``, request 8 ``exact``), resolution
   seconds, dispatch ms, the winner's engine and the kernels launched;
   each output must equal a plain scatter of ``X``'s rows bit for bit.
   Then request 1 and its repeat through services with a 256 MiB budget
   (the tuned winner, and the ``cuda`` engine forced): ``d`` in 3 chunks,
   the same bits, one K2 launch a chunk on a code-generator engine.
   Phases 8 and 9 count each path's launches around one run (the counts
   zeroed just before it, read just after, and added to the summary's)
   and trace each sliced path and the hot and budgeted dispatches
   (``PROFILE`` lines); their kernels are not measured alone again (they
   are the stage kernels phases 3-5 measure, at other widths).
10. Distributed SpTTN (``repro_torch.distributed``) at nell-2's shape:
   the COO and factors written to a directory under ``_build/``, the
   single-device outputs and ms taken first, then four ranks spawned
   (gloo, a ``file://`` store, all on cuda:0: NCCL refuses two ranks on
   one GPU) that memory-map the COO and call the entry points as a user
   does: (a) ``make_distributed`` MTTKRP on ``(4,)``, (b)
   ``make_distributed_cuda`` MTTKRP on ``(2, 2)`` (modes i and j: an
   ``all_reduce`` over ``model``), (c) ``make_distributed_tuned`` TTMc3
   on ``(4,)`` over the ``torch``, ``cuda`` and ``cuda-splitk`` engines,
   (d) ``compressed_psum`` of 64 MB against the exact ``all_reduce``
   (within one scale unit of every rank's block) and
   ``reduce_scatter_grads``; then (e) ``make_distributed_cuda`` on a
   one-rank NCCL mesh in this process, mode i and mode j.  Every output
   (after ``undo_cyclic`` and the trim) is held to the single-device
   one, every rank's counted run must launch its engine's kernels, and
   a ``DIST`` line per case gives the mesh, nonzeros per shard (and
   the block partition's), seconds to partition and build, the call's
   ms (CUDA events between barriers, median of 10) beside the single
   device's, the engine's ms with no collective (all ranks at once, and
   each alone), each rank's peak and launches.  A rank that fails or
   hangs (300 s collective timeout) fails the run.
11. The model stack (``repro_torch.models``) and its continuous-batching
   ``Server`` (``repro_torch.serve``), which launch none of the kernels
   above (the reference's model stack reaches no Pallas kernel): (1)
   granite-moe-1b-a400m at full width in bf16 (24 layers, d_model 1,024,
   16 heads over 8 kv heads, 32 experts top-8 of 512, vocab 49,155
   padded to 49,280; 1,334,756,352 parameters from ``--seed``) serving 8
   requests of 16-192 prompt tokens and 32 new tokens each through
   ``Server(slots=4, cache_len=256)`` (a ``MODEL_SERVE`` line: run
   seconds, tokens per second, peak memory, decode-step ms with 4 slots,
   prefill ms by prompt length), then 20 decode steps traced (the
   device's busy share, a ``PROFILE`` line); (2) prefill of 63 tokens
   plus one decode step against ``forward`` over 64, in bf16 (§2's
   element-wise bf16 bound) and in a float32 copy of the weights
   (``1e-4 * max(1, max|forward|)``), with the MoE layers whose
   last-token experts differ between the two paths counted
   (``routing_flips``), and the float32 copy serving the same requests,
   every token within that tolerance of ``forward``'s argmax at its
   position (``MODEL_TOKENS``); (3) the ten reduced architectures in
   float32: ``forward`` on the card against the CPU from the same params
   (``1e-4``), prefill plus decode against forward, and a ``Server`` run
   with ``cache_len`` at most the local window (seamless-m4t's server
   must raise ``KeyError``, as the reference's does: its prefill needs
   ``enc_frames``); (4) ``launch.serve.main(["--requests", "4"])``.  A
   failed check fails the run; ``MODEL_PART`` lines time the parts.
12. Single-device training (``repro_torch.train``, ``repro_torch.data``,
   ``launch/train.py``), which launches none of the kernels above (the
   launch counts stay 0 across the phase): granite-moe-1b-a400m at full
   width in bf16 with random weights from ``--seed``, at ``train_4k``'s
   T = 4,096 with the global batch cut from 256 to 4 (2 microbatches of
   2; a ``TRAIN_CUT`` line), ``remat=True``, batches from
   ``SyntheticLM``.  (1) Six steps from the seed's state S0 (a ``TRAIN``
   line: each step's loss and grad_norm, all finite, CUDA-event step
   ms, the median of steps 2-6, tokens/s, peak memory); (2) from S0
   again three steps, ``checkpoint.save`` under ``_build/``, ``restore``
   into a fresh tree, three more steps: params, ``m``, ``v`` and ``step``
   equal (1)'s bit for bit (a ``CHECKPOINT`` line: bytes, save and
   restore seconds, free disk); (3) one step traced (``PROFILE``); (4)
   the ten reduced architectures in float32, one step on the card
   against the CPU from the same state (loss, lr, grad_norm ``1e-5``
   relative; ``m``, ``v`` ``2e-4 · max + 1e-7`` a leaf; params ``2·lr +
   1e-6 · max``), ``remat=True`` against ``False`` (loss within
   ``1e-5``), and smollm-135m reduced at 2 microbatches against 1
   (params within ``5e-3``); (5) ``launch.train.main`` twice over one
   checkpoint directory: the second run prints ``resumed at 10``.
   ``MODEL_PART train`` lines time the parts.
13. Sharded training (``distributed/sharding.py``, ``launch/mesh.py``,
   the sharded ``make_train_step``, ``launch/train.py --mesh``), which
   launches none of the kernels above: granite-moe-1b-a400m at full
   width in bf16 from ``--seed`` over a ``(2, 2)`` mesh of ``("data",
   "model")``, four gloo ranks on cuda:0 (NCCL refuses two ranks on one
   card), global batch 4 (two rows a data rank), ``train_4k``'s T cut to
   1,024 (a ``SHARD_CUT`` line), three steps.  (1) The same three steps
   on one device; its state saved leaf by leaf.  (2) Each rank builds
   the mesh (each collective the step calls run once on CUDA tensors
   through gloo and checked, ``gloo_cuda_probe``), places the params by ``tree_sharding``, steps inside
   ``mesh_context`` (CUDA-event step ms between barriers, the second
   step's collectives counted by ``CommDebugMode`` and
   ``roofline.CollectiveBytes``) and holds its local shards to the
   one-device state's (loss and grad_norm within ``2**-8`` relative;
   params within ``2**-7 |want| + 2 Σ lr`` a value, which holds the
   placement: three steps move a bf16 weight less than one ulp; ``m``
   and ``v`` within ``2**-4`` of each leaf's norm, which hold the
   gradient), then runs ``launch.train
   --mesh 2x2`` (smollm-135m reduced) six steps straight and three, a
   checkpoint, three more: bit for bit.  Meanwhile the parent dry-runs
   the same cell on a fake ``(2, 2)`` mesh (``launch.dryrun.lower_cell``)
   and each rank's collective bytes must equal its count.  ``SHARD``
   lines: per rank the routes (all direct), local state bytes, peak, step ms,
   collectives, worst error over tolerance.

Every path of phases 2-7 is timed (CUDA events, median of 10 after 2 warm-ups) and its
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
work items and the combine of their partial rows; ``ops.mttkrp`` K5
over its own items and the combine of theirs, ``ops.ttmc_fiber`` K6 so.  Per kernel, on the
inputs the path gave it: the kernel against its plain PyTorch version
(tolerance ``1e-4 * max(1, max|plain|)``: float32 with another
summation order; for bf16 results, where a float32 sum in another order
can move a value across a bf16 rounding boundary, element by element the
smaller of ``1e-2 * max(1, max|plain|)`` and ``2**-7 * |plain| + 2**-4
* rms(plain)``: :func:`max_err`), kernel / plain / library-call times,
the kernel's time and the library call's over ten calls back to back
(``ms_back_to_back``, ``library_ms_back_to_back``: the host's work to
launch one call then overlaps the device's work on the one before),
achieved rates
(``achieved_tflop_s``, ``achieved_tb_s``; a ``TENSOR_CORES`` line beside
the bound for K8 and K9 in bf16, on wgmma, and a ``CUDA_CORES`` line for
K8 and K9 in float32, their share of the float32 peak beside the library
call's time (``torch.bmm``, SDPA) and the SM clock under their load; K8
and K9 in float32 also give the same bits on a second call),
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
import math
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
# phase 8: (spec, memory budget, the slice decision the pricing must
# give at the 16 M tensor's profile: mode, chunks, kind, priced unsliced
# and chunk bytes)
SLICED_CASES = (("MTTKRP", 2**30, ("a", 2, "output", 1_263_228_160,
                                   663_614_080)),
                ("TTTP3", 2 * 2**30, ("r", 3, "contracted", 5_423_228_160,
                                      1_948_234_680)))
# phase 9: routing requests, the budgeted service's budget and the
# decision it must give for the dispatch tec,td->ecd
SERVE_REQUESTS = 8
SERVE_BUDGET = 256 * 2**20
SERVE_DECISION = ("d", 3, "output", 553_779_200, 185_040_896)
# phase 10: the ranks that share the card through gloo (NCCL refuses
# two ranks on one GPU), the seconds after which a rank's collective
# fails, the compressed all-reduce's size, and the runs: (case, spec,
# mesh shape, mesh axes, mode -> axis, entry point)
DIST_RANKS = 4
DIST_TIMEOUT_S = 300
DIST_PSUM_BYTES = 64 * 2**20
DIST_CASES = (
    ("a", "MTTKRP", (4,), ("data",), {0: "data"}, "make_distributed"),
    ("b", "MTTKRP", (2, 2), ("data", "model"), {0: "data", 1: "model"},
     "make_distributed_cuda"),
    ("c", "TTMc3", (4,), ("data",), {0: "data"}, "make_distributed_tuned"))
# phase 11: the served model, its server's slots and cache rows, the
# requests (prompt lengths drawn from [16, 192], each with max_new new
# tokens), the prompt lengths whose prefill is timed, the decode steps of
# the busy-share trace and the tokens of the decode-against-forward check
MODEL_ARCH = "granite-moe-1b-a400m"
MODEL_SLOTS = 4
MODEL_CACHE_LEN = 256
MODEL_REQUESTS = 8
MODEL_PROMPTS = (16, 192)
MODEL_MAX_NEW = 32
MODEL_PREFILL_LENGTHS = (16, 64, 128, 192)
MODEL_TRACE_STEPS = 20
MODEL_CHECK_T = 64
# phase 12: training granite-moe-1b at full width, train_4k's T
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_MICROBATCHES = 2
TRAIN_MICROBATCH_ROWS = 2        # global batch 4 of train_4k's 256
TRAIN_STEPS = 6
TRAIN_CKPT_AT = 3
SHARD_ARCH = "granite-moe-1b-a400m"
SHARD_MESH = (2, 2)                # (data, model), four gloo ranks
SHARD_BATCH = 4                    # global: two rows a data rank
SHARD_T = 1024                     # train_4k's 4,096 cut: four ranks share
SHARD_STEPS = 3                    # one card's memory
SHARD_TIMEOUT_S = 300
# kernel stem -> its name in a profiler trace
TRACE_NAMES = {stem: f"spttn::{stem}_kernel<" for stem in (
    "reduce", "product", "splitk", "combine", "chain", "mttkrp", "ttmc",
    "tttp", "grouped_matmul", "local_attn", "wkv6", "rglru")}
# the kernels whose work is a matrix product (bound by the tensor cores
# in bf16, by FFMA in float32), with their library call's name; the LM
# wrappers' modules
MATMUL_STEMS = {"grouped_matmul": "torch.bmm", "local_attn": "SDPA"}
LM_STEMS = ("grouped_matmul", "local_attn", "wkv6", "rglru")
# the recurrences, whose every kernel keeps its state in registers or
# shared memory, K8 in float32, whose threads keep 8 x 8 sums in
# registers, K9 in bf16 and in float32, whose O accumulators live in
# registers, and K1's outer-product path (kReduceOuter = 2), whose
# threads keep 4 x 4 sums and four rows' loads in registers (their
# mangled names): a spill fails the build phase
NO_SPILL_STEMS = ("wkv6", "rglru")
NO_SPILL_KERNELS = ("21grouped_matmul_kernelIf", "17local_attn_kernelILi",
                    "17local_attn_kernelIfLi", "13reduce_kernelIfLi2E",
                    "13reduce_kernelIdLi2E")
# K8 and K9 in bf16 (their mangled names), whose products run on the
# tensor cores: their machine code must hold wgmma (HGMMA) and TMA loads
# (UTMALDG), or the build phase fails
TENSOR_CORE_KERNELS = ("21grouped_matmul_kernelI13__nv_bfloat16",
                       "17local_attn_kernelILi")


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


def clock_under_load(fn, calls: int = 300) -> str:
    """The card's SM clock and power draw as ``nvidia-smi`` reads them
    while ``calls`` calls of ``fn``, queued back to back, run."""
    import torch
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return out


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


def sass_counts(sass: str) -> dict[str, dict[str, int]]:
    """The HGMMA (wgmma) and UTMALDG (TMA load) instructions of every
    kernel in ``cuobjdump -sass`` output, by the kernel's mangled name."""
    import re
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts[m.group(1)] = {"HGMMA": 0, "UTMALDG": 0}
        elif cur is not None:
            for op in cur:
                cur[op] += op in line
    return counts


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
                   "repro_torch.kernels.codegen.stages": "K1/K3 items",
                   "repro_torch.kernels.paper": "K5/K6 items"}


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
    ``launch_work`` (``(nbytes, ops)`` when None; the wrappers of K1, K3
    and K5 launch the combine too).  ``measured`` False marks a launch
    that gets no record of its own (a K2 already measured on the other
    target, the K4 inside the split-K chain): it counts only towards the
    trace's bound."""

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


# K1's paths by their code (stages.REDUCE_TABLES, _VECTORS, _OUTER)
REDUCE_PATHS = ("tables", "vectors", "outer")


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
        tables, block_ptr, mask, padded, dtype, items = args
        if target != "hopper":
            out.append(splitk_entry(st, tables, mask, padded, dtype, expr,
                                    target, n))
            continue
        out.append(reduce_entry(st, tables, block_ptr, mask, padded, dtype,
                                items, expr, target, n))
    return out


def reduce_entry(st, tables, block_ptr, mask, padded, dtype, items, expr,
                 target, calls: int) -> Entry:
    """A captured K1 call as a :func:`stage_entries` entry: the kernel
    over the layout's work items, which writes one partial row an item,
    and the combine that reads them back and writes the output."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.kernels.codegen import stages
    P = mask.shape[0]
    isz = torch.empty((), dtype=dtype).element_size()
    w = st.out_flat_dim
    part_bytes = items.nitems * w * isz
    nbytes = (stage_nbytes(st, P, isz) + P * 4 + table_nbytes(tables)
              + items.item_block.numel() * 8 + part_bytes)
    ops = 2 * P * int(tables.a_idx.numel()) + P * w
    launch_work = (nbytes, ops)
    nbytes += part_bytes + items.item_ptr.numel() * 8 + st.nseg * w * isz
    ops += items.nitems * w
    rows, _ = stages.operand_rows(st, padded, P, dtype)
    path = stages.reduce_launch_path(st, rows)
    lanes = 256 // native.column_threads(stages.reduce_columns(st, path,
                                                               isz))
    log(f"K1 {expr}: path {REDUCE_PATHS[path]}, block {st.block}, P = {P} "
        f"padded rows for {st.nseg} segments; nitems {items.nitems}, cap "
        f"{items.cap} blocks, {lanes} row lanes a thread block")

    def kern():
        return stages.run_reduce_stage(st, tables, block_ptr, mask, padded,
                                       dtype, items)

    def plain():
        return stages.run_reduce_stage_plain(st, block_ptr, mask, padded,
                                             dtype)

    return Entry("reduce", "K1 reduce", expr, target, kern, plain, None,
                 nbytes, ops, dtype, calls, launch_work)


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
    from repro_torch.kernels.codegen.ir import chain_items
    out = []
    for name, (args, kwargs) in captured.items():
        kern = getattr(paper, name)
        plain = getattr(paper, name + "_plain")
        launch_work = None
        if name == "mttkrp_kernel":
            # the kernel over the work items writes one partial row an
            # item; the combine reads them back and writes the output
            vals, bg, cg, mask, block_ptr, nseg, block = args
            P, R = bg.shape
            isz = bg.element_size()
            items = chain_items(block_ptr, paper.MTTKRP_ITEM_BLOCKS)
            part_bytes = items.nitems * R * isz
            nbytes = (P * isz + 2 * P * R * isz + P * 4
                      + items.item_block.numel() * 8 + part_bytes)
            ops, lib = 3 * P * R + P, None
            launch_work = (nbytes, ops)
            nbytes += (block_ptr.numel() * 8 + part_bytes
                       + items.item_ptr.numel() * 8 + nseg * R * isz)
            ops += items.nitems * R
            stem, label = "mttkrp", f"({P}, {R}) -> ({nseg}, {R})"
        elif name == "ttmc_kernel":
            # over K1's work items, as K5: one partial row an item, which
            # the combine reads back
            ug, xf, block_ptr, nseg, block = args
            items = kwargs["items"]
            P, R = ug.shape
            S = xf.shape[1]
            isz = ug.element_size()
            part_bytes = items.nitems * R * S * isz
            nbytes = (P * (R + S) * isz + items.item_block.numel() * 8
                      + part_bytes)
            ops, lib = 2 * P * R * S, None
            launch_work = (nbytes, ops)
            nbytes += (part_bytes + items.item_ptr.numel() * 8
                       + nseg * R * S * isz)
            ops += items.nitems * R * S
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
                         lib, nbytes, ops, args[1].dtype, calls[name],
                         launch_work))
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
        if stem in MATMUL_STEMS and dtype == torch.float32:
            # K8 and K9 in float32 sum in a fixed order: a second call, the
            # same bits
            same = torch.equal(got.view(torch.int32),
                               kern().view(torch.int32))
            log(f"check {name} {stage}: the same bits on a second call "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{name} {stage}: two calls on the "
                                     f"same inputs gave other bits")
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
        # again over ten calls back to back, and the library call so
        rec["ms_back_to_back"] = time_ms(kern, reps=3, warmup=1, calls=10)
        rec["library_ms_back_to_back"] = (
            time_ms(lib, reps=3, warmup=1, calls=10)
            if lib is not None else None)
        log("KERNEL_PHASE " + json.dumps(rec))
        if stem in MATMUL_STEMS and dtype == torch.bfloat16:
            log(f"TENSOR_CORES {name} {stage}: {ops / ms / 1e9!r} TFLOP/s "
                f"achieved in {ms!r} ms; the bound is {bound_ms!r} ms "
                f"({ops_per_s / 1e12:g} TFLOP/s bf16, {bound_by})")
        elif stem in MATMUL_STEMS:
            rate = ops / ms / 1e9
            lib_rate = ops / lib_ms / 1e9 if lib_ms else None
            log(f"CUDA_CORES {name} {stage}: {rate!r} TFLOP/s achieved in "
                f"{ms!r} ms, {rate / (ops_per_s / 1e12)!r} of the "
                f"{ops_per_s / 1e12:g} TFLOP/s float32 peak (bound "
                f"{bound_ms!r} ms, {bound_by}); {MATMUL_STEMS[stem]} f32 "
                f"{lib_ms!r} ms, {lib_rate!r} TFLOP/s; SM clock and power "
                f"under its load {clock_under_load(kern)}")
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


def k1_item_checks(dev) -> None:
    """K1 over the work items of a skewed layout at the main path's block
    (one segment of 40,000 fibers, cut into many items; one of pad rows
    alone), on each of its paths, in float32 and float64, against its
    plain version; the same bits on a second call, one launch of K1 and
    one of the combine a call."""
    import numpy as np
    import torch
    from repro_torch.kernels import native
    from repro_torch.kernels.codegen import ir, stages
    from repro_torch.kernels.segment import segment_ptr
    from repro_torch.kernels.util import padded_segment_layout
    rng = np.random.default_rng(0)
    nseg, block, nfib = 64, 128, 120_000
    seg = np.sort(rng.integers(2, nseg, nfib))
    seg[:40_000] = 0                       # segment 1: pad rows alone
    lay = padded_segment_layout(np.sort(seg), nseg, block)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg))
    items = ir.reduce_items(ptr, block)
    gather = torch.from_numpy(lay.gather).long().to(dev)
    mask = torch.from_numpy(lay.mask).to(dev)
    cases = [([("d", (64,), True), ("d", (64,), True)], "d", (64,)),
             ([("d", (16,), True), ("e", (16,), True)], "de", (16, 16)),
             ([("de", (3, 4), True), ("e", (4,), False)], "d", (3,))]
    for ops_, out_subs, out_shape in cases:
        st = ir.Stage(tuple(ir.StageOperand(*o) for o in ops_), out_subs,
                      out_shape, True, block, nseg)
        tables = ir.index_tables(st, dev)
        for dtype in (torch.float32, torch.float64):
            padded = [torch.randn((nfib if f else 1, int(np.prod(sh))),
                                  device=dev, dtype=dtype)
                      for _, sh, f in ops_]
            padded = [p[gather] if f else p
                      for p, (_, _, f) in zip(padded, ops_)]
            args = (st, tables, ptr.to(dev), mask, padded, dtype,
                    items.to(dev))
            native.reset_launch_counts()
            got = stages.run_reduce_stage(*args)
            torch.cuda.synchronize()
            counts = native.launch_counts()
            path = stages.reduce_launch_path(st, padded)
            check(f"K1 items {st.expr} {str(dtype)[6:]} "
                  f"({REDUCE_PATHS[path]})", got,
                  stages.run_reduce_stage_plain(st, ptr.to(dev), mask,
                                                padded, dtype))
            same = torch.equal(got, stages.run_reduce_stage(*args))
            log(f"K1 items {st.expr} {str(dtype)[6:]}: path "
                f"{REDUCE_PATHS[path]}, nitems {items.nitems} (segment 0: "
                f"{int(items.item_ptr[1])}), cap {items.cap} blocks, "
                f"launches {counts['reduce']} + {counts['combine']}, the "
                f"same bits on a second call {'ok' if same else 'FAIL'}")
            if not same or counts["reduce"] != 1 or counts["combine"] != 1:
                raise AssertionError(f"K1 items {st.expr}: other bits or "
                                     f"launches {counts}")
            if bool(got[1].any()):
                raise AssertionError(f"K1 items {st.expr}: a segment of "
                                     f"pad rows is not zero")


def k6_item_checks(dev) -> None:
    """K6 over K1's work items on a skewed layout at the main path's
    block (a third of the fibers in segment 0, cut into several items;
    segment 1 pad rows alone), on its register-block path (16 x 16, and
    128 x 128 in four column tiles) and its scalar walk (5 x 7), in
    float32 and float64, against its plain version; the same bits on a
    second call, one launch of K6 and one of the combine a call."""
    import numpy as np
    import torch
    from repro_torch.kernels import native, paper
    from repro_torch.kernels.codegen import ir
    from repro_torch.kernels.segment import segment_ptr
    from repro_torch.kernels.util import padded_segment_layout
    rng = np.random.default_rng(1)
    nseg, block = 64, 128
    paths = {paper.TTMC_SCALAR: "scalar", paper.TTMC_OUTER: "outer"}
    for R, S, nfib in ((16, 16, 120_000), (5, 7, 120_000),
                       (128, 128, 12_000)):
        seg = np.sort(rng.integers(2, nseg, nfib))
        seg[:nfib // 3] = 0
        lay = padded_segment_layout(np.sort(seg), nseg, block)
        ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg))
        items = ir.reduce_items(ptr, block)
        gather = torch.from_numpy(lay.gather).long().to(dev)
        mask = torch.from_numpy(lay.mask).to(dev)[:, None]
        for dtype in (torch.float32, torch.float64):
            ug = torch.randn((nfib, R), device=dev, dtype=dtype)[gather]
            xf = torch.randn((nfib, S), device=dev, dtype=dtype)[gather]
            args = (ug * mask, xf * mask, ptr.to(dev), nseg, block)
            native.reset_launch_counts()
            got = paper.ttmc_kernel(*args, items=items.to(dev))
            torch.cuda.synchronize()
            counts = native.launch_counts()
            path = paths[paper.ttmc_path(*args[:2])]
            check(f"K6 items {R}x{S} {str(dtype)[6:]} ({path})", got,
                  paper.ttmc_kernel_plain(*args))
            same = torch.equal(got, paper.ttmc_kernel(
                *args, items=items.to(dev)))
            log(f"K6 items {R}x{S} {str(dtype)[6:]}: path {path}, "
                f"nitems {items.nitems} (segment 0: "
                f"{int(items.item_ptr[1])}), cap {items.cap} blocks, "
                f"launches {counts['ttmc']} + {counts['combine']}, the "
                f"same bits on a second call {'ok' if same else 'FAIL'}")
            if not same or counts["ttmc"] != 1 or counts["combine"] != 1:
                raise AssertionError(f"K6 items {R}x{S}: other bits or "
                                     f"launches {counts}")
            if bool(got[1].any()):
                raise AssertionError(f"K6 items {R}x{S}: a segment of pad "
                                     f"rows is not zero")
            del ug, xf, args, got


def ttmc_fiber_host(ug, xf, layout, reps: int = 5) -> tuple[dict, str]:
    """Host-clock medians (ms, over ``reps`` calls after one warm-up) of
    the parts of one ``ops.ttmc_fiber`` call, each ended by
    ``torch.cuda.synchronize()``: ``layout_arrays`` (of it, ``astype``:
    the numpy cast of the gather to int64 alone), the item cut and its
    upload, the gathers and masking, and the wrapper (K6 and the
    combine); then the whole call, timed alone the same way.  Also
    returns the path K6 took on the padded rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, paper
    dev = ug.device
    laps = collections.defaultdict(list)
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t = [time.perf_counter()]

        def lap(name: str) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            if rep:
                laps[name].append((now - t[0]) * 1e3)
            t[0] = now

        np.ascontiguousarray(layout.gather.astype(np.int64))
        lap("astype")
        gather, mask, block_ptr = ops.layout_arrays(layout, dev)
        lap("layout_arrays")
        items = ops.ttmc_fiber_items(layout).to(dev)
        lap("items")
        m = mask[:, None]
        ugp, xfp = ug[gather] * m, xf[gather] * m
        lap("gathers")
        paper.ttmc_kernel(ugp, xfp, block_ptr, layout.nseg, layout.block,
                          items=items)
        lap("wrapper")
        path = "outer" if paper.ttmc_path(ugp, xfp) == paper.TTMC_OUTER \
            else "scalar"
        del gather, mask, block_ptr, items, ugp, xfp
        ops.ttmc_fiber(ug, xf, layout)
        lap("whole call")
    return {k: statistics.median(v) for k, v in laps.items()}, path


def sliced_paths(specs, factors, arrays, levels, torch_out, drv) -> None:
    """Phase 8: each of ``SLICED_CASES`` through ``execute_plan`` with its
    memory budget on both code-generator engines, after the same path
    unsliced: the decision must be the one priced, every kernel of the
    unsliced path must launch once a chunk, the result must agree with
    the ``torch`` engine's unsliced one, and the sliced peak must stay
    under the unsliced one (the priced bytes are printed beside both; the
    engines' dense TTTP3 intermediate is not priced)."""
    import torch

    from repro_torch.core.executor import execute_plan
    from repro_torch.core.planner import plan
    from repro_torch.core.slicing import plan_decision, stamp_plan_slicing
    for name, budget, want in SLICED_CASES:
        spec, f = specs[name], factors[name]
        p = plan(spec, nnz_levels=levels)
        decision = plan_decision(stamp_plan_slicing(p, levels, budget),
                                 levels)
        if dataclasses.astuple(decision) != want:
            raise AssertionError(f"{name}: sliced as {decision}, expected "
                                 f"{want}")
        for backend in ("cuda", "cuda-splitk"):
            def run(budget=None, p=p, f=f, backend=backend):
                return execute_plan(p, arrays, f, backend=backend,
                                    memory_budget=budget)

            unsliced, once = peak_and_launches(run)
            sliced, counts = peak_and_launches(lambda: run(budget), (
                f"sliced {name} {backend} vs torch", torch_out[name]))
            for stem, n in counts.items():
                drv.launches[stem] += n
            grown = {stem: n for stem, n in counts.items()
                     if n != decision.chunks * once[stem]}
            if grown or not (once["reduce"] + once["product"]
                             + once["splitk"]):
                raise AssertionError(
                    f"sliced {name} {backend}: launches {counts}, unsliced "
                    f"{once}; every kernel must launch once a chunk")
            ms = time_ms(lambda: run(budget))
            rec = {"spec": name, "backend": backend, "budget": budget,
                   **dataclasses.asdict(decision), "ms": ms,
                   "unsliced_ms": time_ms(run),
                   "peak_bytes_measured": sliced,
                   "unsliced_peak_bytes_measured": unsliced,
                   "resident_bytes": torch.cuda.memory_allocated(),
                   "launches": {k: n for k, n in counts.items() if n},
                   "unsliced_launches": {k: n for k, n in once.items()
                                         if n}}
            log("SLICED " + json.dumps(rec))
            profile_path(f"sliced {name} {backend}", lambda: run(budget),
                         ms, {})
            if sliced >= unsliced:
                raise AssertionError(f"sliced {name} {backend} peaked at "
                                     f"{sliced} bytes, unsliced {unsliced}")
            torch.cuda.empty_cache()


def peak_and_launches(run, against=None):
    """Run ``run`` once with the peak-memory counter and the launch counts
    reset just before it; returns (peak bytes, launch counts).  With
    ``against`` = (label, want), the result is held to ``want``."""
    import torch

    from repro_torch.kernels import native
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    counts = native.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if against is not None:
        check(against[0], got, against[1])
    del got
    return peak, counts


def scatter_rows(coo, x):
    """The plain MoE dispatch: each routed token's row of ``x`` copied
    into its (expert, slot) row of a zero ``(E, C, D)`` tensor."""
    import torch
    _, E, C = coo.shape
    t, e, c = (torch.from_numpy(coo.coords[:, m].astype("int64")).to(
        x.device) for m in range(3))
    out = torch.zeros((E, C, x.shape[-1]), dtype=x.dtype, device=x.device)
    out[e, c] = x[t]
    return out


def serve_stream(moe, dev, seed: int, drv) -> None:
    """Phase 9: ``PlanService`` over a stream of routing patterns at
    ``moe``'s widths (the dropless capacity C = N), each dispatch held to
    the plain scatter bit for bit; then the same first request through a
    service with a memory budget (on the tuned winner, and on the ``cuda``
    engine forced), which must slice ``d`` as priced and give the same
    bits."""
    import numpy as np
    import torch

    from repro_torch.core.slicing import plan_decision
    from repro_torch.kernels import native
    from repro_torch.serve import PlanService, moe_routing_coo
    from repro_torch.sparse import build_csf
    E, D, k = moe.moe.n_experts, moe.d_model, moe.moe.top_k
    N = MOE_TOKENS
    C = max(8, -(-N // 8) * 8)             # dropless (moe.py:114)
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, E))
    stream = []
    for r in range(SERVE_REQUESTS - 1):
        if r:                               # redraw 1 % of the tokens
            who = rng.choice(N, N // 100, replace=False)
            logits[who] = rng.standard_normal((len(who), E))
        stream.append(np.argsort(-logits, axis=1)[:, :k])
    stream.append(stream[0])                # the last repeats the first
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((N, D), generator=gen, device=dev)
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="serve-", dir=native.BUILD_DIR)
    svc = PlanService(cache_dir=cache_dir)
    log(f"serve: {moe.name} dispatch tec,td->ecd, N {N}, E {E}, top-{k}, "
        f"C {C}, d {D}; {len(stream)} requests; tuner {svc.config}")

    def dispatch(service, label, request, coo, want):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        start.record()
        out, st = service.dispatch(coo, x)
        end.record()
        end.synchronize()
        counts = native.launch_counts()
        for stem, n in counts.items():
            drv.launches[stem] += n
        p = service._plans[st.key]
        rec = {"service": label, "request": request, "kind": st.kind,
               "resolve_s": st.seconds, "dispatch_ms": start.elapsed_time(
                   end), "backend": p.backend, "slice_mode": p.slice_mode,
               "slice_chunks": p.slice_chunks, "nnz": coo.nnz,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "launches": {s: n for s, n in counts.items() if n},
               "same_bits": bool(torch.equal(out, want))}
        log("SERVE " + json.dumps(rec))
        if not rec["same_bits"]:
            raise AssertionError(f"{label} request {request}: the dispatch "
                                 f"differs from the plain scatter")
        del out
        return p, st, counts

    coos = [moe_routing_coo(idx, E, C) for idx in stream]
    first = scatter_rows(coos[0], x)
    kinds = []
    for r, coo in enumerate(coos, 1):
        want = first if r == len(coos) else scatter_rows(coo, x)
        _, st, _ = dispatch(svc, "tuned", r, coo, want)
        kinds.append(st.kind)
        del want
    if kinds[0] != "cold" or kinds[-1] != "exact":
        raise AssertionError(f"serve tiers {kinds}: the first request must "
                             f"be cold and the last (a repeat) exact")
    hot = time_ms(lambda: svc.dispatch(coos[0], x))
    log(f"serve hot: {hot!r} ms a dispatch (exact hit; median of 10 after "
        f"2 warm-ups, the CSF build and upload included)")
    profile_path("serve hot", lambda: svc.dispatch(coos[0], x), hot, {})
    levels = build_csf(coos[0]).nnz_levels()
    forced = dataclasses.replace(svc.config, backends=("cuda",))
    for label, tuner in (("budgeted", None), ("budgeted cuda", forced)):
        bsvc = PlanService(cache_dir=cache_dir, tuner=tuner,
                           memory_budget=SERVE_BUDGET)
        # the first request, then its repeat: an exact hit, whose
        # launches are the dispatch's alone (a cold one's hold the
        # tuner's measurements too)
        for r in (1, len(coos)):
            p, st, counts = dispatch(bsvc, label, r, coos[r - 1], first)
        decision = dataclasses.astuple(plan_decision(p, levels))
        if decision != SERVE_DECISION:
            raise AssertionError(f"{label}: sliced as {decision}, expected "
                                 f"{SERVE_DECISION}")
        chunks = next(iter(bsvc._chunk_executors.values()))
        stems = [s for s, n in counts.items() if n]
        if p.backend != "torch" and counts["product"] != p.slice_chunks:
            raise AssertionError(f"{label}: {counts['product']} launches "
                                 f"of K2 for {p.slice_chunks} chunks")
        ms = time_ms(lambda: bsvc.dispatch(coos[0], x))
        log(f"serve {label}: {ms!r} ms a dispatch (median of 10 after 2 "
            f"warm-ups), backend {p.backend}, chunk widths "
            f"{sorted(chunks)}, kernels {stems}")
        profile_path(f"serve {label}", lambda: bsvc.dispatch(coos[0], x),
                     ms, {})
    del first, x


def served_tokens_check(label, params, cfg, reqs) -> None:
    """Every token a server gave is ``forward``'s argmax at its position,
    or its logit is within the float32 tolerance of that argmax's
    (``1e-4 * max(1, max|row|)``: random weights give near-ties, so the
    logits are compared, not the tokens)."""
    import numpy as np
    import torch

    from repro_torch.models import forward
    dev = params["embed"]["w"].device
    worst, argmax_equal, total = 0.0, 0, 0
    for r in reqs:
        seq = np.concatenate([np.asarray(r.prompt), np.asarray(r.out[:-1])])
        logits, _ = forward(params, cfg, {"tokens": torch.as_tensor(
            seq[None], dtype=torch.int32, device=dev)})
        rows = logits[0, len(r.prompt) - 1:, :cfg.vocab].double().cpu()
        got = torch.as_tensor(r.out)
        gap = rows.max(-1).values - rows[torch.arange(len(r.out)), got]
        tol = 1e-4 * rows.abs().amax(-1).clamp(min=1.0)
        worst = max(worst, float((gap / tol).max()))
        argmax_equal += int((rows.argmax(-1) == got).sum())
        total += len(r.out)
    rec = {"label": label, "tokens": total, "argmax_equal": argmax_equal,
           "worst_gap/tol": worst}
    log("MODEL_TOKENS " + json.dumps(rec))
    if worst > 1.0:
        raise AssertionError(f"{label}: a served token's logit is {worst} "
                             f"times the tolerance under forward's maximum")


def routing_recorder():
    """Wrap ``moe._route`` to keep each call's expert choices (the MoE
    layers' top-k, in call order); returns (the list, undo)."""
    from repro_torch.models import moe
    calls, real = [], moe._route

    def route(p, m, x2d):
        gate, idx, aux = real(p, m, x2d)
        calls.append(idx)
        return gate, idx, aux

    moe._route = route
    return calls, lambda: setattr(moe, "_route", real)


def decode_against_forward(label, params, cfg, dev, seed) -> None:
    """Prefill of ``MODEL_CHECK_T - 1`` tokens then one decode step,
    against ``forward`` over all of them at the last two positions (the
    real vocabulary's columns, by :func:`check`); the MoE layers whose
    last-token experts differ between the two are counted
    (``routing_flips``: a near-tie that the paths' roundings split)."""
    import torch

    from repro_torch.configs import make_batch
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.transformer import _encode
    T = MODEL_CHECK_T
    batch = make_batch(cfg, "train_4k", seed=seed, batch_override=2,
                       seq_override=T, device=dev)
    batch.pop("labels")
    calls, undo = routing_recorder()
    try:
        full, _ = forward(params, cfg, batch)
        n = len(calls)
        last, caches = prefill(params, cfg, dict(
            batch, tokens=batch["tokens"][:, :T - 1]), cache_len=T)
        m = len(calls)
        enc = (_encode(params, cfg, batch["enc_frames"]) if cfg.encdec
               else None)
        step, _ = decode_step(params, cfg, caches,
                              batch["tokens"][:, T - 1:], T - 1, enc_out=enc)
    finally:
        undo()
    flips = sum(int((torch.sort(f.view(2, T, -1)[:, T - 1], -1).values
                     != torch.sort(d, -1).values).any())
                for f, d in zip(calls[:n], calls[m:]))
    log(f"MODEL_DECODE {label}: {n} MoE layers, routing_flips {flips}")
    V = cfg.vocab
    check(f"{label} prefill vs forward", last[:, 0, :V], full[:, T - 2, :V])
    check(f"{label} decode vs forward", step[:, 0, :V], full[:, T - 1, :V])


def serve_models(dev, seed: int) -> None:
    """Phase 11: the model stack and its ``Server`` (see the module's
    docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, get_config, get_reduced
    from repro_torch.configs import make_batch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import (decode_step, forward, model_init,
                                    prefill)
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.serve import Request, Server
    t_part = [time.perf_counter()]

    def part_done(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        log(f"MODEL_PART {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    cfg = get_config(MODEL_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params, _ = model_init(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"MODEL {cfg.name}: {n_params} parameters, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params))} "
        f"bytes in {cfg.dtype}, drawn in {time.perf_counter() - t0:.2f} s")

    # (1) the bf16 server at full width
    rng = np.random.default_rng(seed)
    lo, hi = MODEL_PROMPTS
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, MODEL_REQUESTS)]

    def serve(p, c):
        srv = Server(c, p, slots=MODEL_SLOTS, cache_len=MODEL_CACHE_LEN)
        reqs = [Request(prompt=q, max_new=MODEL_MAX_NEW) for q in prompts]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.perf_counter()
        done = srv.run(max_steps=4 * MODEL_MAX_NEW * MODEL_REQUESTS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if len(done) != len(reqs) or any(len(r.out) != MODEL_MAX_NEW
                                         for r in reqs):
            raise AssertionError(f"served {len(done)} of {len(reqs)}, "
                                 f"lengths {[len(r.out) for r in reqs]}")
        # the peak, and what was resident when the run began (earlier
        # phases' tensors and the weights included)
        return srv, reqs, secs, (torch.cuda.max_memory_allocated(),
                                 resident)

    srv, reqs, secs, (peak, resident) = serve(params, cfg)
    ntok = sum(len(r.out) for r in reqs)
    toks = torch.zeros((MODEL_SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([lo + 3 * s for s in range(MODEL_SLOTS)], device=dev)

    def steps(n, p=params, c=cfg, caches=srv.caches):
        for _ in range(n):
            _, caches = decode_step(p, c, caches, toks, pos)

    decode_ms = time_ms(lambda: steps(1))
    prefill_ms = {}
    for T in MODEL_PREFILL_LENGTHS:
        batch = {"tokens": torch.as_tensor(prompts[0][:1].repeat(T)[None],
                                           device=dev)}
        prefill_ms[T] = time_ms(lambda: prefill(
            params, cfg, batch, cache_len=MODEL_CACHE_LEN), reps=5)
    log("MODEL_SERVE " + json.dumps({
        "arch": cfg.name, "dtype": cfg.dtype, "slots": MODEL_SLOTS,
        "cache_len": MODEL_CACHE_LEN, "requests": len(reqs),
        "prompt_lengths": [len(q) for q in prompts],
        "generated_tokens": ntok, "run_s": secs,
        "tokens_per_s": ntok / secs, "peak_bytes": peak,
        "resident_bytes_before": resident,
        "decode_step_ms": decode_ms,
        "decode_tokens_per_s": MODEL_SLOTS / decode_ms * 1e3,
        "prefill_ms": prefill_ms}))
    part_done("1a bf16 server, timed prefills and decode steps")
    trace_ms = time_ms(lambda: steps(MODEL_TRACE_STEPS), reps=1, warmup=0)
    profile_path(f"serve {cfg.name} {MODEL_TRACE_STEPS} decode steps",
                 lambda: steps(MODEL_TRACE_STEPS), trace_ms, {})
    del srv, steps
    part_done("1b decode steps traced")

    # (2) decode against forward in bf16 and float32; the float32 server's
    # tokens against forward's argmax
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    for label, p, c in ((f"{cfg.name} bf16", params, cfg),
                        (f"{cfg.name} f32", params32, cfg32)):
        decode_against_forward(label, p, c, dev, seed)
    del params
    _, reqs32, secs32, peak32 = serve(params32, cfg32)
    log(f"MODEL_SERVE f32: {sum(len(r.out) for r in reqs32)} tokens in "
        f"{secs32!r} s, peak {peak32[0]} bytes ({peak32[1]} resident "
        f"before the run)")
    served_tokens_check(f"{cfg.name} f32 server", params32, cfg32, reqs32)
    del params32
    part_done("2 decode against forward, float32 server")

    # (3) the ten reduced architectures, float32: cuda against the CPU,
    # decode against forward, and one server run
    for arch in ARCHS:
        small = get_reduced(arch)
        cpu_params, _ = model_init(small, seed, device="cpu")
        p = tree_map(lambda t: t.to(dev), cpu_params)
        batch = make_batch(small, "train_4k", seed=seed, batch_override=2,
                           seq_override=16, device="cpu")
        want, _ = forward(cpu_params, small, batch)
        got, _ = forward(p, small, {k: v.to(dev) for k, v in batch.items()})
        check(f"{arch} forward cuda vs cpu", got, want)
        decode_against_forward(arch, p, small, dev, seed)
        cache_len = min(MODEL_CHECK_T, small.window or MODEL_CHECK_T)
        srv = Server(small, p, slots=2, cache_len=cache_len)
        sreqs = [Request(prompt=rng.integers(0, small.vocab, n).astype(
            np.int32), max_new=4) for n in (5, 9, 3)]
        for r in sreqs:
            srv.submit(r)
        if small.encdec:      # the reference's server never passes frames
            try:
                srv.run(max_steps=32)
            except KeyError as e:
                log(f"MODEL_SMALL {arch}: server raises KeyError({e}) as "
                    f"the reference's does")
                continue
            raise AssertionError(f"{arch}: the server ran without "
                                 f"enc_frames")
        srv.run(max_steps=32)
        served_tokens_check(f"{arch} server", p, small, sreqs)
    part_done("3 reduced architectures")

    # (4) the serving CLI on the card
    done = launch_serve.main(["--requests", "4"])
    if len(done) != 4:
        raise AssertionError(f"launch.serve served {len(done)} of 4")
    part_done("4 launch.serve")


def hold(name: str, err: float, tol: float) -> None:
    """A ``check`` line for an error already reduced to one number, held
    to its own tolerance."""
    ok = err <= tol
    log(f"check {name}: max_abs_err={err!r} tol={tol!r} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: error {err} over its tolerance {tol}")


def hold_train_state(label: str, got, gm, want, wm) -> None:
    """One train step's result against another's from the same state
    (the CPU tests' bounds): loss, lr and grad_norm within ``1e-5``
    relative; ``m`` and ``v`` within ``2e-4 · max|want| + 1e-7`` a leaf;
    params within ``2·lr₁ + 1e-6 · max|p|`` (the first AdamW step moves
    a param by about ``lr·sign(g)``: a gradient near 0 whose sign another
    summation order flips moves it by ``2·lr``)."""
    from repro_torch.train.tree import key_paths
    for name in ("loss", "lr", "grad_norm"):
        g, w = float(gm[name]), float(wm[name])
        hold(f"{label} {name}", abs(g - w), 1e-5 * abs(w))
    lr1 = float(wm["lr"])
    for part, tree, base in (("m", lambda s: s.opt.m, None),
                             ("v", lambda s: s.opt.v, None),
                             ("params", lambda s: s.params, 2 * lr1)):
        worst = 0.0
        for (k, a), (_, b) in zip(key_paths(tree(got)),
                                  key_paths(tree(want))):
            if not b.numel():
                continue
            b = b.double().cpu()
            scale = float(b.abs().max())
            tol = 2e-4 * scale + 1e-7 if base is None else base + 1e-6 * scale
            err = float((a.double().cpu() - b).abs().max())
            if not err <= tol:
                raise AssertionError(f"{label} {part} {k}: {err} > {tol}")
            worst = max(worst, err / tol)
        log(f"check {label} {part}: worst_err/tol={worst!r} ok")


def same_bits(label: str, got, want) -> None:
    """Every leaf of ``got`` equals ``want``'s bit for bit."""
    import torch

    from repro_torch.train.tree import key_paths
    n = 0
    for (k, a), (j, b) in zip(key_paths(got), key_paths(want)):
        if k != j or a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}: leaf {k} / {j} differs in kind")
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: leaf {k} differs")
        n += 1
    log(f"check {label}: {n} leaves bit for bit ok")


def gather_backward(table_shape, ids, seed: int) -> None:
    """The embedding gather's backward on a token stream, as indexing
    (``w[ids]``: sort-based ``index_put_``, a row's repeats summed one
    after another) and as ``F.embedding`` (what ``embed_lookup`` calls):
    each one's forward-and-backward ms (CUDA events, median of 10), the
    same bits twice, and its error against a float64 sum, largest on the
    most repeated row, relative to that row's largest value (a
    ``GATHER`` line).  ``F.embedding``'s must be within one bf16 ulp of
    the row's maximum (``2**-7``)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=ids.device)
    gen.manual_seed(seed)
    g = torch.randn((ids.numel(), table_shape[1]), generator=gen,
                    device=ids.device).to(torch.bfloat16)
    w = torch.zeros(table_shape, dtype=torch.bfloat16, device=ids.device,
                    requires_grad=True)
    flat = ids.reshape(-1).long()
    exact = torch.zeros(table_shape, dtype=torch.float64,
                        device=ids.device).index_add_(0, flat, g.double())
    counts = torch.bincount(flat)
    top = int(counts.argmax())

    def grad(fn):
        (out,) = torch.autograd.grad(fn(w), w, g)
        return out

    rec = {"table": list(table_shape), "ids": flat.numel(),
           "rows": int((counts > 0).sum()), "max_repeats": int(counts[top])}
    for name, fn in (("index", lambda t: t[flat]),
                     ("embedding", lambda t: F.embedding(flat, t))):
        a, b = grad(fn), grad(fn)
        rec[name] = {
            "ms": time_ms(lambda: grad(fn)),
            "same_bits_twice": torch.equal(a.view(torch.int16),
                                           b.view(torch.int16)),
            "rel_err_most_repeated_row": float(
                (a[top].double() - exact[top]).abs().max()
                / exact[top].abs().max())}
    log("GATHER " + json.dumps(rec))
    emb = rec["embedding"]
    if not emb["same_bits_twice"] or emb["rel_err_most_repeated_row"] > \
            2.0 ** -7:
        raise AssertionError(f"embed_lookup's backward: {emb}")


def train_models(dev, seed: int) -> None:
    """Phase 12: single-device training (see the module's docstring)."""
    import contextlib
    import io
    import shutil

    import torch

    from repro_torch.configs import ARCHS, SHAPES, get_config, get_reduced
    from repro_torch.configs import make_batch
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import native
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import (checkpoint, init_train_state,
                                   make_train_step)
    from repro_torch.train.tree import key_paths, map_with_keys
    t_part = [time.perf_counter()]

    def part_done(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        log(f"MODEL_PART train {name}: {now - t_part[0]:.1f} s")
        t_part[0] = now

    native.reset_launch_counts()
    cfg = get_config(TRAIN_ARCH)
    T = SHAPES["train_4k"].seq_len
    B = TRAIN_MICROBATCHES * TRAIN_MICROBATCH_ROWS
    run = RunConfig(model=cfg, remat=True, microbatches=TRAIN_MICROBATCHES)
    step = make_train_step(cfg, run)
    ds = SyntheticLM(cfg.vocab, T, B, seed=seed, device=dev)
    batches = [ds.batch_at(i) for i in range(TRAIN_STEPS)]
    work = os.path.join(REPO, "src", "repro_torch", "_build", "train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log(f"TRAIN_CUT {cfg.name}: global batch {B} of train_4k's "
        f"{SHAPES['train_4k'].global_batch} ({TRAIN_MICROBATCHES} "
        f"microbatches of {TRAIN_MICROBATCH_ROWS}), T {T}, remat, "
        f"{cfg.dtype}, all {cfg.n_layers} layers at full width")

    def s0():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_train_state(model_init(cfg, gen)[0])

    # (0) the embedding gather's backward on the run's tokens
    gather_backward((cfg.padded_vocab, cfg.d_model),
                    torch.stack([b["tokens"] for b in batches]), seed)
    part_done("0 gather backward")

    # (1) six steps from S0
    state = s0()
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in key_paths(state))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    events, metrics = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, m = step(state, batches[i])
        ev[1].record()
        events.append(ev)
        metrics.append(m)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad_norm: {losses} "
                             f"{norms}")
    med = statistics.median(step_ms[1:])
    log("TRAIN " + json.dumps({
        "arch": cfg.name, "dtype": cfg.dtype, "seq": T, "global_batch": B,
        "microbatches": TRAIN_MICROBATCHES, "remat": True,
        "parameters": sum(t.numel() for t in tree_leaves(state.params)),
        "state_bytes": state_bytes, "loss": losses, "grad_norm": norms,
        "lr": [float(m["lr"]) for m in metrics], "step_ms": step_ms,
        "step_ms_median_2_6": med, "tokens_per_s": B * T / med * 1e3,
        "run_s": run_s, "peak_bytes": torch.cuda.max_memory_allocated(),
        "resident_bytes_before": resident}))
    straight = state
    del state, metrics
    part_done("1 six steps")

    # (2) three steps, save, restore into a fresh tree, three more: the
    # straight run's bits
    state = s0()
    for i in range(TRAIN_CKPT_AT):
        state, _ = step(state, batches[i])
    ckdir = os.path.join(work, "ckpt")
    free = shutil.disk_usage(work).free
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepdir = checkpoint.save(state, ckdir, step=TRAIN_CKPT_AT)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(stepdir, f))
                 for f in os.listdir(stepdir))
    fresh = map_with_keys(lambda _, t: torch.empty_like(t), state)
    del state
    t0 = time.perf_counter()
    state, at = checkpoint.restore(fresh, ckdir)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    if at != TRAIN_CKPT_AT:
        raise AssertionError(f"restored step {at}")
    log("CHECKPOINT " + json.dumps({
        "bytes": nbytes, "state_bytes": state_bytes, "save_s": save_s,
        "restore_s": restore_s, "free_disk_bytes": free,
        "leaves": len(key_paths(state))}))
    shutil.rmtree(ckdir)
    for i in range(TRAIN_CKPT_AT, TRAIN_STEPS):
        state, _ = step(state, batches[i])
    same_bits(f"{cfg.name} 3 + checkpoint + 3 vs 6 straight", state,
              straight)
    del straight
    part_done("2 checkpoint and resume")

    # (3) one step traced
    trace_ms = time_ms(lambda: step(state, batches[0]), reps=1, warmup=0)
    profile_path(f"train {cfg.name} one step", lambda: step(state,
                                                            batches[0]),
                 trace_ms, {})
    del state
    part_done("3 one step traced")

    # (4) the ten reduced architectures, float32: a step on the card
    # against the CPU, remat against none
    for arch in ARCHS:
        small = get_reduced(arch)
        cpu_params, _ = model_init(small, seed, device="cpu")
        batch = make_batch(small, "train_4k", seed=seed, batch_override=2,
                           seq_override=16, device="cpu")
        on_card = {k: v.to(dev) for k, v in batch.items()}
        dev_params = tree_map(lambda t: t.to(dev), cpu_params)
        one = make_train_step(small, RunConfig(model=small, remat=False))
        want, wm = one(init_train_state(cpu_params), batch)
        got, gm = one(init_train_state(dev_params), on_card)
        hold_train_state(f"{arch} train step cuda vs cpu", got, gm, want, wm)
        _, rm = make_train_step(small, RunConfig(model=small, remat=True))(
            init_train_state(dev_params), on_card)
        hold(f"{arch} remat loss", abs(float(rm["loss"]) - float(gm["loss"])),
             1e-5)
    small = get_reduced("smollm-135m")
    params, _ = model_init(small, seed, device=dev)
    batch = make_batch(small, "train_4k", seed=seed, batch_override=4,
                       seq_override=16, device=dev)
    s1, _ = make_train_step(small, RunConfig(model=small, remat=False))(
        init_train_state(params), batch)
    s2, _ = make_train_step(small, RunConfig(
        model=small, remat=False, microbatches=2))(init_train_state(params),
                                                   batch)
    hold("smollm-135m microbatches 2 vs 1 params", max(
        float((a - b).abs().max()) for a, b in zip(
            tree_leaves(s1.params), tree_leaves(s2.params))), 5e-3)
    part_done("4 reduced architectures")

    # (5) the training driver twice: the second run resumes
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "12",
            "--ckpt-every", "5", "--ckpt-dir", os.path.join(work, "driver")]
    outs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_train.main(argv)
        outs.append(buf.getvalue())
        log("TRAIN_DRIVER " + json.dumps(outs[-1].splitlines()))
    if "resumed" in outs[0] or "resumed at 10" not in outs[1]:
        raise AssertionError(f"launch.train did not resume: {outs}")
    shutil.rmtree(work)
    counts = native.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"training launched kernels of this package: "
                             f"{counts}")
    part_done("5 launch.train")


def leaf_file(work: str, key: str) -> str:
    return os.path.join(work, "single", key.replace("/", "__") + ".npy")


def save_leaves(tree, work: str) -> None:
    """Every leaf of a state as a ``.npy`` file (bf16 as its bits)."""
    import numpy as np
    import torch

    from repro_torch.train.tree import key_paths
    os.makedirs(os.path.join(work, "single"), exist_ok=True)
    for k, t in key_paths(tree):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        np.save(leaf_file(work, k), t.numpy())


def saved_shard(work: str, key: str, like, sharding):
    """This rank's shard of a saved full leaf (read from a memory map:
    only the shard's bytes), on ``like``'s device and dtype."""
    import numpy as np
    import torch
    arr = np.load(leaf_file(work, key), mmap_mode="r")
    coord = sharding.mesh.get_coordinate()
    for i, d in sharding.sharded_dims():
        arr = np.array_split(arr, sharding.mesh.shape[i], axis=d)[coord[i]]
    t = torch.from_numpy(np.array(arr))      # a writable copy
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def host_memory() -> str:
    """This process's resident and peak resident memory, and the host's
    available memory (from ``/proc``)."""
    fields = {}
    for path, keys in (("/proc/self/status", ("VmRSS", "VmHWM")),
                       ("/proc/meminfo", ("MemAvailable",))):
        try:
            with open(path) as fh:
                for ln in fh:
                    k, _, v = ln.partition(":")
                    if k in keys:
                        fields[k] = v.strip()
        except OSError:
            pass
    return " ".join(f"{k} {v}" for k, v in fields.items())


def gloo_cuda_probe(world: int) -> dict:
    """Each collective the sharded step calls, once on small CUDA tensors
    over the default group, its result checked.  The step calls them
    directly: a collective gloo refuses raises here, on every rank."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    ar = torch.arange(2 * world, device="cuda", dtype=torch.bfloat16)
    x = ar[2 * rank:2 * rank + 2].clone()
    cases = {"all_gather_into_tensor": (x.new_empty(2 * world), x, ar),
             "reduce_scatter_tensor": (x.new_empty(2), ar,
                                       world * ar[2 * rank:2 * rank + 2]),
             "all_reduce": (x.clone(), None, ar.reshape(world, 2).sum(0))}
    for op, (out, inp, want) in cases.items():
        if op == "all_reduce":
            dist.all_reduce(out)
        else:
            getattr(dist, op)(out, inp)
        if not torch.equal(out, want):
            raise AssertionError(f"gloo {op} on CUDA tensors gave "
                                 f"{out.tolist()}, not {want.tolist()}")
    return dict.fromkeys(cases, "direct")


def shard_rank(rank: int, world: int, work: str) -> None:
    """Phase 13, one rank of ``world`` on the card (gloo): the mesh (its
    collectives probed on CUDA tensors), granite-moe-1b's params placed by
    ``tree_sharding``, ``SHARD_STEPS`` sharded steps (step ms between
    barriers, the second step's collectives counted), each local shard
    held to the one-device run's, then ``launch.train --mesh 2x2``
    straight and resumed.  What it measured goes to
    ``work/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import native
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import CollectiveBytes
    from repro_torch.models import model_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.tree import key_paths
    torch.cuda.set_device(0)
    torch.set_num_threads(1)      # four ranks and the parent share 8 cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "single", "meta.json")) as fh:
        meta = json.load(fh)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    t_start = time.perf_counter()
    card_free_min = [None]

    def mark(stage: str) -> None:
        # progress, so the parent can say where a failed rank stopped
        with open(os.path.join(work, f"rank{rank}.log"), "a") as fh:
            free, _ = torch.cuda.mem_get_info()
            card_free_min[0] = min(free, card_free_min[0] or free)
            fh.write(f"{time.perf_counter() - t_start:.1f} s {stage}: "
                     f"allocated {torch.cuda.memory_allocated()} peak "
                     f"{torch.cuda.max_memory_allocated()} reserved peak "
                     f"{torch.cuda.max_memory_reserved()} card free "
                     f"{free}; host {host_memory()}\n")

    try:
        native.reset_launch_counts()
        mesh = make_host_mesh(SHARD_MESH[1], "cuda")
        if tuple(mesh.shape) != SHARD_MESH:
            raise AssertionError(f"mesh {mesh} is not {SHARD_MESH}")
        rec = {"rank": rank, "coord": list(mesh.get_coordinate()),
               "routes": gloo_cuda_probe(world)}
        mark(f"mesh, routes {rec['routes']}")
        cfg = get_config(SHARD_ARCH)
        rules = SH.default_rules(False, "train")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(meta["seed"])
        params, specs = model_init(cfg, gen)
        dparams = SH.distribute_params(params, SH.tree_sharding(
            params, specs, rules, mesh))
        del params
        torch.cuda.empty_cache()
        state = init_train_state(dparams)
        del dparams
        mark("state")
        rec["local_state_bytes"] = sum(
            (t.to_local() if SH.is_dtensor(t) else t).numel()
            * t.element_size() for _, t in key_paths(state))
        ds = SyntheticLM(cfg.vocab, SHARD_T, SHARD_BATCH, seed=meta["seed"],
                         device="cuda")
        step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["resident_bytes"] = torch.cuda.memory_allocated()
        metrics, ms = [], []
        with SH.mesh_context(mesh, rules):
            for i in range(SHARD_STEPS):
                counting = i == 1
                dist.barrier()
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                with CommDebugMode() as cdm, CollectiveBytes() as coll:
                    ev[0].record()
                    state, m = step(state, ds.batch_at(i))
                    ev[1].record()
                ev[1].synchronize()
                mark(f"step {i}")
                dist.barrier()
                ms.append(ev[0].elapsed_time(ev[1]))
                metrics.append({k: float(v) for k, v in m.items()})
                if counting:
                    rec["collectives"] = coll.summary()
                    rec["comm_debug_ops"] = cdm.get_total_counts()
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        rec["step_ms"] = ms
        rec["metrics"] = metrics
        # each local shard against the one-device run's (PERF.md §2):
        # params 2**-7 |want| + 2 Σ lr a value, m, v by the leaf's
        # relative norm.  Three steps move a bf16 weight by ~Σ lr, below
        # one ulp, so the params bound holds the placement (the right
        # shard of the right leaf), not the update: m and v, float32,
        # hold the sharded gradient
        lr_sum = sum(m["lr"] for m in metrics)
        worst = {"params": 0.0, "m": 0.0, "v": 0.0}
        for part, tree in (("params", state.params), ("m", state.opt.m),
                           ("v", state.opt.v)):
            prefix = {"params": "0", "m": "1/0", "v": "1/1"}[part]
            for k, t in key_paths(tree):
                local = t.to_local()
                want = saved_shard(work, f"{prefix}/{k}", local,
                                   SH.sharding_of(t)).double()
                got = local.double()
                if part == "params":
                    tol = 2.0 ** -7 * want.abs() + 2 * lr_sum
                    err = float(((got - want).abs() / tol).max())
                else:
                    err = float((got - want).norm() / want.norm().clamp(
                        min=1e-30)) / (2.0 ** -4)
                worst[part] = max(worst[part], err)
        rec["worst_err/tol"] = worst
        rec["launches"] = {k: n for k, n in native.launch_counts().items()
                           if n}
        mark("held to one device")
        del state
        torch.cuda.empty_cache()
        # launch.train --mesh 2x2: six steps straight; three, a
        # checkpoint, three more
        argv = ["--arch", "smollm-135m", "--reduced", "--mesh", "2x2"]
        outs = []

        def driver(extra):
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                st = launch_train.main(argv + extra)
            outs.append(buf.getvalue())
            return st

        straight = driver(["--steps", "6", "--ckpt-every", "100",
                           "--ckpt-dir", os.path.join(work, "straight")])
        ck = os.path.join(work, "resume")
        driver(["--steps", "3", "--ckpt-every", "3", "--ckpt-dir", ck])
        resumed = driver(["--steps", "6", "--ckpt-every", "3",
                          "--ckpt-dir", ck])
        same = 0
        for (k, a), (_, b) in zip(key_paths(straight), key_paths(resumed)):
            a = a.to_local() if SH.is_dtensor(a) else a
            b = b.to_local() if SH.is_dtensor(b) else b
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            if not torch.equal(a, b):
                raise AssertionError(f"rank {rank}: resumed leaf {k} "
                                     f"differs from the straight run's")
            same += 1
        rec["card_free_min_bytes"] = card_free_min[0]
        rec["host"] = host_memory()
        rec["resume"] = {"leaves_bit_for_bit": same,
                         "driver": [o.splitlines() for o in outs]}
        if "resumed at 3" not in outs[2]:
            raise AssertionError(f"rank {rank}: the sharded driver did not "
                                 f"resume: {outs[2]}")
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)
    except Exception:
        import traceback
        mark("failed")
        with open(os.path.join(work, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def rank_reports(work: str, world: int) -> str:
    """Each rank's progress and error files, for a failed phase."""
    out = []
    for r in range(world):
        for ext in ("log", "err"):
            path = os.path.join(work, f"rank{r}.{ext}")
            if os.path.exists(path):
                with open(path) as fh:
                    out.append(f"--- rank {r} {ext}\n{fh.read()}")
    return "\n".join(out)


def sharded_training(dev, seed: int) -> None:
    """Phase 13: granite-moe-1b-a400m over a ``SHARD_MESH`` mesh of four
    gloo ranks on the card, held to the same steps on one device (see
    the module's docstring)."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import native
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models import model_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.tree import key_paths
    cfg = get_config(SHARD_ARCH)
    world = SHARD_MESH[0] * SHARD_MESH[1]
    work = os.path.join(REPO, "src", "repro_torch", "_build", "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "single"))
    log(f"SHARD_CUT {cfg.name}: mesh {SHARD_MESH} of (data, model), "
        f"{world} gloo ranks on cuda:0, global batch {SHARD_BATCH} of "
        f"train_4k's {SHAPES['train_4k'].global_batch}, T {SHARD_T} of "
        f"{SHAPES['train_4k'].seq_len}, {SHARD_STEPS} steps, remat, "
        f"{cfg.dtype}, all {cfg.n_layers} layers at full width")

    # (1) the same steps on one device; its state on disk for the ranks
    native.reset_launch_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_train_state(model_init(cfg, gen)[0])
    step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
    ds = SyntheticLM(cfg.vocab, SHARD_T, SHARD_BATCH, seed=seed, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, ms = [], []
    for i in range(SHARD_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, m = step(state, ds.batch_at(i))
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        metrics.append({k: float(v) for k, v in m.items()})
    single = {"step_ms": ms, "metrics": metrics,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "state_bytes": sum(t.numel() * t.element_size()
                                 for _, t in key_paths(state))}
    t0 = time.perf_counter()
    save_leaves(state, work)
    single["save_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "single", "meta.json"), "w") as fh:
        json.dump({"seed": seed}, fh)
    del state, step
    torch.cuda.empty_cache()
    log("SHARD single " + json.dumps(single))

    # (2) the ranks; meanwhile the dry run of the same cell on a fake mesh.
    # Four ranks' caching allocators share the card: expandable segments
    # keep each one's reserve near what it allocates
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    free, _ = torch.cuda.mem_get_info()
    log(f"SHARD parent before spawning: allocated "
        f"{torch.cuda.memory_allocated()} reserved "
        f"{torch.cuda.memory_reserved()} card free {free}; host "
        f"{host_memory()}")
    ctx = mp.start_processes(shard_rank, args=(world, work), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * SHARD_TIMEOUT_S
    try:
        t0 = time.perf_counter()
        dry = lower_cell(cfg.name, ShapeConfig(
            "train_4k", SHARD_T, SHARD_BATCH, "train"), False,
            cfg_override=cfg, mesh_shape=SHARD_MESH)
        log("SHARD dryrun " + json.dumps({
            "s": time.perf_counter() - t0, "cost": dry["cost"],
            "memory": dry["memory"], "collectives": dry["collectives"],
            "analytic_memory": dry["analytic_memory"]}))
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError("phase 13: a rank did not finish")
    except Exception:
        log(rank_reports(work, world))
        log(f"SHARD exit codes {[p.exitcode for p in ctx.processes]}; "
            f"host {host_memory()}")
        raise
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))

    # (3) the ranks against one device, and against the dry run
    for rec in ranks:
        for g, w in zip(rec["metrics"], single["metrics"]):
            for k in ("loss", "grad_norm"):
                hold(f"sharded rank {rec['rank']} {k}", abs(g[k] - w[k]),
                     2.0 ** -8 * abs(w[k]))
            hold(f"sharded rank {rec['rank']} lr", abs(g["lr"] - w["lr"]),
                 1e-7 * abs(w["lr"]))
        for part, worst in rec["worst_err/tol"].items():
            hold(f"sharded rank {rec['rank']} {part} worst_err/tol", worst,
                 1.0)
        if rec["collectives"]["per_op_bytes"] != \
                dry["collectives"]["per_op_bytes"]:
            raise AssertionError(f"rank {rec['rank']}: collectives "
                                 f"{rec['collectives']} against the dry "
                                 f"run's {dry['collectives']}")
        if rec["launches"]:
            raise AssertionError(f"sharded training launched kernels of "
                                 f"this package: {rec['launches']}")
        line = {k: rec[k] for k in ("rank", "coord", "routes",
                                    "local_state_bytes", "resident_bytes",
                                    "peak_bytes", "peak_reserved_bytes",
                                    "step_ms", "collectives",
                                    "comm_debug_ops", "worst_err/tol",
                                    "card_free_min_bytes", "host")}
        line["loss"] = [m["loss"] for m in rec["metrics"]]
        line["grad_norm"] = [m["grad_norm"] for m in rec["metrics"]]
        line["resume_leaves_bit_for_bit"] = rec["resume"][
            "leaves_bit_for_bit"]
        log("SHARD " + json.dumps(line))
    log("SHARD_DRIVER " + json.dumps(ranks[0]["resume"]["driver"]))
    log("SHARD summary " + json.dumps({
        "single_step_ms": single["step_ms"],
        "sharded_step_ms_median_2_3": [statistics.median(r["step_ms"][1:])
                                       for r in ranks],
        "dryrun_argument_bytes": dry["memory"]["argument_size_in_bytes"],
        "local_state_bytes": [r["local_state_bytes"] for r in ranks],
        "single_state_bytes": single["state_bytes"],
        "peak_bytes": [r["peak_bytes"] for r in ranks]}))
    shutil.rmtree(work)


def engine_kernels(backend: str, fused: bool = False) -> tuple:
    """The kernels a plan on ``backend`` launches (a tuple inside: any
    one of its stems): the ``torch`` engine's segment sums run K4c."""
    return {"torch": ("combine",),
            "cuda": (("chain", "combine") if fused
                     else (("reduce", "product"),)),
            "cuda-splitk": ("splitk", "combine")}[backend]


def kept_schedules(spec, levels, blocks, fit_bytes: int):
    """The candidates ``tune`` ranks on every engine at ``blocks``, the
    largest buffer of each, the schedules in rank order, and the length
    of the longest head of schedules whose every candidate's largest
    buffer stays under ``fit_bytes`` (``max_candidates`` for a search
    that fits)."""
    from repro_torch.autotune import generate_candidates
    full = generate_candidates(spec, nnz_levels=levels, blocks=blocks,
                               backends=("torch", "cuda", "cuda-splitk"))
    sizes = {c.key: largest_buffer_bytes(spec, c, levels) for c in full}
    schedules: list = []
    for c in full:
        if (c.path, c.order) not in schedules:
            schedules.append((c.path, c.order))
    keep = 0
    for m in range(1, len(schedules) + 1):
        if all(sizes[c.key] <= fit_bytes for c in full
               if (c.path, c.order) in schedules[:m]):
            keep = m
        else:
            break
    return full, sizes, schedules, keep


def dist_time_ms(call, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time in ms of one distributed call, every rank
    meeting at a barrier before and after each timed call."""
    import torch
    import torch.distributed as dist
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        dist.barrier()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dist_rank(rank: int, world: int, work: str) -> None:
    """Phase 10, one rank of ``world`` on the card (gloo): the nell-2 COO
    memory-mapped from ``work``, each of ``DIST_CASES`` through the
    port's entry point as a user calls it (its output, after
    ``undo_cyclic`` and the trim, held to the single-device output), then
    ``compressed_psum`` and ``reduce_scatter_grads`` against the exact
    collectives.  What it measured goes to ``work/rank<r>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch import distributed as D
    from repro_torch.autotune import TunerConfig
    from repro_torch.core import spec as S
    from repro_torch.core.planner import plan
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     reduce_scatter_grads)
    from repro_torch.distributed.spttn_dist import (partition_mesh,
                                                    partition_nonzeros,
                                                    rank_shard, undo_cyclic)
    from repro_torch.kernels import native
    from repro_torch.sparse import COOTensor
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "meta.json")) as fh:
        meta = json.load(fh)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        native.load_library()          # the parent built it: loaded only
        coo = COOTensor(
            coords=np.load(os.path.join(work, "coords.npy"), mmap_mode="r"),
            values=np.load(os.path.join(work, "values.npy"), mmap_mode="r"),
            shape=tuple(meta["shape"]))
        levels = {int(k): v for k, v in meta["levels"].items()}
        I, J, K = coo.shape
        specs = {"MTTKRP": S.mttkrp(I, J, K, 64),
                 "TTMc3": S.ttmc3(I, J, K, 16, 16)}
        meshes: dict = {}
        out = []
        for case, name, shape, axes, mode_axis, entry in DIST_CASES:
            spec = specs[name]
            f = {k: torch.from_numpy(np.load(os.path.join(
                work, f"{name}.{k}.npy"))).cuda()
                for k in meta["factors"][name]}
            want = torch.from_numpy(np.load(os.path.join(work,
                                                         f"{name}.want.npy")))
            if shape not in meshes:
                meshes[shape] = init_device_mesh("cuda", shape,
                                                 mesh_dim_names=axes)
            mesh = meshes[shape]
            rec = {"case": case, "spec": name, "entry": entry,
                   "mesh": list(shape), "axes": list(axes),
                   "mode_axis": {str(m): a for m, a in mode_axis.items()},
                   "backend": dist.get_backend()}
            if case == "a":
                t0 = time.perf_counter()
                partition_mesh(spec, coo, mesh, mode_axis)
                rec["partition_mesh_s"] = time.perf_counter() - t0
                rec["nnz_per_shard_blocks"] = [
                    c.nnz for c in partition_nonzeros(coo, {0: world},
                                                      cyclic=False)]
            t0 = time.perf_counter()
            if entry == "make_distributed_tuned":
                cfg = TunerConfig(backends=("torch", "cuda", "cuda-splitk"),
                                  blocks=(8,),
                                  max_candidates=meta["tune_keep"][name])
                d = D.make_distributed_tuned(
                    spec, coo, mesh, mode_axis, tuner=cfg,
                    cache_dir=os.path.join(work, "plans"))
                rec["mode"] = d.mode
                rec["winners"] = [None if sh.plan is None else {
                    "shard": sh.index, "backend": sh.plan.backend,
                    "fused": sh.plan.fused, "block": sh.plan.block,
                    "path": [str(t) for t in sh.plan.path],
                    "cache_hit": sh.stats.cache_hit,
                    "search_s": sh.stats.search_seconds}
                    for sh in d.shards]
                # the harmonized plan of a collective mode, else this
                # rank's shard's own (none for an empty shard)
                ran = (d.collective.plan if d.collective is not None else
                       d.shards[rank_shard(mesh, tuple(axes))[0]].plan)
                expect = (engine_kernels(ran.backend, ran.fused)
                          if ran is not None else ())

                def call(d=d, f=f):
                    return d(f)
            else:
                p = plan(spec, nnz_levels=levels)
                d = getattr(D, entry)(spec, p, coo, mesh, mode_axis)
                expect = engine_kernels("torch" if entry == "make_distributed"
                                        else "cuda", p.fused)

                def call(d=d, f=f, spec=spec, mode_axis=mode_axis,
                         mesh=mesh):
                    return undo_cyclic(d(f), spec, mode_axis, mesh,
                                       coo.shape)[:I]
            rec["build_s"] = time.perf_counter() - t0
            rec["nnz_per_shard"] = list(d.nnz_per_shard)
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            native.reset_launch_counts()
            got = call()
            torch.cuda.synchronize()
            counts = native.launch_counts()
            rec["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
            rec["launches"] = {k: n for k, n in counts.items() if n}
            missing = [s for s in expect if not any(
                counts[x] for x in (s if isinstance(s, tuple) else (s,)))]
            if missing:
                raise AssertionError(f"rank {rank} case {case}: kernels "
                                     f"{missing} were not launched")
            rec["max_abs_err"] = check(
                f"dist {case} {name} rank {rank} vs one device", got, want)
            del got
            rec["ms"] = dist_time_ms(call)
            # where a call's time goes: the rank's engine on its padded
            # shard with no collective, all ranks at once, and each rank
            # alone while the others wait
            eng = getattr(d, "collective", None) or d
            if hasattr(eng, "executor"):
                fl = eng._prepare(f)

                def local(eng=eng, fl=fl):
                    return eng.executor(eng.arrays, fl)

                rec["local_ms"] = dist_time_ms(local)
                for r in range(world):
                    solo = dist_time_ms(local if r == rank else lambda: None)
                    if r == rank:
                        rec["solo_ms"] = solo
                del fl, local
            out.append(rec)
            del d, call
            torch.cuda.empty_cache()

        # (d) the int8 all-reduce against the exact one, within one scale
        # unit of every rank's block; the ZeRO-2 gradient slices
        n = DIST_PSUM_BYTES // 4
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + rank)
        x = torch.randn(n, generator=gen, device="cuda")
        exact = x.clone()
        dist.all_reduce(exact)
        qgen = torch.Generator(device="cuda")
        qgen.manual_seed(2000 + rank)
        got = compressed_psum(x, None, qgen)
        unit = x.reshape(-1, 256).abs().amax(1).div(127.0).clamp_min(1e-12)
        dist.all_reduce(unit)
        bound = unit.repeat_interleave(256) * (1 + 1e-5) + 1e-6 * exact.abs()
        diff = got - exact
        rec = {"case": "d", "entry": "compressed_psum", "bytes": n * 4,
               "backend": dist.get_backend(),
               "worst_err/bound": float((diff.abs() / bound).max()),
               "mean_err": float(diff.mean()),
               "mean_bound": float(unit.mean()),
               "ms": dist_time_ms(lambda: compressed_psum(x, None, qgen)),
               "all_reduce_ms": dist_time_ms(
                   lambda: dist.all_reduce(x.clone()))}
        if rec["worst_err/bound"] > 1.0:
            raise AssertionError(f"rank {rank}: compressed_psum off by "
                                 f"{rec['worst_err/bound']} of its bound")
        grads = {"w": torch.randn((4096, 1024), generator=gen,
                                  device="cuda"),
                 "b": torch.randn(1023, generator=gen, device="cuda")}
        sliced = reduce_scatter_grads(grads)     # gloo, CUDA tensors
        for k, g in grads.items():
            full = g.clone()
            dist.all_reduce(full)
            if k == "w":
                full = full.chunk(world)[rank]
            check(f"dist d reduce_scatter_grads {k} rank {rank}", sliced[k],
                  full)
        out.append(rec)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def distributed_paths(coo, specs, factors, arrays, levels, torch_out, drv,
                      tune_keep) -> None:
    """Phase 10: ``DIST_RANKS`` gloo ranks on the card drive
    ``DIST_CASES`` and the compressed all-reduce (``dist_rank``), each
    output held to the single-device one computed here first; then one
    NCCL rank runs (b)'s plan.  A ``DIST`` line per case gives the mesh,
    nonzeros per shard, seconds to build, ms beside the single device's,
    each rank's peak and launches."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.executor import execute_plan
    from repro_torch.core.planner import plan
    from repro_torch.distributed import make_distributed_cuda
    from repro_torch.distributed.spttn_dist import undo_cyclic
    from repro_torch.kernels import native
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dist-", dir=native.BUILD_DIR)
    np.save(os.path.join(work, "coords.npy"), coo.coords)
    np.save(os.path.join(work, "values.npy"), coo.values)
    single = {}
    for name in ("MTTKRP", "TTMc3"):
        for k, t in factors[name].items():
            np.save(os.path.join(work, f"{name}.{k}.npy"), t.cpu().numpy())
        np.save(os.path.join(work, f"{name}.want.npy"),
                torch_out[name].cpu().numpy())
        p = plan(specs[name], nnz_levels=levels)
        for backend in ("torch", "cuda"):
            single[f"{name} {backend}"] = time_ms(
                lambda p=p, b=backend, f=factors[name]: execute_plan(
                    p, arrays, f, backend=b))
    with open(os.path.join(work, "meta.json"), "w") as fh:
        json.dump({"shape": list(coo.shape),
                   "levels": {str(k): int(v) for k, v in levels.items()},
                   "factors": {n: sorted(factors[n]) for n in factors},
                   "tune_keep": tune_keep}, fh)
    log(f"DIST single-device ms {json.dumps(single)}; tune max_candidates "
        f"{tune_keep}")
    torch.cuda.empty_cache()
    # every rank on the one card: NCCL refuses two ranks on one GPU
    # ("Duplicate GPU detected"), gloo moves CUDA tensors through host
    # memory; the kernels still run on the card
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    log(f"DIST spawning {DIST_RANKS} ranks, backend gloo, all on cuda:0 "
        f"(NCCL refuses two ranks on one GPU)")
    ctx = mp.start_processes(dist_rank, args=(DIST_RANKS, work),
                             nprocs=DIST_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 2 * DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError("phase 10: a rank did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    for i, rec in enumerate(ranks[0]):
        per = [rk[i] for rk in ranks]
        line = {k: v for k, v in rec.items()
                if k not in ("ms", "local_ms", "solo_ms", "peak_GiB",
                             "launches", "build_s", "max_abs_err",
                             "partition_mesh_s", "all_reduce_ms")}
        line["ranks"] = DIST_RANKS
        for key in ("ms", "local_ms", "solo_ms", "build_s",
                    "partition_mesh_s", "peak_GiB", "launches",
                    "max_abs_err", "all_reduce_ms"):
            if key in rec:
                line[key] = [r[key] for r in per]
        if "nnz_per_shard" in rec:
            line["nnz_min"] = min(rec["nnz_per_shard"])
            line["nnz_max"] = max(rec["nnz_per_shard"])
        if rec.get("spec"):
            engine = "cuda" if rec["entry"] == "make_distributed_cuda" \
                else "torch"
            line["single_device_ms"] = single[f"{rec['spec']} {engine}"]
        for r in per:
            for stem, n in r.get("launches", {}).items():
                drv.launches[stem] += n
        log("DIST " + json.dumps(line))

    # (e) one NCCL rank running (b)'s plan: its all_reduce (mode j
    # partitioned) and its all_gather (mode i) go through NCCL
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(work, "nccl-store"),
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        spec, f = specs["MTTKRP"], factors["MTTKRP"]
        p = plan(spec, nnz_levels=levels)
        for mode_axis in ({0: "data"}, {1: "data"}):
            t0 = time.perf_counter()
            d = make_distributed_cuda(spec, p, coo, mesh, mode_axis)
            build_s = time.perf_counter() - t0

            def run(d=d, mode_axis=mode_axis):
                return undo_cyclic(d(f), spec, mode_axis, mesh,
                                   coo.shape)[:coo.shape[0]]

            peak, counts = peak_and_launches(run, (
                f"dist e nccl {mode_axis} vs one device",
                torch_out["MTTKRP"]))
            missing = [s for s in engine_kernels("cuda", p.fused) if not any(
                counts[x] for x in (s if isinstance(s, tuple) else (s,)))]
            if missing:
                raise AssertionError(f"(e): kernels {missing} were not "
                                     f"launched")
            for stem, n in counts.items():
                drv.launches[stem] += n
            log("DIST " + json.dumps({
                "case": "e", "spec": "MTTKRP", "entry":
                "make_distributed_cuda", "mesh": [1], "axes": ["data"],
                "mode_axis": {str(m): a for m, a in mode_axis.items()},
                "backend": dist.get_backend(), "ranks": 1,
                "build_s": build_s, "ms": time_ms(run),
                "single_device_ms": single["MTTKRP cuda"],
                "peak_GiB": peak / 2**30,
                "launches": {k: n for k, n in counts.items() if n}}))
            del d
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


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
        from repro_torch.autotune import TunerConfig
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.core import spec as S
        from repro_torch.core.executor import (CSFArrays, execute_plan,
                                               factors_to_torch,
                                               reference_execute,
                                               segment_sum)
        from repro_torch.core.planner import plan
        from repro_torch.kernels import native, ops, paper
        from repro_torch.kernels.codegen.ir import chain_items
        from repro_torch.kernels.segment import segment_ptr
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
    spilled = []
    for rec in ptxas_kernels(report):
        log("PTXAS " + json.dumps(rec))
        must_not = rec["stem"] in NO_SPILL_STEMS or any(
            k in rec["kernel"] for k in NO_SPILL_KERNELS)
        if must_not and (rec.get("spill_stores") or rec.get("spill_loads")):
            spilled.append(rec["kernel"])
    for line in report.splitlines():  # e.g. wgmma serialized (C7513)
        if "Potential Performance Loss" in line:
            log("PTXAS_NOTE " + line.strip())
    if spilled:
        raise AssertionError(f"kernels that must keep their state in "
                             f"registers spill: {spilled}")
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(
        native._nvcc())), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    tensor_core = {k: c for k, c in sass_counts(sass).items()
                   if any(t in k for t in TENSOR_CORE_KERNELS)}
    for kernel, c in tensor_core.items():
        log("SASS " + json.dumps({"kernel": kernel, **c}))
    if len(tensor_core) < len(TENSOR_CORE_KERNELS) or not all(
            c["HGMMA"] and c["UTMALDG"] for c in tensor_core.values()):
        raise AssertionError(f"a bf16 matrix-product kernel lacks wgmma or "
                             f"TMA instructions: {tensor_core}")
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
    k1_item_checks(dev)
    phase_done("2b K1 items")
    k6_item_checks(dev)
    phase_done("2c K6 items")

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
    tune_keep = {}          # phase 10's, under a quarter of the card each
    for name in ("MTTKRP", "TTMc3"):
        spec, f = specs[name], factors[name]
        full, sizes, schedules, keep = kept_schedules(spec, levels, blocks,
                                                      FIT_BYTES)
        tune_keep[name] = kept_schedules(spec, levels, blocks,
                                         FIT_BYTES // DIST_RANKS)[3]
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
        replay = engine_kernels(tuned.backend, tuned.fused)

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
                    expect=("mttkrp", "combine"), measure_as="ops")
    items5 = chain_items(torch.from_numpy(segment_ptr(lay5.block_seg,
                                                      lay5.nseg)),
                         paper.MTTKRP_ITEM_BLOCKS)
    log(f"K5 ops.mttkrp: block {lay5.block}, P = {lay5.padded_len} padded "
        f"rows ({lay5.nblocks} blocks) for {lay5.nseg} segments; nitems "
        f"{items5.nitems}, cap {items5.cap}")
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
                    expect=("ttmc", "combine"), measure_as="ops")
    items6 = ops.ttmc_fiber_items(lay6)
    log(f"K6 ops.ttmc_fiber: block {lay6.block}, P = {lay6.padded_len} "
        f"padded rows ({lay6.nblocks} blocks) for {lay6.nseg} segments; "
        f"nitems {items6.nitems}, cap {items6.cap}")
    check("ops.ttmc_fiber vs TTMc3 torch", got, torch_out["TTMc3"][rows1])
    host, path6 = ttmc_fiber_host(ug, xf, lay6)
    log(f"HOST ops.ttmc_fiber (K6 path {path6}) " + json.dumps(
        {**host, "sum of parts": sum(v for k, v in host.items()
                                     if k not in ("astype", "whole call"))}))
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
    # kv heads expanded to the query heads inside the timed path; each
    # band in float32 too, held at 1e-4 (gemma3's short band weighs a
    # block's prologue and epilogue most)
    T9 = SHAPES["prefill_32k"].seq_len
    for arch, dtype in (("recurrentgemma-9b", None),
                        ("recurrentgemma-9b", torch.float32),
                        ("gemma3-1b", None), ("gemma3-1b", torch.float32)):
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

    # -- 8. memory-budgeted sliced execution --------------------------- #
    sliced_paths(specs, factors, arrays, levels, torch_out, drv)
    phase_done("8 sliced execution")

    # -- 9. the plan service: MoE dispatch at granite-moe-1b's widths -- #
    serve_stream(moe, dev, args.seed, drv)
    phase_done("9 plan service")

    # -- 10. distributed SpTTN: four gloo ranks, one NCCL rank ---------- #
    distributed_paths(coo, specs, factors, arrays, levels, torch_out, drv,
                      tune_keep)
    phase_done("10 distributed")

    # -- 11. the model stack and its server: granite-moe-1b at full width #
    serve_models(dev, args.seed)
    phase_done("11 serve")

    # -- 12. single-device training: granite-moe-1b at full width ------ #
    train_models(dev, args.seed)
    phase_done("12 train")

    # -- 13. sharded training: granite-moe-1b over a (2, 2) mesh -------- #
    sharded_training(dev, args.seed)
    phase_done("13 sharded train")

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
