"""Multi-pod dry run: trace every (arch x shape x mesh) cell without a
device (the JAX package's ``launch/dryrun.py``).

For each cell this traces the real step function (the sharded train
step, prefill, or a decode step) under ``FakeTensorMode`` — tensors with
shapes and no storage — on a fake process group the size of the 16x16
single-pod or 2x16x16 multi-pod mesh (``torch.testing``'s ``FakeStore``,
backend ``"fake"``: every collective returns at once), with the state,
batch and caches placed as the production run places them, and records
per device (this process is rank 0, and every rank does the same work):

  * ``cost.flops``: ``FlopCounterMode`` over the step.  The sharded step
    computes on plain local tensors (gathered weights, the rank's rows),
    so the count is the rank's own; around DTensor ops it would count
    the global op;
  * ``cost.bytes_accessed``: each dispatched op's input and output bytes
    (views and collectives excluded) — what the eager step moves, with
    no fusion and no cache;
  * ``memory``: argument bytes (the rank's shards of the state and its
    rows of the batch), output bytes, and temp bytes (``MemTracker``'s
    peak over the step less the arguments);
  * ``collectives``: the c10d collectives the step issues
    (``roofline.CollectiveBytes``), in the reference parser's dict.

XLA counts a ``while`` body once, so the reference compiles 2- and
3-group probes and extrapolates (``cost_corrected``).  The eager trace
runs every layer, so here ``cost_corrected`` is ``cost`` and there is no
probe.  Fields with no counterpart are listed under ``unavailable``
with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, RunConfig, ShapeConfig,
                                 get_config, input_specs, shape_applicable)
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import (CollectiveBytes, analytic_memory,
                                         roofline_terms)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.train_step import init_train_state, make_train_step

UNAVAILABLE = {
    "compile_s": "eager PyTorch compiles nothing; lower_s is the trace",
    "cost.transcendentals": "no per-op count of transcendentals in "
                            "FlopCounterMode",
    "cost.optimal_seconds": "XLA's own estimate; see roofline",
    "memory.generated_code_size_in_bytes": "eager: no generated code",
    "probe_body": "the eager trace counts every layer: no probe",
    "collectives_probe": "the eager trace counts every layer: no probe",
}


def abstract_params(cfg: ModelConfig):
    """(params as fake tensors, logical-axis specs) without allocating."""
    return L.abstract_init(T.model_init, cfg, 0, "cpu")


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group: it makes a fake one of the mesh's size")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        if SH.is_dtensor(x):
            x = x.to_local()
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    if isinstance(x, dict):
        return sum(_nbytes(t) for t in x.values())
    if hasattr(x, "__dataclass_fields__"):
        return sum(_nbytes(getattr(x, f)) for f in x.__dataclass_fields__)
    return 0


class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Input and output bytes of each dispatched op but views and
    collectives: what the eager step reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not func.is_view:
            self.bytes += _nbytes(list(args)) + _nbytes(
                list(kwargs.values())) + _nbytes(out)
        return out


def _fake(spec: torch.Tensor) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype)


def _batch_sharding(batch_shapes, rules, mesh):
    """Rows over the data axes, the rest whole."""
    dataxes = rules["act_batch"]
    return {k: SH.NamedSharding(mesh, (dataxes,) + (None,) * (v.ndim - 1))
            for k, v in batch_shapes.items()}


def _cache_sharding(cache_shapes, rules, mesh, B: int, S: int):
    """KV/state cache shardings.  Batched decode: shard the batch axis over
    the data axes; long-context (batch < data axis): shard the sequence
    axis instead."""
    data = rules["act_batch"]
    seq = rules.get("act_seq")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = (data,) if isinstance(data, str) else tuple(data)
    d_extent = 1
    for a in axes:
        d_extent *= sizes[a]

    def one(leaf):
        parts: list = [None] * leaf.ndim
        if seq is not None:
            for ax, sz in enumerate(leaf.shape):
                if sz == S and sz % sizes[seq] == 0:
                    parts[ax] = seq
                    break
        else:
            for ax, sz in enumerate(leaf.shape):
                if sz == B and sz % d_extent == 0:
                    parts[ax] = data
                    break
        return SH.NamedSharding(mesh, tuple(parts))

    return L.tree_map(one, cache_shapes)


def _gathered(params):
    leaves = L.tree_leaves(params)
    full = iter(SH.gather_full(t.to_local(), SH.sharding_of(t))
                for t in leaves)
    return L.tree_map(lambda _: next(full), params)


def _lower(cfg: ModelConfig, sc: ShapeConfig, mesh, rules,
           kv_dtype=torch.bfloat16) -> dict:
    """Trace the cell's real step on fake tensors; the counts of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    run = RunConfig(model=cfg, microbatches=1)
    with FakeTensorMode():
        params, specs = abstract_params(cfg)
        params_sh = SH.tree_sharding(params, specs, rules, mesh)
        dparams = SH.distribute_params(params, params_sh)
        del params
        specs_in = input_specs(cfg, sc)
        batch = {k: _fake(v) for k, v in specs_in.items()}
        split = SH.batch_split_for(mesh, rules, sc.global_batch)
        # the rank's rows of the batch (each rank is given the global
        # batch and keeps these)
        rows = sum(_nbytes(SH.local_shard(v, sh)) for v, sh in zip(
            batch.values(), _batch_sharding(batch, rules, mesh).values()))
        if sc.kind == "train":
            # m and v are placed as the params, the step replicated (the
            # reference's _state_sharding)
            args = (init_train_state(dparams), batch)
            arg_bytes = _nbytes(args[0]) + rows
            fn = make_train_step(cfg, run)
        elif sc.kind == "prefill":
            def fn(params, batch):
                full = _gathered(params)
                with SH.batch_split(split):
                    return T.prefill(full, cfg, {k: split.rows(v) for k, v
                                                 in batch.items()})
            args = (dparams, batch)
            arg_bytes = _nbytes(dparams) + rows
        else:
            B, S = sc.global_batch, sc.seq_len
            caches = T.init_cache(cfg, B, S, kv_dtype, device="cpu")
            cache_sh = _cache_sharding(caches, rules, mesh, B, S)
            local = L.tree_map(SH.local_shard, caches, cache_sh)
            del caches
            enc = None
            if cfg.encdec:
                enc = torch.zeros((B, S // 4, cfg.d_model),
                                  dtype=cfg.compute_dtype)

            def fn(params, local, tokens, pos, enc_out=None):
                full = _gathered(params)
                if split.n > 1:      # caches hold this rank's rows
                    with SH.batch_split(split):
                        return T.decode_step(
                            full, cfg, local, split.rows(tokens), pos,
                            None if enc_out is None else split.rows(enc_out))
                whole = L.tree_map(SH.gather_full, local, cache_sh)
                logits, new = T.decode_step(full, cfg, whole, tokens, pos,
                                            enc_out)
                return logits, L.tree_map(SH.local_shard, new, cache_sh)

            args = (dparams, local, batch["tokens"], S - 1, enc)
            arg_bytes = _nbytes(dparams) + _nbytes(local) + rows + (
                0 if enc is None else _nbytes(split.rows(enc)))
        tracker, peak_why = _mem_tracker(args)
        flops = FlopCounterMode(display=False)
        moved = _ByteCounter()
        t0 = time.time()
        with SH.mesh_context(mesh, rules), CollectiveBytes() as coll, \
                flops, moved, tracker or contextlib.nullcontext():
            out = fn(*args)
        lower_s = time.time() - t0
        peak = None
        if tracker is not None:
            snap = tracker.get_tracker_snapshot("peak")
            peak = max(v["Total"] for v in snap.values())
        out_bytes = _nbytes(out)
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "output_size_in_bytes": int(out_bytes),
           "temp_size_in_bytes": (None if peak is None
                                  else int(max(peak - arg_bytes, 0))),
           "alias_size_in_bytes": 0}   # no argument is donated
    return {"lower_s": lower_s, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(moved.bytes), "memory": mem,
            "collectives": coll.summary(), "peak_why": peak_why}


def _mem_tracker(args):
    """``MemTracker`` with the step's arguments tracked, or ``(None,
    reason)``."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as e:
        return None, f"no MemTracker in this torch ({e})"
    tracker = MemTracker()
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x.to_local() if SH.is_dtensor(x) else x)
        elif isinstance(x, (list, tuple)):
            for t in x:
                walk(t)
        elif isinstance(x, dict):
            for t in x.values():
                walk(t)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(args)
    tracker.track_external(*leaves)
    return tracker, None


def lower_cell(arch: str, shape: str | ShapeConfig, multi_pod: bool,
               kv_dtype=torch.bfloat16, preset: str = "2d",
               cfg_override=None,
               mesh_shape: tuple[int, int] | None = None):
    """One cell's result (the reference's keys; the reference's ``probe``
    argument has no counterpart, see the module's docstring).
    ``mesh_shape`` (the port's) traces on a ``(data, model)`` mesh of that
    shape instead of the production one."""
    cfg = cfg_override or get_config(arch)
    sc = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
    elif multi_pod:
        dims, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        dims, axes = (16, 16), ("data", "model")
    label = "x".join(map(str, dims))
    ok, why = shape_applicable(cfg, sc.name)
    if not ok:
        return {"arch": arch, "shape": sc.name, "skipped": why,
                "mesh": label}
    n_dev = 1
    for d in dims:
        n_dev *= d
    with fake_world(n_dev):
        mesh = make_mesh(dims, axes, "cpu")
        sizes = dict(zip(axes, dims))
        seq_shard = sc.kind == "decode" and sc.global_batch < sizes["data"]
        rules = SH.default_rules(multi_pod, sc.kind, seq_shard=seq_shard,
                                 preset=preset)
        got = _lower(cfg, sc, mesh, rules, kv_dtype)
    cost = {"flops": got["flops"], "bytes_accessed": got["bytes_accessed"]}
    unavailable = dict(UNAVAILABLE)
    if got["memory"]["temp_size_in_bytes"] is None:
        unavailable["memory.temp_size_in_bytes"] = got["peak_why"]
    res = {
        "arch": arch, "shape": sc.name, "mesh": label, "preset": preset,
        "n_devices": n_dev,
        "lower_s": round(got["lower_s"], 1), "compile_s": None,
        "cost": cost,
        "memory": got["memory"],
        "cost_corrected": dict(cost),
        "collectives": got["collectives"],
        "unavailable": unavailable,
    }
    res["analytic_memory"] = analytic_memory(cfg, sc, n_dev, multi_pod,
                                             sizes["model"])
    res["roofline"] = roofline_terms(res, cfg, sc, n_dev)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--preset", default="2d")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            print(f"=== {arch} x {shape} x "
                  f"{'2x16x16' if mp else '16x16'} ===", flush=True)
            try:
                res = lower_cell(arch, shape, mp, preset=args.preset)
            except Exception as e:
                import traceback
                traceback.print_exc()
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "error": f"{type(e).__name__}: {e}"[:500]}
            print(json.dumps(res, indent=1, default=str)[:2000], flush=True)
            results.append(res)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    return results


if __name__ == "__main__":
    main()
