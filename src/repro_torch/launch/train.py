"""Cluster training driver (the JAX package's ``launch/train.py``): mesh
+ sharded state + checkpoint/restart + straggler monitor.

    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --steps 30 [--device cuda]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-135m --reduced --steps 30 --mesh 2x2

The flags and printed lines are the reference's, and so is the run:
``default_rules(False, "train")``, ``tree_sharding``, the params
distributed over the mesh (``distribute_params``), the step inside
``mesh_context``, a resume from ``latest_step`` of ``--ckpt-dir``, each
step through ``guarded_step``.  ``--device`` (default: the CUDA card) is
the port's one addition.  ``--mesh DxM`` takes its ``D·M`` ranks from
``torchrun``'s environment (gloo when there are more ranks than cards:
NCCL refuses two ranks on one card; each rank on card
``LOCAL_RANK mod count``).  ``auto`` is ``make_host_mesh()`` over the
ranks there are: with one rank (no ``torchrun``), the one device,
unsharded.  Every rank prints; rank 0's lines are the run's.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import make_loader
from repro_torch.distributed import sharding as SH
from repro_torch.models import model_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import StragglerMonitor, guarded_step
from repro_torch.train.train_step import init_train_state, make_train_step


def _ranks(device: torch.device, want: int | None) -> int:
    """The number of ranks, initializing ``torchrun``'s process group if
    it is not yet (``want``: the ranks ``--mesh`` names)."""
    if not dist.is_initialized():
        env = os.environ.get("WORLD_SIZE")
        if env is None or int(env) == 1:
            if want not in (None, 1):
                raise RuntimeError(
                    f"--mesh needs {want} ranks: run under torchrun "
                    f"--nproc-per-node {want}")
            return 1
        many = device.type != "cuda" or int(env) > torch.cuda.device_count()
        dist.init_process_group("gloo" if many else "nccl")
    n = dist.get_world_size()
    if want is not None and n != want:
        raise RuntimeError(f"--mesh needs {want} ranks, torchrun gave {n}")
    return n


def main(argv=None):
    """Train; returns the final state (DTensor leaves when sharded)."""
    from repro_torch.core.executor import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="auto")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    shape = None
    if args.mesh != "auto":
        shape = tuple(int(x) for x in args.mesh.split("x"))
    n = _ranks(dev, None if shape is None else shape[0] * shape[1])
    if dev.type == "cuda" and n > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params, specs = model_init(cfg, 0, device=dev)
    ctx = contextlib.nullcontext()
    if n > 1:
        mesh = (make_host_mesh(device_type=dev.type) if shape is None
                else make_mesh(shape, device_type=dev.type))
        rules = SH.default_rules(False, "train")
        psh = SH.tree_sharding(params, specs, rules, mesh)
        params = SH.distribute_params(params, psh)
        ctx = SH.mesh_context(mesh, rules)
    state = init_train_state(params)
    run = RunConfig(model=cfg, remat=True)

    with ctx:
        step = make_train_step(cfg, run)
        ds, _ = make_loader(cfg.vocab, args.seq, args.batch, device=dev)
        start = ckpt.latest_step(args.ckpt_dir) or 0
        if start:
            state, start = ckpt.restore(state, args.ckpt_dir)
            print(f"resumed at {start}")
        mon = StragglerMonitor()
        for i in range(start, args.steps):
            t0 = time.time()
            state, m = guarded_step(step, state, ds.batch_at(i))
            loss = float(m["loss"])
            dt = time.time() - t0
            if mon.observe(dt):
                print(f"step {i}: straggler flagged ({dt:.2f}s)")
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {loss:.4f} ({dt:.2f}s)", flush=True)
            if (i + 1) % args.ckpt_every == 0:
                ckpt.save(state, args.ckpt_dir, step=i + 1)
    print("train driver done")
    return state


if __name__ == "__main__":
    main()
