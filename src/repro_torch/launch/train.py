"""Training driver on one device (the JAX package's ``launch/train.py``):
state + checkpoint/restart + straggler monitor.

    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --steps 30 [--device cuda]

The flags and printed lines are the reference's, and so is the run:
``RunConfig(model=cfg, remat=True)``, a resume from ``latest_step`` of
``--ckpt-dir``, each step through ``guarded_step``.  ``--device``
(default: the CUDA card) is the port's one addition.  ``--mesh`` other
than ``auto`` raises ``NotImplementedError``: sharded training comes with
the sharding slice (DTensor/FSDP placements); ``auto`` is the one device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import make_loader
from repro_torch.models import model_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import StragglerMonitor, guarded_step
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
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

    if args.mesh != "auto":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training comes with the sharding "
            f"slice (distributed/sharding.py on DTensor/FSDP); this driver "
            f"trains on one device")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params, _ = model_init(cfg, 0, device=args.device)
    state = init_train_state(params)
    run = RunConfig(model=cfg, remat=True)

    step = make_train_step(cfg, run)
    ds, _ = make_loader(cfg.vocab, args.seq, args.batch, device=args.device)
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


if __name__ == "__main__":
    main()
