"""End-to-end LM training driver: a reduced SmolLM-family model through
the full framework path (data pipeline -> train step -> checkpointing;
the JAX package's ``examples/train_lm.py``).  ~200 steps, loss printed
every 20.

    python -m repro_torch.examples.train_lm [--steps 200]
        [--arch smollm-135m] [--ckpt-dir DIR] [--device cpu]

A checkpoint is written every 100 steps, and a run resumes from the
latest one under ``--ckpt-dir`` (``resumed from step N``): pass a
directory of the run's own, as the default one is shared by every run.
The model stack runs eagerly on the params' device and launches no
kernel of this package.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable

from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import make_loader
from repro_torch.models import model_init
from repro_torch.models.layers import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import init_train_state, make_train_step


def train(cfg, params, steps: int, ckpt_dir: str, batch: int = 8,
          seq: int = 64, on_step: Callable | None = None):
    """Train ``cfg`` from ``params`` (or from the latest checkpoint under
    ``ckpt_dir``) up to step ``steps`` on the params' device, saving every
    100 steps; ``on_step(i, metrics)`` sees each step's metrics.  Returns
    the final state."""
    run = RunConfig(model=cfg, remat=False, learning_rate=3e-3,
                    warmup_steps=20)
    step = make_train_step(cfg, run)
    state = init_train_state(params)
    ds, _ = make_loader(cfg.vocab, seq, batch,
                        device=tree_leaves(params)[0].device)

    start = 0
    if ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(state, ckpt_dir)
        print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, steps):
        state, m = step(state, ds.batch_at(i))
        if on_step is not None:
            on_step(i, m)
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{(i - start + 1) / (time.time() - t0):.1f} it/s",
                  flush=True)
        if (i + 1) % 100 == 0:
            ckpt.save(state, ckpt_dir, step=i + 1)
    print("done")
    return state


def main(argv=None):
    """Train the reduced ``--arch``; returns the final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    params, _ = model_init(cfg, 0, device=args.device)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} (reduced) params={n/1e6:.2f}M")
    return train(cfg, params, args.steps, args.ckpt_dir, args.batch,
                 args.seq)


if __name__ == "__main__":
    main()
