"""Serving CLI (the JAX package's ``launch/serve.py``): random-weight
requests through the continuous-batching :class:`Server`.

    python -m repro_torch.launch.serve [--arch smollm-135m] [--requests 8]
        [--max-new 16] [--device cuda]

The flags are the reference's.  ``--reduced`` is ``store_true`` with
``default=True`` there, so the reduced configuration is always served;
the port keeps that.  ``--device`` (default ``cuda``) is the port's one
addition: the CLI runs on the card unless told otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model_init
from repro_torch.serve.serve_step import Request, Server


def main(argv=None) -> list[Request]:
    """Serve ``--requests`` prompts of 12 tokens; prints how many were
    served and returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params, _ = model_init(cfg, 0, device=args.device)
    srv = Server(cfg, params, slots=4, cache_len=128)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        srv.submit(Request(prompt=rng.integers(0, cfg.vocab, 12)
                           .astype(np.int32), max_new=args.max_new))
    done = srv.run(max_steps=256)
    print(f"served {len(done)}/{args.requests} requests")
    return done


if __name__ == "__main__":
    main()
