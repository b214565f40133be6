"""Serving example: slot-based continuous batching over a reduced model —
prefill + decode through the port's ``Server`` (the JAX package's
``examples/serve_lm.py``).

    python -m repro_torch.examples.serve_lm [--device cpu]

Six prompts of 8 tokens from ``np.random.default_rng(0)``, 12 new
tokens each, over ``Server(slots=4, cache_len=64)``.  The model stack
runs eagerly on the params' device and launches no kernel of this
package (the reference's reaches no Pallas kernel either).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.models import model_init
from repro_torch.serve.serve_step import Request, Server


SLOTS, CACHE_LEN = 4, 64


def serve(cfg, params) -> list[Request]:
    """Serve the example's six prompts on ``params``' device; prints each
    request's tokens and returns the finished requests."""
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN)
    rng = np.random.default_rng(0)
    for _ in range(6):
        srv.submit(Request(prompt=rng.integers(
            0, cfg.vocab, 8).astype(np.int32), max_new=12))
    done = srv.run(max_steps=64)
    for i, r in enumerate(done):
        print(f"req{i}: prompt={r.prompt[:4]}... -> {r.out}")
    assert len(done) == 6 and all(len(r.out) >= 12 for r in done)
    print("served", len(done), "requests")
    return done


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced("smollm-135m")
    params, _ = model_init(cfg, 0, device=args.device)
    return serve(cfg, params)


if __name__ == "__main__":
    main()
