"""What the drivers share: the tensor handed to the program, and the
freeing of the program's state before the reference runs."""
from __future__ import annotations

import gc
import time

import torch

from port_bench import generate


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tensor(config: dict, seed: int, dev: torch.device):
    """The configuration's tensor from ``seed``: the harness's copy (on
    the host until the check), its level counts, and the port's
    ``COOTensor`` of the same nonzeros."""
    from repro_torch import COOTensor
    coo = generate.frostt_like(config, seed, dev)
    levels = generate.level_counts(coo)
    host = COOTensor(coords=coo.coords.to(torch.int32).cpu().numpy(),
                     values=coo.values.cpu().numpy(), shape=coo.shape)
    return coo.to("cpu"), levels, host


def load_kernels(dev: torch.device) -> None:
    """Build (the first run in a checkout) or load the port's kernels."""
    if dev.type == "cuda":
        from repro_torch.kernels import native
        native.load_library()


class Timer:
    """Host seconds of a ``with`` block, synchronized at both ends."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds = 0.0

    def __enter__(self):
        sync(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.dev)
        self.seconds = time.perf_counter() - self.t0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
