"""Carry the JAX package's params (and caches) across to the port.

:func:`params_from_jax` takes the reference's tree — nested dicts, lists
and tuples whose leaves are arrays (numpy, or anything ``numpy.asarray``
reads, bf16 included) — and returns the port's tree with the same keys
and shapes, on ``device``.  The stacked group leaves keep their leading
``n_groups`` axis, as the port's ``transformer`` runs them.  A
``KVCache`` of the reference (a NamedTuple with fields ``k`` and ``v``)
becomes the port's :class:`~repro_torch.models.attention.KVCache`, so
caches built by the reference's ``prefill``/``init_cache`` cross too.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: torch reads bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device=None):
    """The reference's params (or cache) tree as the port's, on ``device``
    (``None``: the CUDA card)."""
    from repro_torch.core.executor import resolve_device
    dev = resolve_device(device)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and getattr(t, "_fields", None) == ("k",
                                                                    "v"):
            return KVCache(k=walk(t.k), v=walk(t.v))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _leaf(t, dev)

    return walk(tree)
