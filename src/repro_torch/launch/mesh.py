"""Production mesh construction (single-pod 16x16, multi-pod 2x16x16; the
JAX package's ``launch/mesh.py``), on ``init_device_mesh``.

Functions, not module-level constants: a mesh needs an initialized
process group (``torchrun``'s ranks, or a fake group for the dry run),
and importing this module touches none.  Both take the device type from
the caller (default ``"cuda"``) and never fall back to the CPU on their
own.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: tuple[int, ...],
              axes: tuple[str, ...] = ("data", "model"),
              device_type: str = "cuda"):
    """A mesh of ``shape`` over the process group's ranks (the
    reference's ``jax.make_mesh``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialized "
            f"process group of {_size(shape)} ranks (run under torchrun)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 2, device_type: str = "cuda"):
    """Small ``(data, model)`` mesh over the ranks of the process group
    (tests/examples)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = min(model, n)
    data = n // model
    return make_mesh((data, model), ("data", "model"), device_type)
