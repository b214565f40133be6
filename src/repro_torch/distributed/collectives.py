"""Distributed-optimization primitives on ``torch.distributed`` (the JAX
package's ``distributed/collectives.py``): gradient compression and the
ZeRO-2 gradient shape.

``compressed_psum`` — int8 stochastic-rounding all-reduce: blockwise
scale, quantize, all-gather the int8 payloads and float32 scales, sum
the dequantized parts.  Unbiased (E[result] = the exact sum); a quarter
of the wire bytes of a float32 all-reduce.

``reduce_scatter_grads`` — ``reduce_scatter_tensor`` along a group so
each rank only materializes its own gradient slice (ZeRO-2 shape).

The reference's ``shard_map`` (a JAX version shim) has no counterpart.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _quantize_block(x: torch.Tensor, generator: torch.Generator,
                    block: int = 256):
    """``x`` as int8 blocks of ``block`` values with one float32 scale
    each (max |x| / 127), rounded stochastically: uniform noise from
    ``generator`` (on ``x``'s device) in [-0.5, 0.5) before rounding."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = (blocks.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    scaled = blocks / scale
    noise = torch.rand(scaled.shape, generator=generator,
                       device=scaled.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale, x.shape, pad


def _dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape,
                      pad: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(x: torch.Tensor, group=None,
                    generator: torch.Generator | None = None,
                    block: int = 256) -> torch.Tensor:
    """Unbiased int8 stochastic-rounding all-reduce over ``group``
    (``None``: the default group); float32 result.

    int8 payloads + per-block float32 scales are all-gathered and the
    exact dequantized sum is formed locally — 1/4 the wire bytes of a
    float32 ring all-reduce (scales add 4/block).  Stochastic rounding
    keeps E[result] equal to the exact sum; each rank's part is off by
    less than one scale unit per element.  ``generator`` stands in for
    the reference's PRNG key: a ``torch.Generator`` on ``x``'s device,
    seeded differently per rank.
    """
    q, scale, shape, pad = _quantize_block(x, generator, block)
    world = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(world)]
    sg = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qg, q, group=group)
    dist.all_gather(sg, scale, group=group)
    total = torch.stack([a.float() * s for a, s in zip(qg, sg)]).sum(0)
    return _dequantize_block(total, torch.ones_like(scale), shape, pad)


def reduce_scatter_grads(grads: Mapping[str, torch.Tensor],
                         group=None) -> dict[str, torch.Tensor]:
    """Sum every gradient over ``group`` and keep this rank's slice of
    dim 0 (``reduce_scatter_tensor``, the ZeRO-2 gradient shape).
    Gradients whose dim 0 does not divide the group size are summed
    whole (``all_reduce``), as in the reference."""
    size = dist.get_world_size(group)
    out = {}
    for name, g in grads.items():
        g = g.contiguous()
        if g.dim() and g.shape[0] % size == 0 and g.shape[0] >= size:
            mine = g.new_empty((g.shape[0] // size, *g.shape[1:]))
            dist.reduce_scatter_tensor(mine, g, group=group)
        else:
            mine = g.clone()
            dist.all_reduce(mine, group=group)
        out[name] = mine
    return out
