"""The plain SpTTN contraction: a sparse first operand given as COO,
dense factors, and a dense output, in blocks of nonzeros.

``out[o] = sum over nonzeros n of v[n] * prod_f F_f[coords of n, ...]``,
each block an ``einsum`` over the gathered factor rows and an
``index_add_`` into the output's sparse rows.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from port_bench.reference.precision import accumulator, cast

BLOCK_BYTES = 1 << 28


def parse(expr: str) -> tuple[list[str], str]:
    lhs, out = expr.replace(" ", "").split("->")
    return lhs.split(","), out


def contract(expr: str, names: list[str], coords: torch.Tensor,
             values: torch.Tensor, shape: tuple[int, ...],
             factors: Mapping[str, torch.Tensor],
             precision: str = "float64") -> torch.Tensor:
    """``expr`` (e.g. ``"ijk,ja,ka->ia"``; the first operand is the
    sparse tensor, the output dense) over the COO ``coords``/``values``
    and the dense ``factors`` by name (``names`` name the operands)."""
    ins, out = parse(expr)
    sparse = ins[0]
    col = {c: m for m, c in enumerate(sparse)}
    dims = dict(zip(sparse, shape))
    for ind, name in zip(ins[1:], names[1:]):
        dims.update(zip(ind, factors[name].shape))
    n = next(c for c in "nzyxwvutsrqponmlkjihgfedcba"
             if c not in expr)
    out_sparse = [c for c in out if c in col]
    out_dense = [c for c in out if c not in col]
    acc = accumulator(precision)
    rows = 1
    for c in out_sparse:
        rows *= dims[c]
    width = 1
    for c in out_dense:
        width *= dims[c]
    result = torch.zeros((rows, width), dtype=acc, device=values.device)
    per_row = 8 * max(width, 1) * len(ins)
    block = max(1, BLOCK_BYTES // per_row)
    ops = []                  # (sparse letters, dense letters, factor)
    for ind, name in zip(ins[1:], names[1:]):
        sp = [x for x in ind if x in col]
        de = [x for x in ind if x not in col]
        f = cast(factors[name], precision).permute(
            [ind.index(x) for x in sp + de])
        ops.append((sp, de, f))
    vals = cast(values, precision)
    eq = ",".join([n] + [(n if sp else "") + "".join(de)
                         for sp, de, _ in ops]) + "->" + n + "".join(
                             out_dense)
    for lo in range(0, values.shape[0], block):
        c = coords[lo:lo + block]
        gathered = [f[tuple(c[:, col[x]] for x in sp)] if sp else f
                    for sp, _, f in ops]
        part = torch.einsum(eq, vals[lo:lo + block], *gathered)
        row = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
        for x in out_sparse:
            row = row * dims[x] + c[:, col[x]]
        result.index_add_(0, row, part.reshape(c.shape[0], width).to(acc))
    full = result.reshape([dims[x] for x in out_sparse + out_dense])
    order = [(out_sparse + out_dense).index(x) for x in out]
    return full.permute(order)
