"""Plain CP-ALS, the sweeps of ``repro_torch.examples.cp_als.cp_als``
from the same documented start: ``np.random.default_rng(seed)`` draws
A, B, C (``standard_normal((n, rank))`` in float32, times 0.1); each
sweep solves for A, B, C in turn against the MTTKRP and the Hadamard
product of the other two Gram matrices (plus 1e-6 I)."""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.precision import accumulator, cast
from port_bench.reference.spttn import contract

_EXPRS = ("ijk,ja,ka->ia", "ijk,ia,ka->ja", "ijk,ia,ja->ka")
_NAMES = ["T", "F1", "F2"]


def start(shape, rank: int, seed: int, device) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, rank))
                             .astype(np.float32)).to(device) * .1
            for n in shape]


def als(coords: torch.Tensor, values: torch.Tensor, shape, rank: int,
        steps: int, seed: int, precision: str = "float64"):
    """The factors ``[A, B, C]`` after ``steps`` sweeps."""
    acc = accumulator(precision)
    f = [x.to(acc) for x in start(shape, rank, seed, values.device)]
    eye = torch.eye(rank, dtype=acc, device=values.device)
    for _ in range(steps):
        for m in range(3):
            o1, o2 = (x for x in range(3) if x != m)
            g1, g2 = cast(f[o1], precision), cast(f[o2], precision)
            gram = (g1.T @ g1) * (g2.T @ g2) + 1e-6 * eye
            rhs = contract(_EXPRS[m], _NAMES, coords, values, shape,
                           {"F1": f[o1], "F2": f[o2]}, precision)
            f[m] = torch.linalg.solve(gram.to(acc), rhs.to(acc).T).T
    return f
