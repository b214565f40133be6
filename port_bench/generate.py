"""The cells' sparse tensors, generated on the device from the seed.

The recipe follows the port's ``random_sparse(...,
distribution="frostt")`` (``src/repro_torch/sparse/coo.py``), drawn with
``torch`` instead of numpy: the leading mode's coordinate with weight
``i ** -exponent`` (``i = 1 .. I``), every other mode uniform, ``draws *
nnz`` coordinates drawn, and ``nnz`` of the distinct ones kept, each
with a standard normal value.  The port's recipe keeps the
lexicographically smallest, which leaves all but the first few hundred
leading slices empty; here a uniform sample of the distinct draws is
kept, so every mode spans its published size as the FROSTT tensors do.
The same seed on the same kind of device gives the same tensor.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch


@dataclasses.dataclass
class Coo:
    """Lexicographically sorted, distinct coordinates and their values."""

    coords: torch.Tensor      # (nnz, order) int64
    values: torch.Tensor      # (nnz,) float32
    shape: tuple[int, ...]

    @property
    def nnz(self) -> int:
        return self.coords.shape[0]

    def to(self, device) -> "Coo":
        return Coo(self.coords.to(device), self.values.to(device),
                   self.shape)


def frostt_like(config: Mapping, seed: int, device) -> Coo:
    """The configuration's tensor (``shape``, ``nnz`` and ``recipe``)."""
    shape = tuple(int(s) for s in config["shape"])
    nnz = int(config["nnz"])
    recipe = config["recipe"]
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n = int(recipe["draws_per_nnz"]) * nnz
    w = torch.arange(1, shape[0] + 1, dtype=torch.float64, device=dev).pow(
        -float(recipe["lead_exponent"]))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=g, dtype=torch.float64, device=dev)
    key = torch.searchsorted(cdf, u, right=True).clamp_(max=shape[0] - 1)
    del u
    for s in shape[1:]:
        key = key * s + torch.randint(0, s, (n,), generator=g, device=dev)
    key = torch.unique(key)              # sorted: row-major = lexicographic
    if key.numel() < nnz:
        raise ValueError(f"{key.numel()} distinct coordinates drawn, "
                         f"{nnz} asked for")
    keep = torch.randperm(key.numel(), generator=g, device=dev)[:nnz]
    key = key[torch.sort(keep).values]
    coords = torch.empty((nnz, len(shape)), dtype=torch.int64, device=dev)
    for m in range(len(shape) - 1, -1, -1):
        coords[:, m] = key % shape[m]
        key = torch.div(key, shape[m], rounding_mode="floor")
    values = torch.randn(nnz, generator=g, dtype=torch.float32, device=dev)
    return Coo(coords, values, shape)


def level_counts(coo: Coo) -> dict[int, int]:
    """``{p: nnz^(I1..Ip)}`` for ``p = 1 .. order``: the distinct
    ``p``-prefixes of the sorted coordinates."""
    c = coo.coords
    out = {}
    new = torch.zeros(coo.nnz, dtype=torch.bool, device=c.device)
    if coo.nnz:
        new[0] = True
    for p in range(coo.coords.shape[1]):
        new[1:] |= c[1:, p] != c[:-1, p]
        out[p + 1] = int(new.sum())
    return out
