"""COO sparse tensors (host-side construction; fixed sparsity pattern).

The paper's key structural assumption is that SpTTN kernels have a single
fixed, data-independent sparsity pattern, so all format construction happens
once on the host (numpy) and the resulting index arrays are reused across
every contraction (and every optimizer step).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOTensor:
    """Coordinates are lexicographically sorted and duplicate-free."""

    coords: np.ndarray  # (nnz, order) int32
    values: np.ndarray  # (nnz,)
    shape: tuple[int, ...]

    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return self.coords.shape[0]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        out[tuple(self.coords.T)] = self.values
        return out

    def permute_modes(self, perm: tuple[int, ...]) -> "COOTensor":
        coords = self.coords[:, list(perm)]
        shape = tuple(self.shape[p] for p in perm)
        return _sorted(coords, self.values.copy(), shape)


def _sorted(coords: np.ndarray, values: np.ndarray,
            shape: tuple[int, ...]) -> COOTensor:
    key = _lexicographic_order(coords, shape)
    return COOTensor(coords=np.ascontiguousarray(coords[key]),
                     values=np.ascontiguousarray(values[key]), shape=shape)


def _lexicographic_order(coords: np.ndarray,
                         shape: tuple[int, ...]) -> np.ndarray:
    """``np.lexsort(coords.T[::-1])``: the stable lexicographic order of
    the rows.  Where every row lies in ``shape`` and the index space fits
    an int64, it is the stable order of one row-major key per row, which
    sorts several times faster at millions of rows (and in linear time
    when the rows are sorted already)."""
    if (coords.ndim == 2 and coords.shape[0] and coords.shape[1] == len(shape)
            and float(np.prod([float(s) for s in shape])) < 2.0 ** 62
            and coords.min() >= 0
            and bool((coords.max(axis=0) < np.asarray(shape)).all())):
        return np.argsort(np.ravel_multi_index(tuple(coords.T), shape),
                          kind="stable")
    return np.lexsort(coords.T[::-1])


def from_dense(a: np.ndarray) -> COOTensor:
    coords = np.argwhere(a != 0).astype(np.int32)
    values = a[tuple(coords.T)]
    return _sorted(coords, values, a.shape)


def from_coords(coords: np.ndarray, values: np.ndarray,
                shape: tuple[int, ...], sum_duplicates: bool = True
                ) -> COOTensor:
    coords = np.asarray(coords, dtype=np.int32)
    values = np.asarray(values)
    t = _sorted(coords, values, shape)
    if sum_duplicates and t.nnz > 1:
        same = np.all(t.coords[1:] == t.coords[:-1], axis=1)
        if same.any():
            keep = np.concatenate([[True], ~same])
            seg = np.cumsum(keep) - 1
            vals = np.zeros(int(seg[-1]) + 1, dtype=t.values.dtype)
            np.add.at(vals, seg, t.values)
            t = COOTensor(coords=t.coords[keep], values=vals, shape=shape)
    return t


def random_sparse(shape: tuple[int, ...], density: float,
                  seed: int = 0, dtype=np.float32,
                  distribution: str = "uniform") -> COOTensor:
    """Random sparse tensor with ~density fraction of nonzeros.

    ``distribution='frostt'`` skews nonzeros toward a power-law fiber-length
    profile resembling real FROSTT tensors (nell-2 etc.); 'uniform' samples
    coordinates i.i.d.
    """
    rng = np.random.default_rng(seed)
    total = int(np.prod([float(s) for s in shape]))
    nnz = max(1, int(round(total * density)))
    nnz = min(nnz, total)
    if distribution == "frostt" and len(shape) >= 2:
        # power-law weights over the leading mode => skewed slice sizes
        w = 1.0 / np.arange(1, shape[0] + 1) ** 0.8
        w /= w.sum()
        lead = rng.choice(shape[0], size=2 * nnz, p=w)
        rest = [rng.integers(0, s, size=2 * nnz) for s in shape[1:]]
        coords = np.stack([lead, *rest], axis=1).astype(np.int32)
    else:
        coords = np.stack([rng.integers(0, s, size=2 * nnz) for s in shape],
                          axis=1).astype(np.int32)
    # keeps the lexicographically smallest ``nnz`` distinct coordinates,
    # exactly as the JAX package's generator does (same seed, same tensor)
    coords = _unique_rows(coords, tuple(shape))[:nnz]
    values = rng.standard_normal(coords.shape[0]).astype(dtype)
    return _sorted(coords, values, tuple(shape))


def _unique_rows(coords: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``np.unique(coords, axis=0)``, computed as a 1-D unique over one
    int64 key per row when the index space fits: row-major keys sort in
    the same lexicographic order, and one integer sort is much faster
    than numpy's structured-row sort at millions of rows."""
    if float(np.prod([float(s) for s in shape])) >= 2.0 ** 62:
        return np.unique(coords, axis=0)
    key = np.unique(np.ravel_multi_index(tuple(coords.T), shape))
    return np.stack(np.unravel_index(key, shape), axis=1).astype(coords.dtype)


def long_fiber_sparse(shape: tuple[int, int, int], n_fibers: int,
                      fiber_len: int, seed: int = 0,
                      dtype=np.float32) -> COOTensor:
    """Sparse tensor with ~fiber_len nonzeros per (i,j) fiber — the regime
    where factorize-and-fuse asymptotically beats unfactorized (paper
    §2.4.2: 2·nnz·R + 2·nnz^(IJ)·R  vs  3·nnz·R requires nnz >> nnz^(IJ)).
    Real decomposition datasets (nell-2 et al.) are of this kind."""
    rng = np.random.default_rng(seed)
    ij = np.stack([rng.integers(0, shape[0], n_fibers),
                   rng.integers(0, shape[1], n_fibers)], axis=1)
    ij = np.unique(ij, axis=0)
    ks = rng.integers(0, shape[2], size=(len(ij), fiber_len))
    coords = np.concatenate(
        [np.repeat(ij, fiber_len, axis=0),
         ks.reshape(-1, 1)], axis=1).astype(np.int32)
    coords = np.unique(coords, axis=0)
    values = rng.standard_normal(len(coords)).astype(dtype)
    return _sorted(coords, values, shape)


def banded_mask(n: int, window: int, block: int = 1) -> COOTensor:
    """Causal banded (sliding-window) mask pattern as a sparse tensor —
    the static sparsity of local attention (gemma3/recurrentgemma), at
    ``block`` granularity for the block-sparse SDDMM kernel."""
    nb = (n + block - 1) // block
    wb = max(1, (window + block - 1) // block)
    rows, cols = [], []
    for i in range(nb):
        j0 = max(0, i - wb + 1)
        for j in range(j0, i + 1):
            rows.append(i)
            cols.append(j)
    coords = np.stack([np.array(rows), np.array(cols)], axis=1).astype(np.int32)
    values = np.ones(len(rows), dtype=np.float32)
    return _sorted(coords, values, (nb, nb))
