"""The cells' tensors: seeded, sorted, distinct, as the recipe gives."""
from __future__ import annotations

import numpy as np
import torch

from port_bench import generate

CONFIG = {"shape": [300, 200, 400], "nnz": 50_000,
          "recipe": {"lead_exponent": 0.8, "draws_per_nnz": 2}}


def test_same_seed_same_tensor():
    a = generate.frostt_like(CONFIG, 2**31 + 11, "cpu")
    b = generate.frostt_like(CONFIG, 2**31 + 11, "cpu")
    c = generate.frostt_like(CONFIG, 2**31 + 12, "cpu")
    assert torch.equal(a.coords, b.coords) and torch.equal(a.values,
                                                           b.values)
    assert not torch.equal(a.coords, c.coords)


def test_sorted_distinct_in_range():
    t = generate.frostt_like(CONFIG, 7, "cpu")
    assert t.nnz == 50_000 and t.coords.dtype == torch.int64
    assert bool((t.coords >= 0).all())
    assert bool((t.coords < torch.tensor(CONFIG["shape"])).all())
    key = np.ravel_multi_index(tuple(t.coords.numpy().T), CONFIG["shape"])
    assert bool((np.diff(key) > 0).all())


def test_keeps_a_seeded_sample_of_the_distinct_draws():
    """The kept coordinates are ``nnz`` of the distinct draws, chosen by
    a permutation drawn from the seed after the draws, and sorted."""
    shape, nnz = (50, 40, 30), 20_000
    cfg = {"shape": list(shape), "nnz": nnz,
           "recipe": {"lead_exponent": 0.8, "draws_per_nnz": 2}}
    t = generate.frostt_like(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(3)
    n = 2 * nnz
    w = torch.arange(1, 51, dtype=torch.float64).pow(-0.8)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    lead = torch.searchsorted(cdf, torch.rand(n, generator=g,
                                              dtype=torch.float64),
                              right=True)
    rest = [torch.randint(0, s, (n,), generator=g) for s in shape[1:]]
    draws = np.stack([lead.numpy(), *(r.numpy() for r in rest)], axis=1)
    distinct = np.unique(draws, axis=0)
    keep = torch.randperm(len(distinct), generator=g)[:nnz]
    want = distinct[np.sort(keep.numpy())]
    np.testing.assert_array_equal(t.coords.numpy(), want)


def test_level_counts_match_the_port_and_every_slice_is_filled():
    """The harness's level counts are the port's CSF's; unlike the
    port's recipe (the smallest draws), every leading slice holds
    nonzeros, and the power law still skews their sizes."""
    from repro_torch import COOTensor, build_csf
    t = generate.frostt_like(CONFIG, 5, "cpu")
    host = COOTensor(coords=t.coords.to(torch.int32).numpy(),
                     values=t.values.numpy(), shape=tuple(CONFIG["shape"]))
    levels = build_csf(host).nnz_levels()
    assert generate.level_counts(t) == {p: levels[p] for p in (1, 2, 3)}
    assert levels[1] == CONFIG["shape"][0]
    sizes = torch.bincount(t.coords[:, 0])
    assert int(sizes[0]) > 20 * int(sizes[-10:].min())
