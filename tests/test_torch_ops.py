"""The paper kernels' drivers (K5-K7), port vs reference, on the CPU.

``repro_torch.kernels.ops.{mttkrp, ttmc_fiber, tttp}`` on CPU tensors
(so the kernel wrappers run their plain versions) against
``repro.kernels.ops`` with ``use_pallas=True, interpret=True`` on the
same seeded inputs, at several block sizes, on a skewed pattern and on
one with empty mode-0 slices; the layouts are held equal to the
reference's, and the oracles (``use_kernel=False``) to the reference's
``use_pallas=False``.  A Python walk of K5's algorithm (work items of at
most a few blocks, each summed into a partial row in ascending row
order, the partial rows added per segment in ascending item order)
stands in for the kernel and is held to the reference too.

Tolerance: float32 ``|port - ref| <= 1e-5 * max(1, max|ref|)``, float64
``1e-12`` relative (under ``jax.enable_x64``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro.sparse.coo import from_coords as j_from_coords  # noqa: E402
from repro_torch.kernels import native, ops, paper  # noqa: E402
from repro_torch.kernels.codegen.ir import chain_items  # noqa: E402
from repro_torch.kernels.segment import segment_ptr  # noqa: E402
from repro_torch.kernels.util import padded_segment_layout  # noqa: E402
from repro_torch.sparse import build_csf  # noqa: E402
from repro_torch.sparse.coo import from_coords  # noqa: E402

SHAPE = (12, 9, 10)


def _close(port, ref, rel=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, rel * scale)


@functools.cache
def _pattern(kind):
    if kind == "frostt":
        jc = j_build_csf(j_random_sparse(SHAPE, 0.2, seed=4,
                                         distribution="frostt"))
    else:                                  # mode-0 slices 1 and 5 empty
        rng = np.random.default_rng(6)
        coords = np.stack([rng.integers(0, n, 150) for n in SHAPE], 1)
        coords = np.unique(coords[~np.isin(coords[:, 0], [1, 5])], axis=0)
        jc = j_build_csf(j_from_coords(
            coords, rng.standard_normal(len(coords)).astype(np.float32),
            SHAPE))
    coo = jc.coo
    return jc, build_csf(from_coords(coo.coords, coo.values, coo.shape))


def _mats(dtype, *shapes, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


PATTERNS = ["frostt", "empty-slices"]


@pytest.mark.parametrize("block", [8, 256])
@pytest.mark.parametrize("kind", PATTERNS)
def test_mttkrp_matches_reference(kind, block):
    jc, tc = _pattern(kind)
    b, c = _mats(np.float32, (SHAPE[1], 5), (SHAPE[2], 5))
    want = jops.mttkrp(jc, jnp.asarray(b), jnp.asarray(c), block=block,
                       use_pallas=True, interpret=True)
    native.reset_launch_counts()
    got = ops.mttkrp(tc, torch.from_numpy(b), torch.from_numpy(c),
                     block=block)
    assert native.launch_counts()["mttkrp"] == 0     # CPU: plain version
    _close(got, want)
    _close(ops.mttkrp(tc, torch.from_numpy(b), torch.from_numpy(c),
                      use_kernel=False),
           jops.mttkrp(jc, jnp.asarray(b), jnp.asarray(c),
                       use_pallas=False))
    lay, jlay = ops.mttkrp_layout(tc, block), jops.mttkrp_layout(jc, block)
    np.testing.assert_array_equal(lay.gather, jlay.gather)
    np.testing.assert_array_equal(lay.block_seg, jlay.block_seg)


@pytest.mark.parametrize("block", [8, 128])
@pytest.mark.parametrize("kind", PATTERNS)
def test_ttmc_fiber_matches_reference(kind, block):
    jc, tc = _pattern(kind)
    nf = tc.nfib[2]
    ug, xf = _mats(np.float32, (nf, 4), (nf, 3))
    jlay = jops.ttmc_fiber_layout(jc, block)
    lay = ops.ttmc_fiber_layout(tc, block)
    np.testing.assert_array_equal(lay.gather, jlay.gather)
    want = jops.ttmc_fiber(jnp.asarray(ug), jnp.asarray(xf), jlay,
                           use_pallas=True, interpret=True)
    got = ops.ttmc_fiber(torch.from_numpy(ug), torch.from_numpy(xf), lay)
    assert tuple(got.shape) == (tc.nfib[1], 4, 3)
    _close(got, want)
    _close(ops.ttmc_fiber(torch.from_numpy(ug), torch.from_numpy(xf), lay,
                          use_kernel=False),
           jops.ttmc_fiber(jnp.asarray(ug), jnp.asarray(xf), jlay,
                           use_pallas=False))


@pytest.mark.parametrize("block", [8, 512])
@pytest.mark.parametrize("kind", PATTERNS)
def test_tttp_matches_reference(kind, block):
    jc, tc = _pattern(kind)
    u, v, w = _mats(np.float32, (SHAPE[0], 6), (SHAPE[1], 6), (SHAPE[2], 6))
    want = jops.tttp(jc, *map(jnp.asarray, (u, v, w)), block=block,
                     use_pallas=True, interpret=True)
    got = ops.tttp(tc, *map(torch.from_numpy, (u, v, w)), block=block)
    assert tuple(got.shape) == (tc.nnz,)
    _close(got, want)
    _close(ops.tttp(tc, *map(torch.from_numpy, (u, v, w)),
                    use_kernel=False),
           jops.tttp(jc, *map(jnp.asarray, (u, v, w)), use_pallas=False))


def test_paper_kernels_float64_match_reference():
    jc, tc = _pattern("frostt")
    b, c = _mats(np.float64, (SHAPE[1], 5), (SHAPE[2], 5))
    u, v, w = _mats(np.float64, (SHAPE[0], 6), (SHAPE[1], 6), (SHAPE[2], 6))
    ug, xf = _mats(np.float64, (tc.nfib[2], 4), (tc.nfib[2], 3))
    with jax.enable_x64(True):
        jc64 = j_build_csf(j_from_coords(jc.coo.coords,
                                         jc.coo.values.astype(np.float64),
                                         SHAPE))
        want = [jops.mttkrp(jc64, jnp.asarray(b), jnp.asarray(c), block=8,
                            interpret=True),
                jops.ttmc_fiber(jnp.asarray(ug), jnp.asarray(xf),
                                jops.ttmc_fiber_layout(jc64, 8),
                                interpret=True),
                jops.tttp(jc64, *map(jnp.asarray, (u, v, w)), block=8,
                          interpret=True)]
        want = [np.asarray(x) for x in want]
    tc64 = build_csf(from_coords(tc.coo.coords,
                                 tc.coo.values.astype(np.float64), SHAPE))
    got = [ops.mttkrp(tc64, torch.from_numpy(b), torch.from_numpy(c),
                      block=8),
           ops.ttmc_fiber(torch.from_numpy(ug), torch.from_numpy(xf),
                          ops.ttmc_fiber_layout(tc64, 8)),
           ops.tttp(tc64, *map(torch.from_numpy, (u, v, w)), block=8)]
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, wnt, rel=1e-12)


def _mttkrp_item_walk(vals, bg, cg, mask, block_ptr, nseg, block, cap):
    """K5's algorithm in plain PyTorch: each work item (at most ``cap``
    consecutive blocks of one segment) sums ``(vals * mask) * bg * cg``
    over its rows in ascending order into a partial row; each segment
    adds its items' partial rows in ascending item order (none: zero)."""
    items = chain_items(block_ptr, cap)
    ib, ip = items.item_block.tolist(), items.item_ptr.tolist()
    w = vals * mask.to(vals.dtype)
    partials = torch.zeros((items.nitems, bg.shape[1]), dtype=bg.dtype)
    for i in range(items.nitems):
        for n in range(ib[i] * block, ib[i + 1] * block):
            partials[i] += w[n] * bg[n] * cg[n]
    out = torch.zeros((nseg, bg.shape[1]), dtype=bg.dtype)
    for s in range(nseg):
        for i in range(ip[s], ip[s + 1]):
            out[s] += partials[i]
    return out, items


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("kind", PATTERNS)
def test_mttkrp_item_walk_matches_reference(kind, cap, dtype, monkeypatch):
    """K5's work-item walk, with items of at most ``cap`` blocks of 8 rows
    (so a segment spans several items and, on ``empty-slices``, some own
    none), stands in for the kernel in ``ops.mttkrp`` and gives the
    reference's result: float32 against ``mttkrp_pallas`` in interpret
    mode, float64 against ``use_pallas=False``."""
    jc, tc = _pattern(kind)
    b, c = _mats(dtype, (SHAPE[1], 5), (SHAPE[2], 5))
    seen = []

    def walk(vals, bg, cg, mask, block_ptr, nseg, block):
        out, items = _mttkrp_item_walk(vals, bg, cg, mask, block_ptr, nseg,
                                       block, cap)
        seen.append((items, block_ptr))
        return out

    monkeypatch.setattr(paper, "mttkrp_kernel", walk)
    if dtype == np.float64:
        tc = build_csf(from_coords(tc.coo.coords,
                                   tc.coo.values.astype(np.float64), SHAPE))
        with jax.enable_x64(True):
            jc = j_build_csf(j_from_coords(
                jc.coo.coords, jc.coo.values.astype(np.float64), SHAPE))
            want = np.asarray(jops.mttkrp(jc, jnp.asarray(b), jnp.asarray(c),
                                          use_pallas=False))
        rel = 1e-12
    else:
        want = jops.mttkrp(jc, jnp.asarray(b), jnp.asarray(c), block=8,
                           use_pallas=True, interpret=True)
        rel = 1e-5
    got = ops.mttkrp(tc, torch.from_numpy(b), torch.from_numpy(c), block=8)
    assert got.dtype == torch.from_numpy(b).dtype
    _close(got, want, rel=rel)
    (items, _), = seen
    assert int(items.item_ptr.diff().max()) > 1   # a segment cut in items


@pytest.mark.parametrize("cap", [1, 2, None], ids=["1", "2", "default"])
def test_mttkrp_item_walk_zeroes_segments_with_no_blocks(cap):
    """On a layout where one segment spans many items and two own none,
    K5's walk gives the wrapper's CPU result (its plain version) at
    float64 and writes zero rows for the segments with no blocks."""
    # six segments: one of 300 blocks of 8, segments 0 and 3 with none
    seg = np.repeat(np.arange(6), [0, 300 * 8, 3, 0, 40, 1])
    lay = padded_segment_layout(seg, 6, 8)
    P = lay.padded_len
    vals, = _mats(np.float64, (P,), seed=3)
    bg, cg = _mats(np.float64, (P, 6), (P, 6), seed=4)
    args = (torch.from_numpy(vals), torch.from_numpy(bg),
            torch.from_numpy(cg), torch.from_numpy(lay.mask),
            torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg)),
            lay.nseg, lay.block)
    got, items = _mttkrp_item_walk(*args, cap or paper.MTTKRP_ITEM_BLOCKS)
    assert int(items.item_ptr.diff().max()) > 1
    assert not bool(got[0].any()) and not bool(got[3].any())
    _close(got, paper.mttkrp_kernel(*args), rel=1e-12)
