"""The fused chain (K3 and the split-K chain), port vs reference.

``strategy="fused"`` on the port's ``cuda`` and ``cuda-splitk`` engines,
on CPU tensors (so K3 and the split-K kernels run their plain versions),
against the reference ``PallasPlanExecutor(strategy="fused")`` on the
TPU target in interpret mode and on the ``pallas-gpu`` target, for the
2-level chains of MTTKRP and TTMc3 and the 3-level chain of TTMc4 —
including patterns with empty mode-0 slices and with no nonzeros.  The
emitted chain IR and the chain layout are held equal field by field, and
a Python walk of the CUDA kernel's algorithm over the layout it reads
(:class:`~repro_torch.kernels.codegen.ir.ChainLayout`: work items of a
bounded number of blocks, their partial rows added in item order) is
held to the plain version and, with items as small as one block so that
cuts fall inside every level's segments, to the reference, an outer row
with no blocks included.  The item table covers every block once.

Tolerance: float32 ``|port - ref| <= 1e-5 * max(1, max|ref|)``, float64
``1e-12`` relative (under ``jax.enable_x64``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.kernels.codegen import PallasPlanExecutor  # noqa: E402
from repro.kernels.codegen import executor as jcg  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro.sparse.coo import from_coords as j_from_coords  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.kernels.codegen import StagePlanExecutor  # noqa: E402
from repro_torch.kernels.codegen import stages  # noqa: E402
from repro_torch.kernels.codegen.ir import (  # noqa: E402
    ITEM_MIN_BLOCKS, ITEM_TARGET, ChainLayout, chain_items, item_cap)
from repro_torch.sparse import build_csf  # noqa: E402
from repro_torch.sparse.coo import from_coords  # noqa: E402
from tests.test_torch_cuda import _with_empty_outer_row  # noqa: E402

CHAINS = {"mttkrp": ("mttkrp", (6, 7, 8, 4), 0.3),
          "ttmc3": ("ttmc3", (6, 7, 8, 4, 3), 0.3),
          "ttmc4": ("ttmc4", (5, 4, 6, 7, 2, 3, 2), 0.3)}
# (port backend, reference target)
TARGETS = [("cuda", "tpu"), ("cuda-splitk", "gpu")]


def _close(port, ref, rel=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, rel * scale)


def _factors(spec, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(dtype)
        for t in spec.inputs if not t.is_sparse}


def _empty_slices_csf(shape, seed=5):
    """A pattern whose mode-0 slices 0, 2 and the last are empty, so the
    output has rows that no chain segment reaches."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, n, 60) for n in shape], axis=1)
    keep = ~np.isin(coords[:, 0], [0, 2, shape[0] - 1])
    coords = np.unique(coords[keep], axis=0)
    return j_build_csf(j_from_coords(
        coords, rng.standard_normal(len(coords)).astype(np.float32), shape))


def _zero_nnz_csf(shape):
    coords = np.zeros((0, len(shape)), np.int64)
    return j_build_csf(j_from_coords(coords, np.zeros(0, np.float32), shape))


@functools.cache
def _case(kernel, pattern):
    builder, args, density = CHAINS[kernel]
    jspec = getattr(JS, builder)(*args)
    shape = tuple(jspec.dims[i] for i in jspec.sparse_indices)
    if pattern == "random":
        jc = j_build_csf(j_random_sparse(shape, density, seed=3))
    elif pattern == "empty-slices":
        jc = _empty_slices_csf(shape)
    else:
        jc = _zero_nnz_csf(shape)
    coo = jc.coo
    tc = build_csf(from_coords(coo.coords, coo.values, coo.shape))
    # plan on the random pattern's profile: the same chain for every case
    levels = j_build_csf(j_random_sparse(shape, density, seed=3)) \
        .nnz_levels()
    jp = jplanner.plan(jspec, nnz_levels=levels)
    tspec = getattr(TS, builder)(*args)
    tp = tplanner.plan(tspec, nnz_levels=levels)
    assert [str(t) for t in jp.path] == [str(t) for t in tp.path]
    assert jp.order == tp.order
    return jspec, tspec, jc, tc, jp, tp


def _run_pair(kernel, pattern, backend, target, dtype=np.float32):
    jspec, tspec, jc, tc, jp, tp = _case(kernel, pattern)
    factors = _factors(jspec, dtype=dtype)
    jx = PallasPlanExecutor(jspec, jp.path, jp.order, block=8,
                            interpret=True, strategy="fused",
                            target=target)
    ref = np.asarray(jx(jex.CSFArrays.from_csf(jc), factors))
    tx = StagePlanExecutor(tspec, tp.path, tp.order, block=8,
                           strategy="fused",
                           target=tex.CODEGEN_TARGETS[backend])
    out = tx(tex.CSFArrays.from_csf(tc, device="cpu"), factors)
    return out, ref, tx, jx


@pytest.mark.parametrize("pattern", ["random", "empty-slices", "no-nnz"])
@pytest.mark.parametrize("backend,target", TARGETS)
@pytest.mark.parametrize("kernel", sorted(CHAINS))
def test_fused_chain_matches_reference(kernel, backend, target, pattern):
    out, ref, tx, jx = _run_pair(kernel, pattern, backend, target)
    _close(out, ref)
    assert tx.stage_strategy == jx.stage_strategy
    if pattern != "no-nnz":
        assert list(tx.stage_strategy.values()) == ["fused"]
    assert len(tx.emitted_chains) == len(jx.emitted_chains)
    for (ts, tl), (js, jl) in zip(tx.emitted_chains, jx.emitted_chains):
        assert ts.expr == js.expr and ts.nseg == js.nseg
        assert [link.expr for link in tl] == [link.expr for link in jl]
        assert [link.out_shape for link in tl] == \
            [link.out_shape for link in jl]
    for ti, ji in zip(tx.emitted_ir, jx.emitted_ir):
        assert (ti.kind, ti.nseg_out, ti.nseg_lvls) == \
            (ji.kind, ji.nseg_out, ji.nseg_lvls)


@pytest.mark.parametrize("backend,target", TARGETS)
@pytest.mark.parametrize("kernel", sorted(CHAINS))
def test_fused_chain_float64_matches_reference(kernel, backend, target):
    with jax.enable_x64(True):
        out, ref, _, _ = _run_pair(kernel, "random", backend, target,
                                   dtype=np.float64)
    assert out.dtype == torch.float64
    _close(out, ref, rel=1e-12)


@pytest.mark.parametrize("kernel", sorted(CHAINS))
def test_chain_layout_equals_reference(kernel):
    """The per-level segment ids, opens and closes flags the kernel reads
    are the reference's ``chain_block_arrays``."""
    _, tspec, jc, tc, _, tp = _case(kernel, "random")
    tx = StagePlanExecutor(tspec, tp.path, tp.order, block=8,
                           strategy="fused")
    arrays = tex.CSFArrays.from_csf(tc, device="cpu")
    tx(arrays, _factors(tx.spec))
    (key, (lay, gather, chain)), = [
        (k, v) for k, v in arrays.cache.items()
        if isinstance(k, tuple) and k[0] == "chain"]
    _, lvl0, levels, block = key
    jlay, segs, firsts, lasts = jcg.chain_block_arrays(
        jex.CSFArrays.from_csf(jc), lvl0, levels, block)
    np.testing.assert_array_equal(lay.gather, jlay.gather)
    np.testing.assert_array_equal(chain.mask.numpy(), jlay.mask)
    C = len(levels)
    want = np.stack([a for j in range(C - 1)
                     for a in (segs[j], firsts[j], lasts[j])])
    np.testing.assert_array_equal(chain.levels.numpy(), want)
    nout = tc.nfib[levels[-1]] if levels[-1] > 0 else 1
    np.testing.assert_array_equal(
        chain.out_block_ptr.numpy(),
        np.searchsorted(segs[-1], np.arange(nout + 1)))


def _kernel_walk(ir, layout, tables, link_tables, padded, link_arrays,
                 items=None):
    """K3's algorithm in Python, as ``chain_kernel`` and the combine run
    it over ``items`` (default ``layout.items``): per work item, per block
    in ascending order, resets of the levels that open (of every level at
    the item's first block), the block partial into buffer 0, then the
    flushes of the levels that close (of every level at the item's last
    block), each through its link's index table, the last link's into
    the item's partial row; then each outermost segment's partial rows
    added in ascending item order."""
    stage, links = ir.stage, ir.links
    items = items or layout.items
    dt = torch.float64
    rows = [p.to(dt) for p in padded]
    mask = layout.mask.to(dt)
    lv = layout.levels
    w_out = links[-1].out_flat_dim
    partials = torch.zeros((items.nitems, w_out), dtype=dt)

    def columns(tab, a, b):
        # out column o = sum over the table's terms of a[a_idx] * b[b_idx]
        prods = a[..., tab.a_idx.long()] * b[..., tab.b_idx.long()]
        seg = torch.repeat_interleave(
            torch.arange(tab.out_ptr.numel() - 1), tab.out_ptr.diff().long())
        res = torch.zeros(prods.shape[:-1] + (tab.out_ptr.numel() - 1,),
                          dtype=dt)
        return res.index_add_(prods.ndim - 1, seg, prods)

    bounds = items.item_block.tolist()
    for i in range(items.nitems):
        first, last = bounds[i], bounds[i + 1] - 1
        bufs = [torch.zeros(stage.out_flat_dim, dtype=dt)] + \
            [torch.zeros(link.out_flat_dim, dtype=dt) for link in links[:-1]]
        for blk in range(first, last + 1):
            for j in range(len(links)):
                if blk == first or lv[3 * j + 1, blk]:
                    bufs[j].zero_()
            z = slice(blk * stage.block, (blk + 1) * stage.block)
            a, b = (r[z] if op.fiber else r[:1].expand(stage.block, -1)
                    for r, op in zip(rows, stage.operands))
            bufs[0] += (columns(tables, a, b) * mask[z, None]).sum(0)
            for j, link in enumerate(links):
                if blk != last and not lv[3 * j + 2, blk]:
                    continue
                other = link_arrays[j].to(dt)
                row = other[lv[3 * j, blk]] if link.operands[1].fiber \
                    else other[0]
                flush = columns(link_tables[j], bufs[j], row)
                if j + 1 < len(links):
                    bufs[j + 1] += flush
                else:
                    partials[i] += flush
    out = torch.zeros((ir.nseg_out, w_out), dtype=dt)
    ptr = items.item_ptr.tolist()
    for s in range(ir.nseg_out):
        for i in range(ptr[s], ptr[s + 1]):
            out[s] += partials[i]
    return out


@pytest.mark.parametrize("kernel", sorted(CHAINS))
def test_kernel_walk_matches_plain_with_an_empty_outer_row(kernel,
                                                           monkeypatch):
    """The layout and index tables that ``run_fused_chain_stage`` hands the
    kernel, walked as the kernel walks them, give the plain version's
    result — also after an outer row with no blocks is inserted, which
    must come out zero."""
    _, tspec, _, tc, _, tp = _case(kernel, "random")
    calls = []
    inner = stages.run_fused_chain_stage

    def capture(*args):
        calls.append(args)
        return inner(*args)

    monkeypatch.setattr(stages, "run_fused_chain_stage", capture)
    tx = StagePlanExecutor(tspec, tp.path, tp.order, block=8,
                           strategy="fused")
    tx(tex.CSFArrays.from_csf(tc, device="cpu"), _factors(tspec))
    ir, layout, tables, link_tables, padded, link_arrays, dt = calls[0]
    plain = stages.run_fused_chain_stage_plain(ir, layout, padded,
                                               link_arrays, dt)
    _close(_kernel_walk(ir, layout, tables, link_tables, padded,
                        link_arrays), plain)

    k = ir.nseg_out // 2
    ir2, layout2 = _with_empty_outer_row(ir, layout, k)
    walked = _kernel_walk(ir2, layout2, tables, link_tables, padded,
                          link_arrays)
    plain2 = stages.run_fused_chain_stage_plain(ir2, layout2, padded,
                                                link_arrays, dt)
    assert not walked[k].any() and not plain2[k].any()
    _close(walked, plain2)
    _close(torch.cat([plain2[:k], plain2[k + 1:]]), plain)


@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc4"])
def test_item_walk_matches_reference_with_cuts_inside_segments(
        kernel, cap, monkeypatch):
    """The work-item walk with items of at most ``cap`` blocks, at block
    2 so that item cuts fall inside the segments of every inner level,
    stands in for K3 in the port's fused executor and gives the
    reference's fused result (``PallasPlanExecutor``, TPU target, in
    interpret mode); with an outermost row that owns no block inserted,
    that row is zero and the rest are the plain version's."""
    jspec, tspec, jc, tc, jp, tp = _case(kernel, "random")
    factors = _factors(jspec)
    calls = []

    def walk(ir, layout, tables, link_tables, padded, link_arrays, dtype):
        calls.append((ir, layout, tables, link_tables, padded, link_arrays,
                      dtype))
        items = chain_items(layout.out_block_ptr, cap)
        return _kernel_walk(ir, layout, tables, link_tables, padded,
                            link_arrays, items).to(dtype)

    monkeypatch.setattr(stages, "run_fused_chain_stage", walk)
    tx = StagePlanExecutor(tspec, tp.path, tp.order, block=2,
                           strategy="fused")
    out = tx(tex.CSFArrays.from_csf(tc, device="cpu"), factors)
    jx = PallasPlanExecutor(jspec, jp.path, jp.order, block=2,
                            interpret=True, strategy="fused", target="tpu")
    _close(out, np.asarray(jx(jex.CSFArrays.from_csf(jc), factors)))

    ir, layout, tables, link_tables, padded, link_arrays, dt = calls[0]
    items = chain_items(layout.out_block_ptr, cap)
    starts = items.item_block[:-1]
    for j in range(len(ir.links)):
        # some item starts where level j's segment does not open
        assert not bool(layout.levels[3 * j + 1, starts].all()), j
    k = ir.nseg_out // 2
    ir2, layout2 = _with_empty_outer_row(ir, layout, k)
    walked = _kernel_walk(ir2, layout2, tables, link_tables, padded,
                          link_arrays, chain_items(layout2.out_block_ptr, cap))
    plain2 = stages.run_fused_chain_stage_plain(ir2, layout2, padded,
                                                link_arrays, dt)
    assert not walked[k].any()
    _close(walked, plain2)


@pytest.mark.parametrize("cap", [1, 2, 3, 64, None])
def test_chain_items_cover_every_block_once_in_order(cap):
    """The item table covers every block exactly once, in order, never
    crosses an outermost segment, holds at most ``cap`` blocks an item
    and as few items as that allows; a segment with no blocks owns no
    item.  The default cap depends on the block count alone."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 300, 40)
    counts[[0, 5, 6, 39]] = 0
    counts[3] = 5000                      # one heavy segment
    out_block_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(
        counts)]).astype(np.int64))
    nblocks = int(counts.sum())
    items = chain_items(out_block_ptr, cap)
    want_cap = cap or item_cap(nblocks)
    assert items.cap == want_cap
    ib, ip = items.item_block.tolist(), items.item_ptr.tolist()
    assert ib[0] == 0 and ib[-1] == nblocks
    assert all(x < y for x, y in zip(ib, ib[1:]))
    assert ip[0] == 0 and ip[-1] == items.nitems
    for s, n in enumerate(counts):
        lo, hi = ip[s], ip[s + 1]
        assert hi - lo == -(-int(n) // want_cap)
        if n:
            assert ib[lo] == out_block_ptr[s] and \
                ib[hi] == out_block_ptr[s + 1]
        assert all(ib[i + 1] - ib[i] <= want_cap for i in range(lo, hi))
    assert item_cap(100) == ITEM_MIN_BLOCKS
    assert item_cap(5_300_000) == -(-5_300_000 // ITEM_TARGET)


def test_chain_layout_caches_its_items():
    """The chain layout keeps the fields that mirror the reference's
    block layout; its item table is built on first use, at the default
    cap, and kept with the layout the executor caches.  A run on the CPU
    (the plain version) builds none."""
    assert [f.name for f in dataclasses.fields(ChainLayout)] == [
        "mask", "levels", "out_block_ptr", "block_ptr", "parent_ptrs"]
    _, tspec, _, tc, _, tp = _case("mttkrp", "random")
    tx = StagePlanExecutor(tspec, tp.path, tp.order, block=8,
                           strategy="fused")
    arrays = tex.CSFArrays.from_csf(tc, device="cpu")
    tx(arrays, _factors(tspec))
    (_, _, chain), = [v for k, v in arrays.cache.items()
                      if isinstance(k, tuple) and k[0] == "chain"]
    assert "items" not in vars(chain)
    nblocks = int(chain.out_block_ptr[-1])
    assert chain.items.cap == item_cap(nblocks)
    want = chain_items(chain.out_block_ptr)
    assert torch.equal(chain.items.item_block, want.item_block)
    assert torch.equal(chain.items.item_ptr, want.item_ptr)
    assert chain.items is chain.items
    tx(arrays, _factors(tspec))
    assert [v for k, v in arrays.cache.items()
            if isinstance(k, tuple) and k[0] == "chain"][0][2] is chain


def test_fused_plan_replays_through_execute_plan():
    """A plan stamped ``fused=True`` replays through the chain lowering on
    both code-generator engines and matches the ``torch`` engine."""
    _, tspec, _, tc, _, tp = _case("mttkrp", "random")
    factors = _factors(tspec)
    arrays = tex.CSFArrays.from_csf(tc, device="cpu")
    want = tex.execute_plan(tp, arrays, factors, backend="torch")
    for backend in ("cuda", "cuda-splitk"):
        fused = dataclasses.replace(tp, backend=backend, fused=True, block=8)
        _close(tex.execute_plan(fused, arrays, factors), want)
