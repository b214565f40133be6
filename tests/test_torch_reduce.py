"""K1, the segmented reduce, over work items: its host side on the CPU.

* K1's items (``ir.reduce_items``) are ``chain_items`` of the host block
  offsets at the cap ``REDUCE_ITEM_ROWS // block``: every block once, in
  order, none crossing a segment, at most the cap an item;
* the path picker (``stages.reduce_path``) sends each stage of the card
  tests' ``STAGES`` to the path intended for it (16-byte vectors, 4 x 4
  register blocks or the index tables), and a base off 16 bytes to the
  tables;
* the executor cuts K1's items once per layout and hands them to the
  lowering;
* a Python walk of the kernel's algorithm (work items, row lanes of the
  path's geometry walking their rows in ascending order, a fixed tree
  over the lanes, the partial rows added per segment in item order)
  gives the JAX package's ``run_reduce_stage`` in interpret mode.

Tolerance: float32 ``1e-5 * max(1, max|ref|)`` (another summation
order), float64 ``1e-12`` relative (under ``jax.enable_x64``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.codegen import ir as jir  # noqa: E402
from repro.kernels.codegen import stages as jst  # noqa: E402
from repro_torch.core import spec as S  # noqa: E402
from repro_torch.core.executor import CSFArrays  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.codegen import executor as tex  # noqa: E402
from repro_torch.kernels.codegen import ir  # noqa: E402
from repro_torch.kernels.codegen import stages  # noqa: E402
from repro_torch.kernels.codegen.ir import (REDUCE_ITEM_ROWS,  # noqa: E402
                                            chain_items, reduce_items)
from repro_torch.kernels.segment import (segment_combine_plain,  # noqa: E402
                                         segment_ptr)
from repro_torch.kernels.util import padded_segment_layout  # noqa: E402
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402
from test_torch_cuda import STAGES  # noqa: E402

# the path each stage of the card tests' STAGES takes, in float32 and
# float64 (20 x 20 has 400 outputs, past the outer-product path's 256)
PATHS = {"Zd,Zd->d": stages.REDUCE_VECTORS,
         "Z,Zd->d": stages.REDUCE_TABLES,
         "Zd,Ze->de": stages.REDUCE_OUTER,
         "Zd,Ze->de-two-tiles": stages.REDUCE_TABLES,
         "Zde,e->d": stages.REDUCE_TABLES,
         "Zd,Zd->": stages.REDUCE_TABLES}


def _stage(ops, out_subs, out_shape, block=8, nseg=1):
    return ir.Stage(tuple(ir.StageOperand(s, sh, f) for s, sh, f in ops),
                    out_subs, out_shape, True, block, nseg)


def _skewed_layout(rng, nfib, nseg, block):
    """Segment 0 holds a third of the fibers; segment 1 none (one block
    of pad rows)."""
    seg = np.sort(rng.integers(min(2, nseg - 1), nseg, size=nfib))
    seg[: nfib // 3] = 0
    return padded_segment_layout(np.sort(seg), nseg, block)


@pytest.mark.parametrize("block", [1, 8, 16, 128, 4096])
def test_reduce_items_are_chain_items_of_the_host_offsets(block):
    """K1's items cut each segment's blocks into runs of at most
    ``max(1, REDUCE_ITEM_ROWS // block)`` blocks: ``chain_items`` of the
    same offsets, every block once and in order, no item across a
    segment, one item for a segment of pad rows alone."""
    lay = _skewed_layout(np.random.default_rng(3), 20000, 12, block)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    items = reduce_items(ptr, block)
    cap = max(1, REDUCE_ITEM_ROWS // block)
    assert items.cap == cap
    want = chain_items(ptr, cap)
    assert torch.equal(items.item_block, want.item_block)
    assert torch.equal(items.item_ptr, want.item_ptr)
    ib, ip = items.item_block.tolist(), items.item_ptr.tolist()
    assert ib[0] == 0 and ib[-1] == lay.nblocks
    assert all(0 < y - x <= cap for x, y in zip(ib, ib[1:]))
    assert ip[0] == 0 and ip[-1] == items.nitems
    for s in range(lay.nseg):
        assert ib[ip[s]] == ptr[s] and ib[ip[s + 1]] == ptr[s + 1]
    assert ip[1] - ip[0] > 1                  # segment 0: several items
    assert ip[2] - ip[1] == 1                 # pad rows alone: one item


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("ops,out_subs,out_shape,path", [
    pytest.param(*p.values, PATHS[p.id], id=p.id) for p in STAGES])
def test_reduce_path_per_stage(ops, out_subs, out_shape, path, itemsize):
    """Each stage of the card tests takes the path intended for it; the
    same stage on a base off 16 bytes takes the index tables."""
    st = _stage(ops, out_subs, out_shape)
    assert stages.reduce_path(st, itemsize) == path
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    rows = [torch.zeros((16 if f else 1, int(np.prod(sh))), dtype=dtype)
            for _, sh, f in ops]
    assert stages.reduce_launch_path(st, rows) == path
    flat = torch.zeros(rows[0].numel() + 1, dtype=dtype)
    rows[0] = flat[1:].view(rows[0].shape)
    assert stages.reduce_launch_path(st, rows) == stages.REDUCE_TABLES


def test_reduce_path_needs_whole_vectors_and_blocks():
    """Off the vector (a float32 width of 6; a float64 one of 6 is three
    vectors) or off the 4 x 4 register block (3 x 4), K1 reads through
    the index tables."""
    dot = _stage([("d", (6,), True), ("d", (6,), True)], "d", (6,))
    assert stages.reduce_path(dot, 4) == stages.REDUCE_TABLES
    assert stages.reduce_path(dot, 8) == stages.REDUCE_VECTORS
    outer = _stage([("d", (3,), True), ("e", (4,), True)], "de", (3, 4))
    assert stages.reduce_path(outer, 4) == stages.REDUCE_TABLES
    flipped = _stage([("e", (4,), True), ("d", (8,), True)], "de", (8, 4))
    assert stages.reduce_path(flipped, 4) == stages.REDUCE_TABLES
    assert stages.reduce_columns(dot, stages.REDUCE_VECTORS, 8) == 3
    assert stages.reduce_columns(
        _stage([("d", (16,), True), ("e", (16,), True)], "de", (16, 16)),
        stages.REDUCE_OUTER, 4) == 16


def test_executor_cuts_reduce_items_once_per_layout(monkeypatch):
    """Two executions on one operand cut K1's items once per stage
    layout, from the host block offsets, and hand the cached items to
    the lowering."""
    cuts, handed = [], []
    real_cut = tex.reduce_items

    def cut(block_ptr, block):
        assert block_ptr.device.type == "cpu"
        cuts.append(block)
        return real_cut(block_ptr, block)

    lowering = tex.get_lowering("hopper")
    real_reduce = lowering.reduce

    def reduce(ir_, tables, block_ptr, mask, padded, dtype, items=None):
        handed.append(items)
        return real_reduce(ir_, tables, block_ptr, mask, padded, dtype,
                           items)

    monkeypatch.setattr(tex, "reduce_items", cut)
    monkeypatch.setattr(lowering, "reduce", reduce)
    csf = build_csf(random_sparse((30, 20, 25), 0.05, seed=3,
                                  distribution="frostt"))
    spec = S.mttkrp(30, 20, 25, 8)
    p = plan(spec, nnz_levels=csf.nnz_levels())
    arrays = CSFArrays.from_csf(csf, device="cpu")
    rng = np.random.default_rng(1)
    factors = {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(np.float32)
        for t in spec.inputs if not t.is_sparse}
    x = tex.StagePlanExecutor(spec, p.path, p.order, block=8,
                              strategy="row")
    x(arrays, factors)
    layouts = [v for k, v in arrays.cache.items()
               if isinstance(k, tuple) and len(k) == 3
               and isinstance(k[0], int)]
    assert layouts and len(cuts) == len(layouts) and cuts[0] == 8
    first = len(handed)
    x(arrays, factors)
    assert len(cuts) == len(layouts) and len(handed) == 2 * first
    for lay, _, _, block_ptr, items in layouts:
        want = reduce_items(block_ptr, 8)
        assert torch.equal(items.item_block, want.item_block)
        assert torch.equal(items.item_ptr, want.item_ptr)
        assert any(h is items for h in handed)


def _kernel_walk(st, items, mask, padded, path, itemsize):
    """K1's algorithm in plain PyTorch: per item, row lanes of the
    path's geometry each sum their rows (lane y: rows y, y + lanes, ...)
    in ascending order, a fixed tree adds the lanes (lane y += lane
    y + h for h = lanes / 2 .. 1) into the item's partial row, and the
    partial rows are added per segment in ascending item order."""
    cols = stages.reduce_columns(st, path, itemsize)
    lanes = 256 // native.column_threads(cols)
    per_row = stages.block_partials_plain(
        ir.Stage(st.operands, st.out_subs, st.out_shape, True, 1,
                 st.nseg), mask, padded)
    ib = items.item_block.tolist()
    partials = torch.zeros((items.nitems, per_row.shape[1]),
                           dtype=per_row.dtype)
    for i in range(items.nitems):
        rows = per_row[ib[i] * st.block:ib[i + 1] * st.block]
        lane = torch.zeros((lanes, rows.shape[1]), dtype=rows.dtype)
        for n in range(rows.shape[0]):
            lane[n % lanes] += rows[n]
        h = lanes // 2
        while h:
            lane[:h] += lane[h:2 * h]
            h //= 2
        partials[i] = lane[0]
    return segment_combine_plain(partials, items.item_ptr, st.nseg)


WALK_STAGES = [
    pytest.param([("d", (8,), True), ("d", (8,), True)], "d", (8,),
                 stages.REDUCE_VECTORS, id="vectors-Zd,Zd->d"),
    pytest.param([("d", (4,), True), ("e", (8,), True)], "de", (4, 8),
                 stages.REDUCE_OUTER, id="outer-Zd,Ze->de"),
    pytest.param([("", (), True), ("d", (6,), True)], "d", (6,),
                 stages.REDUCE_TABLES, id="tables-Z,Zd->d"),
    pytest.param([("de", (3, 4), True), ("e", (4,), False)], "d", (3,),
                 stages.REDUCE_TABLES, id="tables-Zde,e->d"),
    pytest.param([("d", (8,), True), ("d", (8,), True)], "", (),
                 stages.REDUCE_TABLES, id="tables-Zd,Zd->"),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("ops,out_subs,out_shape,path", WALK_STAGES)
def test_reduce_item_walk_matches_reference(ops, out_subs, out_shape, path,
                                            cap, dtype):
    """The walk of K1's items, lanes and tree, with items of at most
    ``cap`` blocks of 8 rows (segment 0 spans several; segment 1 is pad
    rows alone), gives the reference's ``run_reduce_stage`` in interpret
    mode on the same padded inputs, and a zero row for the pad rows."""
    rng = np.random.default_rng(5)
    nfib, nseg, block = 150, 6, 8
    lay = _skewed_layout(rng, nfib, nseg, block)
    padded = []
    for _, sh, fiber in ops:
        w = int(np.prod(sh))
        if fiber:
            padded.append(rng.standard_normal((nfib, w)).astype(dtype)
                          [lay.gather])
        else:
            padded.append(rng.standard_normal((1, w)).astype(dtype))
    st = _stage(ops, out_subs, out_shape, block, nseg)
    itemsize = np.dtype(dtype).itemsize
    assert stages.reduce_path(st, itemsize) == path
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg))
    items = chain_items(ptr, cap)
    assert int(items.item_ptr[1]) > 1
    got = _kernel_walk(st, items, torch.from_numpy(lay.mask),
                       [torch.from_numpy(a) for a in padded], path,
                       itemsize)
    jops = tuple(jir.StageOperand(s, sh, f) for s, sh, f in ops)
    js = jir.Stage(operands=jops, out_subs=out_subs, out_shape=out_shape,
                   reduce=True, block=block, nseg=nseg, interpret=True)

    def ref():
        return np.asarray(jst.run_reduce_stage(
            js, jnp.asarray(lay.block_seg), jnp.asarray(lay.block_first),
            jnp.asarray(lay.mask[:, None]),
            [jnp.asarray(a) for a in padded], padded[0].dtype))

    if dtype == np.float64:
        with jax.enable_x64(True):
            want = ref()
    else:
        want = ref()
    got = got.numpy().astype(np.float64)
    want = want.astype(np.float64).reshape(got.shape)
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())
    assert not got[1].any()
