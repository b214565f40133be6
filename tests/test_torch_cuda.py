"""The port's CUDA kernels on the card: each against its plain version
(K1, K2, K4 and the combine; K2's scalar path, global tables and
float64 table-order sums; K3, the fused chain, on 2- and 3-level
chains over work items from one block to the default cut, the same
bits run to run; K5-K7, the paper kernels; K8-K11, the LM kernels, in
float32 and bfloat16 at sizes no tile or chunk divides, K8's bf16
tensor-core path at full tiles, on an identity weight and on a
misaligned base, and K10 at heads wider than 128).

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use), so they carry the ``cuda``
marker and skip elsewhere.  They import neither JAX nor the JAX package,
so they run where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 ``1e-5 * max(1, max|plain|)`` (the kernel sums in
another order than ``torch.einsum``); float64 ``1e-12`` relative;
bfloat16, element by element, the smaller of ``1e-2 * max(1,
max|plain|)`` and ``2**-7 * |plain| + 2**-4 * rms(plain)`` (the kernel
and its plain version round at the same points, but a float32 sum in
another order can land a value on the other side of a bf16 rounding
boundary: one bf16 ulp is at most 2**-7 of the value; K9's plain
version rounds ``p`` after another running maximum).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import spec as S  # noqa: E402
from repro_torch.core.executor import (CSFArrays,  # noqa: E402
                                       execute_plan, reference_execute)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.kernels import (grouped_matmul, local_attn,  # noqa: E402
                                 native, ops, paper, rglru, wkv6)
from repro_torch.kernels.codegen import ir  # noqa: E402
from repro_torch.kernels.codegen import lower_gpu, stages  # noqa: E402
from repro_torch.kernels.segment import (segment_combine,  # noqa: E402
                                         segment_combine_plain, segment_ptr)
from repro_torch.kernels.util import padded_segment_layout  # noqa: E402
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402

pytestmark = pytest.mark.cuda

STAGES = [
    pytest.param([("d", (64,), True), ("d", (64,), True)], "d", (64,),
                 id="Zd,Zd->d"),
    pytest.param([("", (), True), ("d", (40,), True)], "d", (40,),
                 id="Z,Zd->d"),
    pytest.param([("d", (16,), True), ("e", (16,), True)], "de", (16, 16),
                 id="Zd,Ze->de"),
    pytest.param([("d", (20,), True), ("e", (20,), True)], "de", (20, 20),
                 id="Zd,Ze->de-two-tiles"),
    pytest.param([("de", (3, 4), True), ("e", (4,), False)], "d", (3,),
                 id="Zde,e->d"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "", (),
                 id="Zd,Zd->"),
]
PRODUCTS = [
    pytest.param([("", (), True), ("d", (64,), True)], "d", (64,),
                 id="Z,Zd->Zd"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "", (),
                 id="Zd,Zd->Z"),
    pytest.param([("e", (3,), True), ("fg", (5, 2), True)], "efg",
                 (3, 5, 2), id="Ze,Zfg->Zefg"),
    pytest.param([("k", (4,), True), ("kd", (4, 300), False)], "d", (300,),
                 id="Zk,kd->Zd-wide"),
    pytest.param([("de", (3, 8), True), ("e", (8,), False)], "d", (3,),
                 id="Zde,e->Zd-chunks"),
]
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.float64, id="f64")]
LM_DTYPES = [pytest.param(torch.float32, id="f32"),
             pytest.param(torch.bfloat16, id="bf16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    rel = {torch.float32: 1e-5, torch.bfloat16: 1e-2}.get(dtype, 1e-12)
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * scale, (err, rel * scale)
    if dtype == torch.bfloat16 and want.numel():
        rms = float(want.square().mean().sqrt())
        tol = 2.0 ** -7 * want.abs() + 2.0 ** -4 * rms
        over = (got - want).abs() > tol
        assert not bool(over.any()), (err, int(over.sum()))


def _stage(ops, out_subs, out_shape, reduce_, block, nseg):
    return ir.Stage(tuple(ir.StageOperand(s, sh, f) for s, sh, f in ops),
                    out_subs, out_shape, reduce_, block, nseg)


def _layout(rng, nfib, nseg, block):
    seg = np.sort(rng.integers(0, nseg, size=nfib))
    seg[0], seg[-1] = 0, nseg - 1
    seg[: nfib // 3] = 0                      # one heavy segment
    return padded_segment_layout(np.sort(seg), nseg, block)


def _reduce_inputs(ops, rng, lay, nfib, dtype, dev):
    padded = []
    for _, sh, fiber in ops:
        w = int(np.prod(sh))
        if fiber:
            fib = torch.from_numpy(rng.standard_normal((nfib, w)))
            padded.append(fib[torch.from_numpy(lay.gather).long()])
        else:
            padded.append(torch.from_numpy(rng.standard_normal((1, w))))
    return [p.to(dev, dtype) for p in padded]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape", STAGES)
def test_reduce_and_splitk_kernels_match_plain(cuda, ops, out_subs,
                                               out_shape, dtype):
    rng = np.random.default_rng(0)
    nfib, nseg, block = 1000, 37, 16
    lay = _layout(rng, nfib, nseg, block)
    st = _stage(ops, out_subs, out_shape, True, block, nseg)
    tables = ir.index_tables(st, cuda)
    padded = _reduce_inputs(ops, rng, lay, nfib, dtype, cuda)
    mask = torch.from_numpy(lay.mask).to(cuda)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg)).to(cuda)
    native.reset_launch_counts()
    out = stages.run_reduce_stage(st, tables, ptr, mask, padded, dtype)
    parts = lower_gpu.splitk_partials(st, tables, mask, padded)
    comb = segment_combine(parts, ptr, nseg)
    torch.cuda.synchronize()
    assert native.launch_counts() == {
        **dict.fromkeys(native.KERNELS, 0), "reduce": 1, "splitk": 1,
        "combine": 1}
    _close(out, stages.run_reduce_stage_plain(st, ptr, mask, padded, dtype),
           dtype)
    _close(parts, stages.block_partials_plain(st, mask, padded), dtype)
    _close(comb, segment_combine_plain(parts, ptr, nseg), dtype)
    if dtype == torch.float64:
        # same block order, same partials: the segment loop and split-K
        # then combine add identical block partials in identical order
        _close(comb, out, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape", PRODUCTS)
def test_product_kernel_matches_plain(cuda, ops, out_subs, out_shape, dtype):
    rng = np.random.default_rng(1)
    nrows = 3001                            # not a multiple of any tile
    st = _stage(ops, out_subs, out_shape, False, 128, 0)
    rows = [torch.from_numpy(rng.standard_normal(
        (nrows if f else 1, int(np.prod(sh))))).to(cuda, dtype)
        for _, sh, f in ops]
    tables = ir.index_tables(st, cuda)
    tiling = _tiling(st, dtype)
    assert nrows % tiling.rows and tiling.smem_tables
    native.reset_launch_counts()
    got = stages.run_product_stage(st, tables, rows, dtype)
    torch.cuda.synchronize()
    assert native.launch_counts()["product"] == 1
    _close(got, stages.run_product_stage_plain(st, rows, dtype), dtype)


def _tiling(st, dtype):
    return stages.product_tiling(
        st, torch.empty((), dtype=dtype).element_size())


def _offset_rows(rng, nrows, w, dtype, dev, offset):
    """``(nrows, w)`` rows whose base lies ``offset`` elements into a
    fresh allocation (so not 16-byte aligned when ``offset`` is odd)."""
    flat = torch.from_numpy(rng.standard_normal(nrows * w + offset))
    return flat.to(dev, dtype)[offset:].view(nrows, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("ops,out_subs,out_shape", [
    pytest.param([("d", (3,), True), ("d", (3,), True)], "d", (3,),
                 id="Zd,Zd->Zd-width3"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "", (),
                 id="Zd,Zd->Z"),
    pytest.param([("d", (5,), True), ("d", (5,), True)], "", (),
                 id="Zd,Zd->Z-width5"),
    pytest.param([("", (), True), ("d", (16,), True)], "d", (16,),
                 id="Z,Zd->Zd-16"),
])
def test_product_kernel_scalar_path_on_unaligned_rows(cuda, ops, out_subs,
                                                      out_shape, offset,
                                                      dtype):
    """An operand view offset by one element takes the element-wise copy
    (the scalar path); width 3 rows hold no whole 16-byte chunk."""
    rng = np.random.default_rng(5)
    nrows = 1001
    st = _stage(ops, out_subs, out_shape, False, 128, 0)
    rows = [_offset_rows(rng, nrows, int(np.prod(sh)), dtype, cuda,
                         offset if i == 1 else 0)
            for i, (_, sh, _) in enumerate(ops)]
    assert (rows[1].data_ptr() % 16 == 0) == (offset == 0)
    got = stages.run_product_stage(st, ir.index_tables(st, cuda), rows,
                                   dtype)
    torch.cuda.synchronize()
    _close(got, stages.run_product_stage_plain(st, rows, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_product_kernel_reads_large_tables_from_global_memory(cuda, dtype):
    rng = np.random.default_rng(6)
    st = _stage([("k", (4,), True), ("kd", (4, 3000), False)], "d", (3000,),
                False, 128, 0)
    tables = ir.index_tables(st, cuda)
    assert not _tiling(st, dtype).smem_tables
    rows = [torch.from_numpy(rng.standard_normal((n, w))).to(cuda, dtype)
            for n, w in ((517, 4), (1, 12000))]
    got = stages.run_product_stage(st, tables, rows, dtype)
    torch.cuda.synchronize()
    _close(got, stages.run_product_stage_plain(st, rows, dtype), dtype)


@pytest.mark.parametrize("ops,out_subs,out_shape", PRODUCTS)
def test_product_kernel_f64_is_the_table_order_sum(cuda, ops, out_subs,
                                                   out_shape):
    """Float64: each output is its terms summed in table order, each
    product and each sum rounded once (no fused multiply-add)."""
    rng = np.random.default_rng(7)
    nrows = 203
    st = _stage(ops, out_subs, out_shape, False, 128, 0)
    host = [rng.standard_normal((nrows if f else 1, int(np.prod(sh))))
            for _, sh, f in ops]
    tables = ir.index_tables(st, cuda)
    got = stages.run_product_stage(
        st, tables, [torch.from_numpy(h).to(cuda) for h in host],
        torch.float64).cpu().numpy()
    ptr, ai, bi = (t.cpu().numpy() for t in (tables.out_ptr, tables.a_idx,
                                             tables.b_idx))
    a, b = (h if f else np.broadcast_to(h, (nrows, h.shape[1]))
            for h, (_, _, f) in zip(host, ops))
    want = np.zeros_like(got)
    for z in range(nrows):
        for o in range(st.out_flat_dim):
            s = 0.0
            for t in range(ptr[o], ptr[o + 1]):
                s = s + float(a[z, ai[t]]) * float(b[z, bi[t]])
            want[z, o] = s
    assert np.array_equal(got, want)


def test_combine_kernel_empty_segments_are_zero(cuda):
    seg = np.array([1, 1, 4, 4, 4])
    rows = torch.arange(10.0, device=cuda).reshape(5, 2)
    ptr = torch.from_numpy(segment_ptr(seg, 6)).to(cuda)
    out = segment_combine(rows, ptr, 6)
    torch.cuda.synchronize()
    want = torch.tensor([[0, 0], [2, 4], [0, 0], [0, 0], [18, 21], [0, 0]],
                        dtype=torch.float32)
    assert torch.equal(out.cpu(), want)


def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    rows = torch.zeros((4, 2), dtype=torch.float16, device=cuda)
    ptr = torch.tensor([0, 4], device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        segment_combine(rows, ptr, 1)
    with pytest.raises(ValueError):
        segment_combine(rows.float().t(), ptr, 1)      # not contiguous


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda-splitk"])
@pytest.mark.parametrize("spec", [S.mttkrp(30, 20, 25, 8),
                                  S.ttmc3(30, 20, 25, 4, 3),
                                  S.tttp3(30, 20, 25, 8)],
                         ids=["mttkrp", "ttmc3", "tttp3"])
def test_engines_on_the_card_match_algorithm2(cuda, backend, spec):
    csf = build_csf(random_sparse((30, 20, 25), 0.05, seed=3,
                                  distribution="frostt"))
    rng = np.random.default_rng(1)
    factors = {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(np.float32)
        for t in spec.inputs if not t.is_sparse}
    p = plan(spec, nnz_levels=csf.nnz_levels())
    ref = reference_execute(spec, p.path, p.order, csf, factors)
    if spec.output_is_sparse:
        ref = ref[tuple(csf.coo.coords.T)]
    arrays = CSFArrays.from_csf(csf)
    assert arrays.device.type == "cuda"
    kw = {} if backend == "torch" else {"block": 8}
    native.reset_launch_counts()
    out = execute_plan(p, arrays, factors, backend=backend, **kw)
    torch.cuda.synchronize()
    _close(out, torch.from_numpy(np.asarray(ref)), torch.float32)
    counts = native.launch_counts()
    if backend == "cuda":
        assert counts["reduce"] + counts["product"] > 0
    if backend == "cuda-splitk" and not spec.output_is_sparse:
        assert counts["splitk"] > 0 and counts["combine"] > 0


# --------------------------------------------------------------------- #
# K3, the fused chain
# --------------------------------------------------------------------- #
CHAINS = [pytest.param(S.mttkrp(30, 20, 25, 8), (30, 20, 25), id="mttkrp"),
          pytest.param(S.ttmc3(30, 20, 25, 4, 3), (30, 20, 25),
                       id="ttmc3"),
          pytest.param(S.ttmc4(12, 10, 9, 8, 3, 2, 4), (12, 10, 9, 8),
                       id="ttmc4")]


def _chain_call(monkeypatch, spec, shape, dtype, dev):
    """Run ``spec``'s fused plan on ``dev`` through the ``cuda`` engine,
    capturing the K3 call's arguments."""
    csf = build_csf(random_sparse(shape, 0.05, seed=3,
                                  distribution="frostt"))
    rng = np.random.default_rng(1)
    factors = {t.name: torch.from_numpy(rng.standard_normal(
        [spec.dims[i] for i in t.indices])).to(dev, dtype)
        for t in spec.inputs if not t.is_sparse}
    p = plan(spec, nnz_levels=csf.nnz_levels())
    calls = []
    inner = stages.run_fused_chain_stage

    def capture(*args):
        calls.append(args)
        return inner(*args)

    monkeypatch.setattr(stages, "run_fused_chain_stage", capture)
    arrays = CSFArrays.from_csf(csf, dev)
    arrays.values = arrays.values.to(dtype)
    out = execute_plan(p, arrays, factors, backend="cuda", block=8,
                       strategy="fused")
    monkeypatch.undo()
    return out, calls, p, arrays, factors


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec,shape", CHAINS)
def test_chain_kernel_matches_plain(cuda, monkeypatch, spec, shape, dtype):
    native.reset_launch_counts()
    out, calls, p, arrays, factors = _chain_call(monkeypatch, spec, shape,
                                                 dtype, cuda)
    torch.cuda.synchronize()
    assert native.launch_counts()["chain"] == 1 and len(calls) == 1
    ir_, layout, tables, link_tables, padded, link_arrays, dt = calls[0]
    _close(stages.run_fused_chain_stage(*calls[0]),
           stages.run_fused_chain_stage_plain(ir_, layout, padded,
                                              link_arrays, dt), dtype)
    want = execute_plan(p, arrays, factors, backend="torch")
    _close(out, want, dtype)
    split = execute_plan(p, arrays, factors, backend="cuda-splitk",
                         block=8, strategy="fused")
    _close(split, want, dtype)


def test_chain_kernel_zeroes_an_outer_row_with_no_blocks(cuda,
                                                         monkeypatch):
    """An outermost segment that owns no block (a row the layout never
    reaches, so no work item) comes back exactly zero, as the TPU
    kernel's ``row_written`` guard makes it."""
    _, calls, *_ = _chain_call(monkeypatch, S.mttkrp(30, 20, 25, 8),
                               (30, 20, 25), torch.float32, cuda)
    ir_, layout, tables, link_tables, padded, link_arrays, dt = calls[0]
    k = ir_.nseg_out // 2                  # insert an empty row before k
    ir2, layout2 = _with_empty_outer_row(ir_, layout, k)
    got = stages.run_fused_chain_stage(ir2, layout2, tables, link_tables,
                                       padded, link_arrays, dt)
    want = stages.run_fused_chain_stage_plain(ir2, layout2, padded,
                                              link_arrays, dt)
    torch.cuda.synchronize()
    assert torch.equal(got[k].cpu(), torch.zeros_like(got[k].cpu()))
    _close(got, want, torch.float32)


def _with_empty_outer_row(ir_, layout, k):
    """``ir_`` and ``layout`` with an outermost row that owns no block
    inserted before row ``k`` (shared with tests/test_torch_chain.py)."""
    def widen(ptr):
        return torch.cat([ptr[:k + 1], ptr[k:]])

    layout2 = dataclasses.replace(
        layout, out_block_ptr=widen(layout.out_block_ptr),
        parent_ptrs=layout.parent_ptrs[:-1] + (widen(layout.parent_ptrs[-1]),))
    return dataclasses.replace(ir_, nseg_out=ir_.nseg_out + 1), layout2


def _with_cap(layout, cap):
    """A copy of ``layout`` whose K3 items hold at most ``cap`` blocks
    (``None``: the default cut), set where ``ChainLayout.items`` keeps
    the items it builds."""
    layout2 = dataclasses.replace(layout)
    vars(layout2)["items"] = ir.chain_items(layout2.out_block_ptr, cap)
    return layout2


@pytest.mark.parametrize("cap", [1, 2, None])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec,shape", CHAINS)
def test_chain_kernel_items_match_plain(cuda, monkeypatch, spec, shape,
                                        dtype, cap):
    """K3 over work items of at most ``cap`` blocks (1 and 2: cuts inside
    the segments of every inner level; None: the default cut), each
    item's partial row combined in item order, against the plain
    version, which walks level by level; with an outer row that owns no
    block inserted, that row is zero."""
    _, calls, *_ = _chain_call(monkeypatch, spec, shape, dtype, cuda)
    ir_, layout, tables, link_tables, padded, link_arrays, dt = calls[0]
    small = _with_cap(layout, cap)
    if cap:
        assert small.items.nitems > layout.items.nitems
    native.reset_launch_counts()
    got = stages.run_fused_chain_stage(ir_, small, tables, link_tables,
                                       padded, link_arrays, dt)
    torch.cuda.synchronize()
    counts = native.launch_counts()
    assert counts["chain"] == 1 and counts["combine"] == 1
    want = stages.run_fused_chain_stage_plain(ir_, layout, padded,
                                              link_arrays, dt)
    _close(got, want, dtype)
    k = ir_.nseg_out // 2
    ir2, layout2 = _with_empty_outer_row(ir_, layout, k)
    got2 = stages.run_fused_chain_stage(ir2, _with_cap(layout2, cap), tables,
                                        link_tables, padded, link_arrays, dt)
    torch.cuda.synchronize()
    assert not bool(got2[k].any())
    _close(torch.cat([got2[:k], got2[k + 1:]]), want, dtype)


@pytest.mark.parametrize("spec,shape", CHAINS)
def test_chain_kernel_is_bit_identical_run_to_run(cuda, monkeypatch, spec,
                                                  shape):
    """No atomics and a fixed combine order: two launches on the same
    inputs give the same bits."""
    _, calls, *_ = _chain_call(monkeypatch, spec, shape, torch.float32,
                               cuda)
    args = calls[0]
    first = stages.run_fused_chain_stage(*args)
    second = stages.run_fused_chain_stage(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# --------------------------------------------------------------------- #
# K5-K7, the paper kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
def test_paper_kernels_match_plain(cuda, dtype):
    csf = build_csf(random_sparse((40, 30, 35), 0.05, seed=2,
                                  distribution="frostt"))
    rng = np.random.default_rng(4)

    def mat(n, r):
        return torch.from_numpy(rng.standard_normal((n, r))).to(cuda, dtype)

    b, c = mat(30, 33), mat(35, 33)           # R not a power of two
    native.reset_launch_counts()
    got = ops.mttkrp(csf, b, c, block=16)
    _close(got, ops.mttkrp(csf, b, c, use_kernel=False), dtype)
    lay = ops.ttmc_fiber_layout(csf, block=8)
    ug, xf = mat(csf.nfib[2], 5), mat(csf.nfib[2], 7)
    got = ops.ttmc_fiber(ug, xf, lay)
    _close(got, ops.ttmc_fiber(ug, xf, lay, use_kernel=False), dtype)
    u, v, w = mat(40, 45), mat(30, 45), mat(35, 45)
    got = ops.tttp(csf, u, v, w, block=64)
    _close(got, ops.tttp(csf, u, v, w, use_kernel=False), dtype)
    torch.cuda.synchronize()
    counts = native.launch_counts()
    assert (counts["mttkrp"], counts["ttmc"], counts["tttp"]) == (1, 1, 1)
    # each wrapper against its own plain version on the same inputs
    gather, mask, ptr = ops.layout_arrays(lay, cuda)
    _close(paper.ttmc_kernel(ug[gather], xf[gather], ptr, lay.nseg, 8),
           paper.ttmc_kernel_plain(ug[gather], xf[gather], ptr, lay.nseg,
                                   8), dtype)


# --------------------------------------------------------------------- #
# K8-K11, the LM kernels
# --------------------------------------------------------------------- #
def _randn(gen, shape, dtype, dev, scale=1.0, shift=0.0):
    t = torch.randn(shape, generator=gen, device=dev) * scale + shift
    return t.to(dtype)


@pytest.mark.parametrize("E,C,D,F", [(3, 70, 33, 65), (1, 64, 64, 64),
                                     (1, 5, 3, 7), (2, 130, 1000, 20)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_grouped_matmul_kernel_matches_plain(cuda, E, C, D, F, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _randn(gen, (E, C, D), dtype, cuda)
    w = _randn(gen, (E, D, F), dtype, cuda, D ** -0.5)
    got = grouped_matmul.grouped_matmul_kernel(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, grouped_matmul.grouped_matmul_plain(x, w), dtype)


@pytest.mark.parametrize("E,C,D,F", [(1, 128, 64, 128), (2, 256, 512, 384),
                                     (1, 128, 1024, 256), (3, 300, 200, 136)])
def test_grouped_matmul_bf16_tiles_and_stages(cuda, E, C, D, F):
    """bf16 on the tensor cores at widths TMA takes as they are: full
    tiles, several turns of the stage ring, ragged C and F edges."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(gen, (E, C, D), torch.bfloat16, cuda)
    w = _randn(gen, (E, D, F), torch.bfloat16, cuda, D ** -0.5)
    assert grouped_matmul.padded_widths(D, F, torch.bfloat16) == (D, F)
    native.reset_launch_counts()
    got = grouped_matmul.grouped_matmul_kernel(x, w)
    torch.cuda.synchronize()
    assert native.launch_counts()["grouped_matmul"] == 1
    _close(got, grouped_matmul.grouped_matmul_plain(x, w), torch.bfloat16)


@pytest.mark.parametrize("E,C,D", [(2, 200, 128), (1, 64, 72)])
def test_grouped_matmul_bf16_identity_weight_is_exact(cuda, E, C, D):
    """``x @ I`` is ``x`` bit for bit: a wrong shared-memory descriptor
    or swizzle shows as misplaced values."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(gen, (E, C, D), torch.bfloat16, cuda)
    eye = torch.eye(D, dtype=torch.bfloat16, device=cuda).expand(E, D, D)
    got = grouped_matmul.grouped_matmul_kernel(x, eye.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, x)


def test_grouped_matmul_bf16_misaligned_base_raises_or_pads(cuda):
    """A base pointer off 16 bytes raises when the tensor goes to TMA as
    it is; when D or F needs padding the padded copy is aligned."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    E, C, D, F = 2, 40, 64, 32
    flat = _randn(gen, (E * C * D + 1,), torch.bfloat16, cuda)
    x = flat[1:].view(E, C, D)
    w = _randn(gen, (E, D, F), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        grouped_matmul.grouped_matmul_kernel(x, w)
    x5 = flat[1:1 + E * C * 60].view(E, C, 60)     # D = 60: padded to 64
    got = grouped_matmul.grouped_matmul_kernel(x5, w[:, :60].contiguous())
    torch.cuda.synchronize()
    _close(got, grouped_matmul.grouped_matmul_plain(
        x5, w[:, :60].contiguous()), torch.bfloat16)


@pytest.mark.parametrize("BH,T,D,window", [
    (2, 130, 64, 40),       # T no tile divides
    (1, 100, 64, 1),        # the diagonal only
    (2, 90, 64, 1000),      # window >= T: causal
    (1, 200, 256, 70),      # recurrentgemma's / gemma3's head size
    (3, 64, 40, 64),        # a head size no column tile divides
    (1, 600, 256, 300),     # bands across the plain version's chunks
])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_local_attn_kernel_matches_plain(cuda, BH, T, D, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(gen, (BH, T, D), dtype, cuda) for _ in range(3))
    got = local_attn.local_attn_kernel(q, k, v, window)
    torch.cuda.synchronize()
    _close(got, local_attn.local_attn_plain(q, k, v, window), dtype)


def _wkv6_inputs(gen, BH, T, K, dtype, dev):
    r, k, v = (_randn(gen, (BH, T, K), dtype, dev, 0.5) for _ in range(3))
    w = _randn(gen, (BH, T, K), dtype, dev, 0.5, -1.0)
    return r, k, v, w, _randn(gen, (BH, K), dtype, dev, 0.5)


@pytest.mark.parametrize("BH,T,K", [(3, 1, 64), (2, 37, 64), (2, 70, 16),
                                    (1, 33, 100),
                                    # wider than 128: the state in shared
                                    # memory, columns split over blocks
                                    (2, 37, 192), (1, 40, 256),
                                    (1, 20, 500)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_wkv6_kernel_matches_plain(cuda, BH, T, K, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = _wkv6_inputs(gen, BH, T, K, dtype, cuda)
    got = wkv6.wkv6_kernel(*args)
    torch.cuda.synchronize()
    _close(got, wkv6.wkv6_plain(*args), dtype)


@pytest.mark.parametrize("B,T,D", [(2, 1, 64), (3, 13, 300), (1, 70, 33)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_rglru_kernel_matches_plain(cuda, B, T, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(gen, (B, T, D), dtype, cuda)
    a = (torch.rand((B, T, D), generator=gen, device=cuda) * 0.93
         + 0.05).to(dtype)
    got = rglru.rglru_kernel(x, a)
    torch.cuda.synchronize()
    _close(got, rglru.rglru_plain(x, a), dtype)


@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_lm_drivers_launch_their_kernels(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, T, H, K = 2, 40, 3, 16
    x = _randn(gen, (4, 20, 24), dtype, cuda)
    w = _randn(gen, (4, 24, 12), dtype, cuda)
    q, k, v = (_randn(gen, (B, T, H, K), dtype, cuda) for _ in range(3))
    r, kk, vv, ww = (_randn(gen, (B, T, H, K), dtype, cuda, 0.5)
                     for _ in range(4))
    u = _randn(gen, (H, K), dtype, cuda, 0.5)
    a = (torch.rand((B, T, K), generator=gen, device=cuda) * 0.9
         + 0.05).to(dtype)
    native.reset_launch_counts()
    got = [ops.grouped_matmul(x, w), ops.local_attn(q, k, v, 9),
           ops.wkv6(r, kk, vv, ww, u), ops.rglru(q[:, :, 0], a)]
    want = [ops.grouped_matmul(x, w, use_kernel=False),
            ops.local_attn(q, k, v, 9, use_kernel=False),
            ops.wkv6(r, kk, vv, ww, u, use_kernel=False),
            ops.rglru(q[:, :, 0], a, use_kernel=False)]
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        _close(g, wnt, dtype)
    counts = native.launch_counts()
    assert [counts[s] for s in ("grouped_matmul", "local_attn", "wkv6",
                                "rglru")] == [1, 1, 1, 1]


def test_lm_wrappers_reject_what_their_kernels_lack(cuda):
    half = torch.zeros((2, 8, 16), dtype=torch.float16, device=cuda)
    dbl = torch.zeros((2, 8, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="'grouped_matmul' takes"):
        grouped_matmul.grouped_matmul_kernel(half, half.transpose(1, 2)
                                             .contiguous())
    with pytest.raises(TypeError, match="'local_attn' takes"):
        local_attn.local_attn_kernel(dbl, dbl, dbl, 4)
    with pytest.raises(TypeError, match="'rglru' takes"):
        rglru.rglru_kernel(half, half)
    with pytest.raises(TypeError, match="'wkv6' takes"):
        wkv6.wkv6_kernel(dbl, dbl, dbl, dbl, dbl[:, 0].contiguous())
    big = torch.zeros((1, 8, 257), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        local_attn.local_attn_kernel(big, big, big, 4)
    wide = torch.zeros((1, 2, 1615), device=cuda)
    with pytest.raises(ValueError, match="32 state columns"):
        wkv6.wkv6_kernel(wide, wide, wide, wide, wide[:, 0].contiguous())
