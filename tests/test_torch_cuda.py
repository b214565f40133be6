"""The port's CUDA kernels on the card: each against its plain version
(K1, K2, K4 and the combine; K1 over work items on a skewed layout on
each of its three paths, the same bits twice and no host read; K2's
scalar path, global tables and
float64 table-order sums; K3, the fused chain, on 2- and 3-level
chains over work items from one block to the default cut, the same
bits run to run; K5-K7, the paper kernels, K5 over work items on a
skewed pattern on its vector and scalar paths, the same bits twice; K6
over K1's work items on its register-block and scalar paths (R = S =
128 in four column tiles, a misaligned base), the same bits twice, and
in float64 the bits of a PyTorch walk of its items, as K1's outer path;
the collective ``cuda`` engine on a one-rank NCCL mesh, through the same
launches as one device; K8-K11, the LM kernels, in
float32 and bfloat16 at sizes no tile or chunk divides, K8's float32
path at full tiles, ragged edges, D = 0, on misaligned bases (its
scalar path) and the same bits call to call, K8's bf16 tensor-core
path at full tiles, on an identity weight and on a misaligned base; K9
at the edges of its tiles, on padded heads, with the diagonal only (the
output is ``v``), on a misaligned base and the same bits twice; K10
at heads wider than 128, at the edges of its ring of chunks, on
unaligned tiles and the same bits run to run; K11 at the edges of its
ring and with the plain version's bits).

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
import json

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
    # K1 launches the combine of its items' partial rows, K4's caller one
    assert native.launch_counts() == {
        **dict.fromkeys(native.KERNELS, 0), "reduce": 1, "splitk": 1,
        "combine": 2}
    _close(out, stages.run_reduce_stage_plain(st, ptr, mask, padded, dtype),
           dtype)
    _close(parts, stages.block_partials_plain(st, mask, padded), dtype)
    _close(comb, segment_combine_plain(parts, ptr, nseg), dtype)
    if dtype == torch.float64:
        # the two engines group the same rows into other partials (K1 by
        # work items and row lanes, K4 by blocks), so they agree to
        # float64 rounding, not bit for bit
        _close(comb, out, dtype)


# K1's cases: (operands, out_subs, out_shape, segments, elements moving
# the first operand's base off 16 bytes, the path the kernel takes)
REDUCE_CASES = [
    pytest.param([("d", (64,), True), ("d", (64,), True)], "d", (64,), 40,
                 0, stages.REDUCE_VECTORS, id="vectors-Zd,Zd->d"),
    pytest.param([("d", (16,), True), ("e", (16,), True)], "de", (16, 16),
                 40, 0, stages.REDUCE_OUTER, id="outer-16x16"),
    pytest.param([("d", (8,), True), ("e", (12,), True)], "de", (8, 12), 40,
                 0, stages.REDUCE_OUTER, id="outer-8x12"),
    pytest.param([("de", (3, 4), True), ("e", (4,), False)], "d", (3,), 40,
                 0, stages.REDUCE_TABLES, id="tables-Zde,e->d"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "", (), 1, 0,
                 stages.REDUCE_TABLES, id="tables-Zd,Zd->-one-segment"),
    pytest.param([("d", (64,), True), ("d", (64,), False)], "d", (64,), 40,
                 0, stages.REDUCE_TABLES, id="tables-broadcast-Zd,d->d"),
    pytest.param([("", (), True), ("d", (40,), True)], "d", (40,), 40, 0,
                 stages.REDUCE_TABLES, id="tables-width-40"),
    pytest.param([("d", (20,), True), ("e", (20,), True)], "de", (20, 20),
                 40, 0, stages.REDUCE_TABLES, id="tables-20x20"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "d", (64,), 40,
                 1, stages.REDUCE_TABLES, id="tables-misaligned"),
]


def _skewed_reduce_call(ops, out_subs, out_shape, nseg, offset, dtype,
                        dev):
    """K1's arguments on a skewed layout: 20,000 fibers, a third of them
    in segment 0 (many work items), segment 1 pad rows alone (when there
    are several), block 16; ``offset`` elements moves the first
    operand's base off 16 bytes."""
    rng = np.random.default_rng(11)
    nfib, block = 20000, 16
    seg = np.sort(rng.integers(min(2, nseg - 1), nseg, size=nfib))
    seg[: nfib // 3] = 0
    lay = padded_segment_layout(np.sort(seg), nseg, block)
    st = _stage(ops, out_subs, out_shape, True, block, nseg)
    padded = _reduce_inputs(ops, rng, lay, nfib, dtype, dev)
    if offset:
        flat = torch.zeros(padded[0].numel() + offset, dtype=dtype,
                           device=dev)
        flat[offset:] = padded[0].flatten()
        padded[0] = flat[offset:].view(padded[0].shape)
    mask = torch.from_numpy(lay.mask).to(dev)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg)).to(dev)
    return st, ir.index_tables(st, dev), ptr, mask, padded


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape,nseg,offset,path",
                         REDUCE_CASES)
def test_reduce_kernel_items_match_plain(cuda, ops, out_subs, out_shape,
                                         nseg, offset, path, dtype):
    """K1 over work items on a skewed layout, on each of its paths:
    items of three blocks (segment 0 spans over a hundred) as the
    executor passes them, and the wrapper's own cut; against its plain
    version, one launch of K1 and one of the combine a call, the same
    bits on a second call, and a zero row for a segment of pad rows."""
    st, tables, ptr, mask, padded = _skewed_reduce_call(
        ops, out_subs, out_shape, nseg, offset, dtype, cuda)
    assert stages.reduce_launch_path(
        st, [p.to(dtype) for p in padded]) == path
    want = stages.run_reduce_stage_plain(st, ptr, mask, padded, dtype)
    small = ir.chain_items(ptr.cpu(), 3).to(cuda)
    assert int(small.item_ptr[1]) > 100
    for items in (small, None):
        native.reset_launch_counts()
        got = stages.run_reduce_stage(st, tables, ptr, mask, padded, dtype,
                                      items)
        torch.cuda.synchronize()
        counts = native.launch_counts()
        assert counts["reduce"] == 1 and counts["combine"] == 1
        _close(got, want, dtype)
        again = stages.run_reduce_stage(st, tables, ptr, mask, padded,
                                        dtype, items)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if nseg > 1:
            assert not bool(got[1].any())


def test_reduce_kernel_given_its_items_reads_nothing_back(cuda):
    """Given the layout's items (as the executor passes them), K1's
    wrapper makes no device-to-host read: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    st, tables, ptr, mask, padded = _skewed_reduce_call(
        *REDUCE_CASES[1].values[:5], torch.float32, cuda)
    items = ir.reduce_items(ptr.cpu(), st.block).to(cuda)
    want = stages.run_reduce_stage(st, tables, ptr, mask, padded,
                                   torch.float32, items)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = stages.run_reduce_stage(st, tables, ptr, mask, padded,
                                      torch.float32, items)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def test_torch_engine_gradient_on_the_card_matches_the_cpu(cuda):
    """``torch.autograd.grad`` through the ``torch`` engine's MTTKRP (two
    segment sums: two combine launches forward) on the card equals the
    CPU's.  The combine's backward, a gather, reads nothing back to the
    host."""
    spec = S.mttkrp(30, 20, 25, 8)
    csf = build_csf(random_sparse((30, 20, 25), 0.05, seed=3,
                                  distribution="frostt"))
    rng = np.random.default_rng(2)
    f = {t.name: rng.standard_normal([spec.dims[i] for i in t.indices])
         .astype(np.float32) for t in spec.inputs if not t.is_sparse}
    w = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    p = plan(spec, nnz_levels=csf.nnz_levels())
    grads = {}
    for dev in ("cpu", "cuda"):
        arrays = CSFArrays.from_csf(csf, dev)
        fb = {k: torch.from_numpy(v).to(dev).requires_grad_()
              for k, v in f.items()}
        native.reset_launch_counts()
        out = execute_plan(p, arrays, fb, backend="torch")
        loss = (out * w.to(dev)).sum()
        torch.cuda.synchronize()
        assert native.launch_counts()["combine"] == (2 if dev == "cuda"
                                                     else 0)
        grads[dev] = torch.autograd.grad(loss, [fb["B"], fb["C"]])
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want, torch.float32)
    rows = torch.randn((9, 4), device=cuda, requires_grad=True)
    ptr = torch.tensor([0, 3, 3, 7], device=cuda)     # rows 7, 8 in none
    out = segment_combine(rows, ptr, 3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        (g,) = torch.autograd.grad(out, rows, torch.ones_like(out))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(g.sum(1).cpu(), torch.tensor([4.0] * 7 + [0.0] * 2))


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


@pytest.mark.parametrize("mode_axis", [{0: "data"}, {1: "data"}],
                         ids=["i-gathered", "j-reduced"])
def test_distributed_cuda_on_one_nccl_rank_matches_execute_plan(
        cuda, tmp_path, mode_axis):
    """``make_distributed_cuda`` on a one-rank NCCL mesh gives
    ``execute_plan``'s output on the card through the same kernel
    launches (one shard: its padding is empty), the ``all_gather`` of
    mode i or the ``all_reduce`` of mode j going through NCCL — the
    counterpart of the reference's one-trace-for-all-shards test."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import make_distributed_cuda
    from repro_torch.distributed.spttn_dist import undo_cyclic
    spec = S.mttkrp(30, 20, 25, 8)
    coo = random_sparse((30, 20, 25), 0.05, seed=3, distribution="frostt")
    csf = build_csf(coo)
    rng = np.random.default_rng(4)
    factors = {t.name: rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(np.float32)
        for t in spec.inputs if not t.is_sparse}
    p = dataclasses.replace(plan(spec, nnz_levels=csf.nnz_levels()),
                            backend="cuda", block=8)
    native.reset_launch_counts()
    want = execute_plan(p, CSFArrays.from_csf(csf), factors)
    torch.cuda.synchronize()
    once = native.launch_counts()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        d = make_distributed_cuda(spec, p, coo, mesh, mode_axis)
        native.reset_launch_counts()
        got = undo_cyclic(d(factors), spec, mode_axis, mesh, coo.shape)
        torch.cuda.synchronize()
        assert native.launch_counts() == once
        assert d.arrays.device.type == "cuda"
    finally:
        dist.destroy_process_group()
    _close(got[:30], want, torch.float32)


# --------------------------------------------------------------------- #
# Sliced replay and the plan service on the card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["cuda", "cuda-splitk"])
@pytest.mark.parametrize("spec,mode,chunks", [
    (S.mttkrp(30, 20, 25, 22), "a", 2),     # 11 wide: off 4
    (S.tttp3(30, 20, 25, 21), "r", 3),      # 7 wide, contracted
], ids=["mttkrp", "tttp3"])
def test_sliced_replay_matches_unsliced_on_the_card(cuda, backend, spec,
                                                    mode, chunks):
    from repro_torch.core.slicing import sliced_execute
    csf = build_csf(random_sparse((30, 20, 25), 0.05, seed=3,
                                  distribution="frostt"))
    rng = np.random.default_rng(2)
    factors = {t.name: torch.from_numpy(rng.standard_normal(
        [spec.dims[i] for i in t.indices]).astype(np.float32)).to(cuda)
        for t in spec.inputs if not t.is_sparse}
    p = dataclasses.replace(plan(spec, nnz_levels=csf.nnz_levels()),
                            backend=backend, block=8)
    arrays = CSFArrays.from_csf(csf)
    native.reset_launch_counts()
    want = execute_plan(p, arrays, factors)
    torch.cuda.synchronize()
    once = native.launch_counts()
    native.reset_launch_counts()
    cache = {}
    got = sliced_execute(p, arrays, factors, mode=mode, chunks=chunks,
                         executor_cache=cache)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    _close(got, want, torch.float32)
    counts = native.launch_counts()
    assert once["reduce"] + once["product"] + once["splitk"] > 0
    assert {k: chunks * n for k, n in once.items()} == counts
    D = spec.dims[mode]
    w = -(-D // chunks)
    assert sorted(cache) == sorted({min(w, D - s) for s in range(0, D, w)})
    stamped = dataclasses.replace(p, slice_mode=mode, slice_chunks=chunks)
    assert torch.equal(execute_plan(stamped, arrays, factors), got)


def test_budgeted_plan_service_dispatch_on_the_card(cuda, tmp_path):
    from repro_torch.autotune import TunerConfig
    from repro_torch.serve import PlanService, moe_routing_coo
    N, E, K, C, D = 256, 8, 2, 64, 90
    r = np.random.default_rng(5)
    idx = np.argsort(-r.standard_normal((N, E)), axis=1)[:, :K]
    coo = moe_routing_coo(idx, E, C)
    x = torch.from_numpy(r.standard_normal((N, D)).astype(
        np.float32)).to(cuda)
    svc = PlanService(cache_dir=str(tmp_path), memory_budget=100_000,
                      tuner=TunerConfig(profile_bucket="log2",
                                        backends=("cuda",), warmup=0,
                                        repeats=1, max_candidates=1))
    out, st = svc.dispatch(coo, x)          # tunes, then dispatches
    assert st.kind == "cold"
    native.reset_launch_counts()
    out, st = svc.dispatch(coo, x)
    torch.cuda.synchronize()
    assert st.kind == "exact" and out.device.type == "cuda"
    plan_json, widths = next(iter(svc._chunk_executors.items()))
    chunks = json.loads(plan_json)["slice_chunks"]
    assert json.loads(plan_json)["slice_mode"] == "d" and chunks > 1
    assert native.launch_counts()["product"] == chunks
    t, e, c = (torch.from_numpy(coo.coords[:, m].astype(np.int64)).to(cuda)
               for m in range(3))
    want = torch.zeros((E, C, D), device=cuda)
    want[e, c] = x[t]
    assert torch.equal(out, want)           # copies: the same bits


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
    assert counts["combine"] == 2         # K5's and K6's items' partial rows
    # each wrapper against its own plain version on the same inputs
    gather, mask, ptr = ops.layout_arrays(lay, cuda)
    _close(paper.ttmc_kernel(ug[gather], xf[gather], ptr, lay.nseg, 8),
           paper.ttmc_kernel_plain(ug[gather], xf[gather], ptr, lay.nseg,
                                   8), dtype)


def _mttkrp_inputs(dev, dtype, R, offset=0):
    """K5's inputs on a skewed layout: one segment of 6,667 rows (27
    items of 16 blocks of 16), others of a few; ``offset`` elements moves
    ``bg``'s base off 16 bytes."""
    rng = np.random.default_rng(9)
    lay = _layout(rng, 20000, 40, 16)
    P = lay.padded_len

    def up(a):
        return torch.from_numpy(a).to(dev, dtype)

    big = up(rng.standard_normal(P * R + offset))
    bg = big[offset:].view(P, R)
    return (up(rng.standard_normal(P)), bg, up(rng.standard_normal((P, R))),
            torch.from_numpy(lay.mask).to(dev),
            torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg)).to(dev),
            lay.nseg, lay.block)


@pytest.mark.parametrize("R,offset", [(64, 0), (33, 0), (64, 1)],
                         ids=["vector", "R33-scalar", "misaligned-scalar"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mttkrp_kernel_items_match_plain(cuda, dtype, R, offset):
    """K5 over its work items, on a pattern where one segment spans many
    items: on the 16-byte vector path (R = 64) and the scalar path (R =
    33, or a base off 16 bytes), against its plain version; one launch of
    the kernel and one of the combine a call, and the same bits on a
    second call."""
    args = _mttkrp_inputs(cuda, dtype, R, offset)
    items = ir.chain_items(args[4], paper.MTTKRP_ITEM_BLOCKS)
    assert int(items.item_ptr.diff().max()) > 8
    native.reset_launch_counts()
    got = paper.mttkrp_kernel(*args)
    torch.cuda.synchronize()
    counts = native.launch_counts()
    assert counts["mttkrp"] == 1 and counts["combine"] == 1
    _close(got, paper.mttkrp_kernel_plain(*args), dtype)
    again = paper.mttkrp_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# --------------------------------------------------------------------- #
# K6 over work items, on K1's walk
# --------------------------------------------------------------------- #
def item_walk(per_row, items, block, lanes, nseg):
    """The work-item walk of K1 and K6 in plain PyTorch, in the kernels'
    order: in each item, lane y of ``lanes`` sums the item's rows y, y +
    lanes, ... of ``per_row`` (one row's terms, ``(P, w)``) in ascending
    order; a fixed tree adds the lanes (lane y += lane y + h, for h =
    lanes / 2 .. 1) into the item's partial row; the combine adds each
    segment's partial rows in ascending item order, from zero.  Padding
    an item's rows with zero rows adds nothing."""
    ib = items.item_block.tolist()
    nrows = [(y - x) * block for x, y in zip(ib, ib[1:])]
    steps = max(-(-n // lanes) for n in nrows)
    rows = per_row.new_zeros((items.nitems, steps * lanes, per_row.shape[1]))
    for i, n in enumerate(nrows):
        rows[i, :n] = per_row[ib[i] * block:ib[i] * block + n]
    rows = rows.view(items.nitems, steps, lanes, -1)
    lane = torch.zeros_like(rows[:, 0])
    for k in range(steps):
        lane += rows[:, k]
    h = lanes // 2
    while h:
        lane[:, :h] += lane[:, h:2 * h]
        h //= 2
    ptr = items.item_ptr.tolist()
    out = per_row.new_zeros((nseg, per_row.shape[1]))
    for k in range(max(y - x for x, y in zip(ptr, ptr[1:]))):
        segs = [s for s in range(nseg) if ptr[s] + k < ptr[s + 1]]
        out[segs] += lane[[ptr[s] + k for s in segs], 0]
    return out


def _powers_of_two(rng, shape):
    """Values +-2**k, k in -2 .. 2.  A product with one is exact, so the
    kernel's fused multiply-add and PyTorch's multiply, then add, round
    each sum alike: the order of the sums alone decides the bits."""
    return (rng.choice([-1.0, 1.0], shape)
            * 2.0 ** rng.integers(-2, 3, shape))


def _ttmc_inputs(dev, dtype, R, S, nfib=20000, offset=0, xf_values=None):
    """K6's inputs on a skewed layout: 40 segments, a third of the fibers
    in segment 0, segment 1 pad rows alone, block 16; pad rows zero as
    ``ops.ttmc_fiber`` makes them.  ``offset`` elements move ``ug``'s
    base off 16 bytes."""
    rng = np.random.default_rng(13)
    nseg, block = 40, 16
    seg = np.sort(rng.integers(2, nseg, size=nfib))
    seg[: nfib // 3] = 0
    lay = padded_segment_layout(np.sort(seg), nseg, block)
    g = torch.from_numpy(lay.gather).long()
    m = torch.from_numpy(lay.mask).double()[:, None]
    ug = torch.from_numpy(rng.standard_normal((nfib, R)))[g] * m
    xf = torch.from_numpy(xf_values(rng, (nfib, S)) if xf_values else
                          rng.standard_normal((nfib, S)))[g] * m
    flat = torch.zeros(ug.numel() + offset, dtype=dtype, device=dev)
    flat[offset:] = ug.flatten().to(dev, dtype)
    ug = flat[offset:].view(ug.shape)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, nseg)).to(dev)
    return ug, xf.to(dev, dtype), ptr, nseg, block


K6_CASES = [
    pytest.param(16, 16, 20000, 0, paper.TTMC_OUTER, id="outer-16x16"),
    pytest.param(5, 7, 20000, 0, paper.TTMC_SCALAR, id="scalar-5x7"),
    pytest.param(128, 128, 3000, 0, paper.TTMC_OUTER,
                 id="outer-128x128-four-tiles"),
    pytest.param(16, 16, 20000, 1, paper.TTMC_SCALAR,
                 id="scalar-misaligned"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,S,nfib,offset,path", K6_CASES)
def test_ttmc_kernel_items_match_plain(cuda, dtype, R, S, nfib, offset,
                                       path):
    """K6 over work items on a skewed layout, on each of its paths (R = S
    = 128 spans four column tiles; a base off 16 bytes takes the scalar
    walk, not a refusal): items of three blocks (segment 0 spans dozens)
    and the wrapper's own cut, against its plain version; one launch of
    K6 and one of the combine a call, the same bits on a second call,
    and a zero row for a segment of pad rows."""
    ug, xf, ptr, nseg, block = _ttmc_inputs(cuda, dtype, R, S, nfib,
                                            offset)
    assert paper.ttmc_path(ug, xf) == path
    if R * S > 256 and path == paper.TTMC_OUTER:
        cols = paper.ttmc_columns(R, S, path)
        assert cols // native.column_threads(cols) == 4
    want = paper.ttmc_kernel_plain(ug, xf, ptr, nseg, block)
    small = ir.chain_items(ptr.cpu(), 3).to(cuda)
    assert int(small.item_ptr[1]) > 20
    for items in (small, None):
        native.reset_launch_counts()
        got = paper.ttmc_kernel(ug, xf, ptr, nseg, block, items=items)
        torch.cuda.synchronize()
        counts = native.launch_counts()
        assert counts["ttmc"] == 1 and counts["combine"] == 1
        _close(got, want, dtype)
        again = paper.ttmc_kernel(ug, xf, ptr, nseg, block, items=items)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert not bool(got[1].any())


@pytest.mark.parametrize("R,S,path", [(16, 16, paper.TTMC_OUTER),
                                      (5, 7, paper.TTMC_SCALAR)],
                         ids=["outer", "scalar"])
def test_ttmc_kernel_f64_bits_are_the_walk(cuda, R, S, path):
    """K6 in float64 gives, bit for bit, :func:`item_walk` of the same
    items with its path's row lanes (xf in powers of two, so that a
    fused multiply-add rounds as a multiply and an add do)."""
    ug, xf, ptr, nseg, block = _ttmc_inputs(
        cuda, torch.float64, R, S, xf_values=_powers_of_two)
    assert paper.ttmc_path(ug, xf) == path
    items = ir.chain_items(ptr.cpu(), 3)
    got = paper.ttmc_kernel(ug, xf, ptr, nseg, block, items=items.to(cuda))
    cols = paper.ttmc_columns(R, S, path)
    per_row = (ug[:, :, None] * xf[:, None, :]).reshape(ug.shape[0], -1)
    want = item_walk(per_row.cpu(), items, block,
                     256 // native.column_threads(cols), nseg)
    assert torch.equal(got.reshape(nseg, -1).cpu(), want)


def test_reduce_outer_f64_bits_are_the_walk(cuda):
    """K1's outer path (``Zd,Ze->de``, the walk K6 shares) in float64
    gives, bit for bit, :func:`item_walk` of the same items, its row
    weighted by the mask (B in powers of two, as above)."""
    ops_ = REDUCE_CASES[1].values[:3]
    st, tables, ptr, mask, padded = _skewed_reduce_call(
        *ops_, 40, 0, torch.float64, cuda)
    rng = np.random.default_rng(17)
    padded[1] = torch.from_numpy(_powers_of_two(
        rng, tuple(padded[1].shape))).to(cuda)
    assert stages.reduce_launch_path(st, padded) == stages.REDUCE_OUTER
    items = ir.chain_items(ptr.cpu(), 3)
    got = stages.run_reduce_stage(st, tables, ptr, mask, padded,
                                  torch.float64, items.to(cuda))
    a = mask.double()[:, None] * padded[0]
    per_row = (a[:, :, None] * padded[1][:, None, :]).reshape(a.shape[0],
                                                              -1)
    cols = stages.reduce_columns(st, stages.REDUCE_OUTER, 8)
    want = item_walk(per_row.cpu(), items, st.block,
                     256 // native.column_threads(cols), st.nseg)
    assert torch.equal(got.cpu(), want)


def test_ttmc_kernel_given_its_items_reads_nothing_back(cuda):
    """Given its items (as ``ops.ttmc_fiber`` passes them), K6's wrapper
    makes no device-to-host read: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    ug, xf, ptr, nseg, block = _ttmc_inputs(cuda, torch.float32, 16, 16)
    items = ir.reduce_items(ptr.cpu(), block).to(cuda)
    want = paper.ttmc_kernel(ug, xf, ptr, nseg, block, items=items)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = paper.ttmc_kernel(ug, xf, ptr, nseg, block, items=items)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("E,C,D,F", [
    pytest.param(2, 256, 512, 384, id="full-tiles"),
    pytest.param(3, 300, 203, 133, id="ragged"),
    pytest.param(2, 130, 36, 260, id="vector-edges"),
    pytest.param(2, 70, 0, 65, id="D=0")])
def test_grouped_matmul_f32_tiles_and_edges(cuda, E, C, D, F):
    """float32 on the CUDA cores: full 128 x 128 tiles over several
    16-deep steps, C, D and F that no tile, step or float4 divides (the
    scalar path; a tiny case is in the test above), ragged edges on the
    vector path, and D = 0 (zeros); one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, (E, C, D), torch.float32, cuda)
    w = _randn(gen, (E, D, F), torch.float32, cuda, max(D, 1) ** -0.5)
    native.reset_launch_counts()
    got = grouped_matmul.grouped_matmul_kernel(x, w)
    torch.cuda.synchronize()
    assert native.launch_counts()["grouped_matmul"] == 1
    _close(got, grouped_matmul.grouped_matmul_plain(x, w), torch.float32)
    if D == 0:
        assert not bool(got.any())


@pytest.mark.parametrize("offset", [1, 2, 3], ids=["4B", "8B", "12B"])
@pytest.mark.parametrize("operand", ["x", "w"])
def test_grouped_matmul_f32_misaligned_base_takes_the_scalar_path(
        cuda, operand, offset):
    """A base 4, 8 or 12 bytes off 16-byte alignment (widths that the
    vector path would take) runs the scalar path and agrees."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    E, C, D, F = 2, 140, 64, 136
    shapes = {"x": (E, C, D), "w": (E, D, F)}
    t = {}
    for name, shape in shapes.items():
        n = E * shape[1] * shape[2]
        off = offset if name == operand else 0
        flat = _randn(gen, (n + 4,), torch.float32, cuda, D ** -0.5)
        t[name] = flat[off:off + n].view(shape)
    assert t[operand].data_ptr() % 16 == 4 * offset
    got = grouped_matmul.grouped_matmul_kernel(t["x"], t["w"])
    torch.cuda.synchronize()
    _close(got, grouped_matmul.grouped_matmul_plain(t["x"], t["w"]),
           torch.float32)


@pytest.mark.parametrize("E,C,D,F", [(2, 256, 512, 384), (3, 300, 203, 133)])
def test_grouped_matmul_f32_is_bit_identical_call_to_call(cuda, E, C, D, F):
    """Each output is a sum from 0 in ascending d: two calls on the same
    inputs give the same bits, and each call is one launch."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = _randn(gen, (E, C, D), torch.float32, cuda)
    w = _randn(gen, (E, D, F), torch.float32, cuda, D ** -0.5)
    native.reset_launch_counts()
    first = grouped_matmul.grouped_matmul_kernel(x, w)
    assert native.launch_counts()["grouped_matmul"] == 1
    second = grouped_matmul.grouped_matmul_kernel(x, w)
    torch.cuda.synchronize()
    assert native.launch_counts()["grouped_matmul"] == 2
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


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
    # bf16's 128-row query tiles: T on both sides of one and two
    (1, 127, 64, 50), (2, 129, 128, 100), (1, 257, 256, 129),
    # windows on both sides of a 64-row key tile
    (2, 300, 64, 63), (2, 300, 64, 64), (1, 300, 128, 65),
    (1, 4100, 256, 2048),   # interior key tiles skip the mask
    # bf16 pads D to a multiple of 8; DMAX (64, 128, 256) not filled;
    # D = 160 leaves a 64-column box wholly past D (zeroed, never loaded)
    (2, 150, 8, 40), (2, 150, 36, 70), (1, 200, 96, 64), (1, 260, 200, 100),
    (1, 150, 160, 60),
    # heads no 16-byte row holds whole: float32 pads D to a multiple of 4
    (2, 150, 37, 70), (1, 70, 3, 10), (1, 130, 254, 65),
    (5, 140, 64, 30),       # BH = 5
])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_local_attn_kernel_matches_plain(cuda, BH, T, D, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(gen, (BH, T, D), dtype, cuda) for _ in range(3))
    native.reset_launch_counts()
    got = local_attn.local_attn_kernel(q, k, v, window)
    torch.cuda.synchronize()
    assert native.launch_counts()["local_attn"] == 1
    _close(got, local_attn.local_attn_plain(q, k, v, window), dtype)


@pytest.mark.parametrize("BH,T,D", [(2, 300, 64), (1, 200, 200),
                                    (3, 130, 36)])
def test_local_attn_bf16_window_one_is_v(cuda, BH, T, D):
    """With the diagonal only, each row's softmax is one 1 and the
    output is ``v`` bit for bit: a wrong V descriptor, fragment or
    epilogue shows as misplaced values."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (_randn(gen, (BH, T, D), torch.bfloat16, cuda)
               for _ in range(3))
    got = local_attn.local_attn_kernel(q, k, v, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, v)


@pytest.mark.parametrize("BH,T,D", [(2, 300, 64), (1, 200, 256),
                                    (3, 130, 37)])
def test_local_attn_f32_window_one_is_v(cuda, BH, T, D):
    """Float32 with the diagonal only: p is exp(0) = 1, l is 1 and every
    other key adds 0 * v, so the output is ``v`` bit for bit: a misplaced
    Q, K, P or V fragment or output column shows."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (_randn(gen, (BH, T, D), torch.float32, cuda)
               for _ in range(3))
    got = local_attn.local_attn_kernel(q, k, v, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, v)


def test_local_attn_f32_gives_the_same_bits_twice(cuda):
    """Float32 sums in ascending d and key order within a thread and over
    a row's lanes in a fixed tree: two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, (2, 1000, 256), torch.float32, cuda)
               for _ in range(3))
    first = local_attn.local_attn_kernel(q, k, v, 300)
    second = local_attn.local_attn_kernel(q, k, v, 300)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_local_attn_f32_misaligned_base_raises_or_pads(cuda):
    """Float32's 16-byte cp.async: a base pointer off 16 bytes raises;
    when D needs padding (a multiple of 4) the padded copy is aligned."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    BH, T, D = 2, 70, 64
    flat = _randn(gen, (BH * T * D + 1,), torch.float32, cuda)
    k, v = (_randn(gen, (BH, T, D), torch.float32, cuda) for _ in range(2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        local_attn.local_attn_kernel(flat[1:].view(BH, T, D), k, v, 20)
    q6 = flat[1:1 + BH * T * 62].view(BH, T, 62)   # D = 62: padded to 64
    k6, v6 = k[..., :62].contiguous(), v[..., :62].contiguous()
    got = local_attn.local_attn_kernel(q6, k6, v6, 20)
    torch.cuda.synchronize()
    _close(got, local_attn.local_attn_plain(q6, k6, v6, 20), torch.float32)


def test_local_attn_bf16_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, (2, 1000, 256), torch.bfloat16, cuda)
               for _ in range(3))
    first = local_attn.local_attn_kernel(q, k, v, 300)
    second = local_attn.local_attn_kernel(q, k, v, 300)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_local_attn_bf16_misaligned_base_raises_or_pads(cuda):
    """A base pointer off 16 bytes raises when the tensor goes to TMA as
    it is; when D needs padding the padded copy is aligned."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    BH, T, D = 2, 70, 64
    flat = _randn(gen, (BH * T * D + 1,), torch.bfloat16, cuda)
    q = flat[1:].view(BH, T, D)
    k, v = (_randn(gen, (BH, T, D), torch.bfloat16, cuda) for _ in range(2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        local_attn.local_attn_kernel(q, k, v, 20)
    q6 = flat[1:1 + BH * T * 60].view(BH, T, 60)   # D = 60: padded to 64
    k6, v6 = k[..., :60].contiguous(), v[..., :60].contiguous()
    got = local_attn.local_attn_kernel(q6, k6, v6, 20)
    torch.cuda.synchronize()
    _close(got, local_attn.local_attn_plain(q6, k6, v6, 20), torch.bfloat16)


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


def _edge_steps(L, edge):
    """A length at an edge of a ring of ``L``-step chunks."""
    return {"1": 1, "L-1": L - 1, "L+1": L + 1, "3L+5": 3 * L + 5}[edge]


EDGES = ["1", "L-1", "L+1", "3L+5"]


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("BH,K", [(1, 64), (2, 16), (2, 100)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_wkv6_kernel_at_the_ring_edges(cuda, BH, K, edge, dtype):
    """T at the edges of K10's two-stage ring of chunks: one step, a
    chunk short of full, one step into the second chunk, three turns."""
    T = _edge_steps(wkv6.chunk_steps(K), edge)
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = _wkv6_inputs(gen, BH, T, K, dtype, cuda)
    got = wkv6.wkv6_kernel(*args)
    torch.cuda.synchronize()
    _close(got, wkv6.wkv6_plain(*args), dtype)


@pytest.mark.parametrize("BH,T,K,offset", [
    (2, 37, 33, 0),     # odd T * K: no tile is 16-byte aligned
    (1, 33, 100, 0),    # T * K = 3300: aligned in float32 only
    (2, 40, 64, 1),     # a base one element off 16 bytes
])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_wkv6_kernel_on_unaligned_tiles(cuda, BH, T, K, offset, dtype):
    """Tiles that the TMA cannot copy (not 16-byte aligned) go through
    the register path of the same kernel."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    args = list(_wkv6_inputs(gen, BH, T, K, dtype, cuda))
    for i in range(4):
        flat = torch.empty(BH * T * K + offset, dtype=dtype, device=cuda)
        flat[offset:] = args[i].reshape(-1)
        args[i] = flat[offset:].view(BH, T, K)
    got = wkv6.wkv6_kernel(*args)
    torch.cuda.synchronize()
    _close(got, wkv6.wkv6_plain(*args), dtype)


@pytest.mark.parametrize("BH,T,K", [(4, 100, 64), (2, 53, 100)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_wkv6_kernel_is_bit_identical_run_to_run(cuda, BH, T, K, dtype):
    """The groups' partial sums are added in a fixed order, never by
    atomics: two runs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = _wkv6_inputs(gen, BH, T, K, dtype, cuda)
    first = wkv6.wkv6_kernel(*args)
    second = wkv6.wkv6_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _rglru_inputs(gen, B, T, D, dtype, dev):
    x = _randn(gen, (B, T, D), dtype, dev)
    a = (torch.rand((B, T, D), generator=gen, device=dev) * 0.93
         + 0.05).to(dtype)
    return x, a


@pytest.mark.parametrize("B,T,D", [(2, 1, 64), (3, 13, 300), (1, 70, 33)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_rglru_kernel_matches_plain(cuda, B, T, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, a = _rglru_inputs(gen, B, T, D, dtype, cuda)
    got = rglru.rglru_kernel(x, a)
    torch.cuda.synchronize()
    _close(got, rglru.rglru_plain(x, a), dtype)


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("D", [128, 200, 300])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_rglru_kernel_at_the_ring_edges(cuda, D, edge, dtype):
    """T at the edges of K11's ring of stages, on one full channel tile,
    on a ragged second tile (200) and on rows that are not 16-byte
    aligned in bf16 (300: plain loads into the ring)."""
    T = _edge_steps(rglru.stage_steps(dtype), edge)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, a = _rglru_inputs(gen, 2, T, D, dtype, cuda)
    got = rglru.rglru_kernel(x, a)
    torch.cuda.synchronize()
    _close(got, rglru.rglru_plain(x, a), dtype)


@pytest.mark.parametrize("B,T,D,offset", [(2, 70, 200, 0), (3, 37, 300, 0),
                                          (1, 53, 128, 1), (8, 64, 4096, 0)])
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_rglru_kernel_gives_the_plain_bits(cuda, B, T, D, offset, dtype):
    """Each channel is walked in order with every float32 operation
    rounded once, in the plain version's order (``a * a``, ``1 - .``,
    clip, ``sqrt``, ``* x``, then ``a * h`` and ``+ g``; no fma): the
    kernel gives the plain version's bits on the card, on the TMA ring
    and on the plain-load path (a base one element off)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x, a = _rglru_inputs(gen, B, T, D, dtype, cuda)
    if offset:
        x, a = (torch.empty(t.numel() + offset, dtype=dtype, device=cuda)
                [offset:].view_as(t).copy_(t) for t in (x, a))
    got = rglru.rglru_kernel(x, a)
    torch.cuda.synchronize()
    assert torch.equal(got, rglru.rglru_plain(x, a))


@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_rglru_kernel_gives_the_plain_bits_at_the_clip_edges(cuda, dtype):
    """Gates where ``1 - a²`` is 0, negative (clipped), 1, or as small as
    a float ``a`` below 1 makes it: the kernel's square root (no branch
    to a general path) still gives the plain version's bits."""
    edges = torch.tensor([0.0, 1.0, -1.0, 1.5, 1 - 2.0 ** -24, 1 - 2.0 ** -12,
                          0.999, 1e-20, -1e-20, 2.0 ** -24, 0.5, 0.70710678],
                         device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, T, D = 2, 40, 136
    a = edges[torch.randint(len(edges), (B, T, D), generator=gen,
                            device=cuda)].to(dtype)
    x = _randn(gen, (B, T, D), dtype, cuda)
    got = rglru.rglru_kernel(x, a)
    torch.cuda.synchronize()
    assert torch.equal(got, rglru.rglru_plain(x, a))


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


# --------------------------------------------------------------------------- #
# the model stack and its server on the card (no kernel of this package:
# the device-only faults of plain PyTorch on CUDA)
# --------------------------------------------------------------------------- #
def _model_pair(arch, cuda):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_map
    cfg = get_reduced(arch)
    cpu, _ = model_init(cfg, 0, device="cpu")
    return cfg, cpu, tree_map(lambda t: t.to(cuda), cpu)


def _model_close(got, want):
    """float32 logits: ``1e-4 * max(1, max|cpu|)`` (another summation
    order on the card)."""
    got, want = got.double().cpu(), want.double()
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


MODEL_ARCHS = ["recurrentgemma-9b", "olmo-1b", "gemma3-1b", "qwen1.5-32b",
               "smollm-135m", "rwkv6-3b", "granite-moe-1b-a400m",
               "deepseek-v2-236b", "seamless-m4t-large-v2",
               "phi-3-vision-4.2b"]


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_forward_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """``forward`` and prefill + ``decode_step`` (per-row positions, one
    past the cache's end: its write dropped) on the card against the
    same calls on the CPU, from the same params."""
    from repro_torch.configs import make_batch
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.transformer import _encode
    cfg, cpu, dev = _model_pair(arch, cuda)
    batch = make_batch(cfg, "train_4k", batch_override=2, seq_override=12,
                       device="cpu")
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    _model_close(forward(dev, cfg, on_card)[0], forward(cpu, cfg, batch)[0])
    outs = []
    for p, b in ((cpu, batch), (dev, on_card)):
        enc = _encode(p, cfg, b["enc_frames"]) if cfg.encdec else None
        last, caches = prefill(p, cfg, dict(b, tokens=b["tokens"][:, :11]),
                               cache_len=11)
        pos = torch.tensor([10, 11], device=b["tokens"].device)
        step, _ = decode_step(p, cfg, caches, b["tokens"][:, 11:], pos,
                              enc_out=enc)
        outs.append((last, step))
    torch.cuda.synchronize()
    for got, want in zip(outs[1], outs[0]):
        _model_close(got, want)


@pytest.mark.parametrize("arch", [a for a in MODEL_ARCHS
                                  if a != "seamless-m4t-large-v2"])
def test_server_on_the_card_serves_the_cpu_servers_requests(cuda, arch):
    """A server on the card finishes every request of mixed lengths, with
    ``cache_len`` at most the local window, and each token's logit on
    the CPU's forward is within tolerance of that row's maximum."""
    from repro_torch.models import forward
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import Request, Server
    cfg, cpu, dev = _model_pair(arch, cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=4) for n in (5, 9, 2)]
    srv = Server(cfg, dev, slots=2, cache_len=min(16, cfg.window or 16))
    for r in reqs:
        srv.submit(r)
    assert len(srv.run(max_steps=32)) == 3
    assert all(t.device.type == cuda.type for t in tree_leaves(srv.caches))
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        logits, _ = forward(cpu, cfg, {"tokens": torch.as_tensor(seq[None])})
        rows = logits[0, len(r.prompt) - 1:].double()
        gap = rows.max(-1).values - rows[torch.arange(4), r.out]
        assert float(gap.max()) <= 1e-4 * max(1.0,
                                              float(rows.abs().max()))


# --------------------------------------------------------------------------- #
# single-device training on the card (no kernel of this package either)
# --------------------------------------------------------------------------- #
def _train_pair(arch, cuda, dtype="float32"):
    from repro_torch.configs import get_reduced, make_batch
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_map
    from repro_torch.train import init_train_state
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    cpu, _ = model_init(cfg, 0, device="cpu")
    batch = make_batch(cfg, "train_4k", batch_override=2, seq_override=16,
                       device="cpu")
    return (cfg, init_train_state(cpu), batch,
            init_train_state(tree_map(lambda t: t.to(cuda), cpu)),
            {k: v.to(cuda) for k, v in batch.items()})


def _same_state_bits(a, b):
    from repro_torch.train.tree import key_paths
    for (k, x), (_, y) in zip(key_paths(a), key_paths(b)):
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("arch,k", [(a, 1) for a in MODEL_ARCHS]
                         + [("granite-moe-1b-a400m", 2),
                            ("smollm-135m", 2)])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, k):
    """One ``make_train_step`` step (float32, ``remat=False``) on the card
    against the CPU from the same state and batch: loss, lr and
    grad_norm within ``1e-5`` relative; ``m`` and ``v`` within ``2e-4 ·
    max|cpu| + 1e-7`` a leaf; params within ``2·lr₁ + 1e-6 · max|p|``
    (the first AdamW step moves a param by about ``lr·sign(g)``)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import key_paths
    cfg, cpu, batch, dev, on_card = _train_pair(arch, cuda)
    step = make_train_step(cfg, RunConfig(model=cfg, remat=False,
                                          microbatches=k))
    want, wm = step(cpu, batch)
    got, gm = step(dev, on_card)
    for name in ("loss", "lr", "grad_norm"):
        g, w = float(gm[name]), float(wm[name])
        assert abs(g - w) <= 1e-5 * abs(w), (name, g, w)
    lr1 = float(wm["lr"])
    for tree, bound in ((lambda s: s.opt.m, None), (lambda s: s.opt.v, None),
                        (lambda s: s.params, 2 * lr1)):
        for (key, a), (_, b) in zip(key_paths(tree(got)),
                                    key_paths(tree(want))):
            b = b.double()
            scale = float(b.abs().max()) if b.numel() else 0.0
            tol = (2e-4 * scale + 1e-7 if bound is None
                   else bound + 1e-6 * scale)
            err = float((a.cpu().double() - b).abs().max()) if b.numel() \
                else 0.0
            assert err <= tol, (key, err, tol)
    assert int(got.opt.step) == 1 and got.opt.step.device.type == "cuda"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "smollm-135m",
                                  "deepseek-v2-236b"])
def test_train_step_on_the_card_is_bit_identical_twice(cuda, arch):
    """The same step twice from the same state (bf16 params, remat, two
    microbatches): the same bits.  The backward has no atomics whose
    order could move a sum (the gold logit is a masked sum, not
    ``torch.gather``, whose backward scatter-adds)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import make_train_step
    cfg, _, _, dev, on_card = _train_pair(arch, cuda, "bfloat16")
    step = make_train_step(cfg, RunConfig(model=cfg, remat=True,
                                          microbatches=2))
    a, am = step(dev, on_card)
    b, bm = step(dev, on_card)
    _same_state_bits(a, b)
    for name in am:
        assert torch.equal(am[name], bm[name]), name


def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A bf16 training state on the card saved and restored into a fresh
    tree on the card: the same bits, dtypes and devices."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import checkpoint, make_train_step
    from repro_torch.train.tree import key_paths, map_with_keys
    cfg, _, _, dev, on_card = _train_pair("granite-moe-1b-a400m", cuda,
                                          "bfloat16")
    state, _ = make_train_step(cfg, RunConfig(model=cfg))(dev, on_card)
    checkpoint.save(state, str(tmp_path), step=1)
    fresh = map_with_keys(lambda _, t: torch.zeros_like(t), state)
    restored, at = checkpoint.restore(fresh, str(tmp_path))
    assert at == 1
    _same_state_bits(state, restored)
    assert {t.device.type for _, t in key_paths(restored)} == {"cuda"}
    assert restored.params["embed"]["w"].dtype == torch.bfloat16


def test_embed_lookup_backward_on_a_zipf_stream(cuda):
    """``embed_lookup``'s bf16 backward on a token stream that repeats a
    few ids thousands of times (``SyntheticLM``'s): the same bits twice,
    and each row within one bf16 ulp of its largest value of a float64
    sum (indexing's backward, which sums a row's repeats one after
    another, misses this by an order of magnitude)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models.layers import embed_lookup
    ids = SyntheticLM(4096, 1024, 4, device=cuda).batch_at(0)["tokens"]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    g = torch.randn(ids.shape + (256,), generator=gen, device=cuda).to(
        torch.bfloat16)
    w = torch.zeros((4096, 256), dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    (a,) = torch.autograd.grad(embed_lookup({"w": w}, ids), w, g)
    (b,) = torch.autograd.grad(embed_lookup({"w": w}, ids), w, g)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    exact = torch.zeros((4096, 256), dtype=torch.float64,
                        device=cuda).index_add_(0, ids.reshape(-1).long(),
                                                g.reshape(-1, 256).double())
    err = (a.double() - exact).abs().amax(-1)
    assert bool((err <= 2.0 ** -7 * exact.abs().amax(-1)).all())


def _sharded_rank(rank: int, world: int, outdir: str) -> None:
    """One of two gloo ranks on cuda:0: two sharded steps of reduced
    granite-moe-1b on a (2, 1) mesh; rank 0 writes the gathered state."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_reduced, make_batch
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.tree import key_paths, map_with_keys
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(1, "cuda")
        cfg = get_reduced("granite-moe-1b-a400m")
        params, specs = model_init(cfg, 0, device="cuda")
        rules = SH.default_rules(False, "train")
        state = init_train_state(SH.distribute_params(
            params, SH.tree_sharding(params, specs, rules, mesh)))
        batch = make_batch(cfg, "train_4k", batch_override=4,
                           seq_override=16, device="cuda")
        step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
        metrics = []
        with SH.mesh_context(mesh, rules):
            for _ in range(2):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        full = map_with_keys(lambda _, t: SH.gather_full(
            t.to_local(), SH.sharding_of(t)) if SH.is_dtensor(t) else t,
            state)
        if rank == 0:
            torch.save({"metrics": metrics,
                        "state": {k: t.cpu() for k, t in key_paths(full)}},
                       os.path.join(outdir, "sharded.pt"))
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_on_two_gloo_ranks_matches_one_device(cuda,
                                                                   tmp_path):
    """Two sharded steps (float32, remat) on two gloo ranks on the card
    against the same steps on one device: loss, lr and grad_norm within
    ``1e-5`` relative; ``m`` and ``v`` within ``2e-4 · max|want| + 1e-7``
    a leaf; params within ``2·Σlr + 1e-6 · max|p|``."""
    import os
    import time

    import torch.multiprocessing as mp

    from repro_torch.configs import get_reduced, make_batch
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.tree import key_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = mp.start_processes(_sharded_rank, args=(2, str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks hung"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    got = torch.load(os.path.join(tmp_path, "sharded.pt"))
    cfg = get_reduced("granite-moe-1b-a400m")
    params, _ = model_init(cfg, 0, device=cuda)
    batch = make_batch(cfg, "train_4k", batch_override=4, seq_override=16,
                       device=cuda)
    step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
    state, metrics = init_train_state(params), []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    for gm, wm in zip(got["metrics"], metrics):
        for name in ("loss", "lr", "grad_norm"):
            assert abs(gm[name] - wm[name]) <= 1e-5 * abs(wm[name]), name
    lr_sum = sum(m["lr"] for m in metrics)
    for key, want in key_paths(state):
        a, b = got["state"][key].double(), want.cpu().double()
        scale = float(b.abs().max()) if b.numel() else 0.0
        tol = (2 * lr_sum + 1e-6 * scale if key.startswith("0/")
               else 2e-4 * scale + 1e-7)
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= tol, (key, err, tol)


def test_plan_invariants_lane_executes_every_nest_on_the_card(cuda, capsys):
    """The verifier-versus-engines lane with its operands on the card:
    every enumerated nest runs through the ``cuda`` and ``cuda-splitk``
    engines' kernels against the dense oracle, and each of K1, K2, K4
    and the combine launches."""
    from repro_torch.analysis import plan_invariants
    native.reset_launch_counts()
    rc = plan_invariants.main(["--exec-budget", "72", "--device", "cuda"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "parity: 72 nests verified, 72 executed" in out
    assert "battery: 25 seeded plans" in out and "FAIL" not in out
    counts = native.launch_counts()
    assert all(counts[s] for s in ("reduce", "product", "splitk",
                                   "combine")), counts
