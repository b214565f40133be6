"""Kernel-module parity: the port's stage kernels against the JAX ones.

On CPU tensors each Hopper kernel's wrapper runs its plain PyTorch
version; these tests hold that version to the JAX package's Pallas
kernel in interpret mode on the same padded inputs:

* K1 ``run_reduce_stage`` (segment loop) vs ``stages.run_reduce_stage``;
* K2 ``run_product_stage`` vs ``stages.run_product_stage``;
* K4 ``splitk_partials`` + ``segment_combine`` vs the JAX split-K pair.

They also check the index tables the CUDA kernels read: evaluated with
numpy exactly as the kernels walk them, they reproduce each stage's
einsum; and K2's tiling (rows a tile, table mode, shared bytes, chunk
swizzle), which the wrapper computes on the host.  Tolerance: float32 ``|port - ref| <= 1e-5 * max(1, max|ref|)``
(another summation order); float64 ``1e-12`` relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.codegen import ir as jir  # noqa: E402
from repro.kernels.codegen import lower_gpu as jgpu  # noqa: E402
from repro.kernels.codegen import stages as jst  # noqa: E402
from repro.kernels.util import padded_segment_layout  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.codegen import ir as tir  # noqa: E402
from repro_torch.kernels.codegen import lower_gpu as tgpu  # noqa: E402
from repro_torch.kernels.codegen import stages as tst  # noqa: E402
from repro_torch.kernels.segment import (segment_combine,  # noqa: E402
                                         segment_ptr)

# (operands as (subs, shape, fiber), out_subs, out_shape): every stage
# family the paper kernels emit, plus a broadcast operand and a
# contraction over two letters
REDUCE_STAGES = [
    pytest.param([("d", (5,), True), ("d", (5,), True)], "d", (5,),
                 id="Zd,Zd->d"),
    pytest.param([("", (), True), ("d", (6,), True)], "d", (6,),
                 id="Z,Zd->d"),
    pytest.param([("d", (3,), True), ("e", (4,), True)], "de", (3, 4),
                 id="Zd,Ze->de"),
    pytest.param([("de", (3, 4), True), ("e", (4,), False)], "d", (3,),
                 id="Zde,e->d"),
]
PRODUCT_STAGES = [
    pytest.param([("", (), True), ("d", (6,), True)], "d", (6,),
                 id="Z,Zd->Zd"),
    pytest.param([("d", (5,), True), ("d", (5,), True)], "", (),
                 id="Zd,Zd->Z"),
    pytest.param([("d", (3,), True), ("e", (4,), True)], "de", (3, 4),
                 id="Zd,Ze->Zde"),
    pytest.param([("e", (2,), True), ("fg", (3, 2), True)], "efg",
                 (2, 3, 2), id="Ze,Zfg->Zefg"),
    pytest.param([("k", (4,), True), ("kd", (4, 3), False)], "d", (3,),
                 id="Zk,kd->Zd"),
]
DTYPES = [pytest.param(np.float32, id="f32"),
          pytest.param(np.float64, id="f64")]


def _close(port, ref, dtype):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    rel = 1e-5 if dtype == np.float32 else 1e-12
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_array_less(np.abs(port - ref), rel * scale + 1e-300)


def _stages(ops, out_subs, out_shape, reduce_, block, nseg):
    jops = tuple(jir.StageOperand(s, sh, f) for s, sh, f in ops)
    tops = tuple(tir.StageOperand(s, sh, f) for s, sh, f in ops)
    js = jir.Stage(operands=jops, out_subs=out_subs, out_shape=out_shape,
                   reduce=reduce_, block=block, nseg=nseg, interpret=True)
    ts = tir.Stage(operands=tops, out_subs=out_subs, out_shape=out_shape,
                   reduce=reduce_, block=block, nseg=nseg)
    return js, ts


def _layout(rng, nfib=37, nseg=6, block=8):
    """A sorted segment map with a heavy segment, an empty-ish tail and
    single-fiber segments, padded to blocks."""
    seg = np.sort(rng.choice(nseg, size=nfib, p=[.5, .2, .1, .1, .05, .05]))
    seg[-1] = nseg - 1
    return padded_segment_layout(seg, nseg, block)


def _padded(rng, ops, lay, nfib, dtype):
    arrs = []
    for _, shape, fiber in ops:
        w = int(np.prod(shape))
        if fiber:
            fib = rng.standard_normal((nfib, w)).astype(dtype)
            arrs.append(fib[lay.gather])
        else:
            arrs.append(rng.standard_normal((1, w)).astype(dtype))
    return arrs


def _run_x64(dtype, fn):
    if dtype == np.float64:
        with jax.enable_x64(True):
            return np.asarray(fn())
    return np.asarray(fn())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape", REDUCE_STAGES)
def test_reduce_plain_matches_pallas_reduce(ops, out_subs, out_shape,
                                            dtype):
    rng = np.random.default_rng(0)
    nfib, block = 37, 8
    lay = _layout(rng, nfib, block=block)
    padded = _padded(rng, ops, lay, nfib, dtype)
    js, ts = _stages(ops, out_subs, out_shape, True, block, lay.nseg)
    ref = _run_x64(dtype, lambda: jst.run_reduce_stage(
        js, jnp.asarray(lay.block_seg), jnp.asarray(lay.block_first),
        jnp.asarray(lay.mask[:, None]), [jnp.asarray(a) for a in padded],
        padded[0].dtype))
    tables = tir.index_tables(ts, "cpu")
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    out = tst.run_reduce_stage(ts, tables, ptr, torch.from_numpy(lay.mask),
                               [torch.from_numpy(a) for a in padded],
                               torch.from_numpy(padded[0]).dtype)
    assert out.dtype == torch.from_numpy(padded[0]).dtype
    _close(out.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape", PRODUCT_STAGES)
def test_product_plain_matches_pallas_product(ops, out_subs, out_shape,
                                              dtype):
    rng = np.random.default_rng(1)
    nfib, block = 24, 8
    rows = [rng.standard_normal((nfib if f else 1, int(np.prod(sh))))
            .astype(dtype) for _, sh, f in ops]
    js, ts = _stages(ops, out_subs, out_shape, False, block, 0)
    ref = _run_x64(dtype, lambda: jst.run_product_stage(
        js, [jnp.asarray(a) for a in rows], rows[0].dtype))
    out = tst.run_product_stage(ts, tir.index_tables(ts, "cpu"),
                                [torch.from_numpy(a) for a in rows],
                                torch.from_numpy(rows[0]).dtype)
    _close(out.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ops,out_subs,out_shape", REDUCE_STAGES)
def test_splitk_and_combine_plain_match_pallas_splitk(ops, out_subs,
                                                      out_shape, dtype):
    rng = np.random.default_rng(2)
    nfib, block = 37, 8
    lay = _layout(rng, nfib, block=block)
    padded = _padded(rng, ops, lay, nfib, dtype)
    js, ts = _stages(ops, out_subs, out_shape, True, block, lay.nseg)

    def ref_pair():
        parts = jgpu.splitk_partials(js, jnp.asarray(lay.mask[:, None]),
                                     [jnp.asarray(a) for a in padded])
        return parts, jgpu.segment_combine(
            parts, jnp.asarray(lay.block_seg), lay.nseg)

    if dtype == np.float64:
        with jax.enable_x64(True):
            ref_parts, ref_out = (np.asarray(a) for a in ref_pair())
    else:
        ref_parts, ref_out = (np.asarray(a) for a in ref_pair())
    mask = torch.from_numpy(lay.mask)
    parts = tgpu.splitk_partials(ts, tir.index_tables(ts, "cpu"), mask,
                                 [torch.from_numpy(a) for a in padded])
    assert parts.numpy().dtype == ref_parts.dtype
    _close(parts.numpy(), ref_parts, dtype)
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    out = segment_combine(parts, ptr, lay.nseg)
    _close(out.numpy(), ref_out, dtype)


def test_segment_combine_adds_in_ascending_order_with_empty_segments():
    """The combine's plain version is a sorted segment sum: empty
    segments give exact zeros, and in float64 each row equals the
    left-to-right sum of its rows bit for bit."""
    rng = np.random.default_rng(3)
    seg = np.array([0, 0, 0, 2, 2, 5, 5, 5, 5])
    rows = rng.standard_normal((len(seg), 3)) * 10.0 ** rng.integers(
        -8, 8, size=(len(seg), 1))
    out = segment_combine(torch.from_numpy(rows),
                          torch.from_numpy(segment_ptr(seg, 7)), 7).numpy()
    for s in range(7):
        want = np.zeros(3)
        for r in rows[seg == s]:
            want = want + r
        np.testing.assert_array_equal(out[s], want)


@pytest.mark.parametrize("ops,out_subs,out_shape",
                         REDUCE_STAGES + PRODUCT_STAGES)
def test_index_tables_reproduce_the_einsum(ops, out_subs, out_shape):
    """Walk the CSR index table exactly as the CUDA kernels do —
    out[z, o] = sum_t A[z, a_idx[t]] * B[z, b_idx[t]] — and compare with
    the stage einsum (float64, so only reassociation differs)."""
    rng = np.random.default_rng(4)
    _, ts = _stages(ops, out_subs, out_shape, False, 8, 0)
    out_ptr, a_idx, b_idx = tir.index_table_arrays(ts)
    assert out_ptr.dtype == a_idx.dtype == b_idx.dtype == np.int32
    assert len(out_ptr) == ts.out_flat_dim + 1
    nz = 5
    rows = [rng.standard_normal((nz if f else 1, int(np.prod(sh))))
            for _, sh, f in ops]
    a = rows[0] if ops[0][2] else np.repeat(rows[0], nz, 0)
    b = rows[1] if ops[1][2] else np.repeat(rows[1], nz, 0)
    walked = np.zeros((nz, ts.out_flat_dim))
    for o in range(ts.out_flat_dim):
        for t in range(out_ptr[o], out_ptr[o + 1]):
            walked[:, o] += a[:, a_idx[t]] * b[:, b_idx[t]]
    vals = [r.reshape(((nz,) if f else ()) + sh)
            for r, (_, sh, f) in zip(rows, ops)]
    want = np.einsum(ts.expr, *vals).reshape(nz, -1)
    np.testing.assert_allclose(walked, want, rtol=1e-12, atol=1e-12)


# the stages whose K2 tiling is checked: the parity suite's, and the
# main path's at full width (MTTKRP / TTTP3 R = 64, TTMc3 S = 16)
TILED_STAGES = PRODUCT_STAGES + REDUCE_STAGES + [
    pytest.param([("", (), True), ("d", (64,), True)], "d", (64,),
                 id="Z,Zd->Zd-64"),
    pytest.param([("", (), True), ("e", (16,), True)], "e", (16,),
                 id="Z,Ze->Ze-16"),
    pytest.param([("d", (64,), True), ("d", (64,), True)], "", (),
                 id="Zd,Zd->Z-64"),
    pytest.param([("d", (3,), True), ("d", (3,), True)], "d", (3,),
                 id="Zd,Zd->Zd-3"),
    pytest.param([("k", (4,), True), ("kd", (4, 3000), False)], "d",
                 (3000,), id="Zk,kd->Zd-global-tables"),
]


def _tiling(ts, itemsize):
    return tst.product_tiling(ts, itemsize), tir.index_tables(ts, "cpu")


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("ops,out_subs,out_shape", TILED_STAGES)
def test_product_tiling_fits_shared_memory_and_keeps_alignment(
        ops, out_subs, out_shape, itemsize):
    """K2's tile: a multiple of 4 rows, so every operand tile and output
    tile starts and ends on 16 bytes; the shared bytes are the kernel's
    sum (``product_smem`` in ``csrc/stage_kernels.cu``) and fit the
    budget (or, for four rows that do not, the block's whole shared
    memory); the tables sit in shared memory exactly when they fit
    theirs."""
    _, ts = _stages(ops, out_subs, out_shape, False, 8, 0)
    t, tables = _tiling(ts, itemsize)
    assert t.rows % 4 == 0 and 4 <= t.rows <= tst.PRODUCT_MAX_ROWS
    widths = [op.flat_dim for op in ts.operands]
    for w, op in zip(widths, ts.operands):
        if op.fiber:
            assert t.rows * w * itemsize % 16 == 0
    assert t.rows * ts.out_flat_dim * itemsize % 16 == 0
    table_bytes = 4 * (ts.out_flat_dim + 1 + 2 * tables.a_idx.numel())
    assert t.smem_tables == (-(-table_bytes // 16) * 16
                             <= tst.PRODUCT_TABLE_SMEM)
    r16 = lambda n: -(-n // 16) * 16  # noqa: E731
    smem = sum(r16((2 * t.rows if op.fiber else 1) * w * itemsize)
               for w, op in zip(widths, ts.operands))
    smem += r16(t.rows * ts.out_flat_dim * itemsize)
    smem += r16(table_bytes) if t.smem_tables else 0
    assert t.smem == smem
    budget = tst.PRODUCT_SMEM if t.smem <= tst.PRODUCT_SMEM \
        else native.MAX_SHARED_BYTES
    assert t.smem <= budget
    if t.rows < tst.PRODUCT_MAX_ROWS:          # the most rows that fit
        per_row = itemsize * (ts.out_flat_dim + 2 * sum(
            w for w, op in zip(widths, ts.operands) if op.fiber))
        assert t.smem + 4 * per_row > budget


def test_product_tiling_raises_when_four_rows_do_not_fit():
    _, ts = _stages([("d", (128,), True), ("e", (128,), True)], "de",
                    (128, 128), False, 8, 0)
    with pytest.raises(ValueError, match="do not fit"):
        tst.product_tiling(ts, 4)


@pytest.mark.parametrize("ops,out_subs,out_shape,itemsize,want", [
    ([("d", (64,), True), ("d", (64,), True)], "", (), 4, True),
    ([("d", (64,), True), ("d", (64,), True)], "", (), 8, True),
    ([("d", (6,), True), ("d", (6,), True)], "", (), 4, False),
    ([("d", (6,), True), ("d", (6,), True)], "", (), 8, True),
    ([("de", (3, 8), True), ("e", (8,), False)], "d", (3,), 4, True),
    ([("", (), True), ("d", (64,), True)], "d", (64,), 4, False),
    ([("d", (4,), True), ("e", (4,), True)], "de", (4, 4), 4, False),
    ([("k", (4,), True), ("kd", (4, 3), False)], "d", (3,), 4, False),
])
def test_term_chunks_marks_runs_of_whole_chunks(ops, out_subs, out_shape,
                                                itemsize, want):
    """K2 reads terms a 16-byte chunk at a time only where every output's
    terms are runs of one whole chunk of both operands, in table order,
    and every fiber row is whole chunks."""
    _, ts = _stages(ops, out_subs, out_shape, False, 8, 0)
    assert tst.term_chunks(ts, itemsize) is want
    assert tst.product_tiling(ts, itemsize).chunks is want


@pytest.mark.parametrize("width,itemsize,mask", [
    (64, 4, 7), (16, 4, 3), (3, 4, 0), (6, 4, 0), (8, 4, 1), (24, 4, 1),
    (64, 8, 7), (2, 8, 0), (1, 4, 0)])
def test_chunk_swizzle_stays_inside_the_row(width, itemsize, mask):
    """The XOR mask permutes whole 16-byte chunks within a row: every
    element of every row maps to a distinct slot of that row."""
    assert tst.chunk_swizzle(width, itemsize) == mask
    v = 16 // itemsize
    for r in range(16):
        cols = np.arange(width)
        slot = ((cols // v) ^ (r & mask)) * v + cols % v if mask else cols
        assert sorted(slot) == list(range(width))


@pytest.mark.parametrize("ops,out_subs,out_shape", PRODUCT_STAGES)
def test_product_tile_walk_reproduces_the_einsum(ops, out_subs, out_shape):
    """A Python walk of K2 as the kernel runs it: tiles of ``rows`` fiber
    rows staged through the chunk swizzle, each output element the
    table-order sum of its terms read back through the same index; it
    reproduces the stage's einsum with a ragged last tile."""
    _, ts = _stages(ops, out_subs, out_shape, False, 8, 0)
    t, tables = _tiling(ts, 8)
    rng = np.random.default_rng(9)
    nrows = t.rows * 2 + 3
    rows = [rng.standard_normal((nrows if f else 1, int(np.prod(sh))))
            for _, sh, f in ops]
    ptr, ai, bi = (x.numpy() for x in (tables.out_ptr, tables.a_idx,
                                       tables.b_idx))
    v = 2                                      # float64: 2 a chunk

    def slot(r, col, w, swz):
        return r * w + (((col // v) ^ (r & swz)) * v + col % v
                        if swz else col)

    out = np.zeros((nrows, ts.out_flat_dim))
    for r0 in range(0, nrows, t.rows):
        n = min(t.rows, nrows - r0)
        staged = []
        for x, op, swz in zip(rows, ts.operands, t.swizzle):
            w = op.flat_dim
            buf = np.full(t.rows * w if op.fiber else w, np.nan)
            for e in range(n * w if op.fiber else w):
                r, c = divmod(e, w)
                buf[slot(r, c, w, swz)] = (x[r0:r0 + n] if op.fiber
                                           else x).reshape(-1)[e]
            staged.append(buf)
        for i in range(n * ts.out_flat_dim):
            r, o = divmod(i, ts.out_flat_dim)
            ra, rb = (r if op.fiber else 0 for op in ts.operands)
            (wa, wb), (sa, sb) = ([op.flat_dim for op in ts.operands],
                                  t.swizzle)
            out[r0 + r, o] = sum(
                staged[0][slot(ra, ai[k], wa, sa)]
                * staged[1][slot(rb, bi[k], wb, sb)]
                for k in range(ptr[o], ptr[o + 1]))
    vals = [x.reshape(((nrows,) if f else ()) + sh)
            for x, (_, sh, f) in zip(rows, ops)]
    want = np.einsum(ts.expr, *vals).reshape(nrows, -1)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_launch_a_kernel():
    """The CPU path runs the plain versions; no launch counter moves."""
    native.reset_launch_counts()
    rng = np.random.default_rng(5)
    ops = [("d", (4,), True), ("d", (4,), True)]
    lay = _layout(rng)
    padded = [torch.from_numpy(a) for a in
              _padded(rng, ops, lay, 37, np.float32)]
    _, ts = _stages(ops, "d", (4,), True, 8, lay.nseg)
    tables = tir.index_tables(ts, "cpu")
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    mask = torch.from_numpy(lay.mask)
    tst.run_reduce_stage(ts, tables, ptr, mask, padded, torch.float32)
    tgpu.splitk_partials(ts, tables, mask, padded)
    _, tp = _stages(ops, "", (), False, 8, 0)
    tst.run_product_stage(tp, tir.index_tables(tp, "cpu"), padded,
                          torch.float32)
    assert native.launch_counts() == {s: 0 for s in native.KERNELS}
