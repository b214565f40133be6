"""Kernel-module parity: the port's stage kernels against the JAX ones.

On CPU tensors each Hopper kernel's wrapper runs its plain PyTorch
version; these tests hold that version to the JAX package's Pallas
kernel in interpret mode on the same padded inputs:

* K1 ``run_reduce_stage`` (segment loop) vs ``stages.run_reduce_stage``;
* K2 ``run_product_stage`` vs ``stages.run_product_stage``;
* K4 ``splitk_partials`` + ``segment_combine`` vs the JAX split-K pair.

They also check the index tables the CUDA kernels read: evaluated with
numpy exactly as the kernels walk them, they reproduce each stage's
einsum.  Tolerance: float32 ``|port - ref| <= 1e-5 * max(1, max|ref|)``
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
