"""The port's CUDA kernels on the card: each against its plain version.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` at first use), so they carry the ``cuda``
marker and skip elsewhere.  They import neither JAX nor the JAX package,
so they run where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 ``1e-5 * max(1, max|plain|)`` (the kernel sums in
another order than ``torch.einsum``); float64 ``1e-12`` relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import spec as S  # noqa: E402
from repro_torch.core.executor import (CSFArrays,  # noqa: E402
                                       execute_plan, reference_execute)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
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
]
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.float64, id="f64")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * scale, (err, rel * scale)


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
    assert native.launch_counts() == {"reduce": 1, "product": 0,
                                      "splitk": 1, "combine": 1}
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
    got = stages.run_product_stage(st, ir.index_tables(st, cuda), rows,
                                   dtype)
    torch.cuda.synchronize()
    _close(got, stages.run_product_stage_plain(st, rows, dtype), dtype)


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
