"""IR parity: the port's code generator emits the reference's stage IR.

For the four paper kernels at the sizes of ``test_backend_matrix.py``,
with ``block=8`` and each reduction strategy, the port's
``StagePlanExecutor.emitted_ir`` equals the reference
``PallasPlanExecutor(interpret=True).emitted_ir`` field by field (kind,
expr, operands, out_subs, out_shape, reduce, block, nseg, links,
nseg_out, nseg_lvls), for both Hopper targets, and the per-stage
strategy choices agree.  With the IR equal, a value disagreement between
the two packages is a lowering bug, never a construction bug.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.kernels.codegen import PallasPlanExecutor  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.kernels.codegen import StagePlanExecutor  # noqa: E402
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402

# the four paper kernels at the sizes test_backend_matrix.py uses
KERNELS = {"mttkrp": ((6, 7, 8, 4), 0.3), "ttmc": ((6, 7, 8, 4, 3), 0.3),
           "tttp": ((6, 7, 8, 4), 0.3), "tttc": ((4, 3), 0.02)}
BUILDERS = {"mttkrp": "mttkrp", "ttmc": "ttmc3", "tttp": "tttp3",
            "tttc": "tttc6"}
STRATEGIES = ("row", "segsum", "auto")


@functools.cache
def _case(kernel):
    args, density = KERNELS[kernel]
    jspec = getattr(JS, BUILDERS[kernel])(*args)
    tspec = getattr(TS, BUILDERS[kernel])(*args)
    shape = tuple(jspec.dims[i] for i in jspec.sparse_indices)
    jc = j_build_csf(j_random_sparse(shape, density, seed=3))
    tc = build_csf(random_sparse(shape, density, seed=3))
    rng = np.random.default_rng(1)
    factors = {t.name: rng.standard_normal(
        [jspec.dims[i] for i in t.indices]).astype(np.float32)
        for t in jspec.inputs if not t.is_sparse}
    return (jspec, tspec, jc, tc, factors,
            jplanner.plan(jspec, nnz_levels=jc.nnz_levels()),
            tplanner.plan(tspec, nnz_levels=tc.nnz_levels()))


@functools.cache
def _reference_ir(kernel, strategy, block=8, tile_align=False):
    jspec, _, jc, _, factors, jp, _ = _case(kernel)
    ex = PallasPlanExecutor(jspec, jp.path, jp.order, block=block,
                            interpret=True, strategy=strategy,
                            tile_align=tile_align)
    ex(jex.CSFArrays.from_csf(jc), factors)
    return list(ex.emitted_ir), dict(ex.stage_strategy)


def _fields(ir):
    st = ir.stage
    return {
        "kind": ir.kind, "expr": st.expr,
        "operands": [(op.subs, op.shape, op.fiber) for op in st.operands],
        "out_subs": st.out_subs, "out_shape": st.out_shape,
        "reduce": st.reduce, "block": st.block, "nseg": st.nseg,
        "tile": st.tile,
        "links": [([(op.subs, op.shape, op.fiber) for op in ln.operands],
                   ln.out_subs, ln.out_shape) for ln in ir.links],
        "nseg_out": ir.nseg_out, "nseg_lvls": ir.nseg_lvls,
    }


@pytest.mark.parametrize("target", ["hopper", "hopper-splitk"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_emitted_ir_equals_reference(kernel, strategy, target):
    _, tspec, _, tc, factors, _, tp = _case(kernel)
    ref_ir, ref_strategy = _reference_ir(kernel, strategy)
    ex = StagePlanExecutor(tspec, tp.path, tp.order, block=8,
                           strategy=strategy, target=target)
    ex(tex.CSFArrays.from_csf(tc, device="cpu"), factors)
    assert ex.emitted_ir, "executor recorded no stage IR"
    assert [_fields(ir) for ir in ex.emitted_ir] == \
        [_fields(ir) for ir in ref_ir]
    assert ex.stage_strategy == ref_strategy
    assert [ir.stage for ir in ex.emitted_ir] == ex.emitted_stages


def test_tile_aligned_ir_equals_reference():
    """``tile_align`` rounds the block up to the TPU sublane and marks
    the stages tiled, exactly as the reference's compiled-mode IR."""
    _, tspec, _, tc, factors, _, tp = _case("mttkrp")
    ref_ir, _ = _reference_ir("mttkrp", "auto", block=6, tile_align=True)
    ex = StagePlanExecutor(tspec, tp.path, tp.order, block=6,
                           tile_align=True)
    ex(tex.CSFArrays.from_csf(tc, device="cpu"), factors)
    assert ex.block == 8
    assert [_fields(ir) for ir in ex.emitted_ir] == \
        [_fields(ir) for ir in ref_ir]


def test_segment_profile_matches_reference():
    from repro.kernels.codegen import segment_profile as j_profile
    from repro_torch.kernels.codegen import segment_profile as t_profile
    _, _, jc, tc, _, _, _ = _case("mttkrp")
    ja = jex.CSFArrays.from_csf(jc)
    ta = tex.CSFArrays.from_csf(tc, device="cpu")
    for lvl, out_lvl in ((3, 2), (3, 1), (2, 1), (3, 0), (1, 0)):
        assert j_profile(ja, lvl, out_lvl).__dict__ == \
            t_profile(ta, lvl, out_lvl).__dict__
