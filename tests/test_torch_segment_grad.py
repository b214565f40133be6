"""The gradient of the sorted segment sum (``kernels/segment.py``).

``segment_combine`` is an autograd function: its forward is the combine
(the kernel on CUDA, ``segment_combine_plain`` on the CPU), its backward
the adjoint gather.  Held here, on the CPU, to ``jax.grad`` through the
reference's ``"xla"`` engine on an MTTKRP plan (two segment sums;
float32, ``1e-5 * max|g|``), and to autograd of ``segment_combine_plain``
(``index_add_``, whose backward is the same gather: bit for bit), with
rows past ``ptr[-1]``, empty segments and zero rows.  The card's
gradient is held to the CPU's in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.sparse import build_csf as j_build_csf  # noqa: E402
from repro.sparse.coo import from_coords as j_from_coords  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.kernels.segment import (SegmentCombine,  # noqa: E402
                                         segment_combine,
                                         segment_combine_adjoint,
                                         segment_combine_plain)
from repro_torch.sparse import build_csf, random_sparse  # noqa: E402

SHAPE, R = (14, 11, 9), 6


def _mttkrp_case(seed):
    coo = random_sparse(SHAPE, 0.12, seed=seed, distribution="frostt")
    csf = build_csf(coo)
    rng = np.random.default_rng(seed)
    f = {"B": rng.standard_normal((SHAPE[1], R)).astype(np.float32),
         "C": rng.standard_normal((SHAPE[2], R)).astype(np.float32)}
    w = rng.standard_normal((SHAPE[0], R)).astype(np.float32)
    return coo, csf, f, w


def _port_grads(csf, f, w, monkeypatch=None, combine=None):
    """(dB, dC) of ``sum(MTTKRP(B, C) * w)`` through the ``torch`` engine
    on the CPU, and how many segment sums the plan ran."""
    spec = TS.mttkrp(*SHAPE, R)
    p = tplanner.plan(spec, nnz_levels=csf.nnz_levels())
    calls = []
    inner = combine or tex.segment_combine

    def counted(rows, ptr, nseg):
        calls.append(rows.shape)
        return inner(rows, ptr, nseg)

    monkeypatch.setattr(tex, "segment_combine", counted)
    fb = {k: torch.from_numpy(v).requires_grad_() for k, v in f.items()}
    out = tex.execute_plan(p, tex.CSFArrays.from_csf(csf, "cpu"), fb,
                           backend="torch")
    loss = (out * torch.from_numpy(w)).sum()
    gb, gc = torch.autograd.grad(loss, [fb["B"], fb["C"]])
    return gb.numpy(), gc.numpy(), len(calls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mttkrp_gradient_matches_jax_grad_through_xla(monkeypatch, seed):
    coo, csf, f, w = _mttkrp_case(seed)
    gb, gc, nsums = _port_grads(csf, f, w, monkeypatch)
    assert nsums == 2                       # a plan with two segment sums
    jspec = JS.mttkrp(*SHAPE, R)
    jcsf = j_build_csf(j_from_coords(coo.coords, coo.values, coo.shape))
    jp = jplanner.plan(jspec, nnz_levels=jcsf.nnz_levels())
    ex = jex.make_executor(jspec, jp.path, jp.order, backend="xla")
    arrays = jex.CSFArrays.from_csf(jcsf)

    def loss(B, C):
        return jnp.sum(ex(arrays, {"B": B, "C": C}) * jnp.asarray(w))

    jb, jc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f["B"]),
                                            jnp.asarray(f["C"]))
    for got, want in ((gb, np.asarray(jb)), (gc, np.asarray(jc))):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_mttkrp_gradient_equals_autograd_of_the_plain_combine(monkeypatch):
    _, csf, f, w = _mttkrp_case(0)
    got = _port_grads(csf, f, w, monkeypatch)
    monkeypatch.undo()
    want = _port_grads(csf, f, w, monkeypatch,
                       combine=segment_combine_plain)
    assert got[2] == want[2] == 2
    for g, h in zip(got[:2], want[:2]):
        assert np.array_equal(g, h)


CASES = [
    pytest.param([0, 3, 3, 7], 10, id="rows-past-ptr-end"),
    pytest.param([0, 2, 5, 9], 9, id="every-row-in-a-segment"),
    pytest.param([0, 0, 0], 0, id="zero-rows"),
    pytest.param([0, 0, 0], 4, id="every-row-past-ptr-end"),
    pytest.param([0], 3, id="no-segments"),
]


@pytest.mark.parametrize("ptr,nrows", CASES)
def test_backward_equals_autograd_of_the_plain_combine(ptr, nrows):
    ptr = torch.tensor(ptr)
    nseg = ptr.numel() - 1
    rows = torch.randn((nrows, 3), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(nrows),
                       requires_grad=True)
    out = segment_combine(rows, ptr, nseg)
    plain = segment_combine_plain(rows, ptr, nseg)
    assert torch.equal(out, plain)
    cot = torch.randn(out.shape, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(7))
    (got,) = torch.autograd.grad(out, rows, cot)
    if plain.requires_grad:
        (want,) = torch.autograd.grad(plain, rows, cot)
    else:                                   # no row reaches the output
        want = torch.zeros_like(rows)
    assert torch.equal(got, want)
    beyond = int(ptr[-1])
    assert not bool(got[beyond:].any())     # rows in no segment get zero


def test_adjoint_gives_each_row_its_segment_and_gradchecks():
    ptr = torch.tensor([0, 2, 2, 5])
    rows = torch.randn((7, 2), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda r: SegmentCombine.apply(r, ptr, 3), (rows,))
    g = torch.arange(6.0).reshape(3, 2)
    adj = segment_combine_adjoint(g, ptr, 7)
    want = torch.tensor([[0, 1], [0, 1], [4, 5], [4, 5], [4, 5], [0, 0],
                         [0, 0]], dtype=torch.float32)
    assert torch.equal(adj, want)
