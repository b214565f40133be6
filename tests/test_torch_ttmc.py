"""K6, the TTMc fiber stage, over K1's work items: its host side on the
CPU.

* K6's items, as ``ops.ttmc_fiber`` hands them to the kernel wrapper,
  are ``chain_items`` of the host block offsets at K1's cap
  ``max(1, REDUCE_ITEM_ROWS // block)``, cut from a CPU tensor: every
  block once, in order, none crossing a segment;
* the path picker (``paper.ttmc_path``) sends R and S multiples of 4 on
  16-byte bases to the register blocks and anything else to the scalar
  walk;
* a Python walk of the kernel's algorithm (work items, row lanes of the
  path's geometry walking their rows in ascending order, a fixed tree
  over the lanes, the partial rows added per segment in item order;
  ``test_torch_cuda.item_walk``, which the card tests hold the kernel to
  bit for bit in float64) gives the JAX package's ``ops.ttmc_fiber`` in
  interpret mode, on a skewed layout at caps 1 and 2.

Tolerance: float32 ``1e-5 * max(1, max|ref|)`` (another summation
order), float64 ``1e-12`` relative (under ``jax.enable_x64``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.util import (  # noqa: E402
    padded_segment_layout as j_padded_segment_layout)
from repro_torch.kernels import native, ops, paper  # noqa: E402
from repro_torch.kernels.codegen import ir  # noqa: E402
from repro_torch.kernels.codegen.ir import (REDUCE_ITEM_ROWS,  # noqa: E402
                                            chain_items)
from repro_torch.kernels.segment import segment_ptr  # noqa: E402
from repro_torch.kernels.util import padded_segment_layout  # noqa: E402
from test_torch_cuda import item_walk  # noqa: E402


def _skewed_segments(rng, nfib, nseg):
    """Sorted segment ids: segment 0 holds a third of the fibers, segment
    1 none (one block of pad rows)."""
    seg = np.sort(rng.integers(2, nseg, size=nfib))
    seg[: nfib // 3] = 0
    return np.sort(seg)


@pytest.mark.parametrize("block", [1, 8, 128, 4096])
def test_ttmc_fiber_items_are_chain_items_of_the_host_offsets(monkeypatch,
                                                              block):
    """``ops.ttmc_fiber`` cuts K6's items on the host, from a CPU copy of
    the block offsets, at K1's cap, and hands them to the kernel wrapper:
    every block once and in order, no item across a segment, one item
    for a segment of pad rows alone."""
    nfib, nseg = 20000, 12
    lay = padded_segment_layout(
        _skewed_segments(np.random.default_rng(3), nfib, nseg), nseg, block)
    cut, handed = [], []
    real_cut, real_kernel = ir.chain_items, paper.ttmc_kernel

    def chain(block_ptr, cap=None):
        assert block_ptr.device.type == "cpu"
        cut.append(cap)
        return real_cut(block_ptr, cap)

    def kernel(*args, items=None):
        handed.append(items)
        return real_kernel(*args, items=items)

    monkeypatch.setattr(ir, "chain_items", chain)
    monkeypatch.setattr(paper, "ttmc_kernel", kernel)
    out = ops.ttmc_fiber(torch.ones(nfib, 2), torch.ones(nfib, 3), lay)
    assert tuple(out.shape) == (nseg, 2, 3)
    cap = max(1, REDUCE_ITEM_ROWS // block)
    assert cut == [cap] and len(handed) == 1
    items = handed[0]
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    want = real_cut(ptr, cap)
    assert items.cap == cap
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_ttmc_path_needs_whole_register_blocks_and_aligned_bases(dtype):
    """R and S multiples of 4 on 16-byte bases take the 4 x 4 register
    blocks, anything else the scalar walk; a row lane spans one thread a
    register block or an output."""
    def rows(n, w, offset=0):
        return torch.zeros(n * w + offset, dtype=dtype)[offset:].view(n, w)

    assert paper.ttmc_path(rows(8, 16), rows(8, 16)) == paper.TTMC_OUTER
    assert paper.ttmc_path(rows(8, 4), rows(8, 128)) == paper.TTMC_OUTER
    assert paper.ttmc_path(rows(8, 5), rows(8, 8)) == paper.TTMC_SCALAR
    assert paper.ttmc_path(rows(8, 8), rows(8, 6)) == paper.TTMC_SCALAR
    assert paper.ttmc_path(rows(8, 16, 1), rows(8, 16)) == \
        paper.TTMC_SCALAR
    assert paper.ttmc_path(rows(8, 16), rows(8, 16, 1)) == \
        paper.TTMC_SCALAR
    assert paper.ttmc_columns(16, 16, paper.TTMC_OUTER) == 16
    assert paper.ttmc_columns(128, 128, paper.TTMC_OUTER) == 1024
    assert paper.ttmc_columns(5, 7, paper.TTMC_SCALAR) == 35


def _walk(ug, xf, lay, cap):
    """K6's algorithm on the port's padded, masked rows."""
    g = torch.from_numpy(lay.gather).long()
    m = torch.from_numpy(lay.mask).to(ug.dtype)[:, None]
    ugp, xfp = ug[g] * m, xf[g] * m
    ptr = torch.from_numpy(segment_ptr(lay.block_seg, lay.nseg))
    items = chain_items(ptr, cap)
    assert int(items.item_ptr[1]) > 1         # segment 0 spans items
    R, S = ug.shape[1], xf.shape[1]
    cols = paper.ttmc_columns(R, S, paper.ttmc_path(ugp, xfp))
    per_row = (ugp[:, :, None] * xfp[:, None, :]).reshape(ugp.shape[0], -1)
    out = item_walk(per_row, items, lay.block,
                    256 // native.column_threads(cols), lay.nseg)
    return out.reshape(lay.nseg, R, S)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("R,S,nfib", [(4, 4, 150), (16, 16, 150),
                                      (5, 7, 150), (128, 128, 60)],
                         ids=["4x4", "16x16", "5x7-scalar", "128x128"])
def test_ttmc_item_walk_matches_reference(R, S, nfib, cap, dtype):
    """The walk of K6's items, lanes and tree, with items of at most
    ``cap`` blocks of 8 rows (segment 0 spans several; segment 1 is pad
    rows alone), gives the reference's ``ops.ttmc_fiber`` with its Pallas
    kernel in interpret mode on the same inputs, and a zero row for the
    pad rows."""
    rng = np.random.default_rng(5)
    nseg, block = 6, 8
    seg = _skewed_segments(rng, nfib, nseg)
    lay = padded_segment_layout(seg, nseg, block)
    jlay = j_padded_segment_layout(seg, nseg, block)
    np.testing.assert_array_equal(lay.gather, jlay.gather)
    ug = rng.standard_normal((nfib, R)).astype(dtype)
    xf = rng.standard_normal((nfib, S)).astype(dtype)
    got = _walk(torch.from_numpy(ug), torch.from_numpy(xf), lay, cap)

    def ref():
        return np.asarray(jops.ttmc_fiber(
            jnp.asarray(ug), jnp.asarray(xf), jlay, use_pallas=True,
            interpret=True))

    if dtype == np.float64:
        with jax.enable_x64(True):
            want = ref()
    else:
        want = ref()
    assert want.dtype == dtype
    got = got.numpy().astype(np.float64)
    want = want.astype(np.float64)
    assert got.shape == want.shape == (nseg, R, S)
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())
    assert not got[1].any()
