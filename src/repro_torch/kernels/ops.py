"""Drivers for the paper kernels K5-K7, with their static layouts, and
for the LM kernels K8-K11.

The counterpart of the JAX package's ``src/repro/kernels/ops.py``: the
layouts are computed once per sparsity pattern from the host CSF, the
factor rows are gathered by PyTorch straight into the padded layout (as
XLA gathers them there), and the kernel wrappers of
:mod:`repro_torch.kernels.paper` do the rest — the CUDA kernel on CUDA
tensors, the plain version on CPU tensors.  The device is the factors'.
``use_kernel=False`` computes the oracle of
:mod:`repro_torch.kernels.ref` on the unpadded rows instead (the JAX
package's ``use_pallas=False``).

The LM drivers mirror the JAX module's passthroughs
(``src/repro/kernels/ops.py:128-167``): ``(B, T, H, K)`` operands fold
to ``(B*H, T, K)`` for the kernel and back, ``u`` is broadcast per
batch, and ``use_kernel=False`` computes the oracle on the unfolded
operands.  Tile and chunk sizes are the kernels' own, so these drivers
take none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import grouped_matmul as gmm_k
from repro_torch.kernels import local_attn as attn_k
from repro_torch.kernels import paper, ref
from repro_torch.kernels import rglru as rglru_k
from repro_torch.kernels import wkv6 as wkv6_k
from repro_torch.kernels.codegen.ir import ChainItems, reduce_items
from repro_torch.kernels.segment import segment_ptr
from repro_torch.kernels.util import PaddedSegments, padded_segment_layout
from repro_torch.sparse.csf import CSFTensor, level_segments


# --------------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------------- #
def mttkrp_layout(csf: CSFTensor, block: int = 256) -> PaddedSegments:
    """Pad nonzeros per output row (mode-0 slice) to block multiples."""
    seg1 = level_segments(csf, csf.order, 1)
    return padded_segment_layout(seg1, csf.nfib[1], block)


def ttmc_fiber_layout(csf: CSFTensor, block: int = 128) -> PaddedSegments:
    """Pad level-2 fibers per output row to block multiples."""
    seg = level_segments(csf, 2, 1)
    return padded_segment_layout(seg, csf.nfib[1], block)


def layout_arrays(layout: PaddedSegments, device):
    """A layout's gather (int64), mask (float32) and block offsets
    (int64, ``nseg + 1``) on ``device``."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (up(layout.gather.astype(np.int64)), up(layout.mask),
            up(segment_ptr(layout.block_seg, layout.nseg)))


def _leaf(csf: CSFTensor, device):
    fc = torch.from_numpy(csf.fiber_coords(csf.order).astype(np.int64))
    return fc.to(device), torch.from_numpy(csf.values).to(device)


# --------------------------------------------------------------------------- #
# MTTKRP:  A(i,a) = sum_jk T(i,j,k) B(j,a) C(k,a)
# --------------------------------------------------------------------------- #
def mttkrp(csf: CSFTensor, b: torch.Tensor, c: torch.Tensor,
           layout: PaddedSegments | None = None, block: int = 256,
           use_kernel: bool = True) -> torch.Tensor:
    """The order-3 MTTKRP leaf: gathers, then K5 ``(nfib_1, R)``."""
    fc, vals = _leaf(csf, b.device)
    jidx, kidx = fc[:, 1], fc[:, 2]
    if not use_kernel:
        seg1 = torch.from_numpy(level_segments(csf, csf.order, 1))
        return ref.mttkrp_ref(vals, b[jidx], c[kidx], seg1.to(b.device),
                              csf.nfib[1])
    layout = layout or mttkrp_layout(csf, block)
    gather, mask, block_ptr = layout_arrays(layout, b.device)
    return paper.mttkrp_kernel(vals[gather], b[jidx[gather]],
                               c[kidx[gather]], mask, block_ptr,
                               layout.nseg, layout.block)


# --------------------------------------------------------------------------- #
# TTMc fiber stage:  OUT[i] += U[j_f]^T ⊗ X[f]   over level-2 fibers f
# --------------------------------------------------------------------------- #
def ttmc_fiber_items(layout: PaddedSegments) -> ChainItems:
    """K6's work items (K1's cut,
    :func:`~repro_torch.kernels.codegen.ir.reduce_items`), cut on the host
    from the layout's block offsets."""
    ptr = torch.from_numpy(segment_ptr(layout.block_seg, layout.nseg))
    return reduce_items(ptr, layout.block)


def ttmc_fiber(ug: torch.Tensor, xf: torch.Tensor, layout: PaddedSegments,
               use_kernel: bool = True) -> torch.Tensor:
    """``ug`` ``(nfib_2, R)`` gathered U rows, ``xf`` ``(nfib_2, S)`` fiber
    intermediates -> K6 ``(nseg, R, S)``, over work items cut once per
    call on the host (as the reference builds its layout arrays per
    call)."""
    gather, mask, block_ptr = layout_arrays(layout, ug.device)
    m = mask[:, None]
    if not use_kernel:
        seg = torch.from_numpy(np.repeat(layout.block_seg, layout.block))
        return ref.ttmc_fiber_ref(xf[gather] * m, ug[gather],
                                  seg.to(ug.device), layout.nseg)
    items = ttmc_fiber_items(layout).to(ug.device)
    return paper.ttmc_kernel(ug[gather] * m, xf[gather] * m, block_ptr,
                             layout.nseg, layout.block, items=items)


# --------------------------------------------------------------------------- #
# TTTP leaf:  out[n] = vals[n] * sum_r U[i,r] V[j,r] W[k,r]
# --------------------------------------------------------------------------- #
def tttp(csf: CSFTensor, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         block: int = 512, use_kernel: bool = True) -> torch.Tensor:
    """The order-3 TTTP leaf: gathers, then K7 ``(nnz,)``."""
    fc, vals = _leaf(csf, u.device)
    ug, vg, wg = u[fc[:, 0]], v[fc[:, 1]], w[fc[:, 2]]
    if not use_kernel:
        return ref.tttp_ref(vals, ug, vg, wg)
    return paper.tttp_kernel(vals, ug, vg, wg, block=block)


# --------------------------------------------------------------------------- #
# the LM kernels
# --------------------------------------------------------------------------- #
def _fold(t: torch.Tensor) -> torch.Tensor:
    """(B, T, H, K) -> (B*H, T, K), contiguous."""
    B, T, H, K = t.shape
    return t.transpose(1, 2).reshape(B * H, T, K).contiguous()


def _unfold(t: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """(B*H, T, K) -> (B, T, H, K)."""
    _, T, K = t.shape
    return t.reshape(B, H, T, K).transpose(1, 2)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """x ``(E, C, D)`` @ w ``(E, D, F)`` -> ``(E, C, F)`` in x's dtype (K8)."""
    if not use_kernel:
        return ref.grouped_matmul_ref(x, w)
    return gmm_k.grouped_matmul_kernel(x.contiguous(), w.contiguous())


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         use_kernel: bool = True) -> torch.Tensor:
    """RWKV6 WKV, r/k/v/w ``(B, T, H, K)``, u ``(H, K)`` -> ``(B, T, H, K)``
    (K10)."""
    if not use_kernel:
        return ref.wkv6_ref(r, k, v, w, u)
    B, T, H, K = r.shape
    uu = u.expand(B, H, K).reshape(B * H, K).contiguous()
    out = wkv6_k.wkv6_kernel(*map(_fold, (r, k, v, w)), uu)
    return _unfold(out, B, H)


def rglru(x: torch.Tensor, a: torch.Tensor,
          use_kernel: bool = True) -> torch.Tensor:
    """RG-LRU, x/a ``(B, T, D)`` -> h ``(B, T, D)`` (K11)."""
    if not use_kernel:
        return ref.rglru_ref(x, a)
    return rglru_k.rglru_kernel(x.contiguous(), a.contiguous())


def local_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, use_kernel: bool = True) -> torch.Tensor:
    """Causal sliding-window attention, q/k/v ``(B, T, H, D)`` -> ``(B, T,
    H, D)`` (K9).  k and v carry the query's heads: a caller with fewer
    kv heads (MQA/GQA) expands them first, as the JAX module requires."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"local_attn: q, k, v of one shape (expand k/v to "
                         f"the query heads first), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not use_kernel:
        return ref.local_attn_ref(q, k, v, window)
    B, T, H, D = q.shape
    out = attn_k.local_attn_kernel(_fold(q), _fold(k), _fold(v), window)
    return _unfold(out, B, H)
