"""Drivers for the paper kernels K5-K7, with their static layouts.

The counterpart of the JAX package's ``src/repro/kernels/ops.py``: the
layouts are computed once per sparsity pattern from the host CSF, the
factor rows are gathered by PyTorch straight into the padded layout (as
XLA gathers them there), and the kernel wrappers of
:mod:`repro_torch.kernels.paper` do the rest — the CUDA kernel on CUDA
tensors, the plain version on CPU tensors.  The device is the factors'.
``use_kernel=False`` computes the oracle of
:mod:`repro_torch.kernels.ref` on the unpadded rows instead (the JAX
package's ``use_pallas=False``).

The LM passthroughs of the JAX module (``grouped_matmul``, ``wkv6``,
``rglru``, ``local_attn``) belong to the model stack, which is not
ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import paper, ref
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
def ttmc_fiber(ug: torch.Tensor, xf: torch.Tensor, layout: PaddedSegments,
               use_kernel: bool = True) -> torch.Tensor:
    """``ug`` ``(nfib_2, R)`` gathered U rows, ``xf`` ``(nfib_2, S)`` fiber
    intermediates -> K6 ``(nseg, R, S)``."""
    gather, mask, block_ptr = layout_arrays(layout, ug.device)
    m = mask[:, None]
    if not use_kernel:
        seg = torch.from_numpy(np.repeat(layout.block_seg, layout.block))
        return ref.ttmc_fiber_ref(xf[gather] * m, ug[gather],
                                  seg.to(ug.device), layout.nseg)
    return paper.ttmc_kernel(ug[gather] * m, xf[gather] * m, block_ptr,
                             layout.nseg, layout.block)


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
# passthroughs of the model stack (not ported)
# --------------------------------------------------------------------------- #
def _model_stack(name: str):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"ops.{name} belongs to the LM model stack (kernels K8-K11), "
            "which is not ported yet (ROADMAP queue 1, item 9)")
    unported.__name__ = name
    return unported


grouped_matmul = _model_stack("grouped_matmul")
wkv6 = _model_stack("wkv6")
rglru = _model_stack("rglru")
local_attn = _model_stack("local_attn")
