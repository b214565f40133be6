"""Plain PyTorch oracles of the paper kernels (the JAX package's
``src/repro/kernels/ref.py:10-29``): the semantics K5-K7 must match up to
float tolerance, and the plain versions their wrappers run on CPU
tensors.  Segment sums add in ascending row order
(:func:`~repro_torch.kernels.segment.segment_combine_plain`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment import segment_combine_plain


def _seg_ptr(seg: torch.Tensor, nseg: int) -> torch.Tensor:
    return torch.searchsorted(seg.to(torch.int64),
                              torch.arange(nseg + 1, device=seg.device))


def mttkrp_ref(vals: torch.Tensor, bg: torch.Tensor, cg: torch.Tensor,
               seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """out[s, :] = sum_{n: seg[n]=s} vals[n] * bg[n, :] * cg[n, :]
    (``seg`` sorted)."""
    part = vals[:, None] * bg * cg
    return segment_combine_plain(part, _seg_ptr(seg, nseg), nseg)


def ttmc_fiber_ref(xf: torch.Tensor, ug: torch.Tensor, seg: torch.Tensor,
                   nseg: int) -> torch.Tensor:
    """out[s, r, t] = sum_{f: seg[f]=s} ug[f, r] * xf[f, t] — fiber outer
    products accumulated per output row (``seg`` sorted)."""
    outer = ug[:, :, None] * xf[:, None, :]
    R, S = outer.shape[1:]
    out = segment_combine_plain(outer.reshape(-1, R * S),
                                _seg_ptr(seg, nseg), nseg)
    return out.reshape(nseg, R, S)


def tttp_ref(vals: torch.Tensor, ug: torch.Tensor, vg: torch.Tensor,
             wg: torch.Tensor) -> torch.Tensor:
    """out[n] = vals[n] * sum_r ug[n,r] vg[n,r] wg[n,r]."""
    return vals * torch.sum(ug * vg * wg, dim=-1)
