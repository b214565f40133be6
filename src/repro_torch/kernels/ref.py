"""Plain PyTorch oracles of the kernels (the JAX package's
``src/repro/kernels/ref.py``): the semantics K5-K11 must match up to
float tolerance, and the plain versions their wrappers run on CPU
tensors.  Segment sums add in ascending row order
(:func:`~repro_torch.kernels.segment.segment_combine_plain`).

The LM oracles (K8-K11) keep the kernels' precisions: float32 sums and
states, outputs in the input dtype.  ``wkv6_ref`` and ``rglru_ref`` step
through time as the kernels do (the reference's RG-LRU oracle is an
associative scan), and ``local_attn_ref`` computes each chunk of queries
against its window of keys only (:func:`local_attn_band`): the dense
``(B, H, T, T)`` logits of the reference's oracle would be 68 GB at
recurrentgemma-9b's 32k prefill."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


# --------------------------------------------------------------------------- #
# LM kernels
# --------------------------------------------------------------------------- #
NEG_INF = -1e30            # the masked logit (as the Pallas kernel's)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F) batched expert GEMM, summed in
    float32 and cast to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV6 WKV: per head, o_t = r_t (S + diag(u) k_t v_t^T), then
    S <- diag(exp(-exp(w_t))) S + k_t v_t^T, from S = 0.

    Time is axis 1: r/k/v/w ``(B, T, H, K)`` with u ``(H, K)``, or folded
    ``(BH, T, K)`` with u ``(BH, K)``.  The state is float32; the output
    has r's shape and dtype."""
    dtype, T = r.dtype, r.shape[1]
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    decay = torch.exp(-torch.exp(w))
    state = r.new_zeros(r.shape[:1] + r.shape[2:] + r.shape[-1:])
    out = torch.empty_like(r)
    for t in range(T):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        out[:, t] = (r[:, t, ..., None, :]
                     @ (state + u[..., :, None] * kv))[..., 0, :]
        state = decay[:, t, ..., :, None] * state + kv
    return out.to(dtype)


def rglru_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """RG-LRU: h_t = a_t h_{t-1} + sqrt(clip(1 - a_t^2, 0, 1)) x_t from
    h = 0, x/a ``(B, T, D)``; float32 state, output in x's dtype."""
    xf, af = x.float(), a.float()
    gated = torch.sqrt(torch.clamp(1.0 - af * af, 0.0, 1.0)) * xf
    out = torch.empty_like(xf)
    h = xf.new_zeros(x.shape[:1] + x.shape[2:])
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        out[:, t] = h
    return out.to(x.dtype)


QUERY_CHUNK = 256         # query rows per step of :func:`local_attn_band`


def local_attn_band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, scale: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention on ``(N, T, D)``: each chunk of
    ``QUERY_CHUNK`` query rows ``[q0, q1)`` against its dense key slice
    ``[max(0, q0 - window + 1), q1)`` with the exact mask ``kpos <= qpos``
    and ``kpos > qpos - window``.  The rounding points are the Pallas
    kernel's: ``q * scale`` in the input dtype, float32 logits, ``p``
    cast to ``v.dtype`` before ``p @ v``, float32 normalisation."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    N, T, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(q.dtype).float()
    out = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, QUERY_CHUNK):
        q1 = min(q0 + QUERY_CHUNK, T)
        k0 = max(0, q0 - window + 1)
        qpos, kpos = pos[q0:q1, None], pos[None, k0:q1]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s = torch.where(mask, qs[:, q0:q1] @ k[:, k0:q1].float().mT,
                        NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        acc = p.to(v.dtype).float() @ v[:, k0:q1].float()
        out[:, q0:q1] = (acc / p.sum(-1, keepdim=True)).to(q.dtype)
    return out


def local_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int, scale: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention, q/k/v ``(B, T, H, D)`` (equal
    heads): :func:`local_attn_band` per (batch, head)."""
    B, T, H, D = q.shape

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, T, D)

    out = local_attn_band(fold(q), fold(k), fold(v), window, scale)
    return out.reshape(B, H, T, D).transpose(1, 2)
