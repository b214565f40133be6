"""Recurrent blocks (the JAX package's ``models/recurrent.py``):
RecurrentGemma's RG-LRU and RWKV6 (Finch) time/channel mix.  Decode paths
carry O(1) state.

The reference scans the RG-LRU with ``jax.lax.associative_scan``; PyTorch
has none, so :func:`_lin_rec_scan` is a log-step (Hillis-Steele) scan of
the same associative operator: the same recurrence, summed in another
order.  RWKV6's stateless path is the port's ``kernels/ref.wkv6_ref`` and
its stateful one a step loop, as the reference's ``lax.scan``.
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

C_RGLRU = 8.0


# --------------------------------------------------------------------------- #
# RG-LRU recurrent block (RecurrentGemma)
# --------------------------------------------------------------------------- #
def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    p, s = {}, {}
    p["in_x"], s["in_x"] = L.dense_init(gen, d, d, "embed", "ffn", dtype)
    p["in_g"], s["in_g"] = L.dense_init(gen, d, d, "embed", "ffn", dtype)
    p["conv_w"] = L.gaussian(gen, (4, d), 0.02).to(dtype)
    s["conv_w"] = ("conv", "ffn")
    p["gate_a"], s["gate_a"] = L.dense_init(gen, d, d, "ffn", "ffn", dtype,
                                            bias=True)
    p["gate_x"], s["gate_x"] = L.dense_init(gen, d, d, "ffn", "ffn", dtype,
                                            bias=True)
    a = torch.linspace(0.9, 0.999, d, device=gen.device)
    p["log_a"] = torch.log(torch.expm1(a))         # softplus^-1(a), float32
    s["log_a"] = ("ffn",)
    p["out"], s["out"] = L.dense_init(gen, d, d, "ffn", "embed", dtype)
    return p, s


def _causal_conv(w, x, state=None):
    """width-4 depthwise causal conv; state (B, 3, D) for decode."""
    K = w.shape[0]
    if state is None:
        xp = torch.cat([torch.zeros_like(x[:, :K - 1]), x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):]
    return out, new_state


def rglru_apply(p, cfg: ModelConfig, x, state=None):
    """state = (conv_state (B,3,D), h (B,D)) for decode; None for train."""
    gate_branch = L.gelu(L.dense(p["in_g"], x))
    xb = L.dense(p["in_x"], x)
    conv_state = None if state is None else state[0]
    xb, new_conv = _causal_conv(p["conv_w"], xb, conv_state)

    r = torch.sigmoid(L.dense(p["gate_a"], xb).float())
    i = torch.sigmoid(L.dense(p["gate_x"], xb))
    log_a = -C_RGLRU * r * F.softplus(p["log_a"])     # log a_t  (<0)
    a = torch.exp(log_a).to(x.dtype)
    gated_x = i * xb

    h0 = None if state is None else state[1].to(x.dtype)
    h = _lin_rec_scan(a, gated_x, h0)
    new_h = h[:, -1]
    y = L.dense(p["out"], h * gate_branch)
    return y, (new_conv, new_h)


def _lin_rec_scan(a, x, h0=None):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t over T (axis 1), with optional
    initial state h0 folded in as h_t += (prod a_1..t) h0.

    A log-step inclusive scan of ``(a1, b1) . (a2, b2) = (a1 a2,
    b1 a2 + b2)``: ceil(log2 T) rounds, each combining every row with the
    row ``shift`` before it."""
    mult = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0))
    cum_a, h = a, mult * x
    shift = 1
    while shift < a.shape[1]:
        h = torch.cat([h[:, :shift],
                       h[:, :-shift] * cum_a[:, shift:] + h[:, shift:]], 1)
        cum_a = torch.cat([cum_a[:, :shift],
                           cum_a[:, :-shift] * cum_a[:, shift:]], 1)
        shift *= 2
    if h0 is not None:
        h = h + cum_a * h0[:, None]
    return h


# --------------------------------------------------------------------------- #
# RWKV6 block (time-mix + channel-mix)
# --------------------------------------------------------------------------- #
def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, K = d // 64, 64             # head size 64 (RWKV convention)
    dev = gen.device
    p, s = {}, {}
    for nm in ("r", "k", "v", "g"):
        p[nm], s[nm] = L.dense_init(gen, d, d, "embed", "ffn", dtype)
        p[f"mu_{nm}"] = torch.full((d,), 0.5, dtype=dtype, device=dev)
        s[f"mu_{nm}"] = ("embed",)
    p["w_lora_a"], s["w_lora_a"] = L.dense_init(gen, d, 64, "embed",
                                                "lora", dtype)
    p["w_lora_b"], s["w_lora_b"] = L.dense_init(gen, 64, d, "lora",
                                                "ffn", dtype)
    p["mu_w"] = torch.full((d,), 0.5, dtype=dtype, device=dev)
    s["mu_w"] = ("embed",)
    p["w_base"] = torch.full((d,), -5.0, dtype=torch.float32, device=dev)
    s["w_base"] = ("ffn",)
    p["u"] = L.gaussian(gen, (H, K), 0.1)
    s["u"] = ("heads", "head_dim")
    p["out"], s["out"] = L.dense_init(gen, d, d, "ffn", "embed", dtype)
    p["ln_x"], s["ln_x"] = L.norm_init("layernorm", d, dtype, dev)
    # channel-mix
    p["cm_k"], s["cm_k"] = L.dense_init(gen, d, cfg.d_ff, "embed", "ffn",
                                        dtype)
    p["cm_v"], s["cm_v"] = L.dense_init(gen, cfg.d_ff, d, "ffn", "embed",
                                        dtype)
    p["mu_cm"] = torch.full((d,), 0.5, dtype=dtype, device=dev)
    s["mu_cm"] = ("embed",)
    return p, s


def _token_shift(x, prev=None):
    """shift(x)_t = x_{t-1}; ``prev`` (B, D) is the last token of the
    previous segment (decode/chunked-prefill state)."""
    if prev is None:
        first = torch.zeros_like(x[:, :1])
    else:
        first = prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv6_with_state(r, k, v, w, u, s0):
    """WKV6 stepping an explicit (B,H,K,K) float32 state over T (prefill
    and decode paths; the stateless train path uses kernels/ref.wkv6_ref).
    Returns the float32 output (B,T,H,K) and the final state."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (z[:, t].float() for z in (r, k, v, w))
        decay = torch.exp(-torch.exp(wt))
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 s + u[None, :, :, None] * kv))
        s = decay[..., None] * s + kv
    return torch.stack(outs, 1), s


def rwkv6_time_mix(p, cfg: ModelConfig, x, state=None):
    """state = (x_prev (B,D), wkv_state (B,H,K,K)) for decode/prefill."""
    from repro_torch.kernels.ref import wkv6_ref
    B, T, d = x.shape
    H, K = d // 64, 64
    prev = None if state is None else state[0]
    xx = _token_shift(x, prev)

    def mix(nm):
        return x + (xx - x) * p[f"mu_{nm}"]

    r = L.dense(p["r"], mix("r")).reshape(B, T, H, K)
    k = L.dense(p["k"], mix("k")).reshape(B, T, H, K)
    v = L.dense(p["v"], mix("v")).reshape(B, T, H, K)
    g = F.silu(L.dense(p["g"], mix("g")))
    w = (p["w_base"]
         + L.dense(p["w_lora_b"],
                   torch.tanh(L.dense(p["w_lora_a"], mix("w")))).float())
    w = w.reshape(B, T, H, K).to(x.dtype)

    if state is None:
        o = wkv6_ref(r, k, v, w, p["u"].to(x.dtype))
        new_wkv = None  # stateless training path
    else:
        o, new_wkv = _wkv6_with_state(r, k, v, w, p["u"].float(),
                                      state[1].float())
        o = o.to(x.dtype)
    o = L.apply_norm("layernorm", p["ln_x"], o.reshape(B, T, d))
    y = L.dense(p["out"], o * g)
    return y, (x[:, -1], new_wkv)


def rwkv6_channel_mix(p, cfg: ModelConfig, x, state=None):
    xx = _token_shift(x, state)
    xk = x + (xx - x) * p["mu_cm"]
    k = torch.square(F.relu(L.dense(p["cm_k"], xk)))
    return L.dense(p["cm_v"], k), x[:, -1]


