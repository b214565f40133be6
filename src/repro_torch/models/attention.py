"""Attention variants (the JAX package's ``models/attention.py``): GQA/MQA
(RoPE, optional bias/qk-norm/sliding window), DeepSeek-V2 MLA (latent KV)
and encoder-decoder cross-attention.  Each has a full-sequence path
(train/prefill) and a single-step decode path over a KV cache.

Cache writes never hand PyTorch an index out of range: a per-row decode
write at a position past the cache is dropped, as JAX's scatter drops it,
and a shared-offset write clamps its start, as ``dynamic_update_slice``
does (a continuous-batching slot that decodes past ``cache_len`` goes on
attending to its full cache, as in the reference).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import layers as L

NEG_INF = -2.3819763e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, n_kv, hd)  [or latent (B, S, kv_lora+rope) MLA]
    v: torch.Tensor


def _is_rows(update_slice) -> bool:
    """A per-row offset vector (B,), as opposed to one shared offset."""
    return isinstance(update_slice, torch.Tensor) and update_slice.ndim == 1


# --------------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------------- #
def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    p, s = {}, {}
    p["q"], s["q"] = L.dense_init(gen, d, cfg.n_heads * hd, "embed",
                                  "q_heads", dtype, bias=cfg.qkv_bias)
    p["k"], s["k"] = L.dense_init(gen, d, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads", dtype, bias=cfg.qkv_bias)
    p["v"], s["v"] = L.dense_init(gen, d, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads", dtype, bias=cfg.qkv_bias)
    p["o"], s["o"] = L.dense_init(gen, cfg.n_heads * hd, d, "q_heads",
                                  "embed", dtype)
    if cfg.qk_norm:
        p["qn"], s["qn"] = L.norm_init("rmsnorm", hd, dtype, gen.device)
        p["kn"], s["kn"] = L.norm_init("rmsnorm", hd, dtype, gen.device)
    return p, s


def _mask(Tq: int, Tk: int, q_off, window: int | None, device=None):
    """Causal(-windowed) mask; ``q_off`` is the position of query row 0.

    A scalar offset (shared decode position / prefill) yields a (Tq, Tk)
    mask; a per-row offset vector (B,) — the continuous-batching server,
    where every slot sits at its own depth — yields (B, Tq, Tk)."""
    if _is_rows(q_off):
        device = q_off.device
        qpos = (q_off[:, None, None]
                + torch.arange(Tq, device=device)[None, :, None])
        kpos = torch.arange(Tk, device=device)[None, None, :]
    else:
        qpos = q_off + torch.arange(Tq, device=device)[:, None]
        kpos = torch.arange(Tk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _sdpa(q, k, v, mask, scale):
    # q: (B,Tq,H,D), k/v: (B,Tk,Hkv,D) — grouped heads broadcast;
    # mask is (Tq,Tk) shared or (B,Tq,Tk) per-row (per-slot decode)
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, Tq, Hkv, H // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) * scale
    m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Tq, H, v.shape[-1])


def _cache_write(cache_leaf, new, update_slice):
    """Write a (B, T, ...) update into the sequence axis of a cache leaf.

    Scalar ``update_slice``: one shared offset (prefill, lockstep decode),
    its start clamped to ``[0, S - T]``.  Vector (B,): per-row offsets —
    each batch row lands at its own position (requires T == 1, the decode
    step); a row whose position is past the cache is dropped."""
    S = cache_leaf.shape[1]
    out = cache_leaf.clone()
    new = new.to(cache_leaf.dtype)
    if _is_rows(update_slice):
        B = cache_leaf.shape[0]
        rows = torch.arange(B, device=cache_leaf.device)
        inside = update_slice < S
        at = torch.where(inside, update_slice, 0)
        keep = inside.view((B,) + (1,) * (new.ndim - 2))
        out[rows, at] = torch.where(keep, new[:, 0], out[rows, at])
        return out
    T = new.shape[1]
    if T > S:
        raise ValueError(f"a cache write of {T} rows exceeds the cache's "
                         f"{S} rows")
    start = min(max(int(update_slice), 0), S - T)
    out[:, start:start + T] = new
    return out


def gqa_apply(p, cfg: ModelConfig, x, positions, window=None,
              cache: KVCache | None = None, update_slice=None,
              causal: bool = True):
    """Full-sequence when cache is None; cached prefill/decode otherwise
    (x is (B, T, d) written at offset ``update_slice`` into the cache)."""
    B, T, d = x.shape
    hd = cfg.hd
    q = L.dense(p["q"], x).reshape(B, T, cfg.n_heads, hd)
    k = L.dense(p["k"], x).reshape(B, T, cfg.n_kv_heads, hd)
    v = L.dense(p["v"], x).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.apply_norm("rmsnorm", p["qn"], q)
        k = L.apply_norm("rmsnorm", p["kn"], k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)

    if cache is None:
        if causal:
            mask = _mask(T, T, 0, window, x.device)
        else:
            mask = torch.ones((T, T), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, scale)
        new_cache = KVCache(k=k, v=v)
    else:
        S = cache.k.shape[1]
        if window is not None and S <= window and T == 1:
            # ring-buffer window cache (local layers): O(window) memory
            # instead of O(seq).  Slot s holds position p - ((p - s) mod S);
            # all resident positions are inside the window by construction,
            # only warm-up slots (pos < 0) need masking.
            slot = update_slice % S
            kc = _cache_write(cache.k, k, slot)
            vc = _cache_write(cache.v, v, slot)
            s_idx = torch.arange(S, device=x.device)[None, :]
            if _is_rows(update_slice):
                us = update_slice[:, None]                     # (B, 1)
                slot_pos = us - (us - s_idx) % S
                mask = ((slot_pos >= 0)
                        & (slot_pos > us - window))[:, None, :]  # (B,1,S)
            else:
                us = int(update_slice)
                slot_pos = us - (us - s_idx) % S
                mask = ((slot_pos >= 0)
                        & (slot_pos > us - window)).expand(T, S)
        else:
            kc = _cache_write(cache.k, k, update_slice)
            vc = _cache_write(cache.v, v, update_slice)
            # causal-within-prompt: query row t sits at update_slice + t
            mask = _mask(T, S, update_slice, window, x.device)
        out = _sdpa(q, kc.to(q.dtype), vc.to(q.dtype), mask, scale)
        new_cache = KVCache(k=kc, v=vc)
    y = L.dense(p["o"], out.reshape(B, T, cfg.n_heads * hd))
    return y, new_cache


# --------------------------------------------------------------------------- #
# DeepSeek-V2 MLA
# --------------------------------------------------------------------------- #
def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    p, s = {}, {}
    p["q_a"], s["q_a"] = L.dense_init(gen, d, m.q_lora, "embed", "lora",
                                      dtype)
    p["q_an"], s["q_an"] = L.norm_init("rmsnorm", m.q_lora, dtype,
                                       gen.device)
    p["q_b"], s["q_b"] = L.dense_init(gen, m.q_lora, H * qk, "lora",
                                      "q_heads", dtype)
    # kv compression: latent (kv_lora) + decoupled rope key (qk_rope_dim)
    p["kv_a"], s["kv_a"] = L.dense_init(gen, d, m.kv_lora + m.qk_rope_dim,
                                        "embed", "lora", dtype)
    p["kv_an"], s["kv_an"] = L.norm_init("rmsnorm", m.kv_lora, dtype,
                                         gen.device)
    p["kv_b"], s["kv_b"] = L.dense_init(
        gen, m.kv_lora, H * (m.qk_nope_dim + m.v_head_dim), "lora",
        "q_heads", dtype)
    p["o"], s["o"] = L.dense_init(gen, H * m.v_head_dim, d, "q_heads",
                                  "embed", dtype)
    return p, s


def _mla_query(p, cfg: ModelConfig, x, positions):
    m: MLAConfig = cfg.mla
    B, T, _ = x.shape
    q = L.dense(p["q_b"], L.apply_norm("rmsnorm", p["q_an"],
                                       L.dense(p["q_a"], x)))
    q = q.reshape(B, T, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    """The (latent, rope key) row per token, (B, T, kv_lora + rope)."""
    m: MLAConfig = cfg.mla
    kv_a = L.dense(p["kv_a"], x)
    latent = L.apply_norm("rmsnorm", p["kv_an"], kv_a[..., :m.kv_lora])
    k_rope = L.apply_rope(kv_a[..., None, m.kv_lora:], positions,
                          cfg.rope_theta)[..., 0, :]
    return torch.cat([latent, k_rope], -1)


def _masked_softmax(lg, mask):
    lg = torch.where(mask[:, None] if mask.ndim == 3 else mask[None, None],
                     lg, NEG_INF)
    return torch.softmax(lg, dim=-1)


def mla_apply_absorbed(p, cfg: ModelConfig, x, positions, cache: KVCache,
                       update_slice):
    """Absorbed-matrix MLA decode: W_uk folds into the query and W_uv into
    the attention output, so the cache is only ever read at its
    compressed width."""
    m: MLAConfig = cfg.mla
    B, T, d = x.shape
    if T != 1:
        raise ValueError("the absorbed path is the single-token decode step")
    H = cfg.n_heads
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    lat_cache = _cache_write(cache.k, _mla_latent(p, cfg, x, positions),
                             update_slice)
    new_cache = KVCache(k=lat_cache, v=cache.v)
    S = lat_cache.shape[1]
    lat_all = lat_cache.to(q_nope.dtype)
    latent_all = lat_all[..., :m.kv_lora]               # (B,S,kv_lora)
    krope_all = lat_all[..., m.kv_lora:]                # (B,S,rope)

    # fold W_uk (the k_nope decompression) into the query
    w_kv_b = p["kv_b"]["w"].reshape(m.kv_lora, H,
                                    m.qk_nope_dim + m.v_head_dim)
    w_uk = w_kv_b[..., :m.qk_nope_dim]                  # (kv_lora,H,nope)
    w_uv = w_kv_b[..., m.qk_nope_dim:]                  # (kv_lora,H,v)
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope, w_uk)

    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    lg = (torch.einsum("bthl,bsl->bhts", q_lat.float(), latent_all.float())
          + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                         krope_all.float())) * scale
    pr = _masked_softmax(lg, _mask(T, S, update_slice, None, x.device))
    ctx_lat = torch.einsum("bhts,bsl->bthl", pr.to(latent_all.dtype),
                           latent_all)                  # (B,1,H,kv_lora)
    out = torch.einsum("bthl,lhv->bthv", ctx_lat, w_uv)  # (B,1,H,v)
    y = L.dense(p["o"], out.reshape(B, T, H * m.v_head_dim))
    return y, new_cache


def mla_apply(p, cfg: ModelConfig, x, positions,
              cache: KVCache | None = None, update_slice=None):
    """MLA with latent-KV cache: cache.k stores the (kv_lora + rope) latent
    per token — the compressed cache that is MLA's point."""
    if cache is not None and x.shape[1] == 1 and getattr(
            cfg, "mla_absorb", True):
        return mla_apply_absorbed(p, cfg, x, positions, cache, update_slice)
    m: MLAConfig = cfg.mla
    B, T, d = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    lat_cat = _mla_latent(p, cfg, x, positions)

    if cache is not None:
        lat_cat = _cache_write(cache.k, lat_cat, update_slice)
        new_cache = KVCache(k=lat_cat, v=cache.v)
        S = lat_cat.shape[1]
        mask = _mask(T, S, update_slice, None, x.device)
    else:
        new_cache = KVCache(k=lat_cat, v=lat_cat[..., :0])
        S = T
        mask = _mask(T, T, 0, None, x.device)
    lat_all = lat_cat.to(q_nope.dtype)
    latent_all, krope_all = lat_all[..., :m.kv_lora], lat_all[..., m.kv_lora:]
    kv = L.dense(p["kv_b"], latent_all).reshape(
        B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]

    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    lg = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                         krope_all.float())) * scale
    pr = _masked_softmax(lg, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", pr.to(v.dtype), v)
    y = L.dense(p["o"], out.reshape(B, T, H * m.v_head_dim))
    return y, new_cache


# --------------------------------------------------------------------------- #
# Cross-attention (enc-dec)
# --------------------------------------------------------------------------- #
def cross_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    p, s = {}, {}
    p["q"], s["q"] = L.dense_init(gen, d, cfg.n_heads * hd, "embed",
                                  "q_heads", dtype)
    p["k"], s["k"] = L.dense_init(gen, d, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads", dtype)
    p["v"], s["v"] = L.dense_init(gen, d, cfg.n_kv_heads * hd, "embed",
                                  "kv_heads", dtype)
    p["o"], s["o"] = L.dense_init(gen, cfg.n_heads * hd, d, "q_heads",
                                  "embed", dtype)
    return p, s


def cross_apply(p, cfg: ModelConfig, x, enc_out):
    B, T, d = x.shape
    S = enc_out.shape[1]
    hd = cfg.hd
    q = L.dense(p["q"], x).reshape(B, T, cfg.n_heads, hd)
    k = L.dense(p["k"], enc_out).reshape(B, S, cfg.n_kv_heads, hd)
    v = L.dense(p["v"], enc_out).reshape(B, S, cfg.n_kv_heads, hd)
    mask = torch.ones((T, S), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    return L.dense(p["o"], out.reshape(B, T, cfg.n_heads * hd))
