"""Model assembly for all assigned architectures (the JAX package's
``models/transformer.py``).

One generic decoder (optionally encoder-decoder) built from typed blocks:
  attn   — global causal GQA/MLA + FFN (dense or MoE)
  local  — sliding-window GQA + FFN
  rglru  — RecurrentGemma recurrent block + FFN
  rwkv   — RWKV6 time-mix + channel-mix

The params tree is the reference's: repeating pattern groups keep their
leading ``n_groups`` axis (``p["dec"]["scan"]["b{j}"]``, stacked as the
reference's ``lax.scan`` carries them), and the head/tail layers are
lists.  :func:`_stack_apply` runs the groups in a Python loop over that
axis; caches are stacked the same way.  Everything runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import replicate, shard_activation
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig, dtype,
               ffn: str = "dense"):
    dev = gen.device
    p, s = {}, {}
    p["n1"], s["n1"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if kind in ("attn", "local", "enc_attn", "xattn"):
        if cfg.mla is not None and kind in ("attn", "xattn"):
            p["mix"], s["mix"] = A.mla_init(gen, cfg, dtype)
        else:
            p["mix"], s["mix"] = A.gqa_init(gen, cfg, dtype)
        if kind == "xattn":
            p["n_x"], s["n_x"] = L.norm_init(cfg.norm, cfg.d_model, dtype,
                                             dev)
            p["cross"], s["cross"] = A.cross_init(gen, cfg, dtype)
    elif kind == "rglru":
        p["mix"], s["mix"] = R.rglru_init(gen, cfg, dtype)
    elif kind == "rwkv":
        p["mix"], s["mix"] = R.rwkv6_init(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    p["n2"], s["n2"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
    if kind != "rwkv":  # rwkv's channel-mix lives inside its mix params
        if ffn == "moe":
            p["ffn"], s["ffn"] = M.moe_init(gen, cfg, dtype)
        elif ffn.startswith("dense"):
            d_ff = cfg.d_ff if ffn == "dense" else int(ffn.split(":")[1])
            p["ffn"], s["ffn"] = L.mlp_init(gen, cfg.mlp, cfg.d_model, d_ff,
                                            dtype)
    if cfg.post_norms:
        p["pn1"], s["pn1"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
        p["pn2"], s["pn2"] = L.norm_init(cfg.norm, cfg.d_model, dtype, dev)
    return p, s


def block_apply(kind: str, p, cfg: ModelConfig, x, positions,
                state=None, update_slice=None, enc_out=None,
                ffn: str = "dense", train: bool = True):
    """Returns (x, new_state, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(cfg.norm, p["n1"], x)
    if kind in ("attn", "local", "enc_attn", "xattn"):
        window = cfg.window if kind == "local" else None
        if cfg.mla is not None and kind in ("attn", "xattn"):
            y, new_state = A.mla_apply(p["mix"], cfg, h, positions,
                                       cache=state, update_slice=update_slice)
        else:
            causal = kind != "enc_attn"
            y, new_state = A.gqa_apply(p["mix"], cfg, h, positions,
                                       window=window, cache=state,
                                       update_slice=update_slice,
                                       causal=causal)
            if not causal:
                new_state = None
    elif kind == "rglru":
        y, new_state = R.rglru_apply(p["mix"], cfg, h, state)
    elif kind == "rwkv":
        tm_state = None if state is None else (state[0], state[1])
        y, tm_new = R.rwkv6_time_mix(p["mix"], cfg, h, tm_state)
        x = x + y
        h2 = L.apply_norm(cfg.norm, p["n2"], x)
        cm_prev = None if state is None else state[2]
        y2, cm_new = R.rwkv6_channel_mix(p["mix"], cfg, h2, cm_prev)
        x = shard_activation(x + y2, "btd")
        new_state = None if state is None else (tm_new[0], tm_new[1], cm_new)
        return x, new_state, aux
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        y = L.apply_norm(cfg.norm, p["pn1"], y)
    x = x + y
    if kind == "xattn" and enc_out is not None:
        x = x + A.cross_apply(p["cross"],
                              cfg, L.apply_norm(cfg.norm, p["n_x"], x),
                              enc_out)
    h = L.apply_norm(cfg.norm, p["n2"], x)
    if ffn == "moe":
        y, aux = M.moe_apply(p["ffn"], cfg, h, train=train)
    else:
        y = L.mlp_apply(cfg.mlp, p["ffn"], h)
    if cfg.post_norms:
        y = L.apply_norm(cfg.norm, p["pn2"], y)
    x = shard_activation(x + y, "btd")
    return x, new_state, aux


# --------------------------------------------------------------------------- #
# layer plan: which layers repeat as groups, which stand alone
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    head: tuple[tuple[str, str], ...]   # (kind, ffn) leading layers
    group: tuple[tuple[str, str], ...]  # repeating group
    n_groups: int
    tail: tuple[tuple[str, str], ...]   # remainder


def layer_plan(cfg: ModelConfig, decoder: bool = True) -> LayerPlan:
    n = cfg.n_layers
    kinds = cfg.pattern_for_layers(n)
    if cfg.encdec and decoder:
        kinds = ["xattn"] * n
    ffns = []
    for i in range(n):
        if cfg.moe is not None:
            if i < cfg.moe.first_dense:
                ffns.append(f"dense:{cfg.moe.d_first_dense}")
            else:
                ffns.append("moe")
        else:
            ffns.append("dense")
    layers = list(zip(kinds, ffns))
    head_n = cfg.moe.first_dense if cfg.moe is not None else 0
    head, rest = tuple(layers[:head_n]), layers[head_n:]
    g = len(cfg.block_pattern) if not (cfg.encdec and decoder) else 1
    n_groups = len(rest) // g
    grouped, tail = rest[: n_groups * g], tuple(rest[n_groups * g:])
    group = tuple(grouped[:g]) if n_groups else ()
    return LayerPlan(head=head, group=group, n_groups=n_groups, tail=tail)


def _stack_init(gen: torch.Generator, cfg, plan: LayerPlan, dtype):
    """Init head/tail layers + per-group-position stacked params."""
    p, s = {"head": [], "tail": []}, {"head": [], "tail": []}
    for part in ("head", "tail"):
        for kind, ffn in getattr(plan, part):
            bp, bs = block_init(kind, gen, cfg, dtype, ffn)
            p[part].append(bp)
            s[part].append(bs)
    if plan.n_groups:
        scan_p, scan_s = {}, {}
        for j, (kind, ffn) in enumerate(plan.group):
            per = [block_init(kind, gen, cfg, dtype, ffn)
                   for _ in range(plan.n_groups)]
            scan_p[f"b{j}"] = L.stack_params([pp for pp, _ in per])
            scan_s[f"b{j}"] = L.stack_specs(per[0][1])
        p["scan"], s["scan"] = scan_p, scan_s
    return p, s


def _stack_apply(p, cfg, plan: LayerPlan, x, positions, caches=None,
                 update_slice=None, enc_out=None, remat: bool = True,
                 train: bool = True):
    """Apply head + the repeating groups (a Python loop over the stacked
    group axis) + tail.  ``caches`` mirrors the param structure; returns
    (x, new_caches, aux_sum).

    ``remat`` recomputes each group's activations in the backward pass
    (``torch.utils.checkpoint``, where the reference puts
    ``jax.checkpoint``), and only while autograd records (grad mode on
    and an input that requires grad): serving runs as it would without
    it.  The reference's ``unroll`` has no counterpart: the loop here is
    already unrolled."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: dict[str, Any] = {"head": [], "tail": []}
    for i, (kind, ffn) in enumerate(plan.head):
        st = None if caches is None else caches["head"][i]
        x, ns, aux = block_apply(kind, p["head"][i], cfg, x, positions, st,
                                 update_slice, enc_out, ffn, train)
        new_caches["head"].append(ns)
        aux_total = aux_total + aux

    def group_body(x, aux_total, params_g, cache_g):
        new_cache_g = {}
        for j, (kind, ffn) in enumerate(plan.group):
            st = None if cache_g is None else cache_g[f"b{j}"]
            x, ns, aux = block_apply(kind, params_g[f"b{j}"], cfg, x,
                                     positions, st, update_slice, enc_out,
                                     ffn, train)
            # a block without state leaves a 0 in the stacked caches, as
            # the reference's scan does
            new_cache_g[f"b{j}"] = ns if ns is not None else torch.zeros(
                (), dtype=torch.int32, device=x.device)
            aux_total = aux_total + aux
        return x, aux_total, new_cache_g

    new_caches["scan"] = None
    if plan.n_groups:
        leaves = L.tree_leaves(p["scan"])
        recompute = remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, enc_out, *leaves] if t is not None)
        # one unbind a leaf: its backward stacks the groups' grads once
        # (indexing each group would add a full-size zero grad a group)
        groups = [t.unbind(0) for t in leaves]
        new_scan_list = []
        for g in range(plan.n_groups):
            it = iter([t[g] for t in groups])
            params_g = L.tree_map(lambda _: next(it), p["scan"])
            cache_g = (None if caches is None else
                       L.tree_map(lambda a: a[g], caches["scan"]))
            args = (x, aux_total, params_g, cache_g)
            x, aux_total, new_cache_g = (
                checkpoint(group_body, *args, use_reentrant=False)
                if recompute else group_body(*args))
            new_scan_list.append(new_cache_g)
        if caches is not None:
            new_caches["scan"] = L.tree_map(
                lambda *xs: torch.stack(xs, 0), *new_scan_list)

    for i, (kind, ffn) in enumerate(plan.tail):
        st = None if caches is None else caches["tail"][i]
        x, ns, aux = block_apply(kind, p["tail"][i], cfg, x, positions, st,
                                 update_slice, enc_out, ffn, train)
        new_caches["tail"].append(ns)
        aux_total = aux_total + aux
    return x, new_caches, aux_total


# --------------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------------- #
def _generator(seed_or_generator, device) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    from repro_torch.core.executor import resolve_device
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed_or_generator))
    return gen


def model_init(cfg: ModelConfig, seed_or_generator=0, device=None):
    """Returns (params, specs), drawn from ``seed_or_generator`` (a seed,
    or a ``torch.Generator`` whose device the params then live on) on
    ``device`` (``None``: the CUDA card)."""
    gen = _generator(seed_or_generator, device)
    dtype = cfg.compute_dtype
    p, s = {}, {}
    # vocab padded to a TP-divisible multiple (granite's 49155 rows)
    p["embed"], s["embed"] = L.embed_init(gen, cfg.padded_vocab,
                                          cfg.d_model, dtype)
    plan = layer_plan(cfg, decoder=True)
    p["dec"], s["dec"] = _stack_init(gen, cfg, plan, dtype)
    if cfg.encdec:
        p["enc"], s["enc"] = _stack_init(gen, cfg, _enc_plan(cfg), dtype)
        p["enc_norm"], s["enc_norm"] = L.norm_init(cfg.norm, cfg.d_model,
                                                   dtype, gen.device)
    p["final_norm"], s["final_norm"] = L.norm_init(cfg.norm, cfg.d_model,
                                                   dtype, gen.device)
    if not cfg.tie_embeddings:
        p["head"], s["head"] = L.dense_init(gen, cfg.d_model,
                                            cfg.padded_vocab,
                                            "embed", "vocab", dtype)
    return p, s


def _enc_plan(cfg: ModelConfig) -> LayerPlan:
    return LayerPlan(head=(), group=(("enc_attn", "dense"),),
                     n_groups=cfg.n_enc_layers, tail=())


def _encode(p, cfg: ModelConfig, enc_frames, remat: bool = True):
    B, S = enc_frames.shape[:2]
    pos = torch.arange(S, device=enc_frames.device).expand(B, S)
    x, _, _ = _stack_apply(p["enc"], cfg, _enc_plan(cfg), enc_frames, pos,
                           remat=remat)
    return L.apply_norm(cfg.norm, p["enc_norm"], x)


def _scale_embeddings(cfg: ModelConfig, x):
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _embed_inputs(p, cfg: ModelConfig, batch):
    table = p["embed"]["w"]
    if batch["tokens"].numel() >= table.shape[0]:
        table = replicate(table)
    x = _scale_embeddings(cfg, L.embed_lookup({"w": table}, batch["tokens"]))
    if cfg.modality_stub == "vision" and "stub" in batch:
        n = batch["stub"].shape[1]
        x = torch.cat([batch["stub"].to(x.dtype), x[:, n:]], 1)
    return x


def forward(p, cfg: ModelConfig, batch, remat: bool = True,
            train: bool = False):
    """Full-sequence forward: returns (logits, aux_loss).

    ``train=True`` (set by :func:`loss_fn`) enables capacity-bounded MoE
    dispatch; the default is inference semantics (dropless MoE), which keeps
    a batched forward consistent with prefill + decode_step.  ``remat``
    recomputes each stacked group in the backward pass
    (:func:`_stack_apply`)."""
    x = shard_activation(_embed_inputs(p, cfg, batch), "btd")
    B, T = batch["tokens"].shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    enc_out = None
    if cfg.encdec:
        enc_out = _encode(p, cfg, batch["enc_frames"].to(x.dtype),
                          remat=remat)
    x, _, aux = _stack_apply(p["dec"], cfg, layer_plan(cfg), x, positions,
                             enc_out=enc_out, remat=remat, train=train)
    x = L.apply_norm(cfg.norm, p["final_norm"], x)
    return _logits(p, cfg, x), aux


def _logits(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ p["embed"]["w"].T
    else:
        logits = L.dense(p["head"], x)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab:
        # mask the padding columns (-1e30 holds in bf16 too)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < cfg.vocab, logits, -1e30)
    return logits


def loss_fn(p, cfg: ModelConfig, batch, remat: bool = True):
    """Next-token cross-entropy + 0.01 x the MoE load-balance loss:
    ``(loss, {"ce", "aux"})``, differentiable in ``p``'s leaves (the train
    step takes ``torch.autograd.grad`` of it).

    The gold logit is a masked sum over the vocabulary columns, as the
    reference's: its backward is an element-wise product, where
    ``torch.gather``'s is a ``scatter_add`` whose order on the card is not
    fixed."""
    logits, aux = forward(p, cfg, batch, remat=remat, train=True)
    logits = logits[:, :-1].float()
    targets = batch["labels"][:, 1:].long()
    logz = torch.logsumexp(logits, -1)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(cols == targets[..., None], logits, 0.0).sum(-1)
    ce = (logz - gold).mean()
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------- #
def _one_cache(kind: str, cfg: ModelConfig, B: int, S: int, dtype,
               ring: bool = True, lead: tuple[int, ...] = (), device=None):
    """One block's zero cache, with ``lead`` axes in front of each leaf
    (``(n_groups,)`` for a stacked group)."""
    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    hd = cfg.hd
    if kind in ("attn", "local", "xattn"):
        if cfg.mla is not None and kind in ("attn", "xattn"):
            m = cfg.mla
            return A.KVCache(k=zeros(B, S, m.kv_lora + m.qk_rope_dim),
                             v=zeros(B, S, 0))
        if kind == "local" and ring and cfg.window is not None:
            # ring-buffer cache: O(window) per local layer
            S = min(S, cfg.window)
        return A.KVCache(k=zeros(B, S, cfg.n_kv_heads, hd),
                         v=zeros(B, S, cfg.n_kv_heads, hd))
    if kind == "rglru":
        return (zeros(B, 3, cfg.d_model), zeros(B, cfg.d_model))
    if kind == "rwkv":
        H = cfg.d_model // 64
        return (zeros(B, cfg.d_model), zeros(B, H, 64, 64),
                zeros(B, cfg.d_model))
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=None,
               ring: bool = True, device=None):
    """Zero caches for ``B`` rows of ``S`` positions on ``device``
    (``None``: the CUDA card)."""
    from repro_torch.core.executor import resolve_device
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    plan = layer_plan(cfg, decoder=True)
    caches: dict[str, Any] = {
        part: [_one_cache(k, cfg, B, S, dtype, ring, device=dev)
               for k, _ in getattr(plan, part)]
        for part in ("head", "tail")}
    caches["scan"] = None
    if plan.n_groups:
        caches["scan"] = {
            f"b{j}": _one_cache(kind, cfg, B, S, dtype, ring,
                                (plan.n_groups,), dev)
            for j, (kind, _) in enumerate(plan.group)}
    return caches


def decode_step(p, cfg: ModelConfig, caches, tokens, pos, enc_out=None):
    """One token step: tokens (B, 1), pos — one int when every row decodes
    in lockstep, or a per-row int tensor (B,) on the tokens' device when
    rows sit at different depths (the continuous-batching server with
    mixed-length prompts).  Returns (logits (B,1,V), new_caches)."""
    table = p["embed"]["w"]
    if tokens.numel() >= table.shape[0]:
        table = replicate(table)
    x = _scale_embeddings(cfg, L.embed_lookup({"w": table}, tokens))
    B = tokens.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=x.device, dtype=torch.int64)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    x, new_caches, _ = _stack_apply(p["dec"], cfg, layer_plan(cfg), x,
                                    positions, caches=caches,
                                    update_slice=pos, enc_out=enc_out,
                                    train=False)
    x = L.apply_norm(cfg.norm, p["final_norm"], x)
    return _logits(p, cfg, x), new_caches


def prefill(p, cfg: ModelConfig, batch, cache_len: int | None = None):
    """Prefill: forward over the prompt, building caches sized cache_len."""
    B, T = batch["tokens"].shape
    S = cache_len or T
    x = _embed_inputs(p, cfg, batch)
    caches = init_cache(cfg, B, S, ring=False,   # prefill writes T>1 rows
                        device=x.device)
    positions = torch.arange(T, device=x.device).expand(B, T)
    enc_out = None
    if cfg.encdec:
        enc_out = _encode(p, cfg, batch["enc_frames"].to(x.dtype))
    x, new_caches, _ = _stack_apply(p["dec"], cfg, layer_plan(cfg), x,
                                    positions, caches=caches,
                                    update_slice=0, enc_out=enc_out,
                                    train=False)
    x = L.apply_norm(cfg.norm, p["final_norm"], x)
    return _logits(p, cfg, x[:, -1:]), new_caches
