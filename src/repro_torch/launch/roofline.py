"""Roofline terms of a dry-run cell (the JAX package's
``launch/roofline.py``), for the NVIDIA H100 SXM.

Hardware model (H100 SXM5 80 GB, NVIDIA's H100 Tensor Core GPU datasheet):
  PEAK_FLOPS = 989e12  dense bf16 tensor-core FLOP/s
  HBM_BW     = 3.35e12 B/s (HBM3)
  NVLINK_BW  = 450e9   B/s a direction (fourth-generation NVLink, 900 GB/s
               both directions together, per GPU)
  HBM_BYTES  = 80e9    (the card's 80 GB; ``analytic_memory``'s fit test)

Terms (seconds, per step, per device):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes accessed / HBM_BW
  collective = wire bytes / NVLINK_BW

The dry run (``launch/dryrun.py``) traces the eager step, so every layer
is counted where it runs: nothing is multiplied by a trip count.
:class:`CollectiveBytes` counts the collectives a traced call issues, into
the dict the reference parses out of XLA's HLO text
(``collective_bytes_from_hlo``, which has no PyTorch counterpart):
payload bytes per op (an all-gather's and a reduce-scatter's result, an
all-reduce's tensor) and wire bytes with an all-reduce charged twice
(ring).  The arithmetic functions below are the reference's, line for
line.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
HBM_BYTES = 80e9

# c10d's in-place collectives -> (the reference's op name, the result
# argument whose bytes are the payload)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveBytes(TorchDispatchMode):
    """Counts each c10d collective dispatched while active (what
    ``CommDebugMode`` counts) with its payload bytes:
    ``with CollectiveBytes() as c: ...; c.summary()``."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            if name in _C10D:
                op, arg = _C10D[name]
                self.ops.append((op, _nbytes(args[arg])))
        return func(*args, **kwargs)

    def summary(self) -> dict:
        """The reference parser's dict: ``per_op_bytes``, ``wire_bytes``
        (all-reduce 2x), ``scan_multiplier`` (1: every layer ran) and
        ``n_collectives``."""
        totals: dict[str, int] = {}
        wire = 0
        for op, b in self.ops:
            totals[op] = totals.get(op, 0) + b
            wire += b * (2 if op == "all-reduce" else 1)
        return {"per_op_bytes": totals, "wire_bytes": int(wire),
                "scan_multiplier": 1, "n_collectives": len(self.ops)}


def summarize_cost(cost) -> dict:
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    out = {}
    for k in ("flops", "bytes accessed", "transcendentals",
              "optimal_seconds"):
        if k in cost:
            out[k.replace(" ", "_")] = float(cost[k])
    return out


def model_flops(cfg, sc) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for dense (N_active for MoE) per step,
    plus a per-kind mixing term: S^2 attention (windowed for 'local'
    layers), O(S) latent-cache attention for MLA decode, O(K^2) recurrent
    state updates for RG-LRU/RWKV."""
    n_active = active_params(cfg)
    tokens = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    base = (6.0 if sc.kind == "train" else 2.0) * n_active * tokens
    hd = cfg.hd
    S = sc.seq_len
    B = sc.global_batch
    bwd = 3.0 if sc.kind == "train" else 1.0
    kinds = cfg.pattern_for_layers()
    mix = 0.0
    w = min(cfg.window or S, S)
    for kind in kinds:
        if kind in ("attn", "xattn", "local"):
            span = w if kind == "local" else S
            if sc.kind == "decode":
                if cfg.mla is not None:
                    # absorbed MLA: scores+ctx read the compressed latent
                    m = cfg.mla
                    mix += 4.0 * B * cfg.n_heads * span * \
                        (m.kv_lora + m.qk_rope_dim)
                else:
                    mix += 4.0 * B * span * cfg.n_kv_heads * hd
            else:
                mix += bwd * 2.0 * 2.0 * B * S * span * cfg.n_heads * hd
        elif kind == "rglru":
            mix += bwd * 2.0 * B * (S if sc.kind != "decode" else 1) \
                * cfg.d_model * 4
        elif kind == "rwkv":
            K = 64
            steps = S if sc.kind != "decode" else 1
            mix += bwd * 2.0 * B * steps * (cfg.d_model // 64) * K * K * 3
    return base + mix


def active_params(cfg) -> float:
    """Parameter count active per token (MoE counts top_k experts)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.hd
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    kinds = cfg.pattern_for_layers()
    for i, kind in enumerate(kinds):
        if kind in ("attn", "local", "xattn"):
            if cfg.mla is not None:
                m = cfg.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                per_layer += (d * m.q_lora + m.q_lora * cfg.n_heads * qk
                              + d * (m.kv_lora + m.qk_rope_dim)
                              + m.kv_lora * cfg.n_heads *
                              (m.qk_nope_dim + m.v_head_dim)
                              + cfg.n_heads * m.v_head_dim * d)
            else:
                per_layer += (cfg.n_heads * hd * d * 2
                              + cfg.n_kv_heads * hd * d * 2)
            if kind == "xattn":
                per_layer += (cfg.n_heads * hd * d * 2
                              + cfg.n_kv_heads * hd * d * 2)
        elif kind == "rglru":
            per_layer += 7 * d * d / 1  # in/gate/out + gates (approx exact)
        elif kind == "rwkv":
            per_layer += 5 * d * d + 2 * d * cfg.d_ff
        # ffn
        if kind != "rwkv":
            if cfg.moe is not None and i >= cfg.moe.first_dense:
                mo = cfg.moe
                per_layer += 3 * d * mo.d_expert * mo.top_k
                per_layer += 3 * d * mo.n_shared * mo.d_shared
                per_layer += d * mo.n_experts  # router
            elif cfg.moe is not None and i < cfg.moe.first_dense:
                per_layer += 3 * d * cfg.moe.d_first_dense
            else:
                mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
                per_layer += mult * d * cfg.d_ff
    enc = 0.0
    if cfg.encdec:
        enc = cfg.n_enc_layers * (4 * d * d + (2 if cfg.mlp == "gelu" else 3)
                                  * d * cfg.d_ff)
    return emb + per_layer + enc


def total_params(cfg) -> float:
    """All parameters (MoE counts every expert)."""
    if cfg.moe is None:
        return active_params(cfg)
    mo = cfg.moe
    d = cfg.d_model
    n_moe_layers = cfg.n_layers - mo.first_dense
    delta = 3 * d * mo.d_expert * (mo.n_experts - mo.top_k) * n_moe_layers
    return active_params(cfg) + delta


def analytic_memory(cfg, sc, n_dev: int, multi_pod: bool,
                    model_shards: int = 16) -> dict:
    """Per-device bytes of params, optimizer state, gradients, activations
    (remat boundaries and float32 logits) and caches, with the reference's
    terms; ``fits_80GB`` against the H100's 80 GB (``HBM_BYTES``).  The
    port's eager attention also holds each layer's float32 logits while it
    runs, which these terms leave out.  ``model_shards``: the model
    axis' extent (16 on both production meshes)."""
    n_total = total_params(cfg)
    d_model = cfg.d_model
    data_shards = n_dev // model_shards
    p_bytes = 2 * n_total / n_dev          # bf16 params, fully sharded
    opt_bytes = 8 * n_total / n_dev        # fp32 m+v
    grad_bytes = 4 * n_total / n_dev       # fp32 grads (transient)
    act = cache = 0.0
    if sc.kind == "train":
        toks_per_dev = sc.global_batch * sc.seq_len / data_shards
        L = cfg.n_layers
        act = toks_per_dev * d_model * 2 * (L + 2)   # remat boundaries bf16
        act += toks_per_dev * cfg.vocab * 4 / model_shards  # fp32 logits
    elif sc.kind == "prefill":
        toks_per_dev = sc.global_batch * sc.seq_len / data_shards
        act = toks_per_dev * d_model * 2 * (cfg.n_layers + 2)
        cache = _cache_bytes(cfg, sc) / n_dev
    else:
        cache = _cache_bytes(cfg, sc) / n_dev
        act = sc.global_batch * d_model * 2 * cfg.n_layers
    total = p_bytes + opt_bytes * (sc.kind == "train") \
        + grad_bytes * (sc.kind == "train") + act + cache
    return {"params_B": int(p_bytes), "opt_B": int(opt_bytes),
            "act_B": int(act), "cache_B": int(cache),
            "total_per_dev_B": int(total),
            "fits_80GB": bool(total < HBM_BYTES)}


def _cache_bytes(cfg, sc) -> float:
    B, S = sc.global_batch, sc.seq_len
    per_tok = 0.0
    kinds = cfg.pattern_for_layers()
    for kind in kinds:
        if kind == "attn" or kind == "xattn":
            if cfg.mla is not None:
                per_tok += 2 * (cfg.mla.kv_lora + cfg.mla.qk_rope_dim)
            else:
                per_tok += 2 * 2 * cfg.n_kv_heads * cfg.hd
        elif kind == "local":
            w = min(cfg.window or S, S)
            per_tok += 2 * 2 * cfg.n_kv_heads * cfg.hd * (w / S)
        elif kind in ("rglru", "rwkv"):
            pass  # O(1) state per sequence, counted below
    state = 0.0
    for kind in kinds:
        if kind == "rglru":
            state += 4 * cfg.d_model * 2
        elif kind == "rwkv":
            state += (cfg.d_model // 64) * 64 * 64 * 4 + 2 * cfg.d_model * 4
    return B * S * per_tok + B * state


def roofline_terms(res: dict, cfg, sc, n_dev: int) -> dict:
    """Seconds a step per device of each term, on the H100's rates:
    ``flops`` over ``PEAK_FLOPS``, ``bytes_accessed`` over ``HBM_BW``,
    the collectives' wire bytes over ``NVLINK_BW``."""
    cost = res.get("cost_corrected") or res.get("cost", {})
    if "error" in cost:
        cost = res.get("cost", {})
    coll = res.get("collectives", {})
    hlo_flops = cost.get("flops") or 0.0
    hlo_bytes = cost.get("bytes_accessed") or 0.0
    wire = coll.get("wire_bytes", 0) if isinstance(coll, dict) else 0
    mf = model_flops(cfg, sc)
    terms = {
        "compute_s": hlo_flops / PEAK_FLOPS,
        "memory_s": hlo_bytes / HBM_BW,
        "collective_s": wire / NVLINK_BW,
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "hlo_flops_per_dev": hlo_flops,
        "useful_flops_ratio": (mf / n_dev) / hlo_flops if hlo_flops else None,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    return terms
