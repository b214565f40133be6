"""Model/run configuration dataclasses for all assigned architectures.

A copy of the JAX package's ``configs/base.py`` with one difference:
``ModelConfig.compute_dtype`` is a ``torch.dtype``."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0
    capacity_factor: float = 1.25
    # 'auto' consults the SpTTN planner; 'grouped' = factorize-and-fuse
    # (sort + grouped GEMM); 'onehot' = unfactorized dense einsum baseline
    dispatch: Literal["auto", "grouped", "onehot"] = "auto"
    first_dense: int = 0          # leading layers with a dense FFN instead
    d_first_dense: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention dims."""
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None   # explicit (gemma3); default d_model//heads
    # block pattern repeated over layers, e.g. ("rglru","rglru","attn")
    block_pattern: tuple[str, ...] = ("attn",)
    window: int | None = None     # sliding-window size for 'local' blocks
    qkv_bias: bool = False
    norm: Literal["rmsnorm", "layernorm", "nonparam_ln"] = "rmsnorm"
    post_norms: bool = False      # gemma-style post-attn/ffn norms
    qk_norm: bool = False
    mlp: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mla_absorb: bool = True       # absorbed-matrix MLA decode (§Perf)
    rwkv: bool = False
    encdec: bool = False
    n_enc_layers: int = 0
    modality_stub: Literal["none", "vision", "audio"] = "none"
    n_stub_tokens: int = 256      # patch/frame embeddings from the stub
    dtype: str = "bfloat16"
    pad_vocab_to: int = 128       # pad embedding rows for TP divisibility
    logit_softcap: float = 0.0
    emb_scale: bool = False       # gemma-style sqrt(d_model) embed scaling

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return ((self.vocab + m - 1) // m) * m

    @property
    def compute_dtype(self):
        dtype = getattr(torch, self.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dtype

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid/linear-attn or mostly-windowed."""
        kinds = set(self.block_pattern)
        return bool(kinds & {"rglru", "rwkv", "local"})

    def pattern_for_layers(self, n: int | None = None) -> list[str]:
        n = n or self.n_layers
        p = []
        while len(p) < n:
            p.extend(self.block_pattern)
        return p[:n]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving hyperparameters used by launch drivers."""
    model: ModelConfig
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0
    microbatches: int = 1         # grad-accumulation steps
    remat: bool = True
    scan_unroll: bool = False     # dry-run cost probes unroll layer scans
    kv_cache_dtype: str = "bfloat16"
    seed: int = 0
