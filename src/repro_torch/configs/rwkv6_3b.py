"""rwkv6-3b [ssm]: Finch, 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536; data-dependent decay WKV6 recurrence. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # 2560 / 64 WKV heads
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    norm="layernorm",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab=256, dtype="float32")
