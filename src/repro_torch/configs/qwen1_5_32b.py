"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-32B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    block_pattern=("attn",),
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256, dtype="float32")
