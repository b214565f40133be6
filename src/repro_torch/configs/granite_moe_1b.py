"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8)
d_ff(expert)=512 vocab=49155, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    block_pattern=("attn",),
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=256, dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64))
