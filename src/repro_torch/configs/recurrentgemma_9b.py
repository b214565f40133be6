"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 attn:recurrent
pattern.  38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    norm="rmsnorm",
    mlp="geglu",
    tie_embeddings=True,
    emb_scale=True,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256, window=16, dtype="float32")
