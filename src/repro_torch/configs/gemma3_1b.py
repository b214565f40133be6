"""gemma3-1b [dense]: 26L d_model=1152 4H (MQA kv=1, head_dim=256)
d_ff=6912 vocab=262144.  5 local : 1 global pattern, 512-token window,
qk-norm, gemma post-norms. [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=512,
    norm="rmsnorm",
    post_norms=True,
    qk_norm=True,
    mlp="geglu",
    tie_embeddings=True,
    emb_scale=True,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256, window=16, dtype="float32")
