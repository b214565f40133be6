"""seamless-m4t-large-v2 [audio]: enc-dec transformer backbone, 24L
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  The speech frontend is a
STUB per the assignment: input_specs() provides precomputed frame
embeddings for the encoder. [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    block_pattern=("attn",),
    norm="layernorm",
    mlp="gelu",
    tie_embeddings=True,
    encdec=True,
    n_enc_layers=24,
    modality_stub="audio",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, dtype="float32")
