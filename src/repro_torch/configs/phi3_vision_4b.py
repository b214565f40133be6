"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP stub.  32L
d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  The vision frontend is a
STUB: input_specs() provides precomputed patch embeddings occupying the
first n_stub_tokens positions. [hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    block_pattern=("attn",),
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    modality_stub="vision",
    n_stub_tokens=256,
    rope_theta=500000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, n_stub_tokens=4, dtype="float32")
