"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512,
d_ff(expert)=1536 vocab=102400, 160 routed experts top-6 + 2 shared,
first layer dense (d_ff=12288). [arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab=102400,
    block_pattern=("attn",),
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536,
                  n_shared=2, d_shared=1536,
                  first_dense=1, d_first_dense=12288),
    mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab=256, dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      d_shared=32, first_dense=1, d_first_dense=128),
        mla=MLAConfig(kv_lora=32, q_lora=48, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16))
