"""grok-1-314b [moe]: 64L, d_model=6144, 48H (kv=8), d_ff=32768, MoE 8e top-2,
vocab=131072.  [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp_type="swiglu",      # 3-matrix experts: matches the published 314B total
    n_experts=8,
    n_experts_active=2,
    moe_d_ff=32768,
)
