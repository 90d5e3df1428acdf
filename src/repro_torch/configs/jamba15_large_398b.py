"""jamba-1.5-large-398b [hybrid]: 72L, d_model=8192, 64H (kv=8), d_ff=24576,
MoE 16e top-2, vocab=65536; Mamba:attention 7:1 interleave (1 attention layer
per 8, at offset 4), MoE every other layer.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp_type="swiglu",
    n_experts=16,
    n_experts_active=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=8,
    attn_offset=4,
    notes="sub-quadratic: runs long_500k",
)
