"""mamba2-2.7b [ssm]: 64L, d_model=2560, attention-free, ssm_state=128,
vocab=50280, SSD (state-space duality).  [arXiv:2405.21060; unverified]

The paper's dMVM machinery is inapplicable (no KV cache / QK^T / SV); the
constant-size SSD state plays the SLC fast-write role.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # attention-free, no separate FFN
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    notes="sub-quadratic: runs long_500k; dMVM inapplicable",
)
