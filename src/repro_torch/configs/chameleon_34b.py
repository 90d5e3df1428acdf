"""chameleon-34b [vlm]: 48L, d_model=8192, 64H (kv=8), d_ff=22016,
vocab=65536, early-fusion VQ image tokens, QK-norm.  [arXiv:2405.09818;
unverified].  The VQ image tokenizer is a STUB: the backbone takes
precomputed patch/token embeddings (or token ids); it is a dense LM."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    mlp_type="swiglu",
    use_qk_norm=True,
    input_mode="embeddings",
    notes="early fusion; VQ frontend stubbed as precomputed embeddings",
)
