"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H (kv=128 via MLA), MoE 256e
top-8 (+1 shared), moe_d_ff=2048, vocab=129280, MLA latent attention, MTP.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense FFN for the first_dense_layers
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mlp_type="swiglu",
    n_experts=256,
    n_experts_active=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mtp=True,
    notes="MLA compressed-latent KV cache; 1 shared + 256 routed top-8",
)
