"""whisper-tiny [audio]: enc-dec, 4L, d_model=384, 6H (kv=6), d_ff=1536,
vocab=51865.  Conv frontend is a STUB: ``input_specs()`` feeds precomputed
frame embeddings (1500 x 384).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,           # 30 s of audio after the (stubbed) conv frontend
    d_model=384,
    n_heads=6,
    n_kv_heads=6,               # MHA
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions
    input_mode="embeddings",
    tie_embeddings=True,
    notes="audio frontend stubbed; sinusoidal encoder positions",
)
