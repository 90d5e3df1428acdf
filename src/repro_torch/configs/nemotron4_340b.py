"""nemotron-4-340b [dense]: 96L, d_model=18432, 96H (kv=8), d_ff=73728,
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
)
