"""The paper's own benchmark family (OPT, [2]) as runnable framework configs.

OPT-30B is the paper's headline model; opt-125m is a laptop-runnable sibling
used by the examples.  (The analytical TPOT models in repro.core.pimsim keep
their own lightweight OPTConfig.)"""
from repro_torch.configs.base import ModelConfig


def _opt(name, n_layers, d_model, n_heads) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=4 * d_model,
        vocab_size=50272,
        mlp_type="gelu",
        norm_type="layernorm",
        rope_theta=0.0,          # OPT uses learned positions; we use sinusoidal
        tie_embeddings=True,
    )


CONFIG = _opt("opt-30b", 48, 7168, 56)
OPT_125M = _opt("opt-125m", 12, 768, 12)
OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32)
