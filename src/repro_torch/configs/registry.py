"""Architecture registry: ``--arch <id>`` resolution.

Lists only the configurations the port serves so far, under the
reference's ids; the rest of the reference's catalogue joins as their model
families are ported.
"""
from __future__ import annotations

from repro_torch.configs import granite3_8b, llama3_8b, mamba2_2_7b, opt, phi3_mini_3_8b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "granite-3-8b": granite3_8b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    # the paper's own model family
    "opt-30b": opt.CONFIG,
    "opt-125m": opt.OPT_125M,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
