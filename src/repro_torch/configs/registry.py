"""Architecture registry: ``--arch <id>`` resolution.

Every configuration of the reference's catalogue, under the reference's
ids.
"""
from __future__ import annotations

from repro_torch.configs import (chameleon_34b, deepseek_v3_671b, granite3_8b, grok1_314b,
                                 jamba15_large_398b, llama3_8b, mamba2_2_7b, nemotron4_340b,
                                 opt, phi3_mini_3_8b, whisper_tiny)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "whisper-tiny": whisper_tiny.CONFIG,
    "nemotron-4-340b": nemotron4_340b.CONFIG,
    "granite-3-8b": granite3_8b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "grok-1-314b": grok1_314b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "jamba-1.5-large-398b": jamba15_large_398b.CONFIG,
    # the paper's own model family
    "opt-30b": opt.CONFIG,
    "opt-125m": opt.OPT_125M,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
