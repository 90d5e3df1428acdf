"""Architecture registry: ``--arch <id>`` resolution.

Lists only the configurations the port serves so far; the rest of the
reference's catalogue joins as their model families are ported.
"""
from __future__ import annotations

from repro_torch.configs import llama3_8b, mamba2_2_7b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "llama3-8b": llama3_8b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
