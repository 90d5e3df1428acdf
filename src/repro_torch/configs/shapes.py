"""Assigned input-shape set (one per arch x shape cell).

PyTorch-port copy of ``repro.configs.shapes`` (the port imports nothing of
the reference package).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a
seq_len KV cache), not ``train_step``.  ``long_500k`` requires sub-quadratic
attention and only runs for SSM/hybrid archs (skips noted in DESIGN.md).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention; long_500k needs sub-quadratic decode"
    return True, ""


def cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str]]:
    out = []
    for arch, cfg in configs.items():
        for sname, shape in SHAPES.items():
            ok, _ = applicable(cfg, shape)
            if ok:
                out.append((arch, sname))
    return out
