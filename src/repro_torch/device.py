"""Device selection shared by every entry point: no silent fallback."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda", meta: bool = False) -> torch.device:
    """Return ``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU.  ``meta`` (tensors with a
    shape and a dtype and no storage) is accepted only where the caller
    asks for it: the dry run's parameter trees and decode states."""
    dev = torch.device(device)
    if dev.type == "meta" and meta:
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device.  ``torch.randn``
    on ``meta`` accepts it and draws nothing, so an initializer that draws
    from ``gen`` on ``gen.device`` builds a tree with no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: str | torch.device, seed: int) -> torch.Generator:
    """The seeded ``torch.Generator`` a parameter initializer draws from,
    on ``device``; on ``meta`` a stand-in that allocates nothing (torch has
    no generator on ``meta``)."""
    dev = resolve(device, meta=True)
    if dev.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def set_float32_precision() -> None:
    """Full float32 matmuls: the reference holds float stages to float32, so
    TF32 stays off for both cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
