"""Device selection shared by every entry point: no silent fallback."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_float32_precision() -> None:
    """Full float32 matmuls: the reference holds float stages to float32, so
    TF32 stays off for both cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
