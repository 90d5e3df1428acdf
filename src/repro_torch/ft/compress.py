"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (EF21-ish).

PyTorch-port counterpart of ``repro.ft.compress``.  Each worker quantizes
its gradient to int8 with one scale a tensor, all-reduces the int8 payload
(4x less traffic than f32) and keeps the quantization residual, adding it
back into the next step's gradient: the error-feedback trick that restores
convergence.  The scale divides by 127 and the codes by the scale as IEEE
divisions on every device (``core/quant.py`` :func:`div127`), so the codes
and scales are the reference's bit for bit.  The all-reduce itself
(``compressed_psum``) is a training collective (ROADMAP A.14b).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.convert import tree_map
from repro_torch.core.quant import div127


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, 0-d f32 scale, new residual)."""
    gf = g.to(torch.float32) + residual
    scale = div127(torch.clamp_min(torch.amax(torch.abs(gf)), 1e-12))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.to(torch.float32) * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_residuals(grads: Any) -> Any:
    return tree_map(grads, lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                 device=g.device))
