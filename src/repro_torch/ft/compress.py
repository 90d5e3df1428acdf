"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (EF21-ish).

PyTorch-port counterpart of ``repro.ft.compress``.  Each worker quantizes
its gradient to int8 with one scale a tensor, all-reduces the int8 payload
(4x less traffic than f32) and keeps the quantization residual, adding it
back into the next step's gradient: the error-feedback trick that restores
convergence.  The scale divides by 127 and the codes by the scale as IEEE
divisions on every device (``core/quant.py`` :func:`div127`), so the codes
and scales are the reference's bit for bit.  :func:`compressed_psum` is the
all-reduce over a mesh axis' group: the int8 codes summed exactly in
int32, the scales' max, and the sum divided by the group's size (an IEEE
division), as the reference's ``compressed_psum`` computes it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core.quant import div127
from repro_torch.dist import collectives as C


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


def compressed_psum(grads: Any, residuals: Any, group) -> tuple[Any, Any]:
    """The error-feedback compressed all-reduce of a gradient tree over
    ``group`` (a mesh axis' ``launch.mesh.AxisGroup``, in practice the data
    axes) -> (the mean gradient tree, the new residuals): each leaf
    :func:`compress`-ed on the rank, its codes summed in int32 over the
    group (exact in any order), the scales' max taken, and
    ``float(sum) * max_scale / size``."""
    size = torch.full((), float(group.size), device=tree_leaves(grads)[0].device)

    def one(g, r):
        q, sc, nr = compress(g, r)
        acc = C.all_reduce(q.to(torch.int32), group)
        smax = C.all_reduce(sc, group, "max")
        return acc.to(torch.float32) * smax / size, nr

    outs = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    means, res = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return tree_map(grads, lambda _: next(means)), tree_map(grads, lambda _: next(res))
