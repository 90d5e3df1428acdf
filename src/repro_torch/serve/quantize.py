"""Offline weight quantization: float checkpoint -> W8A8 'QLC-region' params.

PyTorch counterpart of ``repro.serve.quantize`` for the per-layer parameter
tree: static 2-D linears move into the dense flash as ``(name_q, name_s)``
pairs consumed by ``layers.apply_linear``, 3-D expert stacks under a
``"moe"`` dict become weight-only int8 with a scale for each (expert,
output channel), consumed by ``models/moe.py``, while controller-op
parameters (norms, embeddings, the router) and the ``lm_head`` stay in
floating point.  The leaf names equal the reference's (``wq_q/wq_s``, ...,
``w_down_q/w_down_s``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import quant

# 2-D [in, out] weights that become full W8A8 PIM linears
_SMVM_2D = {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "wkv_b",
            "w_up", "w_gate", "w_down", "w_z", "w_x", "out_proj", "w"}
# 3-D [E, in, out] expert stacks -> weight-only int8
_SMVM_3D = {"w_up", "w_gate", "w_down"}
# kept in float (controller ops / sensitive small projections)
_KEEP = {"router", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C"}


def _quantize_2d(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lin = quant.make_quantized_linear(w.to(torch.float32))
    return lin.w_q, lin.w_scale


def _quantize_3d(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[E, in, out] -> (int8 [E, in, out], f32 [E, out]): each expert's
    stack quantized per output channel over its ``in`` axis, as the
    reference's ``_quantize_3d``.  An expert goes through
    ``quant.quantize_weight`` (IEEE division by 127, blocks of at most
    ``QUANT_BLOCK`` elements), one at a time: an expert's scales and codes
    depend on that expert alone."""
    E, d_in, d_out = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((E, d_out), dtype=torch.float32, device=w.device)
    for e in range(E):
        qe, se = quant.quantize_weight(w[e].to(torch.float32), axis=0)
        q[e].copy_(qe)
        s[e].copy_(se)
    return q, s


def quantize_tree(params: Any, quantize_embed: bool = False) -> Any:
    """Recursively replace 2-D sMVM weights, and 3-D expert stacks under a
    ``"moe"`` dict, by (name_q, name_s) pairs.  A bare ``w`` (the
    ``lm_head``) and the ``router`` stay float, as in the reference; any
    other weight of more than two axes (a stack of layers) raises."""
    def rec(node, path):
        if isinstance(node, (list, tuple)):
            return type(node)(rec(e, path) for e in node)
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list, tuple)):
                out[k] = v if (k == "embed" and not quantize_embed) else rec(v, path + [k])
            elif isinstance(v, torch.Tensor) and k in _KEEP:
                out[k] = v
            elif (isinstance(v, torch.Tensor) and v.ndim == 3 and k in _SMVM_3D
                  and "moe" in path):
                out[k + "_q"], out[k + "_s"] = _quantize_3d(v)
            elif isinstance(v, torch.Tensor) and v.ndim > 2 and k in _SMVM_2D:
                raise NotImplementedError(
                    f"{'/'.join(path + [k])}: weights stacked over layers are not "
                    "ported (the port keeps one tree a layer)")
            elif (isinstance(v, torch.Tensor) and v.ndim == 2
                  and k in _SMVM_2D and k != "w"):
                out[k + "_q"], out[k + "_s"] = _quantize_2d(v)
            else:
                out[k] = v
        return out
    return rec(params, [])


def quantized_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(quantized_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_bytes(v) for v in tree)
    return 0
