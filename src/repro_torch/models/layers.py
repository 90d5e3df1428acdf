"""Shared neural building blocks (plain functions on dicts of tensors).

PyTorch counterpart of ``repro.models.layers``.  Every linear layer is a
dict ``{"w": [in, out]}`` (float path) or its quantized "QLC-region" form
``{"w_q", "w_s", ("smooth")}``.  ``apply_linear`` dispatches on the param
form and the execution backend: the W8A8 reference matmul, the B1 kernel
(``fused_int8``) or the bit-serial B5 kernel (``pim_bitserial``).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import int8_matmul as mm_ops
from repro_torch.kernels import layer_norm as ln_ops
from repro_torch.kernels import pim_mvm as pim_ops
from repro_torch.kernels import rms_norm as norm_ops

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initialisation helpers (torch.Generator streams, not jax.random's)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                    device=gen.device) * scale
    return {"w": w}


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Params:
    return {"w": torch.randn((vocab, d), generator=gen, dtype=dtype,
                             device=gen.device) * 0.02}


# ---------------------------------------------------------------------------
# linear dispatch (dense | quantized-ref | kernels)
# ---------------------------------------------------------------------------
def apply_linear(p: Params, x: torch.Tensor, backend: str = "dense") -> torch.Tensor:
    """x: [..., in] -> [..., out]."""
    if "w_q" in p:
        lin = quant.QuantizedLinear(w_q=p["w_q"], w_scale=p["w_s"],
                                    smooth=p.get("smooth"))
        if lin.smooth is not None:
            x = x * (1.0 / lin.smooth)
        x_q, x_s = quant.quantize_activation(x)
        if backend == "pim_bitserial":
            return pim_ops.pim_mvm(x_q, x_s, lin, out_dtype=x.dtype)
        if backend == "fused_int8":
            return mm_ops.int8_matmul(x_q, x_s, lin, out_dtype=x.dtype)
        return quant.int8_matmul_ref(x_q, x_s, lin, out_dtype=x.dtype)
    return torch.matmul(x, p["w"].to(x.dtype))


def quantize_linear_params(p: Params, act_amax: torch.Tensor | None = None) -> Params:
    lin = quant.make_quantized_linear(p["w"].to(torch.float32), act_amax)
    out = {"w_q": lin.w_q, "w_s": lin.w_scale}
    if lin.smooth is not None:
        out["smooth"] = lin.smooth
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(d: int, norm_type: str = "rmsnorm",
              device: str | torch.device = "cpu") -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Controller op (fp32 'ARM-core' path): always computed in fp32.

    Both norms run a row-invariant kernel on CUDA tensors under every
    backend, so a row normalises to the same bits whatever rows share the
    call: LayerNorm (``"bias" in p``) ``kernels/layer_norm.py``, RMSNorm
    ``kernels/rms_norm.py``.  On CPU tensors each takes its plain version
    (the reference's formula)."""
    if "bias" in p:
        return ln_ops.layer_norm(x, p["scale"], p["bias"], eps).to(x.dtype)
    return norm_ops.rms_norm(x, p["scale"], eps).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary positions
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: str | torch.device = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of RoPE's angles at ``positions`` ([B, T] or [T]),
    shaped [..., T, 1, head_dim / 2] to broadcast over heads."""
    freqs = rope_freqs(head_dim, theta, positions.device)        # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs       # [B, T, D/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] (or [T]); ``tables`` their
    :func:`rope_tables`, when the caller reuses them across layers."""
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal positions (the families with ``rope_theta == 0``: OPT)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _sinusoid_rate(d: int) -> float:
    """``-log(10000) / d`` rounded as the reference rounds it (each step in
    f32), computed on the host: a step being captured as a CUDA graph may
    not copy a new host tensor to the card."""
    return float(-torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d)


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at the positions ``pos`` (any shape, int or
    float) -> f32 [*pos.shape, d]: sin at even features, cos at odd ones.
    It reads the positions from the tensor, so a step captured as a CUDA
    graph computes them from its static ``pos`` buffer on every replay."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
                    * _sinusoid_rate(d))
    ang = pos.to(torch.float32)[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *ang.shape[:-1], d)


def sinusoidal_positions(seq: int, d: int, offset=0,
                         device: str | torch.device = "cpu") -> torch.Tensor:
    """The [seq, d] table of :func:`sinusoid_at` at ``offset + arange(seq)``
    (``offset`` an int or a 0-d tensor)."""
    return sinusoid_at(torch.arange(seq, device=device) + offset, d)


# ---------------------------------------------------------------------------
# MLPs: swiglu | gelu | relu2 (squared ReLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, ff: int, mlp_type: str,
             dtype=torch.float32) -> Params:
    p = {"w_up": dense_init(gen, d, ff, dtype)["w"],
         "w_down": dense_init(gen, ff, d, dtype)["w"]}
    if mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, d, ff, dtype)["w"]
    return p


def apply_mlp(p: Params, x: torch.Tensor, mlp_type: str,
              backend: str = "dense") -> torch.Tensor:
    up = apply_linear(_lin(p, "w_up"), x, backend)
    if mlp_type == "swiglu":
        gate = apply_linear(_lin(p, "w_gate"), x, backend)
        h = F.silu(gate) * up
    elif mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:  # gelu (jax.nn.gelu's default is the tanh approximation)
        h = F.gelu(up, approximate="tanh")
    return apply_linear(_lin(p, "w_down"), h, backend)


def _lin(p: Params, name: str) -> Params:
    """Fetch sub-linear ``name`` whether dense or quantized."""
    if name + "_q" in p:
        out = {"w_q": p[name + "_q"], "w_s": p[name + "_s"]}
        if name + "_smooth" in p:
            out["smooth"] = p[name + "_smooth"]
        return out
    return {"w": p[name]}


def quantize_named(p: Params, names: list[str]) -> Params:
    """Replace the listed [in,out] weights with their W8A8 'QLC' form."""
    out = dict(p)
    for n in names:
        if n not in p:
            continue
        q = quantize_linear_params({"w": p[n]})
        del out[n]
        out[n + "_q"], out[n + "_s"] = q["w_q"], q["w_s"]
    return out
