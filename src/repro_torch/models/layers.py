"""Shared neural building blocks (plain functions on dicts of tensors).

PyTorch counterpart of ``repro.models.layers``.  Every linear layer is a
dict ``{"w": [in, out]}`` (float path) or its quantized "QLC-region" form
``{"w_q", "w_s", ("smooth")}``.  ``apply_linear`` dispatches on the param
form and the execution backend: the W8A8 reference matmul, the B1 kernel
(``fused_int8``) or the bit-serial B5 kernel (``pim_bitserial``).  Under
the two kernel backends a norm whose output feeds quantized linears
(:func:`apply_norm_q`) hands them its int8 pair, written by the norm's
entry fused with the activation quantizer.

On a mesh (``Runtime.mesh``) a column-parallel linear is the same call on
the rank's block of output columns; a row-parallel one (``wo``,
``w_down``) takes a :class:`RowReduce` and sums the ranks' partial
products over the model axis, with the integer stages kept exact: the
activation quantizer's ``amax`` is all-reduced with MAX (each rank's codes
and scale are the one-device quantizer's), the rank's int32 partial
accumulator is all-reduced (exact in any order, so ``psum`` and ``htree``
give the same bits) and the epilogue ``acc * x_s * w_s`` runs after it, in
the plain version's order.  Under ``dense`` the float partials are summed
and may differ from one device in the last bits.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.dist import collectives as C
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
# the backends whose quantized linears take a norm output's int8 pair from
# the norm (:func:`apply_norm_q`) instead of quantizing it each
PAIR_BACKENDS = ("fused_int8", "pim_bitserial")
MLP_INPUTS = ("w_up", "w_gate")      # an MLP's linears that read its input


class RowReduce(NamedTuple):
    """A row-parallel linear's reduction: the model axis' process group
    (``launch.mesh.AxisGroup``) and the collective (``psum`` | ``htree``);
    under sequence parallelism (``Runtime.seq_shard``, training) ``scatter``
    is the sequence dim, along which the float partials are
    reduce-scattered instead (each rank keeps its block of the rows)."""
    group: Any
    collective: str = "psum"
    scatter: int | None = None


def _row_parallel(p: Params, x: torch.Tensor, backend: str, red: RowReduce,
                  x_q: tuple | None = None) -> torch.Tensor:
    """:func:`apply_linear` of a rank's block of input rows (``x``'s last
    dim and ``p``'s weight rows are the rank's block of K), summed over
    ``red.group``.  ``x_q``: the block's codes and the whole row's scales,
    where the caller quantized the whole row (the quantizer's bits, so the
    ``amax`` all-reduce is skipped)."""
    if "w_q" not in p:
        part = torch.matmul(x, p["w"].to(x.dtype))
        if red.scatter is not None:
            return C.reduce_scatter(part, red.group, red.scatter)
        return C.allreduce(part, red.group, red.collective)
    if red.scatter is not None:
        raise NotImplementedError("sequence-parallel row-parallel linears are float "
                                  "(training)")
    if p.get("smooth") is not None:
        raise NotImplementedError("a smoothed row-parallel linear on a mesh")
    if x_q is not None:
        x_q, x_s = x_q
    else:
        amax = C.all_reduce(x.abs().amax(dim=-1, keepdim=True), red.group, "max")
        x_s = quant._scale(amax)
        x_q = torch.clamp(torch.round(x / x_s), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    xq2, xs2 = x_q.reshape(-1, x.shape[-1]).contiguous(), x_s.reshape(-1, 1).contiguous()
    if backend == "pim_bitserial":
        _, acc = pim_ops.pim_mvm_2d(xq2, xs2, p["w_q"], p["w_s"], with_acc=True)
    elif backend == "fused_int8":
        _, acc = mm_ops.int8_matmul_2d(xq2, xs2, p["w_q"], p["w_s"], with_acc=True)
    else:
        acc = quant.exact_int_matmul(xq2, p["w_q"])
    acc = C.allreduce(acc, red.group, red.collective)
    out = acc.to(torch.float32) * xs2 * p["w_s"]
    return out.reshape(*lead, out.shape[-1]).to(x.dtype)


def apply_linear(p: Params, x: torch.Tensor, backend: str = "dense",
                 x_q: tuple[torch.Tensor, torch.Tensor] | None = None,
                 reduce: RowReduce | None = None) -> torch.Tensor:
    """x: [..., in] -> [..., out].  ``x_q``: x's per-row int8 codes and
    scales (``quantize_activation(x)``'s bits) where the caller has them
    (:func:`apply_norm_q`); a quantized linear without ``smooth`` takes them
    instead of quantizing x again.  ``reduce``: the linear is row-parallel
    on a mesh (see the module's docstring)."""
    if reduce is not None:
        return _row_parallel(p, x, backend, reduce, x_q)
    if "w_q" in p:
        lin = quant.QuantizedLinear(w_q=p["w_q"], w_scale=p["w_s"],
                                    smooth=p.get("smooth"))
        if lin.smooth is not None:
            x, x_q = x * (1.0 / lin.smooth), None
        x_q, x_s = x_q if x_q is not None else quant.quantize_activation(x)
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


def apply_norm_q(p: Params, x: torch.Tensor, backend: str, readers: Params,
                 names: tuple[str, ...], eps: float = 1e-5
                 ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """:func:`apply_norm` and, for the linears ``names`` of ``readers`` that
    read its output, that output's per-row int8 pair (codes, scales): under
    :data:`PAIR_BACKENDS` where one of them is quantized without
    ``smooth`` and the rows are f32 (what the fused kernel takes), else
    None.  The norm writes the pair in the same launch (``rms_norm_quant``
    of ``kernels/rms_norm.py``, ``layer_norm_quant`` of
    ``kernels/layer_norm.py``).  The pair is ``quantize_activation`` of the
    output, bit for bit, so each reader computes what it would from the
    float rows, one quantizer a norm output instead of one a linear."""
    takes = any(n + "_q" in readers and n + "_smooth" not in readers for n in names)
    if not (takes and backend in PAIR_BACKENDS and x.dtype == torch.float32):
        return apply_norm(p, x, eps), None
    if "bias" in p:
        h, x_q, x_s = ln_ops.layer_norm_quant(x, p["scale"], p["bias"], eps)
    else:
        h, x_q, x_s = norm_ops.rms_norm_quant(x, p["scale"], eps)
    return h, (x_q, x_s)


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


def apply_rope_spmd(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """:func:`apply_rope`'s rotation written as a per-position [D, D]
    rotation *contraction* instead of rotate-half's split and concat, the
    form the reference's prefill takes under a mesh (its partitioner
    mis-partitions the concat of a deferred partial sum); the port's mesh
    prefill takes it too, so both meshes' float K/V part from one device's
    by the same ulps."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs          # [B, T, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    i = torch.arange(half, device=x.device)
    rot = torch.zeros((*ang.shape[:-1], d, d), dtype=torch.float32, device=x.device)
    rot[..., i, i] = cos
    rot[..., half + i, i] = -sin
    rot[..., i, half + i] = sin
    rot[..., half + i, half + i] = cos
    out = torch.einsum("...thd,...tde->...the", x.to(torch.float32), rot)
    return out.to(x.dtype)


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


def apply_mlp(p: Params, x: torch.Tensor, mlp_type: str, backend: str = "dense",
              x_q: tuple[torch.Tensor, torch.Tensor] | None = None,
              reduce: RowReduce | None = None) -> torch.Tensor:
    """The MLP over ``x``; ``x_q`` its int8 pair for ``w_up`` and ``w_gate``
    (see :func:`apply_linear`); ``reduce``: on a mesh, the FFN dim is split
    over the model axis (``w_up`` / ``w_gate`` column-parallel, ``w_down``
    row-parallel)."""
    up = apply_linear(_lin(p, "w_up"), x, backend, x_q)
    if mlp_type == "swiglu":
        gate = apply_linear(_lin(p, "w_gate"), x, backend, x_q)
        h = F.silu(gate) * up
    elif mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:  # gelu (jax.nn.gelu's default is the tanh approximation)
        h = F.gelu(up, approximate="tanh")
    return apply_linear(_lin(p, "w_down"), h, backend, reduce=reduce)


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
