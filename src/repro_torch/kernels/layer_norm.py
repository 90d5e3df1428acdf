"""LayerNorm with row-invariant reductions (``csrc/layer_norm.cu``) and its
plain version.

No TPU kernel stands behind it: the reference computes the norm in jnp
(``repro/models/layers.py::apply_norm``, the ``"bias"`` branch).  On the
card torch's ``mean`` and ``var`` sum a row in an order that depends on how
many rows the call holds, so a row normalised inside a verify window of B*T
rows and inside a decode step of B rows could differ in its last bits (as
torch's RMSNorm did, see ``kernels/rms_norm.py``).  The kernel
gives both of a row's sums one fixed order (one block per row, a fixed
per-thread order, a fixed xor butterfly and warp sums added in index
order), so a row's output does not depend on its neighbours.  It agrees
with the plain version within ``rtol=1e-6`` and an ``atol`` of 1e-6 times
the output's scale (the sums' order and ``rsqrtf``; an output near zero is
the difference of two rounded terms).  Bound: bytes (each element read and
written once).

The training path's gradient runs through :class:`LayerNormFunction`, whose
forward is the kernel (saving each row's mean and ``rstd``) and whose
backward is a second hand kernel of the same source
(``layer_norm_backward_cuda``): one launch in clusters of 8 blocks; rows of
up to 1,024 a warp a row (its sums by a warp's butterfly, no block
barrier), wider rows a block a row; ``dscale`` and ``dbias`` summed over a
block's warps, then the cluster's blocks, then the clusters, in fixed
orders (no float atomics), the last block of each column share found by a
ticket (:func:`repro_torch.kernels.tickets`).  Its plain version is
autograd through :func:`layer_norm_plain`.

The serve path's LayerNorms whose output feeds quantized linears (OPT's
``ln1`` and ``ln2``, whisper's decoder ``ln1``, ``ln_x`` and ``ln2``) run a
third entry of the same source, the forward fused with the per-row int8
quantizer (:func:`layer_norm_quant`): one launch of the forward's body
writes the normed rows (the forward's bits), their int8 codes and each
row's scale, the bits of ``quantize_activation`` over the forward's
output.  Its plain version is that pair of calls.  Each wrapper counts its
own launches: ``launches`` the forward, ``quant_launches`` the fused entry,
``backward_launches`` the backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.kernels import _build

launches = 0
quant_launches = 0
backward_launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``(x - mean) * rsqrt(var + eps) * scale
    + bias``, ``var`` the mean of squared deviations (as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mu) * torch.rsqrt(var + eps) * scale + bias


def layer_norm_quant_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h f32 [..., d], codes int8 [..., d], scales f32 [..., 1]): the norm
    :func:`layer_norm_plain` and ``quantize_activation`` of its output."""
    h = layer_norm_plain(x, scale, bias, eps)
    return (h, *quant.quantize_activation(h))


def layer_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              g: torch.Tensor, eps: float = 1e-5
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx f32 [..., d], dscale f32 [d], dbias f32 [d]) of
    :func:`layer_norm_plain` for the output gradient ``g``: autograd
    through it."""
    with torch.enable_grad():
        xr = x.detach().to(torch.float32).requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        br = bias.detach().requires_grad_(True)
        return torch.autograd.grad(layer_norm_plain(xr, sr, br, eps), (xr, sr, br), g)


CLUSTER = 8           # blocks of a backward cluster (csrc/layer_norm.cu's CL)
WARPS = 8             # warps of a backward block
WARP_ROWS_D = 1024    # rows up to this wide: a warp a row in the backward
MAX_BACKWARD_D = 24576


def backward_grid(M: int, d: int, clusters: int) -> tuple[int, int]:
    """(blocks, rows a block) of the backward at [M, d] when the card holds
    ``clusters`` clusters of :data:`CLUSTER` blocks at once: one wave of
    them at most, consecutive rows a block (a multiple of :data:`WARPS`
    where a warp takes a row), whole clusters, none empty."""
    rows = -(-M // (max(1, clusters) * CLUSTER))
    if d <= WARP_ROWS_D:
        rows = -(-rows // WARPS) * WARPS
    blocks = -(-M // rows)
    return -(-blocks // CLUSTER) * CLUSTER, rows


def backward_scratch(M: int, d: int, clusters: int) -> dict[str, tuple[int, ...]]:
    """Shapes of what a backward call at [M, d] allocates beside ``dx``:
    ``dparams`` (dscale and dbias), the clusters' partial sums ``part``
    and the ``tickets`` kept on the device."""
    blocks, _ = backward_grid(M, d, clusters)
    return {"dparams": (2, d), "part": (blocks // CLUSTER, 2 * d), "tickets": (CLUSTER,)}


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, d: int) -> int:
    """The clusters of the backward the card holds at once for rows of d
    (asked of the CUDA runtime)."""
    with torch.cuda.device(device_index):
        n = _lib().layer_norm_backward_max_clusters(d)
    if n < 1:
        raise RuntimeError(f"layer_norm_backward: no cluster of {CLUSTER} blocks fits at d={d}")
    return n


def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    fn = lib.layer_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.layer_norm_backward_launch
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.layer_norm_backward_max_clusters.argtypes = [ctypes.c_int]
        lib.layer_norm_backward_max_clusters.restype = ctypes.c_int
        fused = lib.layer_norm_quant_launch
        fused.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fused.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as a contiguous f32 [M, d] matrix the kernels take."""
    d = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, d).contiguous()
    if x2.shape[0] < 1 or d < 1 or x2.numel() >= 2 ** 31:
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)}")
    return x2


def layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5, with_stats: bool = False):
    """Launch the kernel on CUDA tensors; same contract as
    :func:`layer_norm_plain`.  With ``with_stats`` it returns ``(out, mean,
    rstd)``, each f32 [M]: every row's mean and ``rsqrt(var + eps)`` as the
    kernel computed them (the output's bits are the same either way)."""
    global launches
    x2 = _rows(x, "layer_norm")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    KN.require(bias, "bias", torch.float32, (d,))
    out = torch.empty_like(x2)
    stats = (torch.empty((2, M), dtype=torch.float32, device=x2.device) if with_stats
             else None)
    err = _lib().layer_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(bias), KN.ptr(out),
                                   KN.ptr(stats[0]) if with_stats else None,
                                   KN.ptr(stats[1]) if with_stats else None,
                                   M, d, eps, KN.stream(x2))
    KN.check(err, "layer_norm")
    launches += 1
    out = out.reshape(x.shape)
    return (out, stats[0], stats[1]) if with_stats else out


def layer_norm_quant_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-5
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused entry on CUDA tensors; same contract as
    :func:`layer_norm_quant_plain`, bit for bit: ``h`` is
    :func:`layer_norm_cuda`'s output, the codes and scales
    ``quantize_activation(h)``'s."""
    global quant_launches
    x2 = _rows(x, "layer_norm_quant")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    KN.require(bias, "bias", torch.float32, (d,))
    out = torch.empty_like(x2)
    codes = torch.empty((M, d), dtype=torch.int8, device=x2.device)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    err = _lib().layer_norm_quant_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(bias), KN.ptr(out),
                                         KN.ptr(codes), KN.ptr(scales), M, d, eps,
                                         KN.stream(x2))
    KN.check(err, "layer_norm_quant")
    quant_launches += 1
    return (out.reshape(x.shape), codes.reshape(x.shape),
            scales.reshape(*x.shape[:-1], 1))


def layer_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                             eps: float = 1e-5, mean: torch.Tensor | None = None,
                             rstd: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on CUDA tensors -> (dx, dscale, dbias),
    the contract of :func:`layer_norm_backward_plain` (the bias does not
    enter the gradient).  ``mean`` and ``rstd`` (f32 [M] each, from
    ``layer_norm_cuda(..., with_stats=True)`` on the same x) spare the
    kernel the forward's two sums; without them it recomputes them in the
    forward's order, to the same bits.  The call can be captured in a CUDA
    graph once it has run outside a capture on the device (which makes the
    device's tickets); calls on one device must not overlap in time."""
    global backward_launches
    x2, g2 = _rows(x, "layer_norm_backward"), _rows(g, "layer_norm_backward")
    M, d = x2.shape
    if d > MAX_BACKWARD_D:
        raise ValueError(f"layer_norm_backward: rows of {d} > {MAX_BACKWARD_D}")
    if (mean is None) != (rstd is None):
        raise ValueError("layer_norm_backward: mean and rstd come together")
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(g2, "g", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    if mean is not None:
        KN.require(mean, "mean", torch.float32, (M,))
        KN.require(rstd, "rstd", torch.float32, (M,))
    clusters = _max_clusters(x2.device.index, d)
    blocks, rows = backward_grid(M, d, clusters)
    shapes = backward_scratch(M, d, clusters)
    dx = torch.empty_like(x2)
    dparams = torch.empty(shapes["dparams"], dtype=torch.float32, device=x2.device)
    part = torch.empty(shapes["part"], dtype=torch.float32, device=x2.device)
    tickets = KN.tickets(x2.device, "layer_norm_backward", CLUSTER)
    err = _lib().layer_norm_backward_launch(
        KN.ptr(x2), KN.ptr(scale), KN.ptr(g2), KN.ptr(mean) if mean is not None else None,
        KN.ptr(rstd) if rstd is not None else None, KN.ptr(dx), KN.ptr(dparams),
        KN.ptr(part), KN.ptr(tickets), M, d, blocks, rows, eps, KN.stream(x2))
    KN.check(err, "layer_norm_backward")
    backward_launches += 1
    return dx.reshape(x.shape), dparams[0], dparams[1]


class LayerNormFunction(torch.autograd.Function):
    """The kernel with its backward kernel: what the training path's
    LayerNorms run on the card (the forward's output alone would have no
    ``grad_fn``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
        out, mean, rstd = layer_norm_cuda(x, scale, bias, eps, with_stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward_cuda(x, scale, g, ctx.eps, mean, rstd)
        return dx.to(x.dtype), dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The kernel on CUDA tensors (through :class:`LayerNormFunction` where
    a gradient is being recorded), the plain version on CPU tensors."""
    if KN.on_cuda(x, scale, bias):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
            return LayerNormFunction.apply(x, scale, bias, eps)
        return layer_norm_cuda(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)


def layer_norm_quant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused entry on CUDA tensors, its plain version on CPU tensors:
    (h, codes, scales)."""
    if KN.on_cuda(x, scale, bias):
        return layer_norm_quant_cuda(x, scale, bias, eps)
    return layer_norm_quant_plain(x, scale, bias, eps)
