"""RMSNorm with a row-invariant reduction (``csrc/rms_norm.cu``) and its
plain version.

No TPU kernel stands behind it: the reference computes the norm in jnp
(``repro/models/layers.py::apply_norm``).  On the card torch's ``mean``
sums a row in an order that depends on how many rows the call holds, so a
row normalised inside a verify window of B*T rows and inside a decode step
of B rows could differ in its last bits.  The kernel gives every row one
fixed summation order (one block per row, a fixed tree over a fixed thread
count), so a row's output does not depend on its neighbours; it agrees
with the plain version within ``rtol=1e-6`` (the sum's order and
``rsqrtf``).  Bound: bytes (each element read and written once).

The training path's gradient runs through :class:`RMSNormFunction`, whose
forward is the kernel (saving each row's ``rstd``) and whose backward is a
second hand kernel of the same source (``rms_norm_backward_cuda``): one
launch in clusters of 8 blocks, each block a fixed range of rows held in
registers while its dot is reduced, ``dscale`` summed over blocks, then
clusters, in fixed orders (no float atomics), the last block of each
column share found by a ticket (:func:`repro_torch.kernels.tickets`).  Its
plain version is autograd through :func:`rms_norm_plain`.

The serve path's norms whose output feeds quantized linears run a third
entry of the same source, the forward fused with the per-row int8
quantizer (:func:`rms_norm_quant`): one launch writes the normed rows (the
forward's bits), their int8 codes and each row's scale, the bits of
``quantize_activation`` over the forward's output, which every such linear
would otherwise run on its own (eight torch kernels a linear).  Its plain
version is that pair of calls.  Each wrapper counts its own launches:
``launches`` the forward, ``quant_launches`` the fused entry,
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


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``x * rsqrt(mean(x^2) + eps) * scale``."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * scale


def rms_norm_quant_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h f32 [..., d], codes int8 [..., d], scales f32 [..., 1]): the norm
    :func:`rms_norm_plain` and ``quantize_activation`` of its output."""
    h = rms_norm_plain(x, scale, eps)
    return (h, *quant.quantize_activation(h))


def rms_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx f32 [..., d], dscale f32 [d]) of :func:`rms_norm_plain` at ``x``,
    ``scale`` for the output gradient ``g``: autograd through it."""
    with torch.enable_grad():
        xr = x.detach().to(torch.float32).requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        return torch.autograd.grad(rms_norm_plain(xr, sr, eps), (xr, sr), g)


CLUSTER = 8           # blocks of a backward cluster (csrc/rms_norm.cu's CL)
MAX_BACKWARD_D = 49152


def backward_grid(M: int, d: int, clusters: int) -> tuple[int, int]:
    """(blocks, rows a block) of the backward at [M, d] when the card holds
    ``clusters`` clusters of :data:`CLUSTER` blocks at once: one wave of
    them at most, consecutive rows a block, whole clusters, none empty."""
    rows = -(-M // (max(1, clusters) * CLUSTER))
    blocks = -(-M // rows)
    return -(-blocks // CLUSTER) * CLUSTER, rows


@functools.lru_cache(maxsize=None)
def _max_clusters(device_index: int, d: int) -> int:
    """The clusters of the backward the card holds at once for rows of d
    (asked of the CUDA runtime)."""
    with torch.cuda.device(device_index):
        n = _lib().rms_norm_backward_max_clusters(d)
    if n < 1:
        raise RuntimeError(f"rms_norm_backward: no cluster of {CLUSTER} blocks fits at d={d}")
    return n


def _lib() -> ctypes.CDLL:
    lib = _build.load("rms_norm")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.rms_norm_backward_launch
        bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.rms_norm_backward_max_clusters.argtypes = [ctypes.c_int]
        lib.rms_norm_backward_max_clusters.restype = ctypes.c_int
        fused = lib.rms_norm_quant_launch
        fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
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


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                  with_rstd: bool = False):
    """Launch the kernel on CUDA tensors; same contract as
    :func:`rms_norm_plain`.  With ``with_rstd`` it returns ``(out, rstd)``,
    ``rstd`` f32 [M] each row's ``rsqrt(mean(x^2) + eps)`` as the kernel
    computed it (the output's bits are the same either way)."""
    global launches
    x2 = _rows(x, "rms_norm")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    out = torch.empty_like(x2)
    rstd = torch.empty((M,), dtype=torch.float32, device=x2.device) if with_rstd else None
    err = _lib().rms_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(out),
                                 KN.ptr(rstd) if with_rstd else None, M, d, eps,
                                 KN.stream(x2))
    KN.check(err, "rms_norm")
    launches += 1
    return (out.reshape(x.shape), rstd) if with_rstd else out.reshape(x.shape)


def rms_norm_quant_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused entry on CUDA tensors; same contract as
    :func:`rms_norm_quant_plain`, bit for bit: ``h`` is
    :func:`rms_norm_cuda`'s output, the codes and scales
    ``quantize_activation(h)``'s."""
    global quant_launches
    x2 = _rows(x, "rms_norm_quant")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    out = torch.empty_like(x2)
    codes = torch.empty((M, d), dtype=torch.int8, device=x2.device)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    err = _lib().rms_norm_quant_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(out), KN.ptr(codes),
                                       KN.ptr(scales), M, d, eps, KN.stream(x2))
    KN.check(err, "rms_norm_quant")
    quant_launches += 1
    return (out.reshape(x.shape), codes.reshape(x.shape),
            scales.reshape(*x.shape[:-1], 1))


def rms_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                           eps: float = 1e-5, rstd: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on CUDA tensors; same contract as
    :func:`rms_norm_backward_plain`.  ``rstd`` (f32 [M], from
    ``rms_norm_cuda(..., with_rstd=True)`` on the same x) spares the kernel
    the sum of squares; without it the kernel recomputes it in the forward's
    order, to the same bits.  The call can be captured in a CUDA graph once
    it has run outside a capture on the device (which makes the device's
    tickets); calls on one device must not overlap in time."""
    global backward_launches
    x2, g2 = _rows(x, "rms_norm_backward"), _rows(g, "rms_norm_backward")
    M, d = x2.shape
    if d > MAX_BACKWARD_D:
        raise ValueError(f"rms_norm_backward: rows of {d} > {MAX_BACKWARD_D}")
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(g2, "g", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    if rstd is not None:
        KN.require(rstd, "rstd", torch.float32, (M,))
    blocks, rows = backward_grid(M, d, _max_clusters(x2.device.index, d))
    dx = torch.empty_like(x2)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    part = torch.empty((blocks // CLUSTER, d), dtype=torch.float32, device=x2.device)
    tickets = KN.tickets(x2.device, "rms_norm_backward", CLUSTER)
    err = _lib().rms_norm_backward_launch(
        KN.ptr(x2), KN.ptr(scale), KN.ptr(g2), KN.ptr(rstd) if rstd is not None else None,
        KN.ptr(dx), KN.ptr(dscale), KN.ptr(part), KN.ptr(tickets), M, d, blocks, rows, eps,
        KN.stream(x2))
    KN.check(err, "rms_norm_backward")
    backward_launches += 1
    return dx.reshape(x.shape), dscale


class RMSNormFunction(torch.autograd.Function):
    """The kernel with its backward kernel: what the training path's norms
    run on the card (the forward's output alone would have no
    ``grad_fn``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        out, rstd = rms_norm_cuda(x, scale, eps, with_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rms_norm_backward_cuda(x, scale, g, ctx.eps, rstd)
        return dx.to(x.dtype), dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The kernel on CUDA tensors (through :class:`RMSNormFunction` where a
    gradient is being recorded), the plain version on CPU tensors."""
    if KN.on_cuda(x, scale):
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return RMSNormFunction.apply(x, scale, eps)
        return rms_norm_cuda(x, scale, eps)
    return rms_norm_plain(x, scale, eps)


def rms_norm_quant(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused entry on CUDA tensors, its plain version on CPU tensors:
    (h, codes, scales)."""
    if KN.on_cuda(x, scale):
        return rms_norm_quant_cuda(x, scale, eps)
    return rms_norm_quant_plain(x, scale, eps)
