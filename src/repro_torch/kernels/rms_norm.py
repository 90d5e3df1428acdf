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
forward is the kernel and whose backward is a second hand kernel of the
same source (``rms_norm_backward_cuda``): ``dx`` a row at a time in the
forward's summation order, ``dscale`` summed over rows in a fixed order
(no atomics).  Its plain version is autograd through
:func:`rms_norm_plain`.  Each wrapper counts its own launches:
``launches`` the forward, ``backward_launches`` the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build

launches = 0
backward_launches = 0


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``x * rsqrt(mean(x^2) + eps) * scale``."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * scale


def rms_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx f32 [..., d], dscale f32 [d]) of :func:`rms_norm_plain` at ``x``,
    ``scale`` for the output gradient ``g``: autograd through it."""
    with torch.enable_grad():
        xr = x.detach().to(torch.float32).requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        return torch.autograd.grad(rms_norm_plain(xr, sr, eps), (xr, sr), g)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rms_norm")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.rms_norm_backward_launch
        bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.rms_norm_backward_rows.argtypes = []
        lib.rms_norm_backward_rows.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as a contiguous f32 [M, d] matrix the kernels take."""
    d = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, d).contiguous()
    if x2.shape[0] < 1 or d < 1 or x2.numel() >= 2 ** 31:
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)}")
    return x2


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; same contract as
    :func:`rms_norm_plain`."""
    global launches
    x2 = _rows(x, "rms_norm")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    out = torch.empty_like(x2)
    err = _lib().rms_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(out), M, d,
                                 eps, KN.stream(x2))
    KN.check(err, "rms_norm")
    launches += 1
    return out.reshape(x.shape)


def rms_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                           eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors; same contract as
    :func:`rms_norm_backward_plain`."""
    global backward_launches
    x2, g2 = _rows(x, "rms_norm_backward"), _rows(g, "rms_norm_backward")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(g2, "g", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    lib = _lib()
    rows = lib.rms_norm_backward_rows()
    dx = torch.empty_like(x2)
    dscale = torch.empty((d,), dtype=torch.float32, device=x2.device)
    partial = torch.empty((-(-M // rows), d), dtype=torch.float32, device=x2.device)
    err = lib.rms_norm_backward_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(g2), KN.ptr(dx),
                                       KN.ptr(dscale), KN.ptr(partial), M, d, eps,
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
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_backward_cuda(x, scale, g, ctx.eps)
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
