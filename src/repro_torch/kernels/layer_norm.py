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
forward is the kernel and whose backward is a second hand kernel of the
same source (``layer_norm_backward_cuda``): ``dx`` a row at a time in the
forward's summation order, ``dscale`` and ``dbias`` summed over rows in a
fixed order (no atomics).  Its plain version is autograd through
:func:`layer_norm_plain`.  Each wrapper counts its own launches:
``launches`` the forward, ``backward_launches`` the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build

launches = 0
backward_launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``(x - mean) * rsqrt(var + eps) * scale
    + bias``, ``var`` the mean of squared deviations (as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mu) * torch.rsqrt(var + eps) * scale + bias


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    fn = lib.layer_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.layer_norm_backward_launch
        bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.layer_norm_backward_rows.argtypes = []
        lib.layer_norm_backward_rows.restype = ctypes.c_int
    return lib


def _rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as a contiguous f32 [M, d] matrix the kernels take."""
    d = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, d).contiguous()
    if x2.shape[0] < 1 or d < 1 or x2.numel() >= 2 ** 31:
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)}")
    return x2


def layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; same contract as
    :func:`layer_norm_plain`."""
    global launches
    x2 = _rows(x, "layer_norm")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    KN.require(bias, "bias", torch.float32, (d,))
    out = torch.empty_like(x2)
    err = _lib().layer_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(bias), KN.ptr(out),
                                   M, d, eps, KN.stream(x2))
    KN.check(err, "layer_norm")
    launches += 1
    return out.reshape(x.shape)


def layer_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                             eps: float = 1e-5
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors -> (dx, dscale, dbias),
    the contract of :func:`layer_norm_backward_plain` (the bias does not
    enter the gradient)."""
    global backward_launches
    x2, g2 = _rows(x, "layer_norm_backward"), _rows(g, "layer_norm_backward")
    M, d = x2.shape
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(g2, "g", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    lib = _lib()
    rows = lib.layer_norm_backward_rows()
    dx = torch.empty_like(x2)
    dparams = torch.empty((2, d), dtype=torch.float32, device=x2.device)
    partial = torch.empty((2, -(-M // rows), d), dtype=torch.float32, device=x2.device)
    err = lib.layer_norm_backward_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(g2), KN.ptr(dx),
                                         KN.ptr(dparams), KN.ptr(partial), M, d, eps,
                                         KN.stream(x2))
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
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layer_norm_cuda(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward_cuda(x, scale, g, ctx.eps)
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
