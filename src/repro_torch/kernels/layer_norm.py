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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build

launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``(x - mean) * rsqrt(var + eps) * scale
    + bias``, ``var`` the mean of squared deviations (as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mu) * torch.rsqrt(var + eps) * scale + bias


def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm")
    fn = lib.layer_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; same contract as
    :func:`layer_norm_plain`."""
    global launches
    d = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, d).contiguous()
    M = x2.shape[0]
    if M < 1 or d < 1 or M * d >= 2 ** 31:
        raise ValueError(f"layer_norm: unsupported shape {tuple(x.shape)}")
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    KN.require(bias, "bias", torch.float32, (d,))
    out = torch.empty_like(x2)
    err = _lib().layer_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(bias), KN.ptr(out),
                                   M, d, eps, KN.stream(x2))
    KN.check(err, "layer_norm")
    launches += 1
    return out.reshape(x.shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x, scale, bias):
        return layer_norm_cuda(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)
