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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build

launches = 0


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> f32 [..., d]: ``x * rsqrt(mean(x^2) + eps) * scale``."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * scale


def _lib() -> ctypes.CDLL:
    lib = _build.load("rms_norm")
    fn = lib.rms_norm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; same contract as
    :func:`rms_norm_plain`."""
    global launches
    d = x.shape[-1]
    x2 = x.to(torch.float32).reshape(-1, d).contiguous()
    M = x2.shape[0]
    if M < 1 or d < 1 or M * d >= 2 ** 31:
        raise ValueError(f"rms_norm: unsupported shape {tuple(x.shape)}")
    KN.require(x2, "x", torch.float32, (M, d))
    KN.require(scale, "scale", torch.float32, (d,))
    out = torch.empty_like(x2)
    err = _lib().rms_norm_launch(KN.ptr(x2), KN.ptr(scale), KN.ptr(out), M, d,
                                 eps, KN.stream(x2))
    KN.check(err, "rms_norm")
    launches += 1
    return out.reshape(x.shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x, scale):
        return rms_norm_cuda(x, scale, eps)
    return rms_norm_plain(x, scale, eps)
