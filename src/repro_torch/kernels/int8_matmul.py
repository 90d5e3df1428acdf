"""B1: the fused W8A8 GEMM (``csrc/int8_matmul.cu``) and its plain version.

Replaces ``repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas`` (wrapper
``ops.int8_matmul``).  The kernel streams the int8 weight once with split-K
integer partial sums meeting by atomicAdd (exact), then applies the f32
epilogue ``(float(acc) * x_s) * w_s``; its bound at decode M is the weight's
bytes over the card's memory rate.  The TPU padding of K to 512 and N to 128
is gone: the kernel masks its tails.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.kernels import _build

launches = 0


def int8_matmul_plain(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                      w_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x_q int8 [M,K], x_s f32 [M,1], w_q int8 [K,N], w_s f32 [N] ->
    (out f32 [M,N], acc int32 [M,N])."""
    acc = quant.exact_int_matmul(x_q, w_q)
    return acc.to(torch.float32) * x_s.reshape(-1, 1) * w_s, acc


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def int8_matmul_cuda(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                     w_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch B1 on CUDA tensors; same contract as :func:`int8_matmul_plain`."""
    global launches
    M, K = x_q.shape
    N = w_q.shape[1]
    if min(M, K, N) < 1 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"int8_matmul: unsupported shape M={M} K={K} N={N}")
    KN.require(x_q, "x_q", torch.int8, (M, K))
    KN.require(w_q, "w_q", torch.int8, (K, N))
    KN.require(x_s, "x_s", torch.float32, (M, 1))
    KN.require(w_s, "w_s", torch.float32, (N,))
    acc = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = _lib().int8_matmul_launch(
        KN.ptr(x_q), KN.ptr(w_q), KN.ptr(x_s), KN.ptr(w_s), KN.ptr(acc),
        KN.ptr(out), M, K, N, KN.num_sms(x_q.device.index), KN.stream(x_q))
    KN.check(err, "int8_matmul")
    launches += 1
    return out, acc


def int8_matmul_2d(x_q, x_s, w_q, w_s) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x_q, x_s, w_q, w_s):
        return int8_matmul_cuda(x_q, x_s, w_q, w_s)
    return int8_matmul_plain(x_q, x_s, w_q, w_s)


def int8_matmul(x_q: torch.Tensor, x_s: torch.Tensor, lin: quant.QuantizedLinear,
                out_dtype=torch.float32) -> torch.Tensor:
    """Model-facing W8A8 linear: x_q [..., K] int8 with per-token scales
    x_s [..., 1] -> [..., N] ``out_dtype``."""
    lead = x_q.shape[:-1]
    out, _ = int8_matmul_2d(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                            x_s.reshape(-1, 1).contiguous(), lin.w_q, lin.w_scale)
    return out.reshape(*lead, out.shape[-1]).to(out_dtype)
