"""B1: the fused W8A8 GEMM (``csrc/int8_matmul.cu``) and its plain version.

Replaces ``repro/kernels/int8_matmul/kernel.py::int8_matmul_pallas`` (wrapper
``ops.int8_matmul``).  One launch a call: int8 tensor cores (``mma.sync``
m16n8k32, the weight as the A operand), the weight streamed once for any
M <= 32, K split across the CTAs of a thread block cluster whose int32
partials meet in distributed shared memory (exact in any order), and the f32
epilogue ``(float(acc) * x_s) * w_s`` applied by the CTA that sums each
output.  Its bound at decode M is the weight's bytes over the card's memory
rate.  The TPU padding of K to 512 and N to 128 is gone: the kernel masks
its tails.  The kernel picks the cluster's split of K itself
(:func:`launch_plan` reads it).

The grouped products of a stack of experts have their own kernel
(``kernels/int8_matmul_grouped.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.kernels import _build

launches = 0


class Plan(NamedTuple):
    """B1's launch (computed in ``csrc/int8_matmul.cu``): ``cluster`` CTAs
    split K into ``k_chunk`` rows each (the last may hold fewer) for every
    output tile of ``n_tiles``; ``m_tiles`` n8 tiles of x a pass, ``passes``
    passes over M; ``smem_bytes`` of dynamic shared memory a CTA."""
    cluster: int
    k_chunk: int
    n_tiles: int
    m_tiles: int
    passes: int
    smem_bytes: int


def launch_plan(M: int, K: int, N: int, num_sms: int) -> Plan:
    """The plan the kernel takes for these dimensions on a card of
    ``num_sms`` SMs (asks the built library, so only where it builds)."""
    fn = _lib().int8_matmul_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * 6)()
    fn(M, K, N, num_sms, out)
    return Plan(*out)


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
                     w_s: torch.Tensor, with_acc: bool = True):
    """Launch B1 on CUDA tensors; same contract as :func:`int8_matmul_plain`.
    With ``with_acc=False`` (the model path) the integer sums are not
    written and ``None`` takes their place.  The weight must start on a
    16-byte boundary (every allocation does; a view at another offset is
    refused)."""
    global launches
    M, K = x_q.shape
    N = w_q.shape[1]
    if min(M, K, N) < 1 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"int8_matmul: unsupported shape M={M} K={K} N={N}")
    KN.require(x_q, "x_q", torch.int8, (M, K))
    KN.require(w_q, "w_q", torch.int8, (K, N))
    KN.require(x_s, "x_s", torch.float32, (M, 1))
    KN.require(w_s, "w_s", torch.float32, (N,))
    if w_q.data_ptr() % 16:
        raise ValueError("int8_matmul: w_q must start on a 16-byte boundary")
    acc = (torch.empty((M, N), dtype=torch.int32, device=x_q.device) if with_acc
           else None)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = _lib().int8_matmul_launch(
        KN.ptr(x_q), KN.ptr(w_q), KN.ptr(x_s), KN.ptr(w_s),
        KN.ptr(acc) if with_acc else None, KN.ptr(out), M, K, N,
        KN.num_sms(x_q.device.index), KN.stream(x_q))
    if err:
        KN.check(err, f"int8_matmul at M={M} K={K} N={N}")
    launches += 1
    return out, acc


def int8_matmul_2d(x_q, x_s, w_q, w_s, with_acc: bool = True):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x_q, x_s, w_q, w_s):
        return int8_matmul_cuda(x_q, x_s, w_q, w_s, with_acc)
    return int8_matmul_plain(x_q, x_s, w_q, w_s)


def int8_matmul(x_q: torch.Tensor, x_s: torch.Tensor, lin: quant.QuantizedLinear,
                out_dtype=torch.float32) -> torch.Tensor:
    """Model-facing W8A8 linear: x_q [..., K] int8 with per-token scales
    x_s [..., 1] -> [..., N] ``out_dtype``."""
    lead = x_q.shape[:-1]
    out, _ = int8_matmul_2d(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                            x_s.reshape(-1, 1).contiguous(), lin.w_q, lin.w_scale,
                            with_acc=False)
    return out.reshape(*lead, out.shape[-1]).to(out_dtype)
