"""B5: the bit-serial QLC PIM MVM (``csrc/pim_mvm.cu``) and its plain version.

Replaces ``repro/kernels/pim_mvm/kernel.py::pim_mvm_pallas`` (wrapper
``ops.pim_mvm``).  The paper's Eq. 2: 8 two's-complement input bit-planes
times the signed-hi and unsigned-lo nibble planes, shift-added in int32 with
the sign plane weighted ``-(1 << 7)``, then the f32 epilogue.  Its int32 sums
equal B1's bit for bit.  On the H100 it is bound by integer operations (8
passes over every tile), not by bytes; it models the array and is not the
fast path.  The TPU padding is gone: the kernel masks its tails.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.kernels import _build

BITS = 8
launches = 0


def pim_mvm_plain(x_q: torch.Tensor, x_s: torch.Tensor, w_hi: torch.Tensor,
                  w_lo: torch.Tensor, w_s: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_q int8 [M,K], x_s f32 [M,1], w_hi/w_lo int8 [K,N] nibble planes,
    w_s f32 [N] -> (out f32 [M,N], acc int32 [M,N]), in the bit-serial
    dataflow of ``repro/kernels/pim_mvm/ref.py::ref_bitserial``."""
    planes = quant.input_bitplanes(x_q, BITS)          # [bits, M, K] 0/1
    bw = quant.bit_weights(BITS).tolist()               # host ints: no sync
    hi, lo = w_hi.to(torch.float64), w_lo.to(torch.float64)
    acc = torch.zeros((x_q.shape[0], w_hi.shape[1]), dtype=torch.int32,
                      device=x_q.device)
    for b in range(BITS):
        plane = planes[b].to(torch.float64)
        hi_dp = torch.matmul(plane, hi).to(torch.int32)   # hi-cell BL sum
        lo_dp = torch.matmul(plane, lo).to(torch.int32)   # lo-cell BL sum
        acc = acc + bw[b] * (16 * hi_dp + lo_dp)          # shift-adders
    return acc.to(torch.float32) * x_s.reshape(-1, 1) * w_s, acc


def _lib() -> ctypes.CDLL:
    lib = _build.load("pim_mvm")
    fn = lib.pim_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pim_mvm_cuda(x_q: torch.Tensor, x_s: torch.Tensor, w_hi: torch.Tensor,
                 w_lo: torch.Tensor, w_s: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch B5 on CUDA tensors; same contract as :func:`pim_mvm_plain`."""
    global launches
    M, K = x_q.shape
    N = w_hi.shape[1]
    if min(M, K, N) < 1 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"pim_mvm: unsupported shape M={M} K={K} N={N}")
    KN.require(x_q, "x_q", torch.int8, (M, K))
    KN.require(w_hi, "w_hi", torch.int8, (K, N))
    KN.require(w_lo, "w_lo", torch.int8, (K, N))
    KN.require(x_s, "x_s", torch.float32, (M, 1))
    KN.require(w_s, "w_s", torch.float32, (N,))
    acc = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = _lib().pim_mvm_launch(
        KN.ptr(x_q), KN.ptr(w_hi), KN.ptr(w_lo), KN.ptr(x_s), KN.ptr(w_s),
        KN.ptr(acc), KN.ptr(out), M, K, N, KN.num_sms(x_q.device.index),
        KN.stream(x_q))
    KN.check(err, "pim_mvm")
    launches += 1
    return out, acc


def pim_mvm_2d(x_q, x_s, w_hi, w_lo, w_s) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x_q, x_s, w_hi, w_lo, w_s):
        return pim_mvm_cuda(x_q, x_s, w_hi, w_lo, w_s)
    return pim_mvm_plain(x_q, x_s, w_hi, w_lo, w_s)


def pim_mvm(x_q: torch.Tensor, x_s: torch.Tensor, lin: quant.QuantizedLinear,
            out_dtype=torch.float32) -> torch.Tensor:
    """Model-facing bit-serial linear: x_q [..., K] int8 with per-token
    scales x_s [..., 1] -> [..., N].  The nibble planes are packed per call,
    as the reference's wrapper packs them."""
    lead = x_q.shape[:-1]
    w_hi, w_lo = quant.pack_qlc(lin.w_q)
    out, _ = pim_mvm_2d(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                        x_s.reshape(-1, 1).contiguous(), w_hi, w_lo, lin.w_scale)
    return out.reshape(*lead, out.shape[-1]).to(out_dtype)
