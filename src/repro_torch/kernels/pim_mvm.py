"""B5: the bit-serial QLC PIM MVM (``csrc/pim_mvm.cu``) and its plain version.

Replaces ``repro/kernels/pim_mvm/kernel.py::pim_mvm_pallas`` (wrapper
``ops.pim_mvm``).  The paper's Eq. 2: 8 two's-complement input bit-planes
times the signed-hi and unsigned-lo QLC cells, shift-added in int32 with the
sign plane weighted ``-(1 << 7)`` once per 128-row tile, then the f32
epilogue.  Its int32 sums equal B1's bit for bit.

The kernel reads one byte a weight: a weight's two 4-bit cells are its int8
byte (``w == 16 * hi + lo``), so it takes a ``QuantizedLinear``'s ``w_q`` as
it is and splits the cells in registers; nothing is packed per call.  Its
plane ops run on the int8 tensor cores, one cluster launch a call (no
memset, no second kernel), K split across the cluster's CTAs (its plan is
computed in the CUDA source; :func:`launch_plan` reads it).  The plain
version keeps the reference's two-plane signature; on CPU tensors the
dispatcher splits the planes for it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.kernels import _build

BITS = 8
launches = 0


class Plan(NamedTuple):
    """B5's launch (computed in ``csrc/pim_mvm.cu``): ``cluster`` CTAs
    split K into ``k_chunk`` rows each (whole 128-row tiles; the last may
    hold fewer) for every output tile of ``n_tiles``; ``rows`` rows of x a
    pass (a compiled size: 1, 4, 8, 16, 24 or 32), ``passes`` passes over
    M (each streams the weight once: one pass for M <= 32);
    ``smem_bytes`` of dynamic shared memory a CTA."""
    cluster: int
    k_chunk: int
    n_tiles: int
    rows: int
    passes: int
    smem_bytes: int


def launch_plan(M: int, K: int, N: int, num_sms: int) -> Plan:
    """The plan the kernel takes for these dimensions on a card of
    ``num_sms`` SMs (asks the built library, so only where it builds)."""
    fn = _lib().pim_mvm_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    out = (ctypes.c_longlong * 6)()
    fn(M, K, N, num_sms, out)
    return Plan(*out)


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pim_mvm_cuda(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                 w_s: torch.Tensor, with_acc: bool = True):
    """Launch B5 on CUDA tensors: x_q int8 [M,K], x_s f32 [M,1], w_q int8
    [K,N] whose bytes hold each weight's two QLC cells (the signed high
    nibble and the unsigned low one: a ``QuantizedLinear``'s ``w_q``),
    w_s f32 [N] -> (out f32 [M,N], acc int32 [M,N]) as
    :func:`pim_mvm_plain` gives them for ``quant.pack_qlc(w_q)``.  With
    ``with_acc=False`` (the model path) the integer sums are not written
    and ``None`` takes their place.  The weight must start on a 16-byte
    boundary (every allocation does; a view at another offset is
    refused)."""
    global launches
    M, K = x_q.shape
    N = w_q.shape[1]
    if min(M, K, N) < 1 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"pim_mvm: unsupported shape M={M} K={K} N={N}")
    KN.require(x_q, "x_q", torch.int8, (M, K))
    KN.require(w_q, "w_q", torch.int8, (K, N))
    KN.require(x_s, "x_s", torch.float32, (M, 1))
    KN.require(w_s, "w_s", torch.float32, (N,))
    if w_q.data_ptr() % 16:
        raise ValueError("pim_mvm: w_q must start on a 16-byte boundary")
    acc = (torch.empty((M, N), dtype=torch.int32, device=x_q.device) if with_acc
           else None)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    err = _lib().pim_mvm_launch(
        KN.ptr(x_q), KN.ptr(w_q), KN.ptr(x_s), KN.ptr(w_s),
        KN.ptr(acc) if with_acc else None, KN.ptr(out), M, K, N,
        KN.num_sms(x_q.device.index), KN.stream(x_q))
    if err:
        KN.check(err, f"pim_mvm at M={M} K={K} N={N}")
    launches += 1
    return out, acc


def pim_mvm_2d(x_q, x_s, w_q, w_s, with_acc: bool = True):
    """The kernel on CUDA tensors; on CPU tensors the plain version, on the
    two cell planes split from ``w_q``."""
    if KN.on_cuda(x_q, x_s, w_q, w_s):
        return pim_mvm_cuda(x_q, x_s, w_q, w_s, with_acc)
    return pim_mvm_plain(x_q, x_s, *quant.pack_qlc(w_q), w_s)


def pim_mvm(x_q: torch.Tensor, x_s: torch.Tensor, lin: quant.QuantizedLinear,
            out_dtype=torch.float32) -> torch.Tensor:
    """Model-facing bit-serial linear: x_q [..., K] int8 with per-token
    scales x_s [..., 1] -> [..., N] ``out_dtype``."""
    lead = x_q.shape[:-1]
    out, _ = pim_mvm_2d(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                        x_s.reshape(-1, 1).contiguous(), lin.w_q, lin.w_scale,
                        with_acc=False)
    return out.reshape(*lead, out.shape[-1]).to(out_dtype)
