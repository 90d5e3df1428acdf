"""B1's grouped entry (``csrc/int8_matmul.cu``, ``int8_mm_grouped``) and its
plain version.

The port's counterpart of the reference's expert product
``repro/models/moe.py::_int8_expert_mm`` (an XLA einsum, no Pallas kernel),
which computes the same integers and B1's epilogue.  It runs B1's body over
a stack of experts in one launch (an expert index on the grid, 64-bit
offsets), with a row count for each expert read on the device: rows at or
past an expert's count are written as zero, and an expert with no row
reads none of its weight.  It is built into B1's library.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import int8_matmul as b1

launches = 0


def int8_matmul_grouped_plain(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                              w_s: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """x_q int8 [E,C,K], x_s f32 [E,C,1], w_q int8 [E,K,N], w_s f32 [E,N],
    counts int32 [E] -> out f32 [E,C,N]: expert e's rows below ``counts[e]``
    are ``(float(x_q[e] @ w_q[e]) * x_s[e]) * w_s[e]`` in int32 and then
    f32, the rows at or past it zero."""
    E, C, _ = x_q.shape
    out = torch.stack([b1.int8_matmul_plain(x_q[e], x_s[e], w_q[e], w_s[e])[0]
                       for e in range(E)])
    live = torch.arange(C, device=x_q.device)[None, :] < counts.to(x_q.device)[:, None]
    return torch.where(live[..., None], out, torch.zeros((), device=out.device))


def _lib() -> ctypes.CDLL:
    lib = b1._lib()
    fn = lib.int8_matmul_grouped_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def int8_matmul_grouped_cuda(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                             w_s: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the grouped B1 on CUDA tensors; same contract as
    :func:`int8_matmul_grouped_plain`.  One launch for every expert; the
    counts stay on the device (nothing syncs with the host, so the call can
    be captured in a CUDA graph).  Each expert's slice must fit B1's limits
    and the weight must start on a 16-byte boundary; a shape the kernel
    cannot take raises."""
    global launches
    E, C, K = x_q.shape
    N = w_q.shape[2]
    if min(E, C, K, N) < 1 or E > 65535 or max(C * K, K * N, C * N) >= 2 ** 31:
        raise ValueError(f"int8_matmul_grouped: unsupported shape E={E} C={C} K={K} N={N}")
    KN.require(x_q, "x_q", torch.int8, (E, C, K))
    KN.require(w_q, "w_q", torch.int8, (E, K, N))
    KN.require(x_s, "x_s", torch.float32, (E, C, 1))
    KN.require(w_s, "w_s", torch.float32, (E, N))
    KN.require(counts, "counts", torch.int32, (E,))
    if w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_grouped: w_q must start on a 16-byte boundary")
    out = torch.empty((E, C, N), dtype=torch.float32, device=x_q.device)
    err = _lib().int8_matmul_grouped_launch(
        KN.ptr(x_q), KN.ptr(w_q), KN.ptr(x_s), KN.ptr(w_s), KN.ptr(counts), KN.ptr(out),
        E, C, K, N, KN.num_sms(x_q.device.index), KN.stream(x_q))
    if err:
        KN.check(err, f"int8_matmul_grouped at E={E} C={C} K={K} N={N}")
    launches += 1
    return out


def int8_matmul_grouped(x_q, x_s, w_q, w_s, counts) -> torch.Tensor:
    """The grouped kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x_q, x_s, w_q, w_s, counts):
        return int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, counts)
    return int8_matmul_grouped_plain(x_q, x_s, w_q, w_s, counts)
