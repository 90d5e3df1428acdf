"""The grouped B1 (``csrc/int8_matmul_grouped.cu``, ``int8_mm_grouped``) and
its plain version.

The port's counterpart of the reference's expert product
``repro/models/moe.py::_int8_expert_mm`` (an XLA einsum, no Pallas kernel),
which computes the same integers and B1's epilogue over a stack of experts
in one launch, with a row count for each expert read on the device: rows at
or past an expert's count are written as zero, and an expert with no row
reads none of its weight.  One persistent CTA an SM streams an equal share
of the live experts' weight by TMA (whole tiles in full waves, then the
last wave's stages in equal ranges); tiles cut between CTAs meet in an
int32 scratch (:func:`scratch_elems`) and a ticket array the kernel leaves
zero (:func:`repro_torch.kernels.tickets`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import kernels as KN
from repro_torch.kernels import _build
from repro_torch.kernels import int8_matmul as b1

launches = 0

# a tile of the kernel: rows of x a pass by output columns (csrc's MR, BN),
# and the weight rows of a stage (BK)
PASS_ROWS, TILE_COLS, STAGE_ROWS = 32, 128, 128


class Plan(NamedTuple):
    """One launch's work (computed in ``csrc/int8_matmul_grouped.cu`` from
    the row counts): ``ctas`` persistent CTAs share ``stages`` stages
    (``passes`` live passes of up to 32 rows x ``tiles_per_pass`` column
    tiles x ``stages_per_tile`` K stages), at most ``stages_per_cta`` each:
    ``waves`` full waves of one whole tile a CTA, then the last wave's
    stages in equal ranges, which cut ``cut_tiles`` tiles between CTAs;
    ``tma`` is 1 where the stages come by TMA; ``smem_bytes`` of dynamic
    shared memory a CTA."""
    ctas: int
    passes: int
    tiles_per_pass: int
    stages_per_tile: int
    stages: int
    stages_per_cta: int
    waves: int
    cut_tiles: int
    tma: int
    smem_bytes: int


def scratch_elems(ctas: int) -> int:
    """int32 elements of the partial-tile scratch of a launch on ``ctas``
    CTAs: each CTA holds at most two cut tiles (its first and its last), a
    pass's rows by a tile's columns each."""
    return 2 * ctas * PASS_ROWS * TILE_COLS


def check_shape(E: int, C: int, K: int, N: int) -> None:
    """Raise for a shape the kernel cannot take: an empty dimension, more
    than 65,535 experts, an expert's slice past 2^31 elements, or more
    stages than a 64-bit count holds."""
    stages = E * -(-C // PASS_ROWS) * -(-N // TILE_COLS) * -(-K // STAGE_ROWS)
    if (min(E, C, K, N) < 1 or E > 65535 or max(C * K, K * N, C * N) >= 2 ** 31
            or stages >= 2 ** 62):
        raise ValueError(f"int8_matmul_grouped: unsupported shape E={E} C={C} K={K} N={N}")


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
    lib = _build.load("int8_matmul_grouped")
    fn = lib.int8_matmul_grouped_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.int8_matmul_grouped_plan
        plan.argtypes = [ctypes.POINTER(ctypes.c_int32)] + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)]
        plan.restype = None
    return lib


def launch_plan(counts, C: int, K: int, N: int, num_sms: int) -> Plan:
    """The work the kernel shares out for these row counts (a sequence of
    ints) on a card of ``num_sms`` SMs (asks the built library, so only
    where it builds)."""
    cnt = (ctypes.c_int32 * len(counts))(*[int(c) for c in counts])
    out = (ctypes.c_longlong * 10)()
    _lib().int8_matmul_grouped_plan(cnt, len(counts), C, K, N, num_sms, out)
    return Plan(*out)


def int8_matmul_grouped_cuda(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                             w_s: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the grouped B1 on CUDA tensors; same contract as
    :func:`int8_matmul_grouped_plain`.  One launch for every expert; the
    counts stay on the device (nothing syncs with the host, so the call can
    be captured in a CUDA graph once it has run outside a capture on the
    device, which makes the device's ticket array).  The weight must start
    on a 16-byte boundary; a shape the kernel cannot take raises.  Calls on
    one device must not overlap in time (they share the tickets)."""
    global launches
    E, C, K = x_q.shape
    N = w_q.shape[2]
    check_shape(E, C, K, N)
    KN.require(x_q, "x_q", torch.int8, (E, C, K))
    KN.require(w_q, "w_q", torch.int8, (E, K, N))
    KN.require(x_s, "x_s", torch.float32, (E, C, 1))
    KN.require(w_s, "w_s", torch.float32, (E, N))
    KN.require(counts, "counts", torch.int32, (E,))
    if w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_grouped: w_q must start on a 16-byte boundary")
    ctas = KN.num_sms(x_q.device.index)
    out = torch.empty((E, C, N), dtype=torch.float32, device=x_q.device)
    partial = torch.empty((scratch_elems(ctas),), dtype=torch.int32, device=x_q.device)
    tickets = KN.tickets(x_q.device, "int8_matmul_grouped", ctas)
    err = _lib().int8_matmul_grouped_launch(
        KN.ptr(x_q), KN.ptr(w_q), KN.ptr(x_s), KN.ptr(w_s), KN.ptr(counts), KN.ptr(out),
        KN.ptr(partial), KN.ptr(tickets), E, C, K, N, ctas, KN.stream(x_q))
    if err:
        KN.check(err, f"int8_matmul_grouped at E={E} C={C} K={K} N={N}")
    launches += 1
    return out


def int8_matmul_grouped(x_q, x_s, w_q, w_s, counts) -> torch.Tensor:
    """The grouped kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(x_q, x_s, w_q, w_s, counts):
        return int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, counts)
    return int8_matmul_grouped_plain(x_q, x_s, w_q, w_s, counts)
