"""B3: speculative-verify flash decoding over the int8 KV pool
(``csrc/decode_attn.cu``, ``verify_attn_launch``) and its plain version.

Replaces ``repro/kernels/decode_attn/kernel.py::verify_attn_pallas`` (wrapper
``ops.verify_attention``).  The T tokens of a verify window (the last
committed token plus T-1 drafts per slot) fold into the GQA rep axis, and
row (t, r) keeps keys ``< lengths[b, t]`` (``pos + t + 1``).  The kernel is
B2's body with a per-row limit: one cluster of 8 CTAs per (slot, group, 16
query rows), walking the 64-key chunks up to the largest limit of its rows,
so a window of R = T * rep rows reads the live cache ``ceil(R / 16)`` times.
The chunks sit at fixed key positions and a chunk past a row's limit adds
exact zeros, so a row equals B2 at its own length bit for bit, also where
B2 runs in the plain lane's pool of ``max_len`` rows and B3 in the spec
lane's ``max_len + T - 1``; against the plain version the float stages
agree within ``rtol=3e-5, atol=3e-6``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.core.kvcache import slot_positions
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import MAX_D, attn_plain

launches = 0


def verify_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, lengths,
                      inter_dtype=None) -> torch.Tensor:
    """q_q int8 [B,G,T,rep,D], q_s f32 [B,G,T,rep,1], k_q/v_q int8
    [B,S,G,D], k_s/v_s f32 [B,S,G], lengths int32 [B,T] per-row key limits
    -> f32 [B,G,T,rep,D]; ``inter_dtype`` as in
    :func:`repro_torch.kernels.decode_attn.attn_plain`."""
    B, G, T, rep, D = q_q.shape
    S = k_q.shape[1]
    mask = (torch.arange(S, device=k_q.device)[None, None, :]
            < lengths.reshape(B, T, 1))                           # [B,T,S]
    mask = mask[:, None, :, None, :].expand(B, 1, T, rep, S).reshape(B, 1, T * rep, S)
    out = attn_plain(q_q.reshape(B, G, T * rep, D), q_s.reshape(B, G, T * rep, 1),
                     k_q, k_s, v_q, v_s, mask, inter_dtype)
    return out.reshape(B, G, T, rep, D)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    fn = lib.verify_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_window(q_q, q_s, k_q, k_s, v_q, v_s, name: str) -> tuple[int, ...]:
    """Shapes, types, devices and alignment of a verify window's q and cache
    operands, as B3 and B4 take them; returns (B, G, T, rep, D, S)."""
    B, G, T, rep, D = q_q.shape
    S = k_q.shape[1]
    if not (4 <= D <= MAX_D and D % 4 == 0) or min(B, G, T, rep, S) < 1:
        raise ValueError(f"{name}: unsupported B={B} G={G} T={T} rep={rep} "
                         f"D={D} S={S}")
    KN.require(q_q, "q_q", torch.int8, (B, G, T, rep, D))
    KN.require(q_s, "q_s", torch.float32, (B, G, T, rep, 1))
    KN.require(k_q, "k_q", torch.int8, (B, S, G, D))
    KN.require(v_q, "v_q", torch.int8, (B, S, G, D))
    KN.require(k_s, "k_s", torch.float32, (B, S, G))
    KN.require(v_s, "v_s", torch.float32, (B, S, G))
    for t, n in ((q_q, "q_q"), (k_q, "k_q"), (v_q, "v_q")):
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: {n} must be 4-byte aligned")
    return B, G, T, rep, D, S


def verify_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths) -> torch.Tensor:
    """Launch B3 on CUDA tensors; same contract as :func:`verify_attn_plain`
    for limits >= 1 (the verify path's)."""
    global launches
    B, G, T, rep, D, S = check_window(q_q, q_s, k_q, k_s, v_q, v_s, "verify_attn")
    KN.require(lengths, "lengths", torch.int32, (B, T))
    out = torch.empty((B, G, T, rep, D), dtype=torch.float32, device=q_q.device)
    err = _lib().verify_attn_launch(
        KN.ptr(q_q), KN.ptr(q_s), KN.ptr(k_q), KN.ptr(k_s), KN.ptr(v_q),
        KN.ptr(v_s), KN.ptr(lengths), KN.ptr(out), B, S, G, T, rep, D,
        math.sqrt(D), KN.stream(q_q))
    KN.check(err, "verify_attn")
    launches += 1
    return out


def verify_attn_5d(q_q, q_s, k_q, k_s, v_q, v_s, lengths) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths):
        return verify_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths)
    return verify_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, lengths)


def quantize_window(q: torch.Tensor, G: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,T,H,D] float -> (int8 [B,G,T,rep,D], f32 [B,G,T,rep,1]),
    quantized per (slot, token, head) over [B, T*H, D] as the reference's
    ``ops.verify_attention`` does."""
    B, T, H, D = q.shape
    rep = H // G
    q_q, q_s = quant.quantize_kv(q.reshape(B, T * H, D))
    return (q_q.reshape(B, T, G, rep, D).permute(0, 2, 1, 3, 4).contiguous(),
            q_s.reshape(B, T, G, rep, 1).permute(0, 2, 1, 3, 4).contiguous())


def verify_attention(q, k_q, k_s, v_q, v_s, pos, plain: bool = False,
                     inter_dtype=None) -> torch.Tensor:
    """Model-facing verify attention: q [B,T,H,D] float (the window's tokens
    at positions ``pos[b] .. pos[b]+T-1``); k_q/v_q int8 [B,S,G,D]; k_s/v_s
    f32 [B,S,G,1]; ``pos`` a scalar or [B] cursors.  Query t of slot b sees
    keys [0, pos[b]+t] -> [B,T,H,D].  ``plain`` runs the plain version on
    any device, its SLC intermediates at ``inter_dtype``; the kernel
    ignores that dtype."""
    B, T, H, D = q.shape
    G = k_q.shape[2]
    q_q, q_s = quantize_window(q, G)
    pos_b = slot_positions(pos, B, q.device).to(q.device)
    lengths = (pos_b[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                             device=q.device)).contiguous()
    args = (q_q, q_s, k_q, k_s[..., 0], v_q, v_s[..., 0], lengths)
    out = verify_attn_plain(*args, inter_dtype) if plain else verify_attn_5d(*args)
    return out.permute(0, 2, 1, 3, 4).reshape(B, T, H, D).to(q.dtype)
