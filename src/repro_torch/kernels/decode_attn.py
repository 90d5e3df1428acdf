"""B2: flash decoding over the int8 KV pool (``csrc/decode_attn.cu``) and its
plain version.

Replaces ``repro/kernels/decode_attn/kernel.py::decode_attn_pallas``
(``_attn_pallas`` / ``_kernel``; wrapper ``ops.decode_attention``) on the
plain decode path.  Per (slot, kv group): int8 q . K^T into int32, descale,
mask to the slot's length, online softmax, ``P . (V * v_s)`` in f32.  It is
bound by the bytes of the live cache rows.  The kernel cuts the key axis
into chunks of 64 keys at fixed, absolute positions; the 8 CTAs of a thread
block cluster share one (slot, group)'s chunks, CTA c taking chunks c,
c + 8, ... up to the slot's length (rows past it are never read), staged by
``cp.async``, scored on int8 ``mma.sync`` and multiplied into V on tf32
``mma.sync`` (3xTF32, about f32); the CTAs merge their online softmax
states in rank order through distributed shared memory, in one launch.  Nothing but a key's position decides which CTA sums it or in what
order, so a row's bits do not depend on the pool size, the walk or the
mask.  The float stages sum in another order than the plain version, so the
two agree within ``rtol=3e-5, atol=3e-6`` (the Pallas kernel's tolerance).
The verify kernels B3 and B4 (``verify_attn``, ``verify_tree_attn``) share
this kernel's source and :func:`attn_plain`, with other masks.  Head dims
up to ``MAX_D`` (192, nemotron-4-340b's) in steps of 4: the body has one
instance for D <= 128 and one, in dynamic shared memory, above.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels as KN
from repro_torch.core import quant
from repro_torch.core.kvcache import slot_positions
from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_REP = 16
MAX_D = 192
launches = 0


def attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, mask) -> torch.Tensor:
    """The plain body that B2, B3 and B4 share: q_q int8 [B,G,R,D], q_s f32
    [B,G,R,1], k_q/v_q int8 [B,S,G,D], k_s/v_s f32 [B,S,G], ``mask`` bool
    broadcastable to [B,G,R,S] (True: the row sees the key) -> f32
    [B,G,R,D]."""
    D = q_q.shape[-1]
    s_int = torch.einsum("bgrd,bsgd->bgrs", q_q.to(torch.float64),
                         k_q.to(torch.float64)).to(torch.int32)   # exact
    k_sc = k_s.permute(0, 2, 1)[:, :, None, :]                     # [B,G,1,S]
    scores = s_int.to(torch.float32) * q_s * k_sc / math.sqrt(D)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    vf = v_q.to(torch.float32) * v_s[..., None]                    # [B,S,G,D]
    return torch.einsum("bgrs,bsgd->bgrd", w, vf)


def decode_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, lengths) -> torch.Tensor:
    """q_q int8 [B,G,rep,D], q_s f32 [B,G,rep,1], k_q/v_q int8 [B,S,G,D],
    k_s/v_s f32 [B,S,G], lengths int32 [B] -> f32 [B,G,rep,D]."""
    S = k_q.shape[1]
    mask = (torch.arange(S, device=k_q.device)[None, None, None, :]
            < lengths.reshape(-1, 1, 1, 1))
    return attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, mask)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(D: int) -> int:
    """Shared memory a CTA of the body's instance for head dim D takes
    (static up to D 128, dynamic above), read from the built library."""
    fn = _lib().decode_attn_smem_bytes
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D)


def decode_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths) -> torch.Tensor:
    """Launch B2 on CUDA tensors; same contract as :func:`decode_attn_plain`
    for lengths >= 1 (the decode path's; a slot of length 0 gives zeros)."""
    global launches
    B, G, rep, D = q_q.shape
    S = k_q.shape[1]
    if not (1 <= rep <= MAX_REP and 4 <= D <= MAX_D and D % 4 == 0):
        raise ValueError(f"decode_attn: unsupported rep={rep} D={D}")
    if min(B, G, S) < 1:
        raise ValueError(f"decode_attn: unsupported B={B} G={G} S={S}")
    KN.require(q_q, "q_q", torch.int8, (B, G, rep, D))
    KN.require(q_s, "q_s", torch.float32, (B, G, rep, 1))
    KN.require(k_q, "k_q", torch.int8, (B, S, G, D))
    KN.require(v_q, "v_q", torch.int8, (B, S, G, D))
    KN.require(k_s, "k_s", torch.float32, (B, S, G))
    KN.require(v_s, "v_s", torch.float32, (B, S, G))
    KN.require(lengths, "lengths", torch.int32, (B,))
    for t, name in ((q_q, "q_q"), (k_q, "k_q"), (v_q, "v_q")):
        if t.data_ptr() % 4:
            raise ValueError(f"decode_attn: {name} must be 4-byte aligned")
    out = torch.empty((B, G, rep, D), dtype=torch.float32, device=q_q.device)
    err = _lib().decode_attn_launch(
        KN.ptr(q_q), KN.ptr(q_s), KN.ptr(k_q), KN.ptr(k_s), KN.ptr(v_q),
        KN.ptr(v_s), KN.ptr(lengths), KN.ptr(out), B, S, G, rep, D,
        math.sqrt(D), KN.stream(q_q))
    KN.check(err, "decode_attn")
    launches += 1
    return out


def decode_attn_4d(q_q, q_s, k_q, k_s, v_q, v_s, lengths) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths):
        return decode_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, lengths)
    return decode_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, lengths)


def decode_attention(q, k_q, k_s, v_q, v_s, length) -> torch.Tensor:
    """Model-facing decode attention: q [B,1,H,D] float; k_q/v_q int8
    [B,S,G,D]; k_s/v_s f32 [B,S,G,1]; length a scalar or [B] per-slot
    lengths -> [B,1,H,D]."""
    B, _, H, D = q.shape
    G = k_q.shape[2]
    rep = H // G
    q_q, q_s = quant.quantize_kv(q.reshape(B, H, D))
    lengths = slot_positions(length, B, q.device).to(q.device).contiguous()
    out = decode_attn_4d(q_q.reshape(B, G, rep, D), q_s.reshape(B, G, rep, 1),
                         k_q, k_s[..., 0], v_q, v_s[..., 0], lengths)
    return out.reshape(B, 1, H, D).to(q.dtype)
