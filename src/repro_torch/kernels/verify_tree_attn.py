"""B4: tree-verify flash decoding over the int8 KV pool
(``csrc/decode_attn.cu``, ``verify_tree_attn_launch``) and its plain version.

Replaces ``repro/kernels/decode_attn/kernel.py::verify_tree_attn_pallas``
(``_tree_kernel``; wrapper ``ops.verify_attention_tree``).  The T tokens of
a window are the nodes of a draft tree at cache rows ``pos .. pos + T - 1``
(node 0 is the root, the last committed token); row (t, r) sees the
committed prefix (keys ``< pos[b]``) plus in-window key ``pos[b] + j`` iff
bit j of ``anc[b, t]`` is set (T <= 31).  The kernel is B2's body with that
mask, its cluster walking the fixed 64-key chunks up to ``pos + T``; on a
chain (``anc[t] = (1 << (t+1)) - 1``) it equals B3 bit for bit.  Against
the plain version the float stages agree within ``rtol=3e-5, atol=3e-6``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels as KN
from repro_torch.core.kvcache import slot_positions
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import attn_plain
from repro_torch.kernels.verify_attn import check_window, quantize_window

MAX_T = 31
launches = 0


def tree_visibility_mask(pos_b: torch.Tensor, anc: torch.Tensor, S: int,
                         T: int) -> torch.Tensor:
    """[B, T, S] bool tree-verify visibility: node ``t`` of slot ``b`` sees
    the committed prefix (keys ``< pos_b[b]``) plus in-window key
    ``pos_b[b]+j`` iff bit j of ``anc[b, t]`` (int32 ancestor-or-self
    bitmask; node 0 = root = last committed token) is set.  The linear
    verify's stepped causal mask is the chain ``anc[i] = (1 << (i+1)) - 1``."""
    dev = anc.device
    idx = (torch.arange(S, dtype=torch.int32, device=dev)[None, :]
           - pos_b.to(dev).reshape(-1, 1))                           # [B,S]
    committed = idx < 0
    in_win = (idx >= 0) & (idx < T)
    bits = anc.to(torch.int64)[:, :, None] & 0xFFFFFFFF             # logical shift
    bit = (bits >> torch.clamp(idx, 0, 31).to(torch.int64)[:, None, :]) & 1
    return committed[:, None, :] | (in_win[:, None, :] & (bit == 1))


def verify_tree_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc) -> torch.Tensor:
    """q_q int8 [B,G,T,rep,D], q_s f32 [B,G,T,rep,1], k_q/v_q int8
    [B,S,G,D], k_s/v_s f32 [B,S,G], pos int32 [B] committed cursors, anc
    int32 [B,T] ancestor bitmasks -> f32 [B,G,T,rep,D]."""
    B, G, T, rep, D = q_q.shape
    S = k_q.shape[1]
    mask = tree_visibility_mask(pos, anc, S, T)                   # [B,T,S]
    mask = mask[:, None, :, None, :].expand(B, 1, T, rep, S).reshape(B, 1, T * rep, S)
    out = attn_plain(q_q.reshape(B, G, T * rep, D), q_s.reshape(B, G, T * rep, 1),
                     k_q, k_s, v_q, v_s, mask)
    return out.reshape(B, G, T, rep, D)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    fn = lib.verify_tree_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def verify_tree_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc) -> torch.Tensor:
    """Launch B4 on CUDA tensors; same contract as
    :func:`verify_tree_attn_plain` for windows whose every row sees a key
    (bit 0, the root, set in every ``anc`` as the engine's trees have it)."""
    global launches
    B, G, T, rep, D, S = check_window(q_q, q_s, k_q, k_s, v_q, v_s,
                                      "verify_tree_attn")
    if T > MAX_T:
        raise ValueError(f"verify_tree_attn: T={T} exceeds the {MAX_T} bits "
                         "of an int32 ancestor mask")
    KN.require(pos, "pos", torch.int32, (B,))
    KN.require(anc, "anc", torch.int32, (B, T))
    out = torch.empty((B, G, T, rep, D), dtype=torch.float32, device=q_q.device)
    err = _lib().verify_tree_attn_launch(
        KN.ptr(q_q), KN.ptr(q_s), KN.ptr(k_q), KN.ptr(k_s), KN.ptr(v_q),
        KN.ptr(v_s), KN.ptr(pos), KN.ptr(anc), KN.ptr(out), B, S, G, T, rep,
        D, math.sqrt(D), KN.stream(q_q))
    KN.check(err, "verify_tree_attn")
    launches += 1
    return out


def verify_tree_attn_5d(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if KN.on_cuda(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc):
        return verify_tree_attn_cuda(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc)
    return verify_tree_attn_plain(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc)


def verify_attention_tree(q, k_q, k_s, v_q, v_s, pos, anc,
                          plain: bool = False) -> torch.Tensor:
    """Model-facing tree-verify attention: q [B,T,H,D] float (the window's
    tree nodes); cache as in ``verify_attn.verify_attention``; ``pos`` a
    scalar or [B] cursors; ``anc`` [B,T] int32 ancestor bitmasks ->
    [B,T,H,D].  ``plain`` runs the plain version on any device."""
    B, T, H, D = q.shape
    G = k_q.shape[2]
    q_q, q_s = quantize_window(q, G)
    pos_b = slot_positions(pos, B, q.device).to(q.device).contiguous()
    anc = anc.to(device=q.device, dtype=torch.int32).contiguous()
    attn = verify_tree_attn_plain if plain else verify_tree_attn_5d
    out = attn(q_q, q_s, k_q, k_s[..., 0], v_q, v_s[..., 0], pos_b, anc)
    return out.permute(0, 2, 1, 3, 4).reshape(B, T, H, D).to(q.dtype)
