"""GQA attention: blocked (flash-style) prefill attention and int8-KV decode
attention (the paper's dMVM, Sec. IV-B / Fig. 13).

PyTorch counterpart of the GQA parts of ``repro.models.attention``.  Decode
attention computes ``q . K^T`` and ``S . V`` against the int8 "SLC-region"
cache: under ``fused_int8`` through the B2 kernel, otherwise through the
plain version of the same function.  Speculative verify attention scores a
window of T tokens per slot the same way: under ``fused_int8`` through the
B3 (linear window) or B4 (draft tree) kernel, otherwise through their plain
versions.  MLA is ported with a later slice.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core import quant
from repro_torch.kernels import decode_attn as da_ops
from repro_torch.kernels import verify_attn as va_ops
from repro_torch.kernels import verify_tree_attn as vt_ops
from repro_torch.models import layers as L

Params = dict[str, Any]
NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.attn_type} attention is not ported yet (ROADMAP A.11)")
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": L.dense_init(gen, d, cfg.n_heads * hd, dtype)["w"],
         "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype)["w"],
         "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype)["w"],
         "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype)["w"]}
    if cfg.use_qk_norm:
        p["q_norm"] = L.norm_init(hd, device=gen.device)
        p["k_norm"] = L.norm_init(hd, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# full (prefill) attention, blocked over KV to bound memory
# ---------------------------------------------------------------------------
def hidden_masks(Tq: int, Tk: int, blk: int, *, causal: bool = True, q_offset=0,
                 kv_lengths: torch.Tensor | None = None,
                 device: str | torch.device = "cpu") -> list[torch.Tensor]:
    """For each block of ``blk`` keys (the last one padded), a bool mask
    [B|1, 1, 1, Tq, blk], True where the key is hidden from the query row:
    later than the row (causal, rows at ``q_offset + arange(Tq)``), past
    ``Tk``, or at and beyond the row's ``kv_lengths``.  One set serves every
    layer of a prefill call."""
    if isinstance(q_offset, torch.Tensor):               # [B] (or [1]) offsets
        q_offset = q_offset.reshape(-1, 1)
    q_pos = torch.arange(Tq, device=device) + q_offset              # [B|1, Tq] or [Tq]
    out = []
    for bi in range(math.ceil(Tk / blk)):
        k_pos = bi * blk + torch.arange(blk, device=device)
        mask = (k_pos <= q_pos[..., None] if causal
                else torch.ones((Tq, blk), dtype=torch.bool, device=device))
        mask = mask & (k_pos < Tk)
        mask = mask if mask.ndim == 3 else mask[None]             # [B|1, Tq, blk]
        if kv_lengths is not None:
            mask = mask & (k_pos[None, None, :] < kv_lengths[:, None, None])
        out.append(~mask[:, None, None])
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, kv_block: int = 1024,
                    kv_lengths: torch.Tensor | None = None,
                    hidden: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Memory-bounded attention with running (max, denom) statistics over
    KV blocks.  q: [B, Tq, H, Dk]; k: [B, Tk, G, Dk]; v: [B, Tk, G, Dv],
    G = kv heads (no head replication).  ``q_offset`` (an int, or a [B]
    tensor) is the position of q's first row; ``kv_lengths`` ([B] int32)
    masks keys at and beyond each request's true prompt length.
    ``hidden``: the blocks' :func:`hidden_masks`, when the caller reuses
    them across calls."""
    B, Tq, H, Dk = q.shape
    G, Dv, Tk = k.shape[2], v.shape[-1], k.shape[1]
    rep = H // G
    dev = q.device
    blk = min(kv_block, Tk)
    if hidden is None:
        hidden = hidden_masks(Tq, Tk, blk, causal=causal, q_offset=q_offset,
                              kv_lengths=kv_lengths, device=dev)
    q5 = (q.to(torch.float32) / math.sqrt(Dk)).reshape(B, Tq, G, rep, Dk)
    m = torch.full((B, G, rep, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, G, rep, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, G, rep, Tq, Dv), dtype=torch.float32, device=dev)
    for bi, hid in enumerate(hidden):
        kblk = k[:, bi * blk:(bi + 1) * blk].to(torch.float32)
        vblk = v[:, bi * blk:(bi + 1) * blk].to(torch.float32)
        pad = blk - kblk.shape[1]
        if pad:
            kblk = torch.cat([kblk, kblk.new_zeros((B, pad, G, Dk))], dim=1)
            vblk = torch.cat([vblk, vblk.new_zeros((B, pad, G, Dv))], dim=1)
        s = torch.einsum("bqgrd,bkgd->bgrqk", q5, kblk).masked_fill(hid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vblk)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]               # [B,G,rep,Tq,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dv).to(q.dtype)


def gqa_chunk(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, buf: dict, start: int,
              kv_lengths: torch.Tensor, key_rows: int, backend: str = "dense",
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              hidden: list[torch.Tensor] | None = None) -> torch.Tensor:
    """One chunk of a chunked prefill.  ``x``: [B, C, d] hidden chunk whose
    tokens sit at ``positions`` (= start + arange(C)); ``buf`` carries the
    float K/V of the whole in-flight prompt ([B, S_buf, H_kv, D]).  The
    chunk's k/v land in ``buf`` in place at offset ``start`` (every row's,
    clamped to ``[0, S_buf - C]`` as the reference's
    ``dynamic_update_slice`` clamps it) and q attends the resident prefix
    ``[0, kv_lengths)`` at full precision, as one-shot prefill does, over
    the buffer's first ``key_rows`` rows as one block of keys.  A key a row
    cannot see adds an exact zero to that row's sums, so rows past the
    visible prefix change no bit.  ``rope`` (:func:`layers.rope_tables` of
    ``positions``) and ``hidden`` (:func:`hidden_masks`) may come
    precomputed, once for every layer of a call.  Returns the attention
    block's output."""
    B, C, _ = x.shape
    hd = cfg.head_dim
    q = L.apply_linear(L._lin(p, "wq"), x, backend).reshape(B, C, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend).reshape(B, C, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend).reshape(B, C, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = L.apply_norm(p["q_norm"], q)
        k = L.apply_norm(p["k_norm"], k)
    if cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta, tables=rope)
        k = L.apply_rope(k, positions, cfg.rope_theta, tables=rope)
    KV.chunk_update(buf["k"], k, start)
    KV.chunk_update(buf["v"], v, start)
    o = flash_attention(q, buf["k"][:, :key_rows].to(q.dtype),
                        buf["v"][:, :key_rows].to(q.dtype), q_offset=start,
                        kv_lengths=kv_lengths, kv_block=key_rows, hidden=hidden)
    return L.apply_linear(L._lin(p, "wo"), o.reshape(B, C, -1), backend)


# ---------------------------------------------------------------------------
# decode attention against the int8 SLC cache (dMVM)
# ---------------------------------------------------------------------------
def decode_attention_int8(q: torch.Tensor, k_q, k_s, v_q, v_s, length,
                          backend: str = "dense") -> torch.Tensor:
    """q: [B, 1, H, D] float; cache: [B, S, Hkv, D] int8 (+[B, S, Hkv, 1]
    f32); ``length`` a scalar or [B] per-slot cache lengths.  ``fused_int8``
    runs the B2 kernel; every other backend the plain version (as the
    reference's jnp branch)."""
    if backend == "fused_int8":
        return da_ops.decode_attention(q, k_q, k_s, v_q, v_s, length)
    B, _, H, D = q.shape
    G = k_q.shape[2]
    rep = H // G
    lengths = KV.slot_positions(length, B, q.device).to(q.device)
    q_q, q_scale = quant.quantize_kv(q.reshape(B, H, D))      # per-(B,H) int8
    o = da_ops.decode_attn_plain(q_q.reshape(B, G, rep, D),
                                 q_scale.reshape(B, G, rep, 1), k_q, k_s[..., 0],
                                 v_q, v_s[..., 0], lengths)
    return o.reshape(B, 1, H, D).to(q.dtype)


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
               k_q, k_s, v_q, v_s, backend: str = "dense"):
    """One-token decode.  The new token's int8 K/V append in place at each
    slot's own offset ``pos`` (scalar or [B]); attention covers the cache
    including this position.  Returns (out, (k_q, k_s, v_q, v_s))."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos_b = KV.slot_positions(pos, B, x.device).to(x.device)
    q = L.apply_linear(L._lin(p, "wq"), x, backend).reshape(B, 1, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend).reshape(B, 1, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = L.apply_norm(p["q_norm"], q)
        k = L.apply_norm(p["k_norm"], k)
    if cfg.rope_theta:
        pp = pos_b[:, None]
        q = L.apply_rope(q, pp, cfg.rope_theta)
        k = L.apply_rope(k, pp, cfg.rope_theta)
    kq_new, ks_new = quant.quantize_kv(k)
    vq_new, vs_new = quant.quantize_kv(v)
    KV.batched_update(k_q, kq_new, pos_b)
    KV.batched_update(k_s, ks_new, pos_b)
    KV.batched_update(v_q, vq_new, pos_b)
    KV.batched_update(v_s, vs_new, pos_b)
    o = decode_attention_int8(q, k_q, k_s, v_q, v_s, pos_b + 1, backend)
    out = L.apply_linear(L._lin(p, "wo"), o.reshape(B, 1, -1), backend)
    return out, (k_q, k_s, v_q, v_s)


# ---------------------------------------------------------------------------
# speculative verify: T tokens per slot against the int8 SLC cache
# ---------------------------------------------------------------------------
def verify_attention_int8(q: torch.Tensor, k_q, k_s, v_q, v_s, pos,
                          backend: str = "dense", anc=None) -> torch.Tensor:
    """Speculative-verify attention: ``q`` [B, T, H, D], the T tokens of
    each slot's window at positions ``pos[b] .. pos[b]+T-1``; cache as in
    :func:`decode_attention_int8`.  Query ``t`` of slot ``b`` sees keys
    ``[0, pos[b]+t]``, so every row scores exactly as a sequential decode
    step would.  With ``anc`` ([B, T] int32 ancestor bitmasks) the window
    is a draft tree and the mask becomes
    :func:`repro_torch.kernels.verify_tree_attn.tree_visibility_mask`.
    ``fused_int8`` runs the B3 / B4 kernel; every other backend the plain
    version (as the reference's jnp branch)."""
    plain = backend != "fused_int8"
    if anc is not None:
        return vt_ops.verify_attention_tree(q, k_q, k_s, v_q, v_s, pos, anc,
                                            plain=plain)
    return va_ops.verify_attention(q, k_q, k_s, v_q, v_s, pos, plain=plain)


def gqa_verify(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
               k_q, k_s, v_q, v_s, backend: str = "dense", depth=None,
               anc=None):
    """Multi-token decode for the verify step: consume ``x`` ([B, T, d], the
    last committed token plus T-1 drafts per slot) at each slot's cursor.
    The T int8 K/V rows append in place at the per-slot offset and all T
    positions are scored in one pass; K/V rows and integer scores are those
    of T sequential :func:`gqa_decode` calls.  Tree mode (``depth``/``anc``
    both [B, T] int32): node i's row still lands at ``pos + i`` but RoPE
    turns it at its tree depth ``pos + depth[b, i]`` and the mask follows
    the ancestry.  Returns (out, (k_q, k_s, v_q, v_s))."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    pos_b = KV.slot_positions(pos, B, x.device).to(x.device)
    q = L.apply_linear(L._lin(p, "wq"), x, backend).reshape(B, T, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend).reshape(B, T, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = L.apply_norm(p["q_norm"], q)
        k = L.apply_norm(p["k_norm"], k)
    if cfg.rope_theta:
        off = (torch.arange(T, device=x.device)[None, :] if depth is None
               else depth.to(x.device))
        pp = pos_b[:, None] + off
        q = L.apply_rope(q, pp, cfg.rope_theta)
        k = L.apply_rope(k, pp, cfg.rope_theta)
    kq_new, ks_new = quant.quantize_kv(k)
    vq_new, vs_new = quant.quantize_kv(v)
    KV.batched_update(k_q, kq_new, pos_b)
    KV.batched_update(k_s, ks_new, pos_b)
    KV.batched_update(v_q, vq_new, pos_b)
    KV.batched_update(v_s, vs_new, pos_b)
    o = verify_attention_int8(q, k_q, k_s, v_q, v_s, pos_b, backend, anc=anc)
    out = L.apply_linear(L._lin(p, "wo"), o.reshape(B, T, -1), backend)
    return out, (k_q, k_s, v_q, v_s)
