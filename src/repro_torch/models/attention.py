"""Attention: GQA / MHA and MLA; blocked (flash-style) prefill attention and
int8-KV decode attention (the paper's dMVM, Sec. IV-B / Fig. 13).

PyTorch counterpart of ``repro.models.attention``.  Decode
attention computes ``q . K^T`` and ``S . V`` against the int8 "SLC-region"
cache: under ``fused_int8`` through the B2 kernel, otherwise through the
plain version of the same function.  Speculative verify attention scores a
window of T tokens per slot the same way: under ``fused_int8`` through the
B3 (linear window) or B4 (draft tree) kernel, otherwise through their plain
versions.  MLA (DeepSeek-V3) caches one int8 compressed latent a token
(``kv_lora_rank + qk_rope_head_dim`` wide) instead of per-head K/V and
decodes in the latent space; the reference computes it with plain einsums
(no Pallas kernel), and so does the port, its linears through the same
backends as every other linear.

On a mesh (``Runtime.mesh``) a GQA layer whose KV heads tile the model
axis runs each rank's block of heads: the caller hands these functions a
configuration with the rank's head counts, the rank's column blocks of
``wq`` / ``wk`` / ``wv``, its row block of ``wo`` with the row-parallel
reduction (``reduce``, ``layers.RowReduce``) and its block of the int8
pool (KV heads, dim 2); B2 / B3 / B4 run over that block.  Where the heads
do not tile, every rank runs them all.  Prefill turns RoPE by
``layers.apply_rope_spmd`` on a mesh, as the reference's ``_rope`` does.
An MLA layer on a mesh runs the rank's query heads in the same way: its
column blocks of ``wq_b`` and ``wkv_b``, its row block of ``wo``; the
narrow outputs of ``wq_a`` and ``wkv_a`` come column-parallel and are
all-gathered over the model axis (``cols``) before their RMSNorms, so the
latent every rank writes into its (model-replicated) pool is one device's.
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
# the linears that read an attention block's input: a mixer function's
# ``x_q`` is that input's int8 pair (``layers.apply_norm_q``), which they
# take in place of quantizing it each
INPUT_LINEARS = ("wq", "wk", "wv", "wq_a", "wkv_a")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.attn_type == "mla":
        qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return {"wq_a": L.dense_init(gen, d, cfg.q_lora_rank, dtype)["w"],
                "q_norm": L.norm_init(cfg.q_lora_rank, device=gen.device),
                "wq_b": L.dense_init(gen, cfg.q_lora_rank, cfg.n_heads * qk_head, dtype)["w"],
                "wkv_a": L.dense_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                      dtype)["w"],
                "kv_norm": L.norm_init(cfg.kv_lora_rank, device=gen.device),
                "wkv_b": L.dense_init(gen, cfg.kv_lora_rank, cfg.n_heads * (
                    cfg.qk_nope_head_dim + cfg.v_head_dim), dtype)["w"],
                "wo": L.dense_init(gen, cfg.n_heads * cfg.v_head_dim, d, dtype)["w"]}
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.attn_type} attention is not ported")
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


def gqa_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                backend: str = "dense", reduce: L.RowReduce | None = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Training GQA over ``x`` [B, T, d] at ``positions`` [B, T]: causal
    :func:`flash_attention` over the call's own K/V, no buffer written (the
    training forward runs under autograd; :func:`gqa_chunk` writes a carry
    in place).  On a mesh ``cfg`` holds the rank's heads and ``reduce`` is
    ``wo``'s reduction.  Returns (out, (k, v))."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = L.apply_linear(L._lin(p, "wq"), x, backend).reshape(B, T, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend).reshape(B, T, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = L.apply_norm(p["q_norm"], q)
        k = L.apply_norm(p["k_norm"], k)
    if cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v)
    return L.apply_linear(L._lin(p, "wo"), o.reshape(B, T, -1), backend,
                          reduce=reduce), (k, v)


def gqa_chunk(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, buf: dict, start: int,
              kv_lengths: torch.Tensor, key_rows: int, backend: str = "dense",
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              hidden: list[torch.Tensor] | None = None,
              skip: int = 0, x_q: tuple | None = None,
              reduce: L.RowReduce | None = None, mesh: bool = False) -> torch.Tensor:
    """One chunk of a chunked prefill.  ``x``: [B, C, d] hidden chunk whose
    tokens sit at ``positions`` (= start + arange(C)); ``buf`` carries the
    float K/V of the whole in-flight prompt ([B, S_buf, H_kv, D]).  The
    chunk's k/v from its row ``skip`` on land in ``buf`` in place at offset
    ``start + skip`` (clamped to ``[0, S_buf - (C - skip)]`` as the
    reference's ``dynamic_update_slice`` clamps it; rows before ``skip``
    keep the buffer's K/V) and q attends the resident prefix
    ``[0, kv_lengths)`` at full precision, as one-shot prefill does, over
    the buffer's first ``key_rows`` rows as one block of keys.  A key a row
    cannot see adds an exact zero to that row's sums, so rows past the
    visible prefix change no bit.  ``rope`` (:func:`layers.rope_tables` of
    ``positions``) and ``hidden`` (:func:`hidden_masks`) may come
    precomputed, once for every layer of a call (on a ``mesh``, RoPE takes
    :func:`layers.apply_rope_spmd` instead).  Returns the
    attention block's output."""
    B, C, _ = x.shape
    hd = cfg.head_dim
    q = L.apply_linear(L._lin(p, "wq"), x, backend, x_q).reshape(B, C, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend, x_q).reshape(B, C, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend, x_q).reshape(B, C, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = L.apply_norm(p["q_norm"], q)
        k = L.apply_norm(p["k_norm"], k)
    if cfg.rope_theta and mesh:
        q = L.apply_rope_spmd(q, positions, cfg.rope_theta)
        k = L.apply_rope_spmd(k, positions, cfg.rope_theta)
    elif cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta, tables=rope)
        k = L.apply_rope(k, positions, cfg.rope_theta, tables=rope)
    KV.chunk_update(buf["k"], k[:, skip:], start + skip)
    KV.chunk_update(buf["v"], v[:, skip:], start + skip)
    o = flash_attention(q, buf["k"][:, :key_rows].to(q.dtype),
                        buf["v"][:, :key_rows].to(q.dtype), q_offset=start,
                        kv_lengths=kv_lengths, kv_block=key_rows, hidden=hidden)
    return L.apply_linear(L._lin(p, "wo"), o.reshape(B, C, -1), backend, reduce=reduce)


# ---------------------------------------------------------------------------
# decode attention against the int8 SLC cache (dMVM)
# ---------------------------------------------------------------------------
def decode_attention_int8(q: torch.Tensor, k_q, k_s, v_q, v_s, length,
                          backend: str = "dense", inter_dtype=None) -> torch.Tensor:
    """q: [B, 1, H, D] float; cache: [B, S, Hkv, D] int8 (+[B, S, Hkv, 1]
    f32); ``length`` a scalar or [B] per-slot cache lengths.  ``fused_int8``
    runs the B2 kernel; every other backend the plain version (as the
    reference's jnp branch), its SLC intermediates (dequantized V, softmax
    weights) at ``inter_dtype`` (``None``: f32), which B2 ignores as the
    reference's Pallas branch does."""
    if backend == "fused_int8":
        return da_ops.decode_attention(q, k_q, k_s, v_q, v_s, length)
    B, _, H, D = q.shape
    G = k_q.shape[2]
    rep = H // G
    lengths = KV.slot_positions(length, B, q.device).to(q.device)
    q_q, q_scale = quant.quantize_kv(q.reshape(B, H, D))      # per-(B,H) int8
    o = da_ops.decode_attn_plain(q_q.reshape(B, G, rep, D),
                                 q_scale.reshape(B, G, rep, 1), k_q, k_s[..., 0],
                                 v_q, v_s[..., 0], lengths, inter_dtype)
    return o.reshape(B, 1, H, D).to(q.dtype)


def gqa_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
               k_q, k_s, v_q, v_s, backend: str = "dense", x_q: tuple | None = None,
               inter_dtype=None, reduce: L.RowReduce | None = None):
    """One-token decode.  The new token's int8 K/V append in place at each
    slot's own offset ``pos`` (scalar or [B]); attention covers the cache
    including this position, its SLC intermediates at ``inter_dtype`` (see
    :func:`decode_attention_int8`).  Returns (out, (k_q, k_s, v_q, v_s))."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos_b = KV.slot_positions(pos, B, x.device).to(x.device)
    q = L.apply_linear(L._lin(p, "wq"), x, backend, x_q).reshape(B, 1, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend, x_q).reshape(B, 1, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend, x_q).reshape(B, 1, cfg.n_kv_heads, hd)
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
    o = decode_attention_int8(q, k_q, k_s, v_q, v_s, pos_b + 1, backend, inter_dtype)
    out = L.apply_linear(L._lin(p, "wo"), o.reshape(B, 1, -1), backend, reduce=reduce)
    return out, (k_q, k_s, v_q, v_s)


# ---------------------------------------------------------------------------
# speculative verify: T tokens per slot against the int8 SLC cache
# ---------------------------------------------------------------------------
def verify_attention_int8(q: torch.Tensor, k_q, k_s, v_q, v_s, pos,
                          backend: str = "dense", anc=None,
                          inter_dtype=None) -> torch.Tensor:
    """Speculative-verify attention: ``q`` [B, T, H, D], the T tokens of
    each slot's window at positions ``pos[b] .. pos[b]+T-1``; cache as in
    :func:`decode_attention_int8`.  Query ``t`` of slot ``b`` sees keys
    ``[0, pos[b]+t]``, so every row scores exactly as a sequential decode
    step would.  With ``anc`` ([B, T] int32 ancestor bitmasks) the window
    is a draft tree and the mask becomes
    :func:`repro_torch.kernels.verify_tree_attn.tree_visibility_mask`.
    ``fused_int8`` runs the B3 / B4 kernel; every other backend the plain
    version (as the reference's jnp branch), its SLC intermediates at
    ``inter_dtype`` (see :func:`decode_attention_int8`)."""
    plain = backend != "fused_int8"
    if anc is not None:
        return vt_ops.verify_attention_tree(q, k_q, k_s, v_q, v_s, pos, anc,
                                            plain=plain, inter_dtype=inter_dtype)
    return va_ops.verify_attention(q, k_q, k_s, v_q, v_s, pos, plain=plain,
                                   inter_dtype=inter_dtype)


def gqa_verify(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
               k_q, k_s, v_q, v_s, backend: str = "dense", depth=None,
               anc=None, x_q: tuple | None = None, inter_dtype=None,
               reduce: L.RowReduce | None = None):
    """Multi-token decode for the verify step: consume ``x`` ([B, T, d], the
    last committed token plus T-1 drafts per slot) at each slot's cursor.
    The T int8 K/V rows append in place at the per-slot offset and all T
    positions are scored in one pass; K/V rows and integer scores are those
    of T sequential :func:`gqa_decode` calls.  Tree mode (``depth``/``anc``
    both [B, T] int32): node i's row still lands at ``pos + i`` but RoPE
    turns it at its tree depth ``pos + depth[b, i]`` and the mask follows
    the ancestry.  ``inter_dtype``: see :func:`decode_attention_int8`.
    Returns (out, (k_q, k_s, v_q, v_s))."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    pos_b = KV.slot_positions(pos, B, x.device).to(x.device)
    q = L.apply_linear(L._lin(p, "wq"), x, backend, x_q).reshape(B, T, cfg.n_heads, hd)
    k = L.apply_linear(L._lin(p, "wk"), x, backend, x_q).reshape(B, T, cfg.n_kv_heads, hd)
    v = L.apply_linear(L._lin(p, "wv"), x, backend, x_q).reshape(B, T, cfg.n_kv_heads, hd)
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
    o = verify_attention_int8(q, k_q, k_s, v_q, v_s, pos_b, backend, anc=anc,
                              inter_dtype=inter_dtype)
    out = L.apply_linear(L._lin(p, "wo"), o.reshape(B, T, -1), backend, reduce=reduce)
    return out, (k_q, k_s, v_q, v_s)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed-latent cache, absorbed decode
# ---------------------------------------------------------------------------
def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE turns: MLA's rope half, else the head."""
    return cfg.qk_rope_head_dim if cfg.attn_type == "mla" else cfg.head_dim


def _quantize_latent(latent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of MLA latent rows ``[..., r + dr]`` ->
    (int8 codes, f32 scales ``[..., 1]``), the one quantizer of every latent
    the port caches (decode, verify, one-shot prefill and a chunked
    prefill's finalize), so their rows are the same bits for the same
    floats.  It divides by 127 as ``core/quant.py`` does (an IEEE division
    on every device)."""
    return quant.quantize_activation(latent)


def _whole(cols, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, the output of linear ``name``, with every column: ``cols``
    gathers a column-parallel output on a mesh (None off one)."""
    return t if cols is None else cols(name, t)


def _mla_q(p: Params, cfg: ModelConfig, x: torch.Tensor, positions, backend: str,
           rope=None, x_q: tuple | None = None, cols=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries ``[B, T, H, dn]`` (no position) and ``[B, T, H, dr]`` (turned
    at ``positions``); ``q_norm`` hands ``wq_b`` its output's int8 pair
    (:func:`layers.apply_norm_q`); ``cols`` see :func:`_whole`."""
    B, T, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_a = _whole(cols, "wq_a", L.apply_linear(L._lin(p, "wq_a"), x, backend, x_q))
    q_lat, q_lat_q = L.apply_norm_q(p["q_norm"], q_a, backend, p, ("wq_b",))
    q = L.apply_linear(L._lin(p, "wq_b"), q_lat, backend, q_lat_q).reshape(
        B, T, cfg.n_heads, dn + dr)
    return q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta, tables=rope)


def _mla_latent(p: Params, cfg: ModelConfig, x: torch.Tensor, positions, backend: str,
                rope=None, x_q: tuple | None = None, cols=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The latent's two halves: the normed ``c_kv`` ``[B, T, r]`` and the
    key's rope part ``[B, T, dr]`` turned at ``positions``."""
    r = cfg.kv_lora_rank
    kv_a = _whole(cols, "wkv_a", L.apply_linear(L._lin(p, "wkv_a"), x, backend, x_q))
    c_kv = L.apply_norm(p["kv_norm"], kv_a[..., :r])
    k_rope = L.apply_rope(kv_a[:, :, None, r:], positions, cfg.rope_theta, tables=rope)
    return c_kv, k_rope[:, :, 0]


def mla_chunk(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, buf: dict, start: int,
              kv_lengths: torch.Tensor, key_rows: int, backend: str = "dense",
              rope: tuple[torch.Tensor, torch.Tensor] | None = None,
              hidden: list[torch.Tensor] | None = None,
              skip: int = 0, x_q: tuple | None = None,
              reduce: L.RowReduce | None = None, cols=None) -> torch.Tensor:
    """Prefill MLA over a chunk, :func:`gqa_chunk`'s sibling: per-head float
    keys ``[k_nope; k_rope]`` (width ``dn + dr``, the rope part shared by
    every head) and values (width ``dv``) land in ``buf["k"]`` /
    ``buf["v"]`` from the chunk's row ``skip`` on, and the latent's two
    halves in ``buf["lat_c"]`` / ``buf["lat_r"]`` (what the int8 cache is
    quantized from); queries attend keys ``[0, kv_lengths)`` among the
    buffer's first ``key_rows`` rows at full precision, scores scaled by
    ``1 / sqrt(dn + dr)``.  ``rope`` holds tables of width ``dr``.  On a
    mesh ``cfg`` holds the rank's heads, ``reduce`` is ``wo``'s reduction
    and ``cols`` gathers ``wq_a`` / ``wkv_a`` (RoPE turns rotate-half, as
    one device's, so a rank's floats are one device's for its heads)."""
    B, C, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend, rope, x_q, cols)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions, backend, rope, x_q, cols)
    kv = L.apply_linear(L._lin(p, "wkv_b"), c_kv, backend).reshape(B, C, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None].expand(B, C, H, dr)], dim=-1)
    for name, val in (("k", k), ("v", kv[..., dn:]), ("lat_c", c_kv), ("lat_r", k_rope)):
        KV.chunk_update(buf[name], val[:, skip:], start + skip)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(qf, buf["k"][:, :key_rows].to(qf.dtype),
                        buf["v"][:, :key_rows].to(qf.dtype), q_offset=start,
                        kv_lengths=kv_lengths, kv_block=key_rows, hidden=hidden)
    return L.apply_linear(L._lin(p, "wo"), o.reshape(B, C, -1), backend, reduce=reduce)


def mla_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                backend: str = "dense", x_q: tuple | None = None,
                reduce: L.RowReduce | None = None, cols=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill MLA over ``x`` [B, T, d] at ``positions`` with no cache (the
    MTP head's cell): (out, latent ``[B, T, r + dr]``); ``reduce`` and
    ``cols`` on a mesh, see :func:`mla_chunk`."""
    B, T, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend, x_q=x_q, cols=cols)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions, backend, x_q=x_q, cols=cols)
    kv = L.apply_linear(L._lin(p, "wkv_b"), c_kv, backend).reshape(B, T, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None].expand(B, T, H, dr)], dim=-1)
    o = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, kv[..., dn:])
    out = L.apply_linear(L._lin(p, "wo"), o.reshape(B, T, -1), backend, reduce=reduce)
    return out, torch.cat([c_kv, k_rope], dim=-1)


def _absorbed(p: Params, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``wkv_b`` as float ``[r, H, dn + dv]`` (a quantized tree's codes
    times their per-column scales, as the reference dequantizes them every
    step), split into ``w_uk`` [r, H, dn] and ``w_uv`` [r, H, dv]."""
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    w = p["wkv_b"] if "wkv_b" in p else p["wkv_b_q"].to(torch.float32) * p["wkv_b_s"]
    w = w.reshape(cfg.kv_lora_rank, cfg.n_heads, dn + dv)
    return w[..., :dn], w[..., dn:]


def _mla_latent_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, pos_b: torch.Tensor,
                          pp: torch.Tensor, c_q: torch.Tensor, c_s: torch.Tensor,
                          mask: torch.Tensor, backend: str,
                          x_q: tuple | None = None, inter_dtype=None,
                          reduce: L.RowReduce | None = None, cols=None) -> torch.Tensor:
    """Absorbed MLA over ``x`` [B, T, d] whose token t sits at ``pp[:, t]``:
    the T int8 latents append in place at rows ``pos_b .. pos_b + T - 1``,
    then attention runs in the latent space against the dequantized cache,
    ``mask`` [B, T, S] (True where a key is visible), and ``wo``.  MLA has
    no kernel, so the SLC intermediates take ``inter_dtype`` (``None``:
    f32) under every backend, rounded where the reference rounds them: the
    absorbed query ``q_eff`` (its product's result is of that dtype), the
    dequantized cache (codes and scales cast to it, multiplied in it), the
    rope query and the softmax weights; the two score products and the
    latent P . V sum in f32 and ``w_uv`` stays f32.  On a mesh (``cfg`` the
    rank's heads, ``reduce``, ``cols``: see :func:`mla_chunk`) every rank
    writes the whole latent and runs its heads over it."""
    B, T, _ = x.shape
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, pp, backend, x_q=x_q, cols=cols)
    c_kv, k_rope = _mla_latent(p, cfg, x, pp, backend, x_q=x_q, cols=cols)
    lq, sc = _quantize_latent(torch.cat([c_kv, k_rope], dim=-1))
    KV.batched_update(c_q, lq, pos_b)
    KV.batched_update(c_s, sc, pos_b)
    w_uk, w_uv = _absorbed(p, cfg)
    dt = inter_dtype or torch.float32
    q_eff = da_ops.at_dtype(torch.einsum("bthd,rhd->bthr", da_ops.at_dtype(q_nope, dt),
                                         da_ops.at_dtype(w_uk, dt)), dt)     # absorb W_UK
    cache = (c_q.to(dt) * c_s.to(dt)).to(torch.float32)                      # [B, S, r + dr]
    scores = (torch.einsum("bthr,bsr->bths", q_eff, cache[..., :r])
              + torch.einsum("bthd,bsd->bths", da_ops.at_dtype(q_rope, dt), cache[..., r:]))
    scores = (scores / math.sqrt(dn + dr)).masked_fill(~mask[:, :, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bths,bsr->bthr", da_ops.at_dtype(w, dt),
                         cache[..., :r])                                     # latent-space SV
    o = torch.einsum("bthr,rhd->bthd", o_lat, w_uv)                          # expand W_UV
    return L.apply_linear(L._lin(p, "wo"), o.reshape(B, T, -1).to(x.dtype), backend,
                          reduce=reduce)


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos, c_q: torch.Tensor,
               c_s: torch.Tensor, backend: str = "dense", x_q: tuple | None = None,
               inter_dtype=None, reduce: L.RowReduce | None = None, cols=None):
    """Absorbed MLA decode of one token a slot: its int8 latent appends in
    place at each slot's ``pos`` (scalar or [B]) and the step reads only the
    ``[S, r + dr]`` int8 latent rows, the paper's SLC-cache read, its
    intermediates at ``inter_dtype`` (see :func:`_mla_latent_attention`).
    Returns (out, (c_q, c_s))."""
    B = x.shape[0]
    pos_b = KV.slot_positions(pos, B, x.device).to(x.device)
    S = c_q.shape[1]
    mask = (torch.arange(S, device=x.device)[None, :] < (pos_b + 1)[:, None])[:, None]
    out = _mla_latent_attention(p, cfg, x, pos_b, pos_b[:, None], c_q, c_s, mask, backend,
                                x_q, inter_dtype, reduce, cols)
    return out, (c_q, c_s)


def mla_verify(p: Params, cfg: ModelConfig, x: torch.Tensor, pos, c_q: torch.Tensor,
               c_s: torch.Tensor, backend: str = "dense", depth=None, anc=None,
               x_q: tuple | None = None, inter_dtype=None,
               reduce: L.RowReduce | None = None, cols=None):
    """:func:`mla_decode` over a verify window ``x`` [B, T, d]: the T latents
    append at each slot's cursor and query t sees the cache up to
    ``pos + t``; tree mode (``depth``/``anc``) turns token i at
    ``pos + depth[:, i]`` and masks by ancestry (see :func:`gqa_verify`).
    Returns (out, (c_q, c_s))."""
    B, T, _ = x.shape
    dev = x.device
    pos_b = KV.slot_positions(pos, B, dev).to(dev)
    off = torch.arange(T, device=dev)[None, :] if depth is None else depth.to(dev)
    pp = pos_b[:, None] + off
    S = c_q.shape[1]
    if anc is not None:
        mask = vt_ops.tree_visibility_mask(pos_b, anc.to(dev), S, T)
    else:
        mask = torch.arange(S, device=dev)[None, None, :] < (pos_b[:, None] + torch.arange(
            T, device=dev)[None, :] + 1)[..., None]
    out = _mla_latent_attention(p, cfg, x, pos_b, pp, c_q, c_s, mask, backend, x_q,
                                inter_dtype, reduce, cols)
    return out, (c_q, c_s)
