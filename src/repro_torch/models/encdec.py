"""Whisper-style encoder-decoder (audio front end stubbed).

PyTorch counterpart of ``repro.models.encdec``.  The encoder consumes
precomputed frame embeddings ([B, S_enc, d], what the stubbed conv front
end gives) with sinusoidal positions and non-causal attention; the decoder
is a causal LM with cross-attention.  At serve time the cross-attention K/V
are computed once from the encoder output and live, quantized int8, in the
"SLC region" beside the self-attention cache (they are static per request,
the most QLC-like of the cache tensors).

Layers are per-layer lists (``params["enc"]``, ``params["dec"]``), where
the reference stacks them and scans.  The decode state is a per-layer list
of int8 self-attention K/V (``k_q`` ...) and cross K/V (``xk_q`` ...) and a
[B] cursor ``pos`` whose entries are equal (the reference keeps a scalar);
every step updates those tensors in place, so a decode step captured as a
CUDA graph (``models/graphs.py``) replays over fixed addresses.  Decode
self-attention takes ``rt.backend`` (B2 under ``fused_int8``); decode
cross-attention runs the plain int8 attention under every backend, as the
reference calls it without the backend.  :func:`forward_train` and
:func:`lm_loss` are the teacher-forced training path.

On a mesh (``Runtime.mesh``: ``Engine`` and training) the
encoder's and the decoder's attention heads go over the model axis: the
rank's column blocks of ``wq`` / ``wk`` / ``wv`` (self and cross), its row
block of ``wo`` (row-parallel), the FFN dim split as a decoder's is, the
int8 cross K/V cache ``[.., S_enc, H, D]`` holding the rank's heads; the
LayerNorms stay whole, and the tied head gives the rank's vocabulary
columns, gathered (``transformer._lm_head``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core.quant import quantize_kv
from repro_torch.device import generator, resolve
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR
from repro_torch.models.transformer import Runtime, remat_call, token_nll

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Encoder-decoders with GQA/MHA attention, dense FFNs and token
    decoder inputs (the encoder takes frame embeddings)."""
    if not (cfg.family == "encdec" and cfg.attn_type == "gqa" and cfg.encoder_layers > 0
            and cfg.encoder_seq > 0 and not cfg.n_experts and cfg.d_ff):
        raise NotImplementedError(
            f"{cfg.name}: models/encdec.py serves GQA/MHA encoder-decoders with dense "
            "FFNs (ROADMAP A.11.5)")


def _xattn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": L.dense_init(gen, d, cfg.n_heads * hd, dtype)["w"],
            "wk": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype)["w"],
            "wv": L.dense_init(gen, d, cfg.n_kv_heads * hd, dtype)["w"],
            "wo": L.dense_init(gen, cfg.n_heads * hd, d, dtype)["w"]}


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random float parameters drawn from one seeded ``torch.Generator`` on
    ``device``, with the reference's leaves and shapes (the draws differ
    from ``jax.random``'s)."""
    check_supported(cfg)
    gen = generator(device, seed)
    d, dev = cfg.d_model, gen.device

    def norm():
        return L.norm_init(d, cfg.norm_type, dev)
    enc = [{"ln1": norm(), "attn": A.attn_init(gen, cfg, dtype), "ln2": norm(),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype)}
           for _ in range(cfg.encoder_layers)]
    dec = [{"ln1": norm(), "attn": A.attn_init(gen, cfg, dtype), "ln_x": norm(),
            "xattn": _xattn_init(gen, cfg, dtype), "ln2": norm(),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype)}
           for _ in range(cfg.n_layers)]
    return {"embed": L.embed_init(gen, cfg.vocab_size, d, dtype), "enc": enc, "dec": dec,
            "ln_enc": norm(), "ln_f": norm()}


def _heads(p: Params, name: str, x: torch.Tensor, heads: int, hd: int,
           backend: str, x_q: tuple | None = None) -> torch.Tensor:
    B, T = x.shape[:2]
    return L.apply_linear(L._lin(p, name), x, backend, x_q).reshape(B, T, heads, hd)


def _layer(p: Params, key: str, i: int, mc) -> tuple[Params, Any, Any]:
    """Layer ``i`` of ``p[key]`` (``"enc"`` or ``"dec"``) -> (its params,
    its place on a mesh (``transformer._LayerMesh``), the cross-attention's
    ``wo`` reduction); off a mesh (``mc`` None) the params and two Nones."""
    pl = p[key][i]
    if mc is None:
        return pl, None, None
    ls = mc.specs[key][i]
    pl, lm = TR._place_layer(pl, ls, mc)
    xred = mc.red if "xattn" in ls and TR._row_split(ls["xattn"], "wo", mc) else None
    return pl, lm, xred


def encode(p: Params, cfg: ModelConfig, frames: torch.Tensor, rt: Runtime,
           mc=None) -> torch.Tensor:
    """frames: [B, S_enc, d] stubbed front-end output -> [B, S_enc, d]: each
    layer's non-causal attention is :func:`attention.flash_attention` (the
    reference's plain blocked attention, keys in blocks of 1,024); ``mc``
    the call's place on a mesh (a rank's heads)."""
    B, S, _ = frames.shape
    hd = cfg.head_dim
    x = frames + L.sinusoidal_positions(S, cfg.d_model, device=frames.device).to(frames.dtype)
    for i in range(len(p["enc"])):
        pl, lm, _ = _layer(p, "enc", i, mc)
        acfg = lm.attn_cfg if lm else cfg
        h = L.apply_norm(pl["ln1"], x)
        q = _heads(pl["attn"], "wq", h, acfg.n_heads, hd, rt.backend)
        k = _heads(pl["attn"], "wk", h, acfg.n_kv_heads, hd, rt.backend)
        v = _heads(pl["attn"], "wv", h, acfg.n_kv_heads, hd, rt.backend)
        o = A.flash_attention(q, k, v, causal=False)
        x = x + L.apply_linear(L._lin(pl["attn"], "wo"), o.reshape(B, S, -1), rt.backend,
                               reduce=lm.attn_reduce if lm else None)
        x = x + L.apply_mlp(pl["mlp"], L.apply_norm(pl["ln2"], x), cfg.mlp_type, rt.backend,
                            reduce=lm.mlp_reduce if lm else None)
    return L.apply_norm(p["ln_enc"], x)


def _cross_attn(pl: Params, cfg: ModelConfig, h: torch.Tensor, enc_kv: tuple,
                rt: Runtime, decode: bool = False, h_q: tuple | None = None,
                reduce: L.RowReduce | None = None) -> torch.Tensor:
    """Cross-attention of ``h`` [B, T, d] over the encoder's K/V: in prefill
    float ``(k, v)`` through the plain blocked attention; in decode the int8
    ``(k_q, k_s, v_q, v_s)`` through the plain int8 attention over every
    frame, whatever the backend (as the reference calls it).  On a mesh
    ``cfg`` holds the rank's heads and ``reduce`` is ``wo``'s reduction."""
    B, T = h.shape[:2]
    q = _heads(pl, "wq", h, cfg.n_heads, cfg.head_dim, rt.backend, h_q)
    if decode:
        k_q, k_s, v_q, v_s = enc_kv
        # every frame visible: a fill on the device, so a captured step
        # copies nothing from the host
        length = torch.full((B,), k_q.shape[1], dtype=torch.int32, device=h.device)
        o = A.decode_attention_int8(q, k_q, k_s, v_q, v_s, length)
    else:
        k, v = enc_kv
        o = A.flash_attention(q, k, v, causal=False)
    return L.apply_linear(L._lin(pl, "wo"), o.reshape(B, T, -1), rt.backend, reduce=reduce)


def forward_train(p: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
                  rt: Runtime, mc=None) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens`` [B, T] attending to the encoded
    ``frames`` -> hidden after ``ln_f`` [B, T, d]: each decoder layer's
    causal self-attention through :func:`attention.gqa_forward` (no
    buffer), its cross-attention over float K/V of the encoder output,
    under ``rt.remat`` each layer recomputed in the backward.  ``mc``: the
    call's place on a mesh (the rank's heads and rows, each layer's FSDP
    gathers inside its body)."""
    enc = encode(p, cfg, frames, rt, mc)
    B, T = tokens.shape
    dev = tokens.device
    x = p["embed"]["w"][tokens] if mc is None else TR._embed_ids(p, tokens, mc)
    x = x + L.sinusoidal_positions(T, cfg.d_model, device=dev).to(x.dtype)
    positions = torch.arange(T, device=dev).expand(B, T)
    hd = cfg.head_dim

    def body(pl: Params, xx: torch.Tensor, i: int) -> torch.Tensor:
        pl, lm, xred = _layer(p, "dec", i, mc)
        acfg = lm.attn_cfg if lm else cfg
        mix, _ = A.gqa_forward(pl["attn"], acfg, L.apply_norm(pl["ln1"], xx), positions,
                               rt.backend, reduce=lm.attn_reduce if lm else None)
        xx = xx + mix
        k = _heads(pl["xattn"], "wk", enc, acfg.n_kv_heads, hd, rt.backend)
        v = _heads(pl["xattn"], "wv", enc, acfg.n_kv_heads, hd, rt.backend)
        xx = xx + _cross_attn(pl["xattn"], acfg, L.apply_norm(pl["ln_x"], xx), (k, v), rt,
                              reduce=xred)
        return xx + L.apply_mlp(pl["mlp"], L.apply_norm(pl["ln2"], xx), cfg.mlp_type,
                                rt.backend, reduce=lm.mlp_reduce if lm else None)

    for i, pl in enumerate(p["dec"]):
        x = remat_call(rt, body, pl, x, i)
    return L.apply_norm(p["ln_f"], x)


def lm_loss(p: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
            labels: torch.Tensor, rt: Runtime, split: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of the tied head's logits over
    :func:`forward_train`'s hidden rows.  On a mesh (``split``: the rows
    are the rank's block of a batch split over the data axes) the head is
    vocabulary-parallel and the value is the whole loss with the rank's
    share as its gradient, as ``transformer.lm_loss`` has it."""
    mc = TR._mesh_call(p, cfg, rt, split=split)
    h = forward_train(p, cfg, frames, tokens, rt, mc)
    if mc is None:
        return torch.mean(token_nll(torch.matmul(h, p["embed"]["w"].to(h.dtype).T), labels))
    return TR.mesh_loss(TR._nll_mesh(p, cfg, h, labels, rt, mc).sum(), h.shape[0] * h.shape[1],
                        rt, mc)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    """Per decoder layer, the int8 self-attention K/V ([B, max_len, H_kv, D]
    + [B, max_len, H_kv, 1] scales) and cross K/V ([B, S_enc, H_kv, D] +
    scales), and the [B] cursor."""
    check_supported(cfg)
    dev = resolve(device, meta=True)
    G, D = cfg.n_kv_heads, cfg.head_dim

    def kv(rows):
        return (torch.zeros((batch, rows, G, D), dtype=torch.int8, device=dev),
                torch.zeros((batch, rows, G, 1), dtype=torch.float32, device=dev))
    layers = []
    for _ in range(cfg.n_layers):
        c = {}
        for name, rows in (("k", max_len), ("v", max_len), ("xk", cfg.encoder_seq),
                           ("xv", cfg.encoder_seq)):
            c[f"{name}_q"], c[f"{name}_s"] = kv(rows)
        layers.append(c)
    return {"layers": layers, "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(p: Params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor,
            max_len: int, rt: Runtime) -> tuple[torch.Tensor, dict]:
    """Encode the frames, quantize each decoder layer's cross K/V into the
    int8 cache, and run the prompt ``tokens`` [B, T] through the decoder
    (causal self-attention, its K/V rows ``[0, T)`` quantized into the
    cache).  Returns (last-token logits [B, V], decode state)."""
    B, T = tokens.shape
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    dev = tokens.device
    mc = TR._mesh_call(p, cfg, rt)
    enc = encode(p, cfg, frames, rt, mc)
    acfg = TR.local_cfg(cfg, rt)
    state = init_decode_state(acfg, B, max_len, dev)
    x = p["embed"]["w"][tokens] if mc is None else TR._embed_ids(p, tokens, mc)
    x = x + L.sinusoidal_positions(T, cfg.d_model, device=dev).to(x.dtype)
    positions = torch.arange(T, device=dev).expand(B, T)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    hd, G = cfg.head_dim, acfg.n_kv_heads
    for i, cache in enumerate(state["layers"]):
        pl, lm, xred = _layer(p, "dec", i, mc)
        h = L.apply_norm(pl["ln1"], x)
        buf = {"k": torch.zeros((B, T, G, hd), dtype=torch.float32, device=dev),
               "v": torch.zeros((B, T, G, hd), dtype=torch.float32, device=dev)}
        x = x + A.gqa_chunk(pl["attn"], acfg, h, positions, buf, 0, lengths, T, rt.backend,
                            reduce=lm.attn_reduce if lm else None)
        hx = L.apply_norm(pl["ln_x"], x)
        xk = _heads(pl["xattn"], "wk", enc, G, hd, rt.backend)
        xv = _heads(pl["xattn"], "wv", enc, G, hd, rt.backend)
        rows = {}
        for name, val in (("k", buf["k"]), ("v", buf["v"]), ("xk", xk), ("xv", xv)):
            rows[f"{name}_q"], rows[f"{name}_s"] = quantize_kv(val)
        for name, val in rows.items():
            KV.chunk_update(cache[name], val, 0)
        x = x + _cross_attn(pl["xattn"], acfg, hx, (xk, xv), rt, reduce=xred)
        x = x + L.apply_mlp(pl["mlp"], L.apply_norm(pl["ln2"], x), cfg.mlp_type, rt.backend,
                            reduce=lm.mlp_reduce if lm else None)
    x = L.apply_norm(p["ln_f"], x)
    state["pos"].fill_(T)
    return TR._lm_head(p, cfg, x[:, -1], rt, mc), state


def decode_step(p: Params, cfg: ModelConfig, state: dict, token: torch.Tensor,
                rt: Runtime) -> tuple[torch.Tensor, dict]:
    """token: [B] -> (logits [B, V], state).  Each layer's self-attention
    appends its K/V row in place at the cursor and attends through
    ``rt.backend``; cross-attention reads the int8 cross K/V.  The cursor
    advances by one in place; the returned state holds the same tensors."""
    B = token.shape[0]
    mc = TR._mesh_call(p, cfg, rt, state)
    acfg = TR.local_cfg(cfg, rt)
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    emb = p["embed"]["w"][token] if mc is None else TR._embed_ids(p, token, mc)
    x = (emb + L.sinusoid_at(pos, cfg.d_model))[:, None]
    for i, c in enumerate(state["layers"]):
        pl, lm, xred = _layer(p, "dec", i, mc)
        h, h_q = L.apply_norm_q(pl["ln1"], x, rt.backend, pl["attn"], A.INPUT_LINEARS)
        mix, _ = A.gqa_decode(pl["attn"], acfg, h, pos, c["k_q"], c["k_s"], c["v_q"],
                              c["v_s"], rt.backend, h_q, reduce=lm.attn_reduce if lm else None)
        x = x + mix
        hx, hx_q = L.apply_norm_q(pl["ln_x"], x, rt.backend, pl["xattn"], ("wq",))
        x = x + _cross_attn(pl["xattn"], acfg, hx, (c["xk_q"], c["xk_s"], c["xv_q"],
                                                     c["xv_s"]),
                            rt, decode=True, h_q=hx_q, reduce=xred)
        h, h_q = L.apply_norm_q(pl["ln2"], x, rt.backend, pl["mlp"], L.MLP_INPUTS)
        x = x + L.apply_mlp(pl["mlp"], h, cfg.mlp_type, rt.backend, h_q,
                            reduce=lm.mlp_reduce if lm else None)
    x = L.apply_norm(p["ln_f"], x)
    logits = TR._lm_head(p, cfg, x[:, 0], rt, mc)
    state["pos"].add_(1)
    return logits, {"layers": state["layers"], "pos": state["pos"]}
