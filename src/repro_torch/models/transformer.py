"""Decoder-LM assembly for the GQA/MHA and MLA decoders (dense or
mixture-of-experts FFNs), the SSM (Mamba2) family and hybrid stacks that
interleave the two (Jamba: SSM layers, a GQA layer every ``attn_every``,
dense or MoE FFNs).

PyTorch counterpart of ``repro.models.transformer``.  Layers are a per-layer
list (``params["layers"]``), not the reference's stacked ``lax.scan``, and
each layer dispatches on ``cfg.layer_kind(i)``.  The decode state is a
per-layer list: an attention layer's int8 "SLC" cache (under MLA the int8
compressed latent ``c_q`` / ``c_s``), which every step updates **in
place** (the reference donates its state to the same effect), or an SSM
layer's constant-size recurrent state (``conv_x``, ``conv_B``, ``conv_C``,
``h``), and the ``pos`` cursor vector.  Every step writes into
those tensors and never swaps one for a new one, so a step captured as a
CUDA graph (``models/graphs.py``) replays over fixed addresses.  The
decode path is the paper's technique: every static linear can run W8A8
("QLC region"), attention runs against the int8 cache, and norms and softmax
are fp32 "controller ops".  A MoE layer (``models/moe.py``) routes the rows
of each call together, so a MoE stack runs each call's rows in one piece
(see ``PREFILL_PIECE``).  DeepSeek-V3's multi-token-prediction head
(``mtp_proj``, ``mtp_layer``) drafts tokens for the speculative lanes
(:func:`mtp_draft`, :func:`mtp_draft_tree`).  The training forward
(:func:`forward_train`, :func:`lm_loss`, with the MTP term and the MoE
aux loss) runs every layer over the whole sequence under autograd, with
no buffer written in place; ``Runtime.remat`` recomputes each layer in the
backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core.quant import quantize_kv
from repro_torch.device import generator, resolve
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = dict[str, Any]
BACKENDS = ("dense", "ref_int8", "fused_int8", "pim_bitserial")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model apply functions.  The
    reference's mesh fields (``mesh``, ``data_axes``, ``model_axis``,
    ``collective``, ``serve_resident_moe``, ``seq_shard``) are mesh code
    (ROADMAP A.14)."""
    backend: str = "dense"               # dense | ref_int8 | fused_int8 | pim_bitserial
    remat: bool = False                  # training: recompute each layer in the backward
    # the SLC intermediates' dtype (e.g. torch.bfloat16; None: f32): decode
    # and verify hand it to the plain int8 attention and to absorbed MLA
    dmvm_dtype: Any = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.dmvm_dtype is not None and not (isinstance(self.dmvm_dtype, torch.dtype)
                                                and self.dmvm_dtype.is_floating_point):
            raise TypeError(f"dmvm_dtype must be a float torch.dtype or None, got "
                            f"{self.dmvm_dtype!r}")


def check_supported(cfg: ModelConfig) -> None:
    """The port's decoder stack serves GQA/MHA decoders (with RoPE or with
    sinusoidal positions when ``rope_theta == 0``, with or without QK-norm;
    family ``vlm`` too, whose stubbed early-fusion front end hands the
    backbone embeddings, ``input_mode="embeddings"``), MLA decoders (token
    inputs, with or without the MTP head), their FFNs dense or
    mixture-of-experts (``n_experts``, any mix of the two by
    ``is_moe_layer``; token inputs), attention-free SSM (Mamba2) stacks,
    and hybrid stacks that interleave SSM and GQA attention layers
    (``layer_kind``; Jamba), their FFNs dense or mixture-of-experts, token
    inputs.  Encoder-decoders are served by ``models/encdec.py`` (A.11.5),
    not by this stack."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoders are served by models/encdec.py (ROADMAP "
            "A.11.5), not by the decoder stack")
    gqa = cfg.family in ("dense", "vlm", "moe") and cfg.attn_type == "gqa"
    mla = cfg.family in ("dense", "moe") and cfg.attn_type == "mla"
    ssm = cfg.family == "ssm" and cfg.attn_type == "none" and not cfg.d_ff
    hybrid = cfg.family == "hybrid" and cfg.attn_type == "gqa" and cfg.attn_every > 0
    inputs = cfg.input_mode == "tokens" or (gqa and not cfg.n_experts
                                            and cfg.input_mode == "embeddings")
    if (not (gqa or mla or ssm or hybrid) or (ssm and cfg.n_experts) or not inputs
            or (cfg.mtp and not mla)):
        raise NotImplementedError(
            f"{cfg.name}: only GQA/MHA and MLA decoders (dense or MoE FFNs), SSM stacks "
            "and hybrid SSM/GQA stacks are ported so far (other families: ROADMAP A.11)")


def has_ssm(cfg: ModelConfig) -> bool:
    return any(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))


def has_moe(cfg: ModelConfig) -> bool:
    return any(cfg.is_moe_layer(i) for i in range(cfg.n_layers))


def is_seq_cache(cache: dict) -> bool:
    """Whether a layer's decode state has a sequence axis (an attention
    layer's int8 K/V, or MLA's latent), unlike an SSM layer's state."""
    return "k_q" in cache or "c_q" in cache


# ---------------------------------------------------------------------------
# whole-model params
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, i: int,
               dtype=torch.float32) -> Params:
    p: Params = {"ln1": L.norm_init(cfg.d_model, cfg.norm_type, gen.device)}
    if cfg.layer_kind(i) == "ssm":
        p["ssm"] = SSM.ssm_init(gen, cfg, dtype)
    else:
        p["attn"] = A.attn_init(gen, cfg, dtype)
    if cfg.is_moe_layer(i):
        p["ln2"] = L.norm_init(cfg.d_model, cfg.norm_type, gen.device)
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    elif cfg.d_ff:
        p["ln2"] = L.norm_init(cfg.d_model, cfg.norm_type, gen.device)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def _ln1(p: Params, x: torch.Tensor, rt: Runtime) -> tuple:
    """A serve path's ``ln1`` over ``x`` and, where its mixer's input
    linears take it, its output's int8 pair (:func:`layers.apply_norm_q`)."""
    if "ssm" in p:
        return L.apply_norm_q(p["ln1"], x, rt.backend, p["ssm"], SSM.INPUT_LINEARS)
    return L.apply_norm_q(p["ln1"], x, rt.backend, p["attn"], A.INPUT_LINEARS)


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """A layer's feed-forward block with its residual: the MoE (the rows of
    ``x`` [B, T, d] routed together, b-major; the router and the dispatched
    rows take the float rows), the MLP (its input linears the norm's int8
    pair where the backend takes it), or nothing."""
    if "moe" in p:
        return x + MOE.moe_apply(p["moe"], L.apply_norm(p["ln2"], x), cfg)[0]
    if "mlp" in p:
        h, h_q = L.apply_norm_q(p["ln2"], x, rt.backend, p["mlp"], L.MLP_INPUTS)
        return x + L.apply_mlp(p["mlp"], h, cfg.mlp_type, rt.backend, h_q)
    return x


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random float parameters drawn from one seeded ``torch.Generator`` on
    ``device`` (the draws differ from ``jax.random``'s; tests that compare
    the two packages convert the JAX parameters instead)."""
    check_supported(cfg)
    gen = generator(device, seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
                 "ln_f": L.norm_init(cfg.d_model, cfg.norm_type, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    p["layers"] = [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)]
    if cfg.mtp:
        # the MTP head: a float projection of [h; embed(tok)] and a layer of
        # the last layer's structure (a MoE layer in DeepSeek-V3)
        p["mtp_proj"] = L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype)
        p["mtp_layer"] = init_layer(gen, cfg, cfg.n_layers - 1, dtype)
    return p


def embedded(cfg: ModelConfig, inputs: torch.Tensor) -> bool:
    """Whether ``inputs`` are embeddings rather than token ids: float rows
    ([B, d] or [B, T, d], what the stubbed front end of a configuration with
    ``input_mode="embeddings"`` gives) where the configuration takes them,
    as the reference's ``_embed`` and ``decode_step`` tell them apart."""
    return cfg.input_mode == "embeddings" and inputs.is_floating_point()


def _embed(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
           positions: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings of ``inputs``, or ``inputs`` themselves where they
    are embeddings (:func:`embedded`), plus the sinusoidal embedding of
    ``positions`` for the families without RoPE (a tensor of the shape of
    the token axes, never a host int, so a captured step reads its
    positions on every replay; it may be None where ``cfg.rope_theta`` is
    set)."""
    x = inputs if embedded(cfg, inputs) else p["embed"]["w"][inputs]
    if not cfg.rope_theta:
        x = x + L.sinusoid_at(positions, cfg.d_model).to(x.dtype)
    return x


def _lm_head(p: Params, cfg: ModelConfig, h: torch.Tensor, rt: Runtime) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(h, p["embed"]["w"].to(h.dtype).T)
    return L.apply_linear(L._lin(p["lm_head"], "w"), h, rt.backend)


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------
def apply_layer_train(p: Params, cfg: ModelConfig, i: int, x: torch.Tensor,
                      positions: torch.Tensor, rt: Runtime
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i`` of the training forward over ``x`` [B, T, d] -> (x, the
    MoE block's load-balance loss, 0 for other layers).  An SSM layer takes
    :func:`ssm.ssm_forward`'s tensor path (``use_kernel`` left False, as the
    reference leaves it in training), attention the causal full-sequence
    form with no K/V buffer."""
    h = L.apply_norm(p["ln1"], x)
    if cfg.layer_kind(i) == "ssm":
        mix = SSM.ssm_forward(p["ssm"], cfg, h, backend=rt.backend)
    elif cfg.attn_type == "mla":
        mix, _ = A.mla_forward(p["attn"], cfg, h, positions, rt.backend)
    else:
        mix, _ = A.gqa_forward(p["attn"], cfg, h, positions, rt.backend)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        mo, aux = MOE.moe_apply(p["moe"], L.apply_norm(p["ln2"], x), cfg, with_aux=True)
        x = x + mo
    elif "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.mlp_type, rt.backend)
    return x, aux


def remat_call(rt: Runtime, fn, *args):
    """``fn(*args)``; under ``rt.remat`` through ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the inputs and recomputes the body in
    the backward, as the reference's ``jax.checkpoint`` does."""
    if rt.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward_train(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                  rt: Runtime) -> tuple[torch.Tensor, torch.Tensor]:
    """inputs: [B, T] int tokens (or [B, T, d] embeddings, see
    :func:`embedded`) -> (hidden after ``ln_f`` [B, T, d], the layers'
    summed MoE aux loss), over the per-layer list in order (the order in
    which the reference's scans over its groups add the aux)."""
    B, T = inputs.shape[:2]
    positions = torch.arange(T, device=inputs.device).expand(B, T)
    x = _embed(p, cfg, inputs, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(p["layers"]):
        x, aux = remat_call(rt, lambda lp_, x_, i=i: apply_layer_train(
            lp_, cfg, i, x_, positions, rt), lp, x)
        aux_total = aux_total + aux
    return L.apply_norm(p["ln_f"], x), aux_total


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` per row, in f32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def lm_loss(p: Params, cfg: ModelConfig, inputs: torch.Tensor, labels: torch.Tensor,
            rt: Runtime, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T], the head applied to
    ``chunk``-token pieces of the sequence (to bound the logits' memory, as
    the reference's scan does), plus DeepSeek-V3's ``0.3 *`` MTP term where
    the configuration has the head and ``0.01 *`` the MoE aux loss."""
    h, aux = forward_train(p, cfg, inputs, rt)
    B, T = h.shape[:2]
    n_chunks = max(1, T // chunk)
    if T % n_chunks:
        n_chunks = 1
    tc = T // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        logits = _lm_head(p, cfg, h[:, c * tc:(c + 1) * tc], rt)
        total = total + torch.sum(token_nll(logits, labels[:, c * tc:(c + 1) * tc]))
    loss = total / torch.full((), float(B * T), device=h.device)
    if cfg.mtp:
        loss = loss + 0.3 * _mtp_loss(p, cfg, h, inputs, labels, rt)
    return loss + 0.01 * aux


def _mtp_loss(p: Params, cfg: ModelConfig, h: torch.Tensor, inputs: torch.Tensor,
              labels: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction (depth 1): ``hm[:, t]``, from
    ``h[:, t]`` and the embedding of token t+1, predicts ``labels[:, t+1]``
    (token t+2)."""
    B, T = inputs.shape[:2]
    emb_next = _embed(p, cfg, inputs, torch.arange(T, device=h.device).expand(B, T))[:, 1:]
    hm = L.apply_linear(L._lin(p["mtp_proj"], "w"), torch.cat([h[:, :-1], emb_next], dim=-1),
                        rt.backend)
    positions = torch.arange(T - 1, device=h.device).expand(B, T - 1)
    hm, _ = apply_layer_train(p["mtp_layer"], cfg, cfg.n_layers - 1, hm, positions, rt)
    return torch.mean(token_nll(_lm_head(p, cfg, hm, rt), labels[:, 1:]))


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    """Per layer, an int8 K/V cache ([B, S, H_kv, D] + [B, S, H_kv, 1]
    scales), MLA's int8 latent cache (``c_q`` [B, S, r + dr] + ``c_s``
    [B, S, 1] scales) or an SSM layer's zero recurrent state; and the [B]
    per-slot position vector."""
    check_supported(cfg)
    dev = resolve(device, meta=True)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    sc = (batch, max_len, cfg.n_kv_heads, 1)

    def layer(i):
        if cfg.layer_kind(i) == "ssm":
            return SSM.init_ssm_state(cfg, batch, dev)
        if cfg.attn_type == "mla":
            dim = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            return {"c_q": torch.zeros((batch, max_len, dim), dtype=torch.int8, device=dev),
                    "c_s": torch.zeros((batch, max_len, 1), dtype=torch.float32, device=dev)}
        return {"k_q": torch.zeros(kv, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(sc, dtype=torch.float32, device=dev),
                "v_q": torch.zeros(kv, dtype=torch.int8, device=dev),
                "v_s": torch.zeros(sc, dtype=torch.float32, device=dev)}
    layers = [layer(i) for i in range(cfg.n_layers)]
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def write_slot(state: dict, slot: int, one: dict, start: int = 0) -> dict:
    """Land a single-request decode state (batch=1) into row ``slot`` of a
    pooled multi-slot state, in place — the admission step of continuous
    batching.  The slot index clamps to the pool like the reference's
    ``dynamic_update_slice``; the row's cache may be shorter than the pool's
    (it lands at sequence rows ``[start, start + S_row)``, the rows before
    ``start`` left as they are).  SSM leaves have no sequence axis and land
    whole.  The slot's cursor becomes ``one["pos"]``."""
    B = state["pos"].shape[0]
    s = min(max(int(slot), 0), B - 1)
    for full, row in zip(state["layers"], one["layers"]):
        for name, buf in full.items():
            r = torch.as_tensor(row[name])
            if not is_seq_cache(full):               # SSM state: whole
                buf[s] = r[0].to(buf.device, buf.dtype)
                continue
            if start + r.shape[1] > buf.shape[1]:
                raise ValueError(f"row of {r.shape[1]} positions at {start} does "
                                 f"not fit a pool of {buf.shape[1]}")
            buf[s, start:start + r.shape[1]] = r[0].to(buf.device, buf.dtype)
    pos = torch.as_tensor(one["pos"]).reshape(-1)[0]
    state["pos"][s] = pos.to(state["pos"].device, state["pos"].dtype)
    return state


def read_slot(state: dict, slot: int, n: int | None = None) -> dict:
    """Row ``slot`` of a pooled decode state as a batch=1 copy, the inverse
    of :func:`write_slot` and the device half of a tiered-pool swap-out: the
    int8 payload and scales leave the pool verbatim.  ``n`` keeps only the
    first ``n`` sequence rows of every attention leaf (the live rows a swap
    moves; SSM state is fixed-size and comes whole)."""
    B = state["pos"].shape[0]
    s = min(max(int(slot), 0), B - 1)
    rows = slice(None) if n is None else slice(0, int(n))
    return {"layers": [{k: (v[s:s + 1, rows] if is_seq_cache(c) else v[s:s + 1]).clone()
                        for k, v in c.items()}
                       for c in state["layers"]],
            "pos": state["pos"][s:s + 1].clone()}


def copy_slot_prefix(state: dict, src: int, dst: int, n: int) -> dict:
    """Prefix-cache row gather, in place: ``dst``'s first ``n`` sequence rows
    of every cache leaf become ``src``'s (int8 payload and scales copied
    verbatim, so the reused prefix is bit-identical to the cached one) and
    ``pos[dst]`` becomes ``n``.  Rows at or past ``n`` keep ``dst``'s dead
    entries (masked, then overwritten by the resumed chunked prefill's
    finalize).  Attention pools only (every leaf ``[B, S, H, ...]``)."""
    n = int(n)
    for cache in state["layers"]:
        if not is_seq_cache(cache):
            raise NotImplementedError("copy_slot_prefix targets attention pools")
        for buf in cache.values():
            buf[int(dst), :n] = buf[int(src), :n]
    state["pos"][int(dst)] = n
    return state


def warm_prefill_carry(cfg: ModelConfig, state: dict, slot: int, n: int,
                       buf_len: int, tokens=None) -> dict:
    """Chunked-prefill carry seeded from rows ``[0:n)`` of pool ``slot``, the
    prefix-cache warm start.  The cached int8 rows dequantize into the float
    K/V carry at the same positions (the rest zero), ``tokens`` (the
    prompt's first ``n`` ids, optional) fill the carry's token ids, and the
    cursor starts at ``n``: chunked prefill resumes mid-prompt as if the
    first ``n`` tokens had just been consumed.  A chunk never rewrites the
    carry's rows below its cursor (:func:`prefill_chunk`), so the resumed
    tail attends exactly these dequantized rows, as the reference's does.
    Attention stacks only: SSM state cannot restart mid-prompt (the engine
    turns the prefix cache off for SSM stacks, and for MLA stacks, whose
    latent cache cannot seed per-head K/V without the weights)."""
    if has_ssm(cfg):
        raise NotImplementedError(
            "prefix-cache warm start targets attention pools; SSM state "
            "cannot restart mid-prompt")
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "prefix-cache warm start needs per-head K/V in the pool; the MLA "
            "latent cache cannot seed the float carry without weights")
    dev = state["pos"].device
    carry = init_prefill_carry(cfg, buf_len, dev)
    n = int(n)
    for buf, cache in zip(carry["layers"], state["layers"]):
        w = min(n, buf_len, cache["k_q"].shape[1])
        for name in ("k", "v"):
            q, sc = cache[f"{name}_q"][slot, :w], cache[f"{name}_s"][slot, :w]
            buf[name][0, :w] = q.to(torch.float32) * sc
    if tokens is not None:
        ids = torch.as_tensor(list(tokens)[:n], dtype=torch.int64)
        carry["tokens"][0, :ids.numel()] = ids.to(dev)
    carry["pos"].fill_(n)
    return carry


def apply_layer_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
                       cache: dict, rt: Runtime) -> torch.Tensor:
    """One layer of the decode step; an attention layer appends to its cache
    in place, an SSM layer copies its new state into its state's tensors."""
    h, h_q = _ln1(p, x, rt)
    if "ssm" in p:
        mix, new = SSM.ssm_decode(p["ssm"], cfg, h, cache, rt.backend, h_q)
        for name, val in new.items():
            cache[name].copy_(val)
    elif cfg.attn_type == "mla":
        mix, _ = A.mla_decode(p["attn"], cfg, h, pos, cache["c_q"], cache["c_s"], rt.backend,
                              h_q, rt.dmvm_dtype)
    else:
        mix, _ = A.gqa_decode(p["attn"], cfg, h, pos, cache["k_q"], cache["k_s"],
                              cache["v_q"], cache["v_s"], rt.backend, h_q, rt.dmvm_dtype)
    return _ffn(p, cfg, x + mix, rt)


def decode_step(p: Params, cfg: ModelConfig, state: dict, token: torch.Tensor,
                rt: Runtime) -> tuple[torch.Tensor, dict]:
    """token: [B] (or [B, d] embeddings, see :func:`embedded`) -> (logits
    [B, V], state).  The caches and the cursor update in place (the cursor
    advances by one); the returned state holds the same tensors."""
    B = token.shape[0]
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    x = _embed(p, cfg, token, pos)[:, None]
    for lp, cache in zip(p["layers"], state["layers"]):
        x = apply_layer_decode(lp, cfg, x, pos, cache, rt)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x[:, 0], rt)
    state["pos"].add_(1)
    return logits, {"layers": state["layers"], "pos": state["pos"]}


def multi_decode_step(p: Params, cfg: ModelConfig, state: dict,
                      token: torch.Tensor, m: int, rt: Runtime
                      ) -> tuple[torch.Tensor, dict]:
    """Fused multi-step greedy decode: ``m`` :func:`decode_step` calls, each
    step's argmax (ties to the lowest id) fed back as the next token on the
    device.  ``token`` is the [B] vector of last committed tokens.  Returns
    ``(tokens [B, m] int32, state advanced by m)``, token-identical to m
    host-driven steps.  A caller that stops a slot mid-block rewinds its
    cursor (:func:`rewind_pos`); the overshoot rows die in place, as a
    rejected speculative suffix does, so the pool needs ``m - 1`` rows of
    headroom past ``max_len``.  Engines do not fuse SSM stacks: their state
    cannot rewind."""
    tok = token.to(torch.int32)
    toks = []
    for _ in range(m):
        logits, state = decode_step(p, cfg, state, tok, rt)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1), state


# ---------------------------------------------------------------------------
# speculative decode: batched multi-token verify + cursor rollback
# ---------------------------------------------------------------------------
def apply_layer_verify(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
                       cache: dict, rt: Runtime, depth=None, anc=None
                       ) -> torch.Tensor:
    """One layer of the verify pass: :func:`apply_layer_decode` over ``x``
    [B, T, d], appending T K/V rows at each slot's cursor.  ``depth``/``anc``
    ([B, T] int32) switch the window to tree mode (see
    :func:`attention.gqa_verify`)."""
    h, h_q = _ln1(p, x, rt)
    if cfg.attn_type == "mla":
        mix, _ = A.mla_verify(p["attn"], cfg, h, pos, cache["c_q"], cache["c_s"],
                              rt.backend, depth=depth, anc=anc, x_q=h_q,
                              inter_dtype=rt.dmvm_dtype)
    else:
        mix, _ = A.gqa_verify(p["attn"], cfg, h, pos, cache["k_q"], cache["k_s"],
                              cache["v_q"], cache["v_s"], rt.backend,
                              depth=depth, anc=anc, x_q=h_q, inter_dtype=rt.dmvm_dtype)
    return _ffn(p, cfg, x + mix, rt)


def verify_step(p: Params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                rt: Runtime, depth=None, anc=None
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Speculative-decode verify: feed ``tokens`` [B, T] (per slot: the last
    committed token plus T-1 drafts) at each slot's cursor in one batched
    pass.  Returns ``(logits [B, T, V], hidden [B, T, d], state)``: row
    ``i`` of ``logits`` is the next-token distribution after
    ``tokens[:, :i+1]``, what ``i+1`` sequential :func:`decode_step` calls
    give; ``hidden`` is the post-``ln_f`` hidden state per position.  The
    caches and the cursor update in place (the cursor advances by T); the
    caller commits an accepted prefix by rewinding the cursor
    (:func:`rewind_pos`), and the rejected rows stay as dead entries that
    the position mask hides and the next append overwrites.

    Tree mode (``depth``/``anc`` both [B, T] int32): ``tokens[:, i]`` is
    node i of a draft tree in topological order (node 0 = root = last
    committed token; bit j of ``anc[b, i]`` set iff node j is an
    ancestor-or-self of node i); positions come from tree depth, masks from
    ancestry.  The caller commits the accepted root-path with
    :func:`tree_commit`.

    Attention stacks only: an SSM layer's recurrent state cannot be rewound
    without checkpointing, so SSM engines keep the one-token decode loop."""
    if has_ssm(cfg):
        raise NotImplementedError(
            "speculative verify needs a rewindable cache; SSM stacks keep the "
            "one-token decode path (see serve engine)")
    B, T = tokens.shape[:2]
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    positions = None
    if not cfg.rope_theta:
        positions = pos[:, None] + (torch.arange(T, device=tokens.device)[None, :]
                                    if depth is None else depth.to(tokens.device))
    x = _embed(p, cfg, tokens, positions)
    for lp, cache in zip(p["layers"], state["layers"]):
        x = apply_layer_verify(lp, cfg, x, pos, cache, rt, depth=depth, anc=anc)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x, rt)
    state["pos"].add_(T)
    return logits, x, {"layers": state["layers"], "pos": state["pos"]}


def rewind_pos(state: dict, pos) -> dict:
    """Speculative-decode (and fused-block) rollback: commit each slot's
    accepted prefix by writing its cursor ``pos`` ([B] int32) into the
    state's cursor tensor, in place.  The rejected rows need no erase: the
    position mask hides them until the next append overwrites them."""
    cur = state["pos"]
    cur.copy_(torch.as_tensor(pos, dtype=cur.dtype).reshape(cur.shape))
    return {"layers": state["layers"], "pos": cur}


def tree_commit(state: dict, base, sel, keep, pos) -> dict:
    """Tree-spec commit: move each slot's accepted root-path rows into
    contiguous committed rows (in place, :func:`kvcache.path_gather` on
    every leaf), then rewind the cursor.  ``base``/``keep``: [B] int32
    (pre-window cursor, accepted path length); ``sel``: [B, W] in-window
    node indices of the path in order; node ``sel[b, w]``'s row, turned at
    position ``base + 1 + w``, moves to row ``base + 1 + w``.  ``pos`` is
    the [B] cursor after the commit."""
    for cache in state["layers"]:
        for buf in cache.values():
            KV.path_gather(buf, base, sel, keep)
    return rewind_pos(state, pos)


# ---------------------------------------------------------------------------
# prefill: the float "GPU stage" that also builds the decode cache
# ---------------------------------------------------------------------------
# An attention stack prefills in pieces of PREFILL_PIECE rows at multiples
# of PREFILL_PIECE, one-shot and chunked alike (a chunk that starts inside
# a piece runs that piece again from its first row: the carry keeps the
# token ids).  Every float call of the piece at ``lo`` (the linears, and
# the attention over the carry's first ``lo + PREFILL_PIECE`` keys as one
# block) has the same shape whatever the prompt's length or its chunking,
# and a row's result depends only on its own inputs at a given shape (a key
# a row cannot see adds an exact zero).  So each token's K/V and hidden
# states, and the first token's logits, are the same bits one-shot as in
# any chunking, which keeps chunked serving token-identical to one-shot
# serving on the card as the reference's chunked prefill is on its devices
# (a float GEMM or reduction of another row count sums in another order).
# A piece dispatches the same ops wherever it starts, so a prompt's
# dispatch grows with its pieces.
#
# A stack with MoE layers runs each call as one piece instead: the prompt's
# T rows (B rows b-major) one-shot, a chunk's C rows at the cursor.  Its
# layers route the rows of a call together, with a capacity counted from
# the call's rows, so a MoE stack must route exactly the rows of the
# reference's call (no row padded past it, none before the cursor run
# again); its one-shot and chunked prefill then differ as the reference's
# do.
PREFILL_PIECE = 64


def carry_len(max_len: int, chunk: int | None = None) -> int:
    """Rows of the float K/V carry for prompts of up to ``max_len`` tokens,
    prefilled in chunks of ``chunk`` rows (``None``: in one shot, for any
    stack): a piece starts at or before a real token (``< max_len``) and
    spans ``PREFILL_PIECE`` rows (a MoE stack's chunk its ``chunk`` rows),
    so it never clamps onto valid rows."""
    return max_len + max(PREFILL_PIECE, chunk or 0)


def prefill_pieces(cfg: ModelConfig, n_tokens: int) -> int:
    """Prefill calls (pieces) a prompt of ``n_tokens`` (padded) tokens
    takes in one shot: an SSM or MoE stack prefills in one."""
    return 1 if has_ssm(cfg) or has_moe(cfg) else -(-n_tokens // PREFILL_PIECE)


def chunk_pieces(cfg: ModelConfig, cursor: int, n: int) -> int:
    """Pieces a chunk of ``n`` tokens at ``cursor`` runs: every piece it
    touches (one for a MoE stack)."""
    if has_moe(cfg):
        return 1
    return (cursor + n - 1) // PREFILL_PIECE - cursor // PREFILL_PIECE + 1


def _prefill_piece(p: Params, cfg: ModelConfig, bufs: list, tokens: torch.Tensor,
                   start: int, n_real: torch.Tensor, rt: Runtime,
                   skip: int = 0) -> torch.Tensor:
    """One ``[B, P]`` piece (or its ``[B, P, d]`` embeddings) at positions
    ``start + arange(P)`` in every row (``P`` is ``PREFILL_PIECE`` and
    ``start`` a multiple of it, but for a MoE stack's one piece a call;
    ``n_real``: [B] int32, row b's first ``n_real[b]`` tokens are real)
    through every layer: the piece's K/V from its row ``skip`` on land in
    the float buffers ``bufs`` in place (the rows before stay as they are),
    and its queries attend keys ``< start + n_real`` among the buffers'
    first ``start + P`` rows.  Returns the hidden states after ``ln_f``
    [B, P, d]."""
    B, P = tokens.shape[:2]
    dev = tokens.device
    key_rows = start + P
    start_t = torch.full((B,), start, dtype=torch.int32, device=dev)
    positions = start_t[:, None] + torch.arange(P, device=dev)
    x = _embed(p, cfg, tokens, positions)
    kv_lengths = start_t + n_real
    # what every layer shares: the rotary tables and the key blocks' masks
    rope = (L.rope_tables(positions, A.rope_dim(cfg), cfg.rope_theta)
            if cfg.rope_theta else None)
    hidden = A.hidden_masks(P, key_rows, key_rows, q_offset=start_t,
                            kv_lengths=kv_lengths, device=dev)
    attn = A.mla_chunk if cfg.attn_type == "mla" else A.gqa_chunk
    for lp, buf in zip(p["layers"], bufs):
        h, h_q = _ln1(lp, x, rt)
        x = x + attn(lp["attn"], cfg, h, positions, buf, start, kv_lengths, key_rows,
                     rt.backend, rope=rope, hidden=hidden, skip=skip, x_q=h_q)
        x = _ffn(lp, cfg, x, rt)
    return L.apply_norm(p["ln_f"], x)


def _piece(inputs: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """Rows ``[lo, lo + size)`` of the token axis of ``inputs`` ([B, T] ids
    or [B, T, d] embeddings), right-padded to ``size`` rows with token 0 or
    zero rows."""
    part = inputs[:, lo:lo + size]
    pad = (0, size - part.shape[1])
    return torch.nn.functional.pad(part, (0, 0) * (part.dim() - 2) + pad)


def prefill(p: Params, cfg: ModelConfig, inputs: torch.Tensor, max_len: int,
            rt: Runtime, lengths: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Process prompts [B, T] (or [B, T, d] embeddings, see
    :func:`embedded`); return (last-token logits, decode state).

    ``lengths`` ([B] int32, optional) admits a ragged right-padded batch:
    attention masks each row's keys to its own prefix, logits are gathered
    at each row's last real token, and the state carries per-slot
    positions.  An attention stack runs in pieces of ``PREFILL_PIECE`` rows
    (a MoE stack in one piece of T rows) against a float K/V carry (see
    above), whose rows ``[0, T)`` are
    quantized into the int8 cache (padded rows included; decode masks and
    then overwrites them).  A stack with SSM layers (hybrid included) runs
    every layer over all T tokens in one piece (:func:`_prefill_exact`):
    an SSM layer the chunked SSD, handing its final recurrent state to
    decode (the engine prefills SSM stacks at exact length); under
    ``fused_int8`` its intra-chunk part runs B6, under every other backend
    the tensor path, as attention takes B2 by the same rule."""
    B, T = inputs.shape[:2]
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    dev = inputs.device
    lengths = (torch.full((B,), T, dtype=torch.int32, device=dev) if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int32,
                                    device=dev).reshape(-1).expand(B))
    if has_ssm(cfg):
        return _prefill_exact(p, cfg, inputs, max_len, rt, lengths)
    carry = init_prefill_carry(cfg, carry_len(max_len), dev, batch=B)
    rows = torch.arange(B, device=dev)
    size = T if has_moe(cfg) else PREFILL_PIECE
    last = None
    for lo in range(0, T, size):
        n_real = torch.clamp(lengths - lo, 0, size)
        h = _prefill_piece(p, cfg, carry["layers"], _piece(inputs, lo, size), lo, n_real, rt)
        at = lengths - 1 - lo                  # each row's last token, if here
        cand = h[rows, torch.clamp(at, 0, size - 1).long()]
        here = ((at >= 0) & (at < size))[:, None]
        last = cand if last is None else torch.where(here, cand, last)
    state = init_decode_state(cfg, B, max_len, dev)
    for cache, buf in zip(state["layers"], carry["layers"]):
        for name, val in _quantize_carry(buf, 0, T).items():
            KV.chunk_update(cache[name], val, 0)
    state["pos"] = lengths.clone()
    return _lm_head(p, cfg, last, rt), state


def _prefill_exact(p: Params, cfg: ModelConfig, inputs: torch.Tensor, max_len: int,
                   rt: Runtime, lengths: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`prefill` of a stack with SSM layers (Mamba2, or a hybrid that
    interleaves attention layers), each layer over all T tokens in one
    piece, as the reference's prefill dispatches them.  An SSM layer runs
    the chunked SSD and hands its final recurrent state to decode (B6 under
    ``fused_int8``).  An attention layer attends the T rows as one block of
    keys, each row's keys masked to its ``lengths`` (the padding the SSM
    layers scan through is not masked: the engine prefills SSM stacks at
    exact length), and its K/V rows ``[0, T)`` are quantized into the int8
    cache as the other stacks' are."""
    B, T = inputs.shape[:2]
    dev = inputs.device
    positions = torch.arange(T, device=dev).expand(B, T)
    x = _embed(p, cfg, inputs, positions)
    state = init_decode_state(cfg, B, max_len, dev)
    if any("attn" in lp for lp in p["layers"]):
        rope = (L.rope_tables(positions, A.rope_dim(cfg), cfg.rope_theta)
                if cfg.rope_theta else None)
        hidden = A.hidden_masks(T, T, T, q_offset=torch.zeros_like(lengths),
                                kv_lengths=lengths, device=dev)
    for lp, cache in zip(p["layers"], state["layers"]):
        h, h_q = _ln1(lp, x, rt)
        if "ssm" in lp:
            mix, new = SSM.ssm_forward(lp["ssm"], cfg, h, backend=rt.backend,
                                       return_state=True,
                                       use_kernel=rt.backend == "fused_int8", x_q=h_q)
            cache.update(new)
        else:
            kv = (B, T, cfg.n_kv_heads, cfg.head_dim)
            buf = {"k": torch.zeros(kv, dtype=torch.float32, device=dev),
                   "v": torch.zeros(kv, dtype=torch.float32, device=dev)}
            mix = A.gqa_chunk(lp["attn"], cfg, h, positions, buf, 0, lengths, T,
                              rt.backend, rope=rope, hidden=hidden, x_q=h_q)
            for name, val in _quantize_carry(buf, 0, T).items():
                KV.chunk_update(cache[name], val, 0)
        x = _ffn(lp, cfg, x + mix, rt)
    x = L.apply_norm(p["ln_f"], x)
    last = x[torch.arange(B, device=x.device), (lengths - 1).long()]
    state["pos"] = lengths.clone()
    return _lm_head(p, cfg, last, rt), state


# ---------------------------------------------------------------------------
# chunked prefill: the prompt is consumed [1, C] tokens at a time, so decode
# iterations never stall behind a whole prompt's prefill
# ---------------------------------------------------------------------------
def init_prefill_carry(cfg: ModelConfig, buf_len: int,
                       device: str | torch.device = "cuda", batch: int = 1) -> dict:
    """Float K/V carry of one in-flight prefill: each attention layer keeps
    ``[batch, buf_len, H_kv, D]`` f32 K and V, so later chunks attend the
    earlier prefix at prefill precision (under MLA per-head K of width
    ``dn + dr`` and V of ``dv``, plus the latent's halves ``lat_c``
    ``[batch, buf_len, r]`` and ``lat_r`` ``[batch, buf_len, dr]``, which
    the int8 cache is quantized from), the token ids consumed
    (``tokens``, [batch, buf_len] int64), so a chunk can run the piece it
    starts in from that piece's first row, and the cursor ``pos`` ([batch]
    int32).  ``buf_len`` is ``carry_len(max_len, chunk)``.  SSM stacks prefill at exact length (their
    recurrent state would integrate the chunk boundary), so a carry for one
    raises."""
    check_supported(cfg)
    dev = resolve(device, meta=True)
    if has_ssm(cfg):
        raise NotImplementedError(
            "chunked prefill carries attention K/V only; SSM stacks "
            "prefill at exact length (see serve engine)")
    def zeros(*shape):
        return torch.zeros((batch, buf_len, *shape), dtype=torch.float32, device=dev)
    if cfg.attn_type == "mla":
        H = cfg.n_heads
        layers = [{"k": zeros(H, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                   "v": zeros(H, cfg.v_head_dim), "lat_c": zeros(cfg.kv_lora_rank),
                   "lat_r": zeros(cfg.qk_rope_head_dim)} for _ in range(cfg.n_layers)]
    else:
        layers = [{"k": zeros(cfg.n_kv_heads, cfg.head_dim),
                   "v": zeros(cfg.n_kv_heads, cfg.head_dim)} for _ in range(cfg.n_layers)]
    return {"layers": layers,
            "tokens": torch.zeros((batch, buf_len), dtype=torch.int64, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill_chunk(p: Params, cfg: ModelConfig, carry: dict, tokens: torch.Tensor,
                  n_real: int, rt: Runtime) -> tuple[torch.Tensor, dict]:
    """Consume one ``[1, C]`` token chunk at the carry's cursor, in the
    ``PREFILL_PIECE``-row pieces it touches (:func:`chunk_pieces`).  Rows of
    the first piece before the cursor run again (from the carry's token
    ids) but keep the carry's K/V: on a cold carry a rerun would write the
    same bits, and on a warm carry (:func:`warm_prefill_carry`) they hold
    the cached rows, dequantized, which is what the chunk attends.
    ``n_real`` (1 <= n_real <= C) counts the chunk's real tokens: a
    prompt's last chunk is right-padded to C, and the engine's token budget
    may cut a chunk short.  ``tokens`` may be ``[1, C, d]`` embeddings
    (:func:`embedded`): the carry then keeps every row's input as an
    embedding (``embeds``, the rows fed so far as ids looked up in the
    table), so a rerun piece reads the same rows, and takes no id chunk
    after that (``ValueError``).  A MoE stack runs the chunk as one piece
    of its C rows at the cursor, padding included, as the reference's call
    routes them (nothing before the cursor runs again).  Returns (logits of
    the chunk's last real token [1, V], the carry), the carry's K/V, inputs
    and cursor updated in place (the cursor advances by ``n_real``)."""
    n = int(n_real)
    if not 1 <= n <= tokens.shape[1]:
        raise ValueError(f"n_real {n} outside a chunk of {tokens.shape[1]}")
    cursor = int(carry["pos"].reshape(-1)[0])     # one cursor: a carry is B = 1
    end = cursor + n
    if embedded(cfg, tokens):
        if "embeds" not in carry:
            carry["embeds"] = p["embed"]["w"][carry["tokens"]]
        src = carry["embeds"]
    elif "embeds" in carry:
        raise ValueError("a prefill carry that holds embeddings takes embedding chunks only")
    else:
        src = carry["tokens"]
    src[:, cursor:end] = tokens[:, :n]
    if has_moe(cfg):
        h = _prefill_piece(p, cfg, carry["layers"], tokens, cursor,
                           torch.full_like(carry["pos"], n), rt)
        carry["pos"].add_(n)
        return _lm_head(p, cfg, h[:, n - 1], rt), carry
    for lo in range(cursor - cursor % PREFILL_PIECE, end, PREFILL_PIECE):
        k = min(PREFILL_PIECE, end - lo)
        h = _prefill_piece(p, cfg, carry["layers"], src[:, lo:lo + PREFILL_PIECE],
                           lo, torch.full_like(carry["pos"], k), rt,
                           skip=max(cursor - lo, 0))
    carry["pos"].add_(n)
    return _lm_head(p, cfg, h[:, k - 1], rt), carry


def finalize_prefill_carry(cfg: ModelConfig, carry: dict, max_len: int,
                           start: int = 0) -> dict:
    """Quantize a completed prefill carry's rows ``[start, max_len)`` into a
    decode state, the prefill->decode K/V handoff; it plugs into
    :func:`write_slot` at the same ``start``.  Per-(token, head)
    quantization gives the int8 rows the one-shot prefill writes for the
    same floats.  A warm carry passes the cached row count as ``start``:
    those rows are already in the slot, and requantizing their dequantized
    values need not give back the same scale bits on every device (a
    division by 127 done as a multiply by its reciprocal drifts by an ulp)."""
    return {"layers": [_quantize_carry(b, start, max_len) for b in carry["layers"]],
            "pos": carry["pos"].to(torch.int32).clone()}


def _quantize_carry(buf: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of one layer's float carry as its int8 cache
    leaves: per-(token, head) K/V, or under MLA the latent ``[lat_c;
    lat_r]`` per token (:func:`attention._quantize_latent`)."""
    if "lat_c" in buf:
        c_q, c_s = A._quantize_latent(torch.cat([buf["lat_c"][:, lo:hi],
                                                 buf["lat_r"][:, lo:hi]], dim=-1))
        return {"c_q": c_q, "c_s": c_s}
    k_q, k_s = quantize_kv(buf["k"][:, lo:hi])
    v_q, v_s = quantize_kv(buf["v"][:, lo:hi])
    return {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}


# ---------------------------------------------------------------------------
# the MTP head: DeepSeek-V3's depth-1 multi-token prediction, drafting
# ---------------------------------------------------------------------------
def _mtp_cell(p: Params, cfg: ModelConfig, h: torch.Tensor, tok: torch.Tensor,
              pos_i: torch.Tensor, rt: Runtime) -> tuple[torch.Tensor, torch.Tensor]:
    """One MTP step: ``[h; embed(tok)]`` through ``mtp_proj`` and
    ``mtp_layer`` at positions ``pos_i`` [B], one position and no cache,
    then ``lm_head`` with no ``ln_f`` -> (logits [B, V], new h [B, d]).
    The layer's MoE routes the B rows together."""
    emb = p["embed"]["w"][tok.long()].to(h.dtype)
    hm = L.apply_linear(L._lin(p["mtp_proj"], "w"), torch.cat([h, emb], dim=-1), rt.backend)
    lp, x = p["mtp_layer"], hm[:, None]
    h, h_q = _ln1(lp, x, rt)
    mix, _ = A.mla_forward(lp["attn"], cfg, h, pos_i[:, None], rt.backend, h_q)
    x = _ffn(lp, cfg, x + mix, rt)[:, 0]
    return _lm_head(p, cfg, x, rt), x


def _mtp_inputs(cfg: ModelConfig, hidden, token, pos) -> tuple:
    if not cfg.mtp:
        raise ValueError(f"{cfg.name} has no MTP head (cfg.mtp is False)")
    return (hidden.to(torch.float32), token.to(torch.int32), pos.to(torch.int32))


def mtp_draft(p: Params, cfg: ModelConfig, hidden: torch.Tensor, token: torch.Tensor,
              pos: torch.Tensor, k: int, rt: Runtime) -> torch.Tensor:
    """``k`` greedy drafts a slot from the MTP head applied recursively:
    step i feeds the previous step's hidden and token at ``pos + i``.
    ``hidden`` [B, d] is the post-``ln_f`` hidden at each slot's last
    committed position (zeros right after a prefill: the head then runs
    from the embedding alone), ``token`` [B] the last committed tokens,
    ``pos`` [B] the cursors.  Returns int32 [B, k]."""
    h, tok, pos = _mtp_inputs(cfg, hidden, token, pos)
    drafts = []
    for i in range(k):
        logits, h = _mtp_cell(p, cfg, h, tok, pos + i, rt)
        tok = torch.argmax(logits, -1).to(torch.int32)
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


def mtp_chain_lengths(n: int, branch: int) -> list[int]:
    """Node budgets of the MTP draft tree's chains: ``n`` nodes over
    ``min(branch, n)`` root-child chains, earlier chains longer."""
    b = max(1, min(branch, n))
    return [n // b + (1 if j < n % b else 0) for j in range(b)]


def mtp_draft_tree(p: Params, cfg: ModelConfig, hidden: torch.Tensor, token: torch.Tensor,
                   pos: torch.Tensor, n: int, branch: int, rt: Runtime) -> torch.Tensor:
    """A static draft tree from the MTP head: the top-``branch`` tokens of
    its first distribution (ties to the lower id, as ``lax.top_k``) each
    root a chain extended greedily, with node budgets from
    :func:`mtp_chain_lengths`.  Returns int32 [B, n] in chain-major order
    (chain j's nodes consecutive, its first a child of the root); at
    ``branch = 1`` it is :func:`mtp_draft`."""
    h, tok, pos = _mtp_inputs(cfg, hidden, token, pos)
    lens = mtp_chain_lengths(n, branch)
    logits0, h1 = _mtp_cell(p, cfg, h, tok, pos, rt)
    _, top = MOE._top_k(logits0, len(lens))
    drafts = []
    for j, clen in enumerate(lens):
        hj, tj = h1, top[:, j].to(torch.int32)
        drafts.append(tj)
        for s in range(1, clen):
            lg, hj = _mtp_cell(p, cfg, hj, tj, pos + s, rt)
            tj = torch.argmax(lg, -1).to(torch.int32)
            drafts.append(tj)
    return torch.stack(drafts, dim=1)
