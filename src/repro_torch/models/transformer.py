"""Decoder-LM assembly for the dense GQA and SSM (Mamba2) families.

PyTorch counterpart of ``repro.models.transformer``.  Layers are a per-layer
list (``params["layers"]``), not the reference's stacked ``lax.scan``, and
each layer dispatches on ``cfg.layer_kind(i)``.  The decode state is a
per-layer list: an attention layer's int8 "SLC" cache, which every step
updates **in place** (the reference donates its state to the same effect),
or an SSM layer's constant-size recurrent state (``conv_x``, ``conv_B``,
``conv_C``, ``h``), whose leaves each step replaces in the same dict.  The
decode path is the paper's technique: every static linear can run W8A8
("QLC region"), attention runs against the int8 cache, and norms and softmax
are fp32 "controller ops".
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core.quant import quantize_kv
from repro_torch.device import resolve
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Params = dict[str, Any]
BACKENDS = ("dense", "ref_int8", "fused_int8", "pim_bitserial")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model apply functions."""
    backend: str = "dense"               # dense | ref_int8 | fused_int8 | pim_bitserial

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense GQA decoders with RoPE and attention-free SSM
    (Mamba2) stacks so far."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: hybrid SSM/attention stacks wait on models/moe.py "
            "(ROADMAP A.11)")
    dense = (cfg.family == "dense" and cfg.attn_type == "gqa"
             and bool(cfg.rope_theta))
    ssm = cfg.family == "ssm" and cfg.attn_type == "none" and not cfg.d_ff
    if not (dense or ssm) or cfg.n_experts or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders with RoPE and SSM stacks are "
            "ported so far (other families: ROADMAP A.11)")


def has_ssm(cfg: ModelConfig) -> bool:
    return any(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))


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
    if cfg.d_ff:
        p["ln2"] = L.norm_init(cfg.d_model, cfg.norm_type, gen.device)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random float parameters drawn from one seeded ``torch.Generator`` on
    ``device`` (the draws differ from ``jax.random``'s; tests that compare
    the two packages convert the JAX parameters instead)."""
    check_supported(cfg)
    gen = torch.Generator(device=resolve(device)).manual_seed(seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
                 "ln_f": L.norm_init(cfg.d_model, cfg.norm_type, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    p["layers"] = [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)]
    return p


def _embed(p: Params, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    return p["embed"]["w"][inputs]


def _lm_head(p: Params, cfg: ModelConfig, h: torch.Tensor, rt: Runtime) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(h, p["embed"]["w"].to(h.dtype).T)
    return L.apply_linear(L._lin(p["lm_head"], "w"), h, rt.backend)


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    """Per layer, an int8 K/V cache ([B, S, H_kv, D] + [B, S, H_kv, 1]
    scales) or an SSM layer's zero recurrent state; and the [B] per-slot
    position vector."""
    check_supported(cfg)
    dev = resolve(device)
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    sc = (batch, max_len, cfg.n_kv_heads, 1)

    def layer(i):
        if cfg.layer_kind(i) == "ssm":
            return SSM.init_ssm_state(cfg, batch, dev)
        return {"k_q": torch.zeros(kv, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(sc, dtype=torch.float32, device=dev),
                "v_q": torch.zeros(kv, dtype=torch.int8, device=dev),
                "v_s": torch.zeros(sc, dtype=torch.float32, device=dev)}
    layers = [layer(i) for i in range(cfg.n_layers)]
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def write_slot(state: dict, slot: int, one: dict) -> dict:
    """Land a single-request decode state (batch=1) into row ``slot`` of a
    pooled multi-slot state, in place — the admission step of continuous
    batching.  The slot index clamps to the pool like the reference's
    ``dynamic_update_slice``; the row's cache may be shorter than the pool's
    (it lands at rows ``[0, S_row)``).  SSM leaves have no sequence axis and
    land whole."""
    B = state["pos"].shape[0]
    s = min(max(int(slot), 0), B - 1)
    for full, row in zip(state["layers"], one["layers"]):
        for name, buf in full.items():
            r = row[name]
            if r.shape[1] > buf.shape[1]:
                raise ValueError(f"row of {r.shape[1]} positions does not fit "
                                 f"a pool of {buf.shape[1]}")
            buf[s, :r.shape[1]] = r[0].to(buf.dtype)
    state["pos"][s] = one["pos"].reshape(-1)[0].to(state["pos"].dtype)
    return state


def read_slot(state: dict, slot: int) -> dict:
    """Row ``slot`` of a pooled decode state as a batch=1 copy — the inverse
    of :func:`write_slot`."""
    B = state["pos"].shape[0]
    s = min(max(int(slot), 0), B - 1)
    return {"layers": [{k: v[s:s + 1].clone() for k, v in c.items()}
                       for c in state["layers"]],
            "pos": state["pos"][s:s + 1].clone()}


def apply_layer_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
                       cache: dict, rt: Runtime) -> torch.Tensor:
    """One layer of the decode step; an attention layer appends to its cache
    in place, an SSM layer replaces its state's leaves in ``cache``."""
    h = L.apply_norm(p["ln1"], x)
    if "ssm" in p:
        mix, new = SSM.ssm_decode(p["ssm"], cfg, h, cache, rt.backend)
        cache.update(new)
    else:
        mix, _ = A.gqa_decode(p["attn"], cfg, h, pos, cache["k_q"], cache["k_s"],
                              cache["v_q"], cache["v_s"], rt.backend)
    x = x + mix
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.mlp_type,
                            rt.backend)
    return x


def decode_step(p: Params, cfg: ModelConfig, state: dict, token: torch.Tensor,
                rt: Runtime) -> tuple[torch.Tensor, dict]:
    """token: [B] -> (logits [B, V], new state).  The caches update in
    place; the returned state shares them and carries ``pos + 1``."""
    B = token.shape[0]
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    x = _embed(p, cfg, token)[:, None]
    for lp, cache in zip(p["layers"], state["layers"]):
        x = apply_layer_decode(lp, cfg, x, pos, cache, rt)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x[:, 0], rt)
    return logits, {"layers": state["layers"], "pos": pos + 1}


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
    h = L.apply_norm(p["ln1"], x)
    mix, _ = A.gqa_verify(p["attn"], cfg, h, pos, cache["k_q"], cache["k_s"],
                          cache["v_q"], cache["v_s"], rt.backend,
                          depth=depth, anc=anc)
    x = x + mix
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.mlp_type,
                            rt.backend)
    return x


def verify_step(p: Params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                rt: Runtime, depth=None, anc=None
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Speculative-decode verify: feed ``tokens`` [B, T] (per slot: the last
    committed token plus T-1 drafts) at each slot's cursor in one batched
    pass.  Returns ``(logits [B, T, V], hidden [B, T, d], state)``: row
    ``i`` of ``logits`` is the next-token distribution after
    ``tokens[:, :i+1]``, what ``i+1`` sequential :func:`decode_step` calls
    give; ``hidden`` is the post-``ln_f`` hidden state per position.  The
    caches update in place and the returned state carries ``pos + T``; the
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
    B, T = tokens.shape
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    x = _embed(p, cfg, tokens)
    for lp, cache in zip(p["layers"], state["layers"]):
        x = apply_layer_verify(lp, cfg, x, pos, cache, rt, depth=depth, anc=anc)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x, rt)
    return logits, x, {"layers": state["layers"], "pos": pos + T}


def rewind_pos(state: dict, pos) -> dict:
    """Speculative-decode rollback: commit each slot's accepted prefix by
    rewinding its cursor to ``pos`` ([B] int32).  The rejected rows need no
    erase: the position mask hides them until the next append overwrites
    them."""
    dev = state["pos"].device
    return {"layers": state["layers"],
            "pos": torch.as_tensor(pos, dtype=torch.int32, device=dev)}


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
def prefill(p: Params, cfg: ModelConfig, inputs: torch.Tensor, max_len: int,
            rt: Runtime, lengths: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Process prompts [B, T]; return (last-token logits, decode state).

    ``lengths`` ([B] int32, optional) admits a ragged right-padded batch:
    attention masks each row's keys to its own prefix, logits are gathered
    at each row's last real token, and the state carries per-slot
    positions.  K/V are quantized into the int8 cache at rows ``[0, T)``
    (padded rows included; decode masks and then overwrites them).  An SSM
    layer runs the chunked SSD over all T tokens and hands its final
    recurrent state to decode (the engine prefills SSM stacks at exact
    length); under ``fused_int8`` its intra-chunk part runs B6, under every
    other backend the tensor path, as attention takes B2 by the same rule."""
    x = _embed(p, cfg, inputs)
    B, T = x.shape[:2]
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    dev = x.device
    positions = torch.arange(T, device=dev).expand(B, T)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=dev).reshape(-1).expand(B)
    state = init_decode_state(cfg, B, max_len, dev)
    for lp, cache in zip(p["layers"], state["layers"]):
        h = L.apply_norm(lp["ln1"], x)
        if "ssm" in lp:
            mix, new = SSM.ssm_forward(lp["ssm"], cfg, h, backend=rt.backend,
                                       return_state=True,
                                       use_kernel=rt.backend == "fused_int8")
            cache.update(new)
        else:
            mix, (k, v) = A.gqa_forward(lp["attn"], cfg, h, positions, rt.backend,
                                        lengths=lengths)
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            for name, val in (("k_q", k_q), ("k_s", k_s), ("v_q", v_q), ("v_s", v_s)):
                KV.chunk_update(cache[name], val, 0)
        x = x + mix
        if "mlp" in lp:
            x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x),
                                cfg.mlp_type, rt.backend)
    x = L.apply_norm(p["ln_f"], x)
    if lengths is None:
        last = x[:, -1]
        pos = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        last = x[torch.arange(B, device=dev), (lengths - 1).long()]
        pos = lengths.clone()
    state["pos"] = pos
    return _lm_head(p, cfg, last, rt), state
