"""Decoder-LM assembly for the dense GQA/MHA and SSM (Mamba2) families.

PyTorch counterpart of ``repro.models.transformer``.  Layers are a per-layer
list (``params["layers"]``), not the reference's stacked ``lax.scan``, and
each layer dispatches on ``cfg.layer_kind(i)``.  The decode state is a
per-layer list: an attention layer's int8 "SLC" cache, which every step
updates **in place** (the reference donates its state to the same effect),
or an SSM layer's constant-size recurrent state (``conv_x``, ``conv_B``,
``conv_C``, ``h``), and the ``pos`` cursor vector.  Every step writes into
those tensors and never swaps one for a new one, so a step captured as a
CUDA graph (``models/graphs.py``) replays over fixed addresses.  The
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
    """The port serves dense decoders (GQA or MHA, with RoPE or with
    sinusoidal positions when ``rope_theta == 0``) and attention-free SSM
    (Mamba2) stacks so far."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: hybrid SSM/attention stacks wait on models/moe.py "
            "(ROADMAP A.11)")
    dense = cfg.family == "dense" and cfg.attn_type == "gqa"
    ssm = cfg.family == "ssm" and cfg.attn_type == "none" and not cfg.d_ff
    if not (dense or ssm) or cfg.n_experts or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA/MHA decoders and SSM stacks are "
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


def _embed(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
           positions: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings of ``inputs``, plus the sinusoidal embedding of
    ``positions`` for the families without RoPE (a tensor of the same shape
    as ``inputs``, never a host int, so a captured step reads its positions
    on every replay; it may be None where ``cfg.rope_theta`` is set)."""
    x = p["embed"]["w"][inputs]
    if not cfg.rope_theta:
        x = x + L.sinusoid_at(positions, cfg.d_model).to(x.dtype)
    return x


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
    in place, an SSM layer copies its new state into its state's tensors."""
    h = L.apply_norm(p["ln1"], x)
    if "ssm" in p:
        mix, new = SSM.ssm_decode(p["ssm"], cfg, h, cache, rt.backend)
        for name, val in new.items():
            cache[name].copy_(val)
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
    """token: [B] -> (logits [B, V], state).  The caches and the cursor
    update in place (the cursor advances by one); the returned state holds
    the same tensors."""
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
    B, T = tokens.shape
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
PREFILL_PIECE = 64


def carry_len(max_len: int) -> int:
    """Rows of the float K/V carry for prompts of up to ``max_len`` tokens:
    a piece starts at or before a real token (``< max_len``) and spans
    ``PREFILL_PIECE`` rows, so it never clamps onto valid rows."""
    return max_len + PREFILL_PIECE


def prefill_pieces(cfg: ModelConfig, n_tokens: int) -> int:
    """Prefill calls (pieces) a prompt of ``n_tokens`` (padded) tokens
    takes in one shot: an SSM stack prefills in one."""
    return 1 if has_ssm(cfg) else -(-n_tokens // PREFILL_PIECE)


def chunk_pieces(cursor: int, n: int) -> int:
    """Pieces a chunk of ``n`` tokens at ``cursor`` runs: every piece it
    touches."""
    return (cursor + n - 1) // PREFILL_PIECE - cursor // PREFILL_PIECE + 1


def _prefill_piece(p: Params, cfg: ModelConfig, bufs: list, tokens: torch.Tensor,
                   start: int, n_real: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """One ``[B, PREFILL_PIECE]`` piece at positions ``start + arange`` in
    every row (``start`` a multiple of ``PREFILL_PIECE``; ``n_real``: [B]
    int32, row b's first ``n_real[b]`` tokens are real) through every
    layer: the piece's K/V land in the float buffers ``bufs`` in place and
    its queries attend keys ``< start + n_real`` among the buffers' first
    ``start + PREFILL_PIECE`` rows.  Returns the hidden states after
    ``ln_f`` [B, PREFILL_PIECE, d]."""
    B, P = tokens.shape
    dev = tokens.device
    key_rows = start + P
    start_t = torch.full((B,), start, dtype=torch.int32, device=dev)
    positions = start_t[:, None] + torch.arange(P, device=dev)
    x = _embed(p, cfg, tokens, positions)
    kv_lengths = start_t + n_real
    # what every layer shares: the rotary tables and the key blocks' masks
    rope = (L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.rope_theta else None)
    hidden = A.hidden_masks(P, key_rows, key_rows, q_offset=start_t,
                            kv_lengths=kv_lengths, device=dev)
    for lp, buf in zip(p["layers"], bufs):
        h = L.apply_norm(lp["ln1"], x)
        x = x + A.gqa_chunk(lp["attn"], cfg, h, positions, buf, start, kv_lengths,
                            key_rows, rt.backend, rope=rope, hidden=hidden)
        if "mlp" in lp:
            x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x),
                                cfg.mlp_type, rt.backend)
    return L.apply_norm(p["ln_f"], x)


def _piece(tokens: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``tokens``, right-padded with token 0 to a
    piece."""
    part = tokens[:, lo:hi]
    return torch.nn.functional.pad(part, (0, PREFILL_PIECE - part.shape[1]))


def prefill(p: Params, cfg: ModelConfig, inputs: torch.Tensor, max_len: int,
            rt: Runtime, lengths: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Process prompts [B, T]; return (last-token logits, decode state).

    ``lengths`` ([B] int32, optional) admits a ragged right-padded batch:
    attention masks each row's keys to its own prefix, logits are gathered
    at each row's last real token, and the state carries per-slot
    positions.  An attention stack runs in pieces of ``PREFILL_PIECE`` rows
    against a float K/V carry (see above), whose rows ``[0, T)`` are
    quantized into the int8 cache (padded rows included; decode masks and
    then overwrites them).  An SSM layer runs the chunked
    SSD over all T tokens and hands its final recurrent state to decode
    (the engine prefills SSM stacks at exact length); under ``fused_int8``
    its intra-chunk part runs B6, under every other backend the tensor
    path, as attention takes B2 by the same rule."""
    B, T = inputs.shape
    if T > max_len:
        raise ValueError(f"prompt of {T} tokens exceeds max_len {max_len}")
    dev = inputs.device
    lengths = (torch.full((B,), T, dtype=torch.int32, device=dev) if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int32,
                                    device=dev).reshape(-1).expand(B))
    if has_ssm(cfg):
        return _prefill_ssm(p, cfg, inputs, max_len, rt, lengths)
    carry = init_prefill_carry(cfg, carry_len(max_len), dev, batch=B)
    rows = torch.arange(B, device=dev)
    last = None
    for lo in range(0, T, PREFILL_PIECE):
        n_real = torch.clamp(lengths - lo, 0, PREFILL_PIECE)
        h = _prefill_piece(p, cfg, carry["layers"], _piece(inputs, lo, lo + PREFILL_PIECE),
                           lo, n_real, rt)
        at = lengths - 1 - lo                  # each row's last token, if here
        cand = h[rows, torch.clamp(at, 0, PREFILL_PIECE - 1).long()]
        here = ((at >= 0) & (at < PREFILL_PIECE))[:, None]
        last = cand if last is None else torch.where(here, cand, last)
    state = init_decode_state(cfg, B, max_len, dev)
    for cache, buf in zip(state["layers"], carry["layers"]):
        for name, val in zip(("k_q", "k_s", "v_q", "v_s"),
                             (*quantize_kv(buf["k"][:, :T]), *quantize_kv(buf["v"][:, :T]))):
            KV.chunk_update(cache[name], val, 0)
    state["pos"] = lengths.clone()
    return _lm_head(p, cfg, last, rt), state


def _prefill_ssm(p: Params, cfg: ModelConfig, inputs: torch.Tensor, max_len: int,
                 rt: Runtime, lengths: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """:func:`prefill` of an SSM stack: every layer over all T tokens."""
    B, T = inputs.shape
    x = _embed(p, cfg, inputs, torch.arange(T, device=inputs.device).expand(B, T))
    state = init_decode_state(cfg, B, max_len, x.device)
    for lp, cache in zip(p["layers"], state["layers"]):
        h = L.apply_norm(lp["ln1"], x)
        mix, new = SSM.ssm_forward(lp["ssm"], cfg, h, backend=rt.backend,
                                   return_state=True,
                                   use_kernel=rt.backend == "fused_int8")
        cache.update(new)
        x = x + mix
        if "mlp" in lp:
            x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], x),
                                cfg.mlp_type, rt.backend)
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
    earlier prefix at prefill precision, the token ids consumed
    (``tokens``, [batch, buf_len] int64), so a chunk can run the piece it
    starts in from that piece's first row, and the cursor ``pos`` ([batch]
    int32).  ``buf_len`` is ``carry_len(max_len)``.  SSM stacks prefill at exact length (their
    recurrent state would integrate the chunk boundary), so a carry for one
    raises."""
    check_supported(cfg)
    dev = resolve(device)
    if has_ssm(cfg):
        raise NotImplementedError(
            "chunked prefill carries attention K/V only; SSM stacks "
            "prefill at exact length (see serve engine)")
    kv = (batch, buf_len, cfg.n_kv_heads, cfg.head_dim)
    layers = [{"k": torch.zeros(kv, dtype=torch.float32, device=dev),
               "v": torch.zeros(kv, dtype=torch.float32, device=dev)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers,
            "tokens": torch.zeros((batch, buf_len), dtype=torch.int64, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill_chunk(p: Params, cfg: ModelConfig, carry: dict, tokens: torch.Tensor,
                  n_real: int, rt: Runtime) -> tuple[torch.Tensor, dict]:
    """Consume one ``[1, C]`` token chunk at the carry's cursor, in the
    ``PREFILL_PIECE``-row pieces it touches (:func:`chunk_pieces`; rows of
    a piece before the cursor run again and rewrite their K/V with the same
    bits).  ``n_real`` (1 <= n_real <= C) counts the chunk's real tokens: a
    prompt's last chunk is right-padded to C, and the engine's token budget
    may cut a chunk short.  Returns (logits of the chunk's last real token
    [1, V], the carry), the carry's K/V, token ids and cursor updated in
    place (the cursor advances by ``n_real``)."""
    n = int(n_real)
    if not 1 <= n <= tokens.shape[1]:
        raise ValueError(f"n_real {n} outside a chunk of {tokens.shape[1]}")
    cursor = int(carry["pos"].reshape(-1)[0])     # one cursor: a carry is B = 1
    end = cursor + n
    ids = carry["tokens"]
    ids[:, cursor:end] = tokens[:, :n]
    for lo in range(cursor - cursor % PREFILL_PIECE, end, PREFILL_PIECE):
        k = min(PREFILL_PIECE, end - lo)
        h = _prefill_piece(p, cfg, carry["layers"], ids[:, lo:lo + PREFILL_PIECE],
                           lo, torch.full_like(carry["pos"], k), rt)
    carry["pos"].add_(n)
    return _lm_head(p, cfg, h[:, k - 1], rt), carry


def finalize_prefill_carry(cfg: ModelConfig, carry: dict, max_len: int) -> dict:
    """Quantize a completed prefill carry into a decode state of
    ``max_len`` rows, the prefill->decode K/V handoff.  Per-(token, head)
    quantization gives the int8 rows the one-shot prefill writes for the
    same floats.  The result plugs into :func:`write_slot`."""
    layers = []
    for b in carry["layers"]:
        k_q, k_s = quantize_kv(b["k"][:, :max_len])
        v_q, v_s = quantize_kv(b["v"][:, :max_len])
        layers.append({"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s})
    return {"layers": layers, "pos": carry["pos"].to(torch.int32).clone()}
