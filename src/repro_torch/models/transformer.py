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

On a mesh (``Runtime.mesh``, a ``launch.mesh.Mesh`` of processes) every
family the stack serves (GQA/MHA and MLA decoders with dense or MoE FFNs,
SSM and hybrid stacks) serves tensor- and expert-parallel, the explicit
form of what the reference's partitioner computes from its shardings:
each rank holds its block of every leaf (:func:`place_params`: the
``dist/sharding.py`` specs, the tree's ``specs`` key keeping them) and of
the slot pool (:func:`init_decode_block`: slots over the data axes, KV
heads and SSM heads over ``model``, MLA's latent replicated over it).  A
layer's FSDP-stored dims (the data axes) are all-gathered before use, one
layer at a time; attention runs the rank's heads and ``wo`` is
row-parallel (MLA gathers the narrow ``wq_a`` / ``wkv_a`` outputs over
``model`` before their norms), an SSM layer runs the rank's heads
(``ssm.HeadBlock``), the MLP's FFN dim splits over ``model`` (``w_down``
row-parallel), the embedding takes the rank's vocabulary rows and sums
them over ``model`` (exact: one rank adds a row, the others zeros),
``lm_head`` gives the rank's vocabulary columns, gathered over ``model``,
and the MoE block (:func:`_moe_block`) runs the reference's layouts.  A
step's rows are the rank's slots (decode, verify) or the whole call,
replicated over the data axes (prefill, the MTP drafts).  The serving
lanes move a slot's rows between ranks (:func:`gather_slot_row`,
:func:`copy_slot_prefix`, :func:`warm_prefill_carry`).

Every family trains on a mesh too (:func:`lm_loss` with ``rt.mesh``;
``train/train_step.py`` ``jit_train_step``): the rank's rows are its block
of the batch over the data axes, the layers are placed as in serving
(their FSDP gathers inside the rematerialized body), the collectives are
differentiable (``dist/collectives.py``), the head is
vocabulary-parallel, the MoE block routes and balances each data shard's
rows, as the reference's ``shard_map`` does, and ``Runtime.seq_shard``
keeps the residual sequence-parallel between layers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core.quant import quantize_kv
from repro_torch.device import generator, resolve
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = dict[str, Any]
BACKENDS = ("dense", "ref_int8", "fused_int8", "pim_bitserial")


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model apply functions.  ``mesh``
    (a ``launch.mesh.Mesh``, or a ``CountingMesh`` for the dry run) serves
    and trains over a (data, model) mesh of processes (see the module's
    docstring); ``collective`` sums the model axis' partials (``psum`` or
    the H-tree); ``serve_resident_moe`` keeps decode experts resident;
    ``seq_shard`` makes training's activations sequence-parallel between
    layers (the residual is the rank's block of the rows over the model
    axis); off a mesh it changes nothing, as in the reference."""
    backend: str = "dense"               # dense | ref_int8 | fused_int8 | pim_bitserial
    mesh: Any = None                     # launch.mesh.Mesh | None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    remat: bool = False                  # training: recompute each layer in the backward
    collective: str = "psum"             # psum (ring) | htree (tree all-reduce)
    serve_resident_moe: bool = False     # decode: experts resident (no FSDP gather)
    # the SLC intermediates' dtype (e.g. torch.bfloat16; None: f32): decode
    # and verify hand it to the plain int8 attention and to absorbed MLA
    dmvm_dtype: Any = None
    seq_shard: bool = False              # sequence-parallel activations (train)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.collective not in C.COLLECTIVES:
            raise ValueError(f"unknown collective {self.collective!r}; want psum|htree")
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


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
         lm: "_LayerMesh | None" = None) -> torch.Tensor:
    """A layer's feed-forward block with its residual: the MoE (the rows of
    ``x`` [B, T, d] routed together, b-major; the router and the dispatched
    rows take the float rows), the MLP (its input linears the norm's int8
    pair where the backend takes it), or nothing.  ``lm``: the layer's
    place on a mesh."""
    if "moe" in p:
        h = L.apply_norm(p["ln2"], x)
        if lm is None:
            return x + MOE.moe_apply(p["moe"], h, cfg)[0]
        return x + _moe_block(p["moe"], h, cfg, rt, lm.specs["moe"], lm.split)
    if "mlp" in p:
        h, h_q = L.apply_norm_q(p["ln2"], x, rt.backend, p["mlp"], L.MLP_INPUTS)
        return x + L.apply_mlp(p["mlp"], h, cfg.mlp_type, rt.backend, h_q,
                               reduce=lm.mlp_reduce if lm else None)
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
           positions: torch.Tensor | None, mc: "_MeshCall | None" = None) -> torch.Tensor:
    """Token embeddings of ``inputs``, or ``inputs`` themselves where they
    are embeddings (:func:`embedded`), plus the sinusoidal embedding of
    ``positions`` for the families without RoPE (a tensor of the shape of
    the token axes, never a host int, so a captured step reads its
    positions on every replay; it may be None where ``cfg.rope_theta`` is
    set)."""
    if embedded(cfg, inputs):
        x = inputs
    else:
        x = p["embed"]["w"][inputs] if mc is None else _embed_ids(p, inputs, mc)
    if not cfg.rope_theta:
        x = x + L.sinusoid_at(positions, cfg.d_model).to(x.dtype)
    return x


def _lm_head(p: Params, cfg: ModelConfig, h: torch.Tensor, rt: Runtime,
             mc: "_MeshCall | None" = None) -> torch.Tensor:
    if mc is not None:
        return _lm_head_mesh(p, cfg, h, rt, mc)
    if cfg.tie_embeddings:
        return torch.matmul(h, p["embed"]["w"].to(h.dtype).T)
    return L.apply_linear(L._lin(p["lm_head"], "w"), h, rt.backend)


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------
def apply_layer_train(p: Params, cfg: ModelConfig, i: int, x: torch.Tensor,
                      positions: torch.Tensor, rt: Runtime, lm: "_LayerMesh | None" = None,
                      seq=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i`` of the training forward over ``x`` [B, T, d] -> (x, the
    MoE block's load-balance loss, 0 for other layers).  An SSM layer takes
    :func:`ssm.ssm_forward`'s tensor path (``use_kernel`` left False, as the
    reference leaves it in training), attention the causal full-sequence
    form with no K/V buffer.  ``lm``: the layer's place on a mesh (its
    heads, its reductions; :func:`_place_layer`); ``seq``: under
    ``Runtime.seq_shard`` the model axis' group, ``x`` then the rank's
    block of the T rows: each norm runs on the block, its output is
    gathered over the rows before the block that reads it, and the
    row-parallel output is reduce-scattered back to the rank's rows."""
    h = _seq_whole(L.apply_norm(p["ln1"], x), seq)
    acfg = lm.attn_cfg if lm else cfg
    if cfg.layer_kind(i) == "ssm":
        blk = lm.ssm if lm else None
        mix, cut = SSM.ssm_forward(p["ssm"], cfg, h, backend=rt.backend, blk=blk), blk
    elif cfg.attn_type == "mla":
        cut = lm.attn_reduce if lm else None
        mix, _ = A.mla_forward(p["attn"], acfg, h, positions, rt.backend, reduce=cut,
                               cols=lm.cols if lm else None)
    else:
        cut = lm.attn_reduce if lm else None
        mix, _ = A.gqa_forward(p["attn"], acfg, h, positions, rt.backend, reduce=cut)
    x = x + _seq_part(mix, seq, cut is not None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        h = _seq_whole(L.apply_norm(p["ln2"], x), seq)
        if lm is None:
            mo, aux = MOE.moe_apply(p["moe"], h, cfg, with_aux=True)
        else:
            mo, aux = _moe_block(p["moe"], h, cfg, rt, lm.specs["moe"], train=True, seq=seq)
        x = x + mo
    elif "mlp" in p:
        h = _seq_whole(L.apply_norm(p["ln2"], x), seq)
        red = lm.mlp_reduce if lm else None
        x = x + _seq_part(L.apply_mlp(p["mlp"], h, cfg.mlp_type, rt.backend, reduce=red),
                          seq, red is not None)
    return x, aux


def _seq_whole(t: torch.Tensor, seq) -> torch.Tensor:
    """A rank's block of the rows (dim 1) gathered over ``seq`` (the model
    axis' group under sequence parallelism), or ``t`` (None)."""
    return t if seq is None else C.all_gather(t, seq, dim=1)


def _seq_part(t: torch.Tensor, seq, scattered: bool) -> torch.Tensor:
    """A block's output as the residual holds it: ``t`` itself off
    sequence parallelism or where its reduction reduce-scattered it
    (``scattered``), else (every rank computed the whole rows) the rank's
    block of the rows."""
    if seq is None or scattered:
        return t
    w = t.shape[1] // seq.size
    return t.narrow(1, seq.index * w, w)


def remat_call(rt: Runtime, fn, *args):
    """``fn(*args)``; under ``rt.remat`` through ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the inputs and recomputes the body in
    the backward, as the reference's ``jax.checkpoint`` does.  On a mesh
    the recompute runs the body's collectives again, in the same order on
    every rank (the graph is the same on every rank)."""
    if rt.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward_train(p: Params, cfg: ModelConfig, inputs: torch.Tensor,
                  rt: Runtime, mc: "_MeshCall | None" = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """inputs: [B, T] int tokens (or [B, T, d] embeddings, see
    :func:`embedded`) -> (hidden after ``ln_f`` [B, T, d], the layers'
    summed MoE aux loss), over the per-layer list in order (the order in
    which the reference's scans over its groups add the aux).  ``mc``: the
    call's place on a mesh (:func:`lm_loss`): each layer's FSDP-stored dims
    are gathered inside its (rematerialized) body, and under
    ``Runtime.seq_shard`` the residual between layers is the rank's block
    of the T rows over the model axis (where the axis tiles T), gathered
    after ``ln_f``."""
    B, T = inputs.shape[:2]
    positions = torch.arange(T, device=inputs.device).expand(B, T)
    x = _embed(p, cfg, inputs, positions, mc)
    seq = mc.seq if mc is not None else None
    x = _seq_part(x, seq, False)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(p["layers"]):
        def body(lp_, x_, i=i):
            if mc is None:
                return apply_layer_train(lp_, cfg, i, x_, positions, rt)
            lp_, lm = _place_layer(lp_, mc.specs["layers"][i], mc)
            return apply_layer_train(lp_, cfg, i, x_, positions, rt, lm, seq)
        x, aux = remat_call(rt, body, lp, x)
        aux_total = aux_total + aux
    return _seq_whole(L.apply_norm(p["ln_f"], x), seq), aux_total


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` per row, in f32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def lm_loss(p: Params, cfg: ModelConfig, inputs: torch.Tensor, labels: torch.Tensor,
            rt: Runtime, chunk: int = 512, split: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T], the head applied to
    ``chunk``-token pieces of the sequence (to bound the logits' memory, as
    the reference's scan does), plus DeepSeek-V3's ``0.3 *`` MTP term where
    the configuration has the head and ``0.01 *`` the MoE aux loss.  On a
    mesh see :func:`_lm_loss_mesh` (``split``: the rows are the rank's
    block of a batch split over the data axes)."""
    if rt.mesh is not None:
        return _lm_loss_mesh(p, cfg, inputs, labels, rt, chunk, split)
    h, aux = forward_train(p, cfg, inputs, rt)
    B, T = h.shape[:2]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo, hi in _chunks(T, chunk):
        logits = _lm_head(p, cfg, h[:, lo:hi], rt)
        total = total + torch.sum(token_nll(logits, labels[:, lo:hi]))
    loss = total / torch.full((), float(B * T), device=h.device)
    if cfg.mtp:
        loss = loss + 0.3 * _mtp_loss(p, cfg, h, inputs, labels, rt)
    return loss + 0.01 * aux


def _chunks(T: int, chunk: int) -> list[tuple[int, int]]:
    n_chunks = max(1, T // chunk)
    if T % n_chunks:
        n_chunks = 1
    tc = T // n_chunks
    return [(c * tc, (c + 1) * tc) for c in range(n_chunks)]


def _mtp_hidden(p: Params, cfg: ModelConfig, h: torch.Tensor, inputs: torch.Tensor,
                rt: Runtime, mc: "_MeshCall | None" = None) -> torch.Tensor:
    """The MTP head's hidden rows: ``hm[:, t]``, from ``h[:, t]`` and the
    embedding of token t+1, through ``mtp_proj`` and ``mtp_layer`` (on a
    mesh ``mtp_proj``'s columns gathered over the model axis, the layer
    placed as a decoder layer is, its rows whole)."""
    B, T = inputs.shape[:2]
    emb_next = _embed(p, cfg, inputs, torch.arange(T, device=h.device).expand(B, T),
                      mc)[:, 1:]
    cat = torch.cat([h[:, :-1], emb_next], dim=-1)
    positions = torch.arange(T - 1, device=h.device).expand(B, T - 1)
    if mc is None:
        hm = L.apply_linear(L._lin(p["mtp_proj"], "w"), cat, rt.backend)
        return apply_layer_train(p["mtp_layer"], cfg, cfg.n_layers - 1, hm, positions, rt)[0]
    proj = _gather_data(p["mtp_proj"], mc.specs["mtp_proj"], mc)
    hm = L.apply_linear(L._lin(proj, "w"), cat, rt.backend)
    if _split_over(mc.specs["mtp_proj"]["w"], mc.mesh, 1, rt.model_axis):
        hm = C.all_gather(hm, mc.model, dim=-1)
    plain = _MeshCall(cfg, rt, mc.specs, mc.split)          # whole rows: no seq split
    lp, lm = _place_layer(p["mtp_layer"], mc.specs["mtp_layer"], plain)
    return apply_layer_train(lp, cfg, cfg.n_layers - 1, hm, positions, rt, lm)[0]


def _mtp_loss(p: Params, cfg: ModelConfig, h: torch.Tensor, inputs: torch.Tensor,
              labels: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction (depth 1): ``hm[:, t]``, from
    ``h[:, t]`` and the embedding of token t+1, predicts ``labels[:, t+1]``
    (token t+2)."""
    hm = _mtp_hidden(p, cfg, h, inputs, rt)
    return torch.mean(token_nll(_lm_head(p, cfg, hm, rt), labels[:, 1:]))


class _Shared(torch.autograd.Function):
    """A loss whose value is ``total`` (the same tensor on every rank) and
    whose gradient flows to the rank's ``part`` of it."""

    @staticmethod
    def forward(ctx, part, total):
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _lm_loss_mesh(p: Params, cfg: ModelConfig, inputs: torch.Tensor, labels: torch.Tensor,
                  rt: Runtime, chunk: int, split: bool) -> torch.Tensor:
    """:func:`lm_loss` on ``rt.mesh`` over a rank's blocks of the params
    (with their ``specs``).  ``inputs`` and ``labels`` are the rank's rows:
    its block of the batch over the data axes (``split``) or the whole
    batch.  The cross-entropy is each rank's token sum over the global
    ``B * T``, the MTP term likewise, the head vocabulary-parallel
    (:func:`_nll_mesh`: a rank's vocabulary columns, the max, the sum of
    exponentials and the gold logit all-reduced over the model axis, [B, T]
    f32 each); each MoE block's aux is its data shard's rows', averaged
    over every rank (the reference's ``pmean``).  The value returned is the
    whole loss, the same bits on every rank; its gradient is the rank's
    share: the collectives' adjoints (``dist/collectives.py``) then give
    each rank the gradient of the whole loss by its blocks, partial for a
    leaf other ranks hold too (``train_step.reduce_grads`` sums those)."""
    mc = _mesh_call(p, cfg, rt, split=split, seq_len=inputs.shape[1])
    h, aux = forward_train(p, cfg, inputs, rt, mc)
    B, T = h.shape[:2]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo, hi in _chunks(T, chunk):
        total = total + torch.sum(_nll_mesh(p, cfg, h[:, lo:hi], labels[:, lo:hi], rt, mc))
    mtp = None
    if cfg.mtp:
        hm = _mtp_hidden(p, cfg, h, inputs, rt, mc)
        mtp = (torch.sum(_nll_mesh(p, cfg, hm, labels[:, 1:], rt, mc)), B * (T - 1))
    return mesh_loss(total, B * T, rt, mc, aux, mtp)


def mesh_loss(nll_sum: torch.Tensor, tokens: int, rt: Runtime, mc: "_MeshCall",
              aux: torch.Tensor | None = None, mtp: tuple | None = None) -> torch.Tensor:
    """A training loss on a mesh from the rank's token sum ``nll_sum`` over
    its ``tokens`` rows: over the global token count (the rank's times the
    data axes' size where the rows are split), plus ``0.3 *`` the MTP term
    (``mtp``: its sum and row count, alike) and ``0.01 *`` the mean of the
    ranks' ``aux``.  Its value is the whole loss, the same bits on every
    rank (an all-reduce of the ranks' shares); its gradient is the rank's
    share: the cross-entropy divided by the ranks that hold the same rows,
    the aux by every rank."""
    mesh = rt.mesh
    rows = SH.axes_size(mesh, mc.dp) if mc.split else 1      # distinct row blocks
    world = SH.axes_size(mesh, mesh.axis_names)
    dev = nll_sum.device

    def n(v):
        return torch.full((), float(v), device=dev)
    part = nll_sum / n(tokens * rows)
    if mtp is not None:
        part = part + 0.3 * (mtp[0] / n(mtp[1] * rows))
    part = part / n(world // rows)
    if aux is not None:
        part = part + 0.01 * (aux / n(world))
    total = C.all_reduce(part.detach(), mesh.group(mesh.axis_names))
    return _Shared.apply(part, total)


def _nll_mesh(p: Params, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
              rt: Runtime, mc: "_MeshCall") -> torch.Tensor:
    """:func:`token_nll` of the head's logits over ``h`` [B, T, d] on a
    mesh, vocabulary-parallel: each rank's logits over its vocabulary
    columns, their max (no gradient, as ``logsumexp`` has none through it),
    sum of exponentials and gold logit (one rank holds it, the others add
    zeros) all-reduced over the axes that split the vocabulary.  It moves
    three [B, T] f32 tensors, not the [B, T, V] logits; its float order
    differs from one device's ``logsumexp``."""
    logits, vocab, v0 = _head_block(p, cfg, h, rt, mc)
    if not vocab:
        return token_nll(logits, labels)
    g = mc.mesh.group(vocab)
    logits = logits.to(torch.float32)
    m = C.all_reduce(torch.amax(logits.detach(), dim=-1, keepdim=True), g, "max")
    se = C.all_reduce(torch.sum(torch.exp(logits - m), dim=-1), g)
    n = logits.shape[-1]
    idx = labels.long() - v0
    hit = (idx >= 0) & (idx < n)
    gold = torch.gather(logits, -1, torch.clamp(idx, 0, n - 1)[..., None])[..., 0]
    gold = C.all_reduce(torch.where(hit, gold, torch.zeros((), device=gold.device)), g)
    return torch.log(se) + m[..., 0] - gold


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
    whole.  The slot's cursor becomes ``one["pos"]``.  On a rank's block of
    a pool (:func:`init_decode_block`) ``slot`` is global: the rank that
    holds it writes the row, the others nothing; a row with every head (a
    cold block, :func:`gather_slot_row`) is cut to the rank's heads
    (``state["cuts"]``)."""
    B = state["pos"].shape[0]
    if "block" in state:              # a rank's block of a pool on a mesh
        slot = local_slot(state, slot)
        if slot is None:
            return state              # another data rank owns the slot
    s = min(max(int(slot), 0), B - 1)
    cuts = state.get("cuts")
    for i, (full, row) in enumerate(zip(state["layers"], one["layers"])):
        for name, buf in full.items():
            r = torch.as_tensor(row[name])
            cut = cuts[i].get(name) if cuts else None
            if cut is not None and r.shape[cut[0]] != buf.shape[cut[0]]:
                r = r.narrow(cut[0], cut[1], cut[2] - cut[1])
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


def copy_slot_prefix(state: dict, src: int, dst: int, n: int, rt: Runtime | None = None
                     ) -> dict:
    """Prefix-cache row gather, in place: ``dst``'s first ``n`` sequence rows
    of every cache leaf become ``src``'s (int8 payload and scales copied
    verbatim, so the reused prefix is bit-identical to the cached one) and
    ``pos[dst]`` becomes ``n``.  Rows at or past ``n`` keep ``dst``'s dead
    entries (masked, then overwritten by the resumed chunked prefill's
    finalize).  Attention pools only (every leaf ``[B, S, H, ...]``).  On a
    rank's block of a pool (``rt.mesh``) the slots are global: where their
    data owners differ, each rank of ``src``'s owner sends its head block
    of the ``n`` rows to the rank of ``dst``'s owner at its model index
    (the cross-shard move the reference's partitioner lowers)."""
    n = int(n)
    if any(not is_seq_cache(c) for c in state["layers"]):
        raise NotImplementedError("copy_slot_prefix targets attention pools")
    if "block" not in state:
        for cache in state["layers"]:
            for buf in cache.values():
                buf[int(dst), :n] = buf[int(src), :n]
        state["pos"][int(dst)] = n
        return state
    s, d = local_slot(state, src), local_slot(state, dst)
    bufs = [buf for cache in state["layers"] for buf in cache.values()]
    if s is not None and d is not None:
        for buf in bufs:
            buf[d, :n] = buf[s, :n]
    elif s is not None or d is not None:
        data = rt.mesh.group(SH.data_axes(rt.mesh))
        for buf in bufs:
            if s is not None:
                C.send(buf[s, :n].contiguous(), data, slot_owner(state, dst))
            else:
                buf[d, :n] = C.recv(buf[d, :n], data, slot_owner(state, src))
    if d is not None:
        state["pos"][d] = n
    return state


def warm_prefill_carry(cfg: ModelConfig, state: dict, slot: int, n: int,
                       buf_len: int, tokens=None, rt: Runtime | None = None) -> dict:
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
    latent cache cannot seed per-head K/V without the weights).  On a
    rank's block of a pool (``rt.mesh``) the carry holds the rank's heads
    and is replicated over the data axes, like every prefill carry: the
    slot's data owner broadcasts its head block of the rows over them."""
    if has_ssm(cfg):
        raise NotImplementedError(
            "prefix-cache warm start targets attention pools; SSM state "
            "cannot restart mid-prompt")
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            "prefix-cache warm start needs per-head K/V in the pool; the MLA "
            "latent cache cannot seed the float carry without weights")
    dev = state["pos"].device
    carry = init_prefill_carry(local_cfg(cfg, rt) if rt else cfg, buf_len, dev)
    n = int(n)
    owner = mine = None
    if pool_split(state):
        owner, mine = slot_owner(state, slot), local_slot(state, slot)
        data = rt.mesh.group(SH.data_axes(rt.mesh))
    for buf, cache in zip(carry["layers"], state["layers"]):
        w = min(n, buf_len, cache["k_q"].shape[1])
        for name in ("k", "v"):
            q, sc = cache[f"{name}_q"], cache[f"{name}_s"]
            if owner is None:
                q, sc = q[slot, :w], sc[slot, :w]
            else:                     # the owner's rows, over the data axes
                at = 0 if mine is None else mine
                q = C.broadcast(q[at, :w].contiguous(), data, owner)
                sc = C.broadcast(sc[at, :w].contiguous(), data, owner)
            buf[name][0, :w] = q.to(torch.float32) * sc
    if tokens is not None:
        ids = torch.as_tensor(list(tokens)[:n], dtype=torch.int64)
        carry["tokens"][0, :ids.numel()] = ids.to(dev)
    carry["pos"].fill_(n)
    return carry


def apply_layer_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, pos,
                       cache: dict, rt: Runtime, lm: "_LayerMesh | None" = None
                       ) -> torch.Tensor:
    """One layer of the decode step; an attention layer appends to its cache
    in place, an SSM layer copies its new state into its state's tensors.
    ``lm``: the layer's place on a mesh (its heads, its reductions)."""
    h, h_q = _ln1(p, x, rt)
    if "ssm" in p:
        mix, new = SSM.ssm_decode(p["ssm"], cfg, h, cache, rt.backend, h_q,
                                  blk=lm.ssm if lm else None)
        for name, val in new.items():
            cache[name].copy_(val)
    elif cfg.attn_type == "mla":
        mix, _ = A.mla_decode(p["attn"], lm.attn_cfg if lm else cfg, h, pos, cache["c_q"],
                              cache["c_s"], rt.backend, h_q, rt.dmvm_dtype,
                              reduce=lm.attn_reduce if lm else None,
                              cols=lm.cols if lm else None)
    else:
        mix, _ = A.gqa_decode(p["attn"], lm.attn_cfg if lm else cfg, h, pos, cache["k_q"],
                              cache["k_s"], cache["v_q"], cache["v_s"], rt.backend, h_q,
                              rt.dmvm_dtype, reduce=lm.attn_reduce if lm else None)
    return _ffn(p, cfg, x + mix, rt, lm)


def decode_step(p: Params, cfg: ModelConfig, state: dict, token: torch.Tensor,
                rt: Runtime) -> tuple[torch.Tensor, dict]:
    """token: [B] (or [B, d] embeddings, see :func:`embedded`) -> (logits
    [B, V], state).  The caches and the cursor update in place (the cursor
    advances by one); the returned state holds the same tensors."""
    B = token.shape[0]
    mc = _mesh_call(p, cfg, rt, state)
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    x = _embed(p, cfg, token, pos, mc)[:, None]
    for i, cache in enumerate(state["layers"]):
        lp, lm = _layer(p, i, mc)
        x = apply_layer_decode(lp, cfg, x, pos, cache, rt, lm)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x[:, 0], rt, mc)
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
                       cache: dict, rt: Runtime, depth=None, anc=None,
                       lm: "_LayerMesh | None" = None) -> torch.Tensor:
    """One layer of the verify pass: :func:`apply_layer_decode` over ``x``
    [B, T, d], appending T K/V rows at each slot's cursor.  ``depth``/``anc``
    ([B, T] int32) switch the window to tree mode (see
    :func:`attention.gqa_verify`)."""
    h, h_q = _ln1(p, x, rt)
    if cfg.attn_type == "mla":
        mix, _ = A.mla_verify(p["attn"], lm.attn_cfg if lm else cfg, h, pos, cache["c_q"],
                              cache["c_s"], rt.backend, depth=depth, anc=anc, x_q=h_q,
                              inter_dtype=rt.dmvm_dtype,
                              reduce=lm.attn_reduce if lm else None,
                              cols=lm.cols if lm else None)
    else:
        mix, _ = A.gqa_verify(p["attn"], lm.attn_cfg if lm else cfg, h, pos, cache["k_q"],
                              cache["k_s"], cache["v_q"], cache["v_s"], rt.backend,
                              depth=depth, anc=anc, x_q=h_q, inter_dtype=rt.dmvm_dtype,
                              reduce=lm.attn_reduce if lm else None)
    return _ffn(p, cfg, x + mix, rt, lm)


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
    mc = _mesh_call(p, cfg, rt, state)
    pos = state["pos"].to(torch.int32).reshape(-1).expand(B)
    positions = None
    if not cfg.rope_theta:
        positions = pos[:, None] + (torch.arange(T, device=tokens.device)[None, :]
                                    if depth is None else depth.to(tokens.device))
    x = _embed(p, cfg, tokens, positions, mc)
    for i, cache in enumerate(state["layers"]):
        lp, lm = _layer(p, i, mc)
        x = apply_layer_verify(lp, cfg, x, pos, cache, rt, depth=depth, anc=anc, lm=lm)
    x = L.apply_norm(p["ln_f"], x)
    logits = _lm_head(p, cfg, x, rt, mc)
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
                   skip: int = 0, mc: "_MeshCall | None" = None) -> torch.Tensor:
    """One ``[B, P]`` piece (or its ``[B, P, d]`` embeddings) at positions
    ``start + arange(P)`` in every row (``P`` is ``PREFILL_PIECE`` and
    ``start`` a multiple of it, but for a MoE stack's one piece a call;
    ``n_real``: [B] int32, row b's first ``n_real[b]`` tokens are real)
    through every layer: the piece's K/V from its row ``skip`` on land in
    the float buffers ``bufs`` in place (the rows before stay as they are),
    and its queries attend keys ``< start + n_real`` among the buffers'
    first ``start + P`` rows.  ``mc``: the call's place on a mesh.  Returns
    the hidden states after ``ln_f`` [B, P, d]."""
    B, P = tokens.shape[:2]
    dev = tokens.device
    key_rows = start + P
    start_t = torch.full((B,), start, dtype=torch.int32, device=dev)
    positions = start_t[:, None] + torch.arange(P, device=dev)
    x = _embed(p, cfg, tokens, positions, mc)
    kv_lengths = start_t + n_real
    # what every layer shares: the rotary tables and the key blocks' masks
    rope = (L.rope_tables(positions, A.rope_dim(cfg), cfg.rope_theta)
            if cfg.rope_theta else None)
    hidden = A.hidden_masks(P, key_rows, key_rows, q_offset=start_t,
                            kv_lengths=kv_lengths, device=dev)
    for i, buf in enumerate(bufs):
        lp, lm = _layer(p, i, mc)
        h, h_q = _ln1(lp, x, rt)
        if cfg.attn_type == "mla":
            x = x + A.mla_chunk(lp["attn"], lm.attn_cfg if lm else cfg, h, positions, buf,
                                start, kv_lengths, key_rows, rt.backend, rope=rope,
                                hidden=hidden, skip=skip, x_q=h_q,
                                reduce=lm.attn_reduce if lm else None,
                                cols=lm.cols if lm else None)
        else:
            x = x + A.gqa_chunk(lp["attn"], lm.attn_cfg if lm else cfg, h, positions, buf,
                                start, kv_lengths, key_rows, rt.backend, rope=rope,
                                hidden=hidden, skip=skip, x_q=h_q,
                                reduce=lm.attn_reduce if lm else None, mesh=lm is not None)
        x = _ffn(lp, cfg, x, rt, lm)
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
    check_mesh(cfg, rt)
    dev = inputs.device
    lengths = (torch.full((B,), T, dtype=torch.int32, device=dev) if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int32,
                                    device=dev).reshape(-1).expand(B))
    if has_ssm(cfg):
        return _prefill_exact(p, cfg, inputs, max_len, rt, lengths)
    mc = _mesh_call(p, cfg, rt)
    local = local_cfg(cfg, rt)
    carry = init_prefill_carry(local, carry_len(max_len), dev, batch=B)
    rows = torch.arange(B, device=dev)
    size = T if has_moe(cfg) else PREFILL_PIECE
    last = None
    for lo in range(0, T, size):
        n_real = torch.clamp(lengths - lo, 0, size)
        h = _prefill_piece(p, cfg, carry["layers"], _piece(inputs, lo, size), lo, n_real,
                           rt, mc=mc)
        at = lengths - 1 - lo                  # each row's last token, if here
        cand = h[rows, torch.clamp(at, 0, size - 1).long()]
        here = ((at >= 0) & (at < size))[:, None]
        last = cand if last is None else torch.where(here, cand, last)
    state = init_decode_local(cfg, B, max_len, rt, dev)
    for cache, buf in zip(state["layers"], carry["layers"]):
        for name, val in _quantize_carry(buf, 0, T).items():
            KV.chunk_update(cache[name], val, 0)
    state["pos"] = lengths.clone()
    return _lm_head(p, cfg, last, rt, mc), state


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
    mc = _mesh_call(p, cfg, rt)
    positions = torch.arange(T, device=dev).expand(B, T)
    x = _embed(p, cfg, inputs, positions, mc)
    state = init_decode_local(cfg, B, max_len, rt, dev)
    if any("attn" in lp for lp in p["layers"]):
        rope = (L.rope_tables(positions, A.rope_dim(cfg), cfg.rope_theta)
                if cfg.rope_theta else None)
        hidden = A.hidden_masks(T, T, T, q_offset=torch.zeros_like(lengths),
                                kv_lengths=lengths, device=dev)
    for i, cache in enumerate(state["layers"]):
        lp, lm = _layer(p, i, mc)
        h, h_q = _ln1(lp, x, rt)
        if "ssm" in lp:
            mix, new = SSM.ssm_forward(lp["ssm"], cfg, h, backend=rt.backend,
                                       return_state=True,
                                       use_kernel=rt.backend == "fused_int8", x_q=h_q,
                                       blk=lm.ssm if lm else None)
            cache.update(new)
        else:
            acfg = lm.attn_cfg if lm else cfg
            kv = (B, T, acfg.n_kv_heads, cfg.head_dim)
            buf = {"k": torch.zeros(kv, dtype=torch.float32, device=dev),
                   "v": torch.zeros(kv, dtype=torch.float32, device=dev)}
            mix = A.gqa_chunk(lp["attn"], acfg, h, positions, buf, 0, lengths, T,
                              rt.backend, rope=rope, hidden=hidden, x_q=h_q,
                              reduce=lm.attn_reduce if lm else None)
            for name, val in _quantize_carry(buf, 0, T).items():
                KV.chunk_update(cache[name], val, 0)
        x = _ffn(lp, cfg, x + mix, rt, lm)
    x = L.apply_norm(p["ln_f"], x)
    last = x[torch.arange(B, device=x.device), (lengths - 1).long()]
    state["pos"] = lengths.clone()
    return _lm_head(p, cfg, last, rt, mc), state


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
    mc = _mesh_call(p, cfg, rt)
    if embedded(cfg, tokens):
        if "embeds" not in carry:
            carry["embeds"] = (p["embed"]["w"][carry["tokens"]] if mc is None
                               else _embed_ids(p, carry["tokens"], mc))
        src = carry["embeds"]
    elif "embeds" in carry:
        raise ValueError("a prefill carry that holds embeddings takes embedding chunks only")
    else:
        src = carry["tokens"]
    src[:, cursor:end] = tokens[:, :n]
    if has_moe(cfg):
        h = _prefill_piece(p, cfg, carry["layers"], tokens, cursor,
                           torch.full_like(carry["pos"], n), rt, mc=mc)
        carry["pos"].add_(n)
        return _lm_head(p, cfg, h[:, n - 1], rt, mc), carry
    for lo in range(cursor - cursor % PREFILL_PIECE, end, PREFILL_PIECE):
        k = min(PREFILL_PIECE, end - lo)
        h = _prefill_piece(p, cfg, carry["layers"], src[:, lo:lo + PREFILL_PIECE],
                           lo, torch.full_like(carry["pos"], k), rt,
                           skip=max(cursor - lo, 0), mc=mc)
    carry["pos"].add_(n)
    return _lm_head(p, cfg, h[:, k - 1], rt, mc), carry


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
              pos_i: torch.Tensor, rt: Runtime, mc: "_MeshCall | None" = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One MTP step: ``[h; embed(tok)]`` through ``mtp_proj`` and
    ``mtp_layer`` at positions ``pos_i`` [B], one position and no cache,
    then ``lm_head`` with no ``ln_f`` -> (logits [B, V], new h [B, d]).
    The layer's MoE routes the B rows together.  On a mesh (``mc``) every
    rank runs every slot's row: ``mtp_proj``'s columns are gathered over
    the model axis, the layer runs as a decoder layer does."""
    if mc is None:
        emb = p["embed"]["w"][tok.long()].to(h.dtype)
        proj, (lp, lm) = p["mtp_proj"], (p["mtp_layer"], None)
    else:
        emb = _embed_ids(p, tok.long(), mc).to(h.dtype)
        proj = _gather_data(p["mtp_proj"], mc.specs["mtp_proj"], mc)
        lp, lm = _place_layer(p["mtp_layer"], mc.specs["mtp_layer"], mc)
    hm = L.apply_linear(L._lin(proj, "w"), torch.cat([h, emb], dim=-1), rt.backend)
    if mc is not None and _split_over(mc.specs["mtp_proj"]["w"], mc.mesh, 1, rt.model_axis):
        hm = C.all_gather(hm, mc.model, dim=-1)
    x = hm[:, None]
    h, h_q = _ln1(lp, x, rt)
    mix, _ = A.mla_forward(lp["attn"], lm.attn_cfg if lm else cfg, h, pos_i[:, None],
                           rt.backend, h_q, reduce=lm.attn_reduce if lm else None,
                           cols=lm.cols if lm else None)
    x = _ffn(lp, cfg, x + mix, rt, lm)[:, 0]
    return _lm_head(p, cfg, x, rt, mc), x


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
    mc = _mesh_call(p, cfg, rt)
    drafts = []
    for i in range(k):
        logits, h = _mtp_cell(p, cfg, h, tok, pos + i, rt, mc)
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
    mc = _mesh_call(p, cfg, rt)
    lens = mtp_chain_lengths(n, branch)
    logits0, h1 = _mtp_cell(p, cfg, h, tok, pos, rt, mc)
    _, top = MOE._top_k(logits0, len(lens))
    drafts = []
    for j, clen in enumerate(lens):
        hj, tj = h1, top[:, j].to(torch.int32)
        drafts.append(tj)
        for s in range(1, clen):
            lg, hj = _mtp_cell(p, cfg, hj, tj, pos + s, rt, mc)
            tj = torch.argmax(lg, -1).to(torch.int32)
            drafts.append(tj)
    return torch.stack(drafts, dim=1)


# ---------------------------------------------------------------------------
# the mesh: tensor-parallel decoders, resident expert parallelism
# ---------------------------------------------------------------------------
RESIDENT = ("ep2", "ep_data", "etp2")


def check_mesh(cfg: ModelConfig, rt: Runtime) -> None:
    """On a mesh, every family the port serves serves (see
    :func:`check_mesh_family`)."""
    if rt.mesh is not None:
        check_mesh_family(cfg)


def check_mesh_family(cfg: ModelConfig) -> None:
    """:func:`check_mesh`'s test of the family, with no mesh at hand: every
    decoder the stack serves (:func:`check_supported`) and the
    encoder-decoders of ``models/encdec.py`` (``Engine`` only) serve and
    train on a mesh."""
    if cfg.family != "encdec":
        check_supported(cfg)


def attn_tiles(cfg: ModelConfig, mesh) -> bool:
    """Whether the KV heads (and so the query heads) tile the model axis:
    then each rank runs its block of heads, else every rank runs them
    all."""
    m = mesh.shape[SH.MODEL_AXIS]
    return cfg.n_kv_heads % m == 0 and cfg.n_kv_heads >= m


def ssm_tiles(cfg: ModelConfig, mesh) -> bool:
    """Whether an SSM layer's heads tile the model axis in blocks that hold
    whole B/C groups or lie inside one (``ssm.group_block``)."""
    m = mesh.shape[SH.MODEL_AXIS]
    if not has_ssm(cfg) or cfg.ssm_heads % m or cfg.ssm_heads < m:
        return False
    n, per = cfg.ssm_heads // m, cfg.ssm_heads // cfg.ssm_groups
    return n % per == 0 or per % n == 0


def local_cfg(cfg: ModelConfig, rt: Runtime | None) -> ModelConfig:
    """``cfg`` with the head counts of a rank's block (the shapes of its
    attention, its carry and its pool), or ``cfg`` off a mesh or where the
    heads do not tile."""
    if rt is None or rt.mesh is None or not attn_tiles(cfg, rt.mesh):
        return cfg
    m = rt.mesh.shape[SH.MODEL_AXIS]
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m)


def ssm_block(cfg: ModelConfig, rt: Runtime) -> tuple[int, int] | None:
    """A rank's SSM heads ``(h0, n)`` where they tile the model axis, else
    None (every rank runs every head)."""
    if rt.mesh is None or not ssm_tiles(cfg, rt.mesh):
        return None
    n = cfg.ssm_heads // rt.mesh.shape[SH.MODEL_AXIS]
    return rt.mesh.index(rt.model_axis) * n, n


def _strip(spec: tuple, axes) -> tuple:
    """``spec`` without ``axes`` in any entry."""
    out = []
    for e in spec:
        kept = tuple(a for a in SH._entry_axes(e) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def _layer_specs(specs: Any) -> list:
    """Every layer's spec dict of a spec tree: its decoder (or encoder and
    decoder) layers and the MTP layer."""
    out = [ls for key in ("layers", "enc", "dec") for ls in specs.get(key, [])]
    return out + ([specs["mtp_layer"]] if "mtp_layer" in specs else [])


def mesh_param_specs(cfg: ModelConfig, tree: Any, mesh, serve: bool = False) -> Any:
    """The spec of every leaf of ``tree`` on ``mesh``: ``dist/sharding.py``
    ``param_shardings``, but attention weights stay whole over ``model``
    where the heads do not tile it (a rank runs whole heads), and so do an
    SSM layer's where its heads do not."""
    specs = SH.param_shardings(cfg, tree, mesh, serve=serve)
    for ls in _layer_specs(specs):
        for key, tiles in (("attn", attn_tiles), ("xattn", attn_tiles), ("ssm", ssm_tiles)):
            if key in ls and not tiles(cfg, mesh):
                ls[key] = {k: _strip(v, (SH.MODEL_AXIS,)) for k, v in ls[key].items()}
    return specs


def shard_pair(cfg: ModelConfig, params: Params, qparams: Params, rt: Runtime
               ) -> tuple[Params, Params]:
    """The rank's blocks of the float tree (placed for prefill: ``ep`` /
    ``etp`` experts) and of the decode tree (resident experts where
    ``rt.serve_resident_moe``), as the reference's ``_place_on_mesh``
    places them.  A tensor of both trees (the float leaves ``quantize_tree``
    keeps, or every leaf where the decode tree is the float tree) whose two
    blocks are the same is held once."""
    mesh = rt.mesh
    memo: dict = {}

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [cut(v, sp) for v, sp in zip(node, spec)]
        if not isinstance(node, torch.Tensor):
            return node
        key = (id(node), SH.live(spec, mesh))
        if key not in memo:
            memo[key] = SH.shard(node, spec, mesh)
        return memo[key]

    out = []
    for tree, serve in ((params, False), (qparams, rt.serve_resident_moe)):
        specs = mesh_param_specs(cfg, tree, mesh, serve=serve)
        local = cut(tree, specs)
        local["specs"] = specs
        out.append(local)
    return out[0], out[1]


class MeshParams(NamedTuple):
    """A rank's placed trees: the float tree for prefill and the decode
    tree (quantized, or the float tree placed for decode), each with its
    ``specs``; the engines take it in place of a whole float tree."""
    params: Params
    qparams: Params


def place_params(cfg: ModelConfig, params, quantize: bool, rt: Runtime) -> MeshParams:
    """The float tree (prefill) and the decode tree (``quantize_tree`` of it
    where ``quantize``, else the float tree) an engine serves; on a mesh the
    rank's blocks of both (quantized whole first, then cut), or ``params``
    itself where it is a rank's :class:`MeshParams` already."""
    if isinstance(params, MeshParams):
        return params
    from repro_torch.serve.quantize import quantize_tree
    qparams = quantize_tree(params) if quantize else params
    if rt.mesh is None:
        return MeshParams(params, qparams)
    return MeshParams(*shard_pair(cfg, params, qparams, rt))


def gather_rows(t: torch.Tensor, state: dict, rt: Runtime) -> torch.Tensor:
    """A step's per-slot output (dim 0 the rank's slots of ``state``'s
    pool) with every slot's row: gathered over the data axes where they
    split the pool, else ``t``."""
    if rt.mesh is None or not pool_split(state):
        return t
    return C.all_gather(t, rt.mesh.group(SH.data_axes(rt.mesh)), dim=0)


def init_params_sharded(cfg: ModelConfig, rt: Runtime, seed: int = 0,
                        device: str | torch.device = "cuda", dtype=torch.float32,
                        quantize: bool = True) -> MeshParams:
    """This rank's blocks of :func:`init_params`'s tree (the same draws)
    and of its ``quantize_tree`` form, drawn a piece at a time (the
    embedding, the head, then one layer, then the MTP head) and cut at
    once, so a rank never holds more than one whole layer: ``(params,
    qparams)``, the float tree placed for prefill and the quantized one for
    decode (resident experts where ``rt.serve_resident_moe``).  Without
    ``quantize`` both are the float tree, placed each way.  An
    encoder-decoder is drawn whole (``models/encdec.py``), then cut."""
    from repro_torch.serve.quantize import quantize_tree
    check_mesh(cfg, rt)
    if cfg.family == "encdec":
        from repro_torch.models import model as M
        return place_params(cfg, M.init_params(cfg, seed, device, dtype), quantize, rt)
    gen = generator(device, seed)
    trees: tuple[Params, Params] = ({}, {})          # float, decode
    specs: tuple[Params, Params] = ({}, {})

    def place(whole: Params) -> None:
        w = {"layers": [], **whole}
        for tree, spec, part in zip(trees, specs, shard_pair(
                cfg, w, quantize_tree(w) if quantize else w, rt)):
            for key in whole:
                if key == "layers":
                    tree.setdefault("layers", []).extend(part["layers"])
                    spec.setdefault("layers", []).extend(part["specs"]["layers"])
                else:
                    tree[key], spec[key] = part[key], part["specs"][key]

    # init_params's draws, in its order, each piece placed before the next
    place({"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)})
    place({"ln_f": L.norm_init(cfg.d_model, cfg.norm_type, gen.device)})
    if not cfg.tie_embeddings:
        place({"lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)})
    for i in range(cfg.n_layers):
        place({"layers": [init_layer(gen, cfg, i, dtype)]})
    if cfg.mtp:
        place({"mtp_proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype)})
        place({"mtp_layer": init_layer(gen, cfg, cfg.n_layers - 1, dtype)})
    for tree, spec in zip(trees, specs):
        tree["specs"] = spec
    return MeshParams(*trees)


def slot_block(n_slots: int, rt: Runtime) -> tuple[int, int]:
    """The rank's slots ``[lo, hi)`` of a pool of ``n_slots``: its block
    over the data axes where they tile the slots (``batch_entry``), else
    all of them."""
    mesh = rt.mesh
    if mesh is None or SH.batch_entry(n_slots, mesh) is None:
        return 0, n_slots
    sl = SH.block(n_slots, mesh, SH.live((SH.data_axes(mesh),), mesh)[0])
    return sl.start, sl.stop


def pool_split(state: dict) -> bool:
    """Whether ``state`` is a rank's block of a pool whose slots the data
    axes split (so other ranks hold other slots)."""
    block = state.get("block")
    return block is not None and block[1] - block[0] < block[2]


def local_slot(state: dict, slot: int) -> int | None:
    """Global ``slot``'s row in a rank's block of a pool, None where
    another data rank holds it (a whole pool: ``slot`` itself)."""
    if "block" not in state:
        return int(slot)
    lo, hi, _ = state["block"]
    return int(slot) - lo if lo <= int(slot) < hi else None


def slot_owner(state: dict, slot: int) -> int:
    """The data-axes index of the ranks whose block holds ``slot``."""
    lo, hi, _ = state["block"]
    return int(slot) // (hi - lo)


def layer_cuts(cfg: ModelConfig, rt: Runtime) -> list[dict]:
    """Per layer of a rank's block of a pool, each leaf the model axis
    splits: ``{name: (dim, lo, hi)}`` of the whole leaf (KV heads at dim 2,
    an SSM layer's ``h`` heads at dim 1 and ``conv_x`` channels at dim 2;
    MLA's latent and ``conv_B`` / ``conv_C`` are whole on every rank).
    The reference's ``decode_state_shardings`` splits dim 3 of every 5-dim
    stacked leaf, which for an SSM ``h`` ``[n_p, B, H, P, N]`` is the head
    dim ``P``; the port places ``h`` and ``conv_x`` by heads instead, so a
    rank's state is its own heads' (the spec builders stay the
    reference's)."""
    g, kv = local_cfg(cfg, rt).n_kv_heads, cfg.n_kv_heads
    sb = ssm_block(cfg, rt)
    out = []
    for i in range(cfg.n_layers):
        c: dict = {}
        if cfg.family == "encdec" or (cfg.layer_kind(i) == "attn" and cfg.attn_type != "mla"):
            if g != kv:
                h0 = rt.mesh.index(rt.model_axis) * g
                names = ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")
                c = {f"{n}_{t}": (2, h0, h0 + g) for n in names for t in "qs"}
        elif cfg.layer_kind(i) == "ssm" and sb is not None:
            h0, n = sb
            hd = cfg.ssm_head_dim
            c = {"h": (1, h0, h0 + n), "conv_x": (2, h0 * hd, (h0 + n) * hd)}
        out.append(c)
    return out


def init_decode_local(cfg: ModelConfig, batch: int, max_len: int, rt: Runtime,
                      device: str | torch.device = "cuda") -> dict:
    """:func:`init_decode_state` of ``batch`` slots with a rank's heads
    (:func:`layer_cuts`) on a mesh, every head off one."""
    state = init_decode_state(local_cfg(cfg, rt), batch, max_len, device)
    sb = ssm_block(cfg, rt)
    if sb is not None:
        dev = state["pos"].device
        for i in range(cfg.n_layers):
            if cfg.layer_kind(i) == "ssm":
                state["layers"][i] = SSM.init_ssm_state(cfg, batch, dev, heads=sb[1])
    return state


def init_decode_block(cfg: ModelConfig, n_slots: int, max_len: int, rt: Runtime,
                      device: str | torch.device = "cuda") -> dict:
    """A rank's block of a pool of ``n_slots`` (:func:`init_decode_state`
    on a mesh): its slots (:func:`slot_block`) and its heads
    (:func:`layer_cuts`); ``block`` holds ``(lo, hi, n_slots)``, which
    :func:`write_slot` and the steps read, ``cuts`` the head cuts.  An
    encoder-decoder's block is ``models/model.py`` ``init_decode_block``."""
    check_mesh(cfg, rt)
    lo, hi = slot_block(n_slots, rt)
    state = init_decode_local(cfg, hi - lo, max_len, rt, device)
    state["block"], state["cuts"] = (lo, hi, n_slots), layer_cuts(cfg, rt)
    return state


def decode_block_of(cfg: ModelConfig, state: dict, rt: Runtime) -> dict:
    """The rank's block (:func:`init_decode_block`'s layout) of a whole
    decode state, copied: its slots and, where the model axis splits them,
    its heads."""
    n = state["pos"].shape[0]
    lo, hi = slot_block(n, rt)
    cuts = layer_cuts(cfg, rt)
    layers = []
    for c, cut in zip(state["layers"], cuts):
        blk = {}
        for k, v in c.items():
            v = v[lo:hi]
            if k in cut:
                d, a, b = cut[k]
                v = v.narrow(d, a, b - a)
            blk[k] = v.clone()
        layers.append(blk)
    return {"layers": layers, "pos": state["pos"][lo:hi].clone(), "block": (lo, hi, n),
            "cuts": cuts}


def gather_slot_row(cfg: ModelConfig, state: dict, slot: int, n: int | None,
                    rt: Runtime) -> dict:
    """Row ``slot`` of a rank's block of a pool as a whole batch=1 row
    (:func:`read_slot`'s layout, every head) on every rank, the device half
    of a swap-out on a mesh: the slot's data owner reads its block, the
    leaves the model axis splits are all-gathered over it, then the owner
    broadcasts the row over the data axes (the reference's
    ``swap_row_shardings``: the row comes out replicated)."""
    mine = local_slot(state, slot)
    cuts = state.get("cuts") or [{} for _ in state["layers"]]
    model = rt.mesh.group(rt.model_axis)
    if mine is not None:
        one = read_slot(state, mine, n)
        for c, cut in zip(one["layers"], cuts):
            for k, (d, _, _) in cut.items():
                c[k] = C.all_gather(c[k], model, dim=d)
    if not pool_split(state):
        return one
    rows = n if n is not None else next((v.shape[1] for c in state["layers"] if is_seq_cache(c)
                                         for v in c.values()), 1)
    like = read_slot(init_decode_state(cfg, 1, max(1, rows), state["pos"].device), 0, n)
    data = rt.mesh.group(SH.data_axes(rt.mesh))
    src = slot_owner(state, slot)
    one = one if mine is not None else like
    return {"layers": [{k: C.broadcast(v.contiguous(), data, src) for k, v in c.items()}
                       for c in one["layers"]],
            "pos": C.broadcast(one["pos"], data, src)}


class _LayerMesh:
    """A layer's place on a mesh: its specs, whether the call's rows are
    split over the data axes, its attention's head counts and the
    row-parallel reductions of ``wo`` and ``w_down`` (None where the dim is
    whole on every rank), MLA's column gather of ``wq_a`` / ``wkv_a``
    (``cols``) and an SSM layer's head block (``ssm``)."""

    def __init__(self, specs: Params, split: bool, attn_cfg: ModelConfig,
                 attn_reduce, mlp_reduce, cols=None, ssm=None):
        self.specs, self.split = specs, split
        self.attn_cfg, self.attn_reduce, self.mlp_reduce = attn_cfg, attn_reduce, mlp_reduce
        self.cols, self.ssm = cols, ssm


class _MeshCall:
    """What one step on a mesh reads: the runtime, the tree's specs and
    whether its rows are the rank's slots or the rank's block of a training
    batch (split over the data axes); ``seq``: under sequence parallelism
    (training) the model axis' group, whose row-parallel reductions then
    reduce-scatter the rows (dim 1)."""

    def __init__(self, cfg: ModelConfig, rt: Runtime, specs: Params, split: bool,
                 seq: bool = False):
        self.cfg, self.rt, self.mesh, self.specs, self.split = cfg, rt, rt.mesh, specs, split
        self.dp = SH.data_axes(rt.mesh)
        self.model = rt.mesh.group(rt.model_axis)
        self.seq = self.model if seq and self.model.size > 1 else None
        self.red = L.RowReduce(self.model, rt.collective, 1 if self.seq else None)
        self.attn_cfg = local_cfg(cfg, rt)


def _mesh_call(p: Params, cfg: ModelConfig, rt: Runtime, state: dict | None = None,
               split: bool = False, seq_len: int | None = None) -> _MeshCall | None:
    """The call's place on ``rt.mesh`` (None off one): a step's rows are
    split where ``state`` is a rank's block of a split pool, a training
    batch's where ``split``; ``seq_len``: a training call's T, sequence
    parallel under ``rt.seq_shard`` where the model axis tiles it."""
    if rt.mesh is None:
        return None
    check_mesh(cfg, rt)
    if "specs" not in p:
        raise ValueError("params on a mesh are a rank's blocks with their specs "
                         "(transformer.place_params / init_params_sharded)")
    seq = (seq_len is not None and rt.seq_shard
           and SH._fit(rt.mesh, seq_len, rt.model_axis) is not None)
    return _MeshCall(cfg, rt, p["specs"], split or (state is not None and pool_split(state)),
                     seq)


def _split_over(spec: tuple, mesh, dim: int, axis: str) -> bool:
    """Whether dim ``dim`` of a leaf under ``spec`` is split over ``axis``."""
    live = SH.live(spec, mesh)
    return dim < len(live) and axis in live[dim]


def _gather_data(node, spec, mc: _MeshCall):
    """A layer's leaves with their data-axis (FSDP) dims gathered; the MoE
    block's leaves stay as stored (``_moe_block`` places them)."""
    if isinstance(node, dict):
        return {k: (v if k == "moe" else _gather_data(v, spec[k], mc)) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return SH.reshard(node, spec, _strip(spec, mc.dp), mc.mesh)
    return node


def _row_split(specs: dict, name: str, mc: _MeshCall) -> bool:
    """Whether row-parallel linear ``name`` of ``specs`` has its input rows
    split over the model axis (a float or a quantized tree)."""
    w = specs.get(name, specs.get(name + "_q"))
    return w is not None and _split_over(w, mc.mesh, 0, mc.rt.model_axis)


def _place_layer(lp: Params, ls: Params, mc: _MeshCall) -> tuple[Params, _LayerMesh]:
    """A layer's params with their FSDP dims gathered, and its place
    (:class:`_LayerMesh`) under its specs ``ls``."""
    lp = _gather_data(lp, ls, mc)
    attn_reduce = mlp_reduce = cols = blk = None
    if "attn" in ls:
        attn_reduce = mc.red if _row_split(ls["attn"], "wo", mc) else None
        if mc.cfg.attn_type == "mla":
            split = {n: _split_over(ls["attn"].get(n, ls["attn"].get(n + "_q")), mc.mesh, 1,
                                    mc.rt.model_axis) for n in ("wq_a", "wkv_a")}

            def cols(name, t, split=split):
                return C.all_gather(t, mc.model, dim=-1) if split[name] else t
    if "mlp" in ls:
        mlp_reduce = mc.red if _row_split(ls["mlp"], "w_down", mc) else None
    if "ssm" in ls and _row_split(ls["ssm"], "out_proj", mc):
        h0, n = ssm_block(mc.cfg, mc.rt)
        blk = SSM.HeadBlock(h0, n, mc.model, mc.red)
    return lp, _LayerMesh(ls, mc.split, mc.attn_cfg if attn_reduce else mc.cfg,
                          attn_reduce, mlp_reduce, cols, blk)


def _layer(p: Params, i: int, mc: _MeshCall | None) -> tuple[Params, _LayerMesh | None]:
    """Layer ``i``'s params and, on a mesh, its FSDP dims gathered and its
    place (:class:`_LayerMesh`)."""
    lp = p["layers"][i]
    if mc is None:
        return lp, None
    return _place_layer(lp, mc.specs["layers"][i], mc)


def _embed_ids(p: Params, ids: torch.Tensor, mc: _MeshCall) -> torch.Tensor:
    """The embedding rows of ``ids`` on a mesh: each rank looks up the ids
    in its vocabulary rows (zeros for the others) and the model axis sums
    them, exactly (one rank adds a row, the others zeros)."""
    spec = mc.specs["embed"]["w"]
    w = p["embed"]["w"]
    vocab, cols = SH.live(spec, mc.mesh)
    if cols and mc.split:
        # the feature blocks of one row live on the data ranks, whose rows
        # differ: look up every rank's ids, keep this rank's rows
        data = mc.mesh.group(mc.dp)
        b = ids.shape[0]
        x = _embed_ids(p, C.all_gather(ids, data, dim=0),
                       _MeshCall(mc.cfg, mc.rt, mc.specs, False))
        return x[data.index * b:(data.index + 1) * b]
    n = w.shape[0]
    if vocab:
        idx = ids - mc.mesh.index(vocab) * n
        hit = (idx >= 0) & (idx < n)
        x = w[torch.clamp(idx, 0, n - 1)] * hit[..., None].to(w.dtype)
    else:
        x = w[ids]
    # the FSDP-stored feature dim: the rows' blocks, gathered (not the table)
    x = C.all_gather(x, mc.mesh.group(cols), dim=-1) if cols else x
    return C.allreduce(x, mc.mesh.group(vocab), mc.rt.collective) if vocab else x


def _head_block(p: Params, cfg: ModelConfig, h: torch.Tensor, rt: Runtime,
                mc: _MeshCall) -> tuple[torch.Tensor, tuple, int]:
    """The head on a mesh over the rank's vocabulary columns (the tied
    embedding's rows), its FSDP-stored dim gathered: (logits of those
    columns, the axes that split the vocabulary, its first column)."""
    if cfg.tie_embeddings:
        spec = mc.specs["embed"]["w"]
        w = SH.reshard(p["embed"]["w"], spec, _strip(spec, mc.dp), mc.mesh)
        vocab = SH.live(spec, mc.mesh)[0]
        logits = torch.matmul(h, w.to(h.dtype).T)
    else:
        specs = mc.specs["lm_head"]
        w_name = "w_q" if "w_q" in p["lm_head"] else "w"
        spec = specs[w_name]
        vocab = SH.live(spec, mc.mesh)[-1]
        lin = {w_name: SH.reshard(p["lm_head"][w_name], spec, _strip(spec, mc.dp), mc.mesh)}
        if "w_s" in p["lm_head"]:      # the scale is whole: the rank's columns of it
            lin["w_s"] = SH.reshard(p["lm_head"]["w_s"], specs["w_s"], (vocab,), mc.mesh)
        logits = L.apply_linear(L._lin(lin, "w"), h, rt.backend)
    v0 = mc.mesh.index(vocab) * logits.shape[-1] if vocab else 0
    return logits, vocab, v0


def _lm_head_mesh(p: Params, cfg: ModelConfig, h: torch.Tensor, rt: Runtime,
                  mc: _MeshCall) -> torch.Tensor:
    """``lm_head`` on a mesh: the rank's vocabulary columns (the tied
    embedding's rows), gathered over the axes that split them.  Where the
    call's rows are the rank's slots, the head runs over every slot's row
    (gathered over the data axes) and the rank keeps its own: a float
    product of another row count may sum in another order, so the rank's
    logits are one device's bits."""
    if mc.split:
        data = mc.mesh.group(mc.dp)
        n = h.shape[0]
        whole = _lm_head_mesh(p, cfg, C.all_gather(h, data, dim=0), rt,
                              _MeshCall(mc.cfg, mc.rt, mc.specs, False))
        return whole[data.index * n:(data.index + 1) * n]
    logits, vocab, _ = _head_block(p, cfg, h, rt, mc)
    if not vocab:
        return logits
    return C.all_gather(logits, mc.mesh.group(vocab), dim=-1)


def _moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
               stored: Params, split: bool = False, train: bool = False, seq=None):
    """The MoE over ``x`` [B, T, d] on ``rt.mesh``, in the reference's
    layouts (``dist/sharding.py`` ``moe_param_specs``): a decode call (T
    1) with a resident layout (``ep2``, ``ep_data``, ``etp2``) runs the
    rank's resident window over the call's rows, the combine summed over
    the layout's axes; any other call the ``ep`` / ``etp`` layout over
    ``model`` (its FSDP dims gathered).  ``p`` holds the rank's blocks under
    the specs ``stored`` (a leaf is moved to the layout's block where they
    differ).  Every rank routes every row of the call (``split``: ``x`` is
    the rank's rows of a call split over the data axes, gathered first and
    cut back after), so every rank keeps one set under the call's global
    capacity.  Partial sums combine by ``rt.collective``.  The shared
    expert (FFN-sliced over ``model``) runs row-parallel after the combine
    (``w_down``'s input quantized over the whole FFN row, as one device
    quantizes it) and is added last, as one device adds it.

    ``train``: the reference's training block, which returns ``(out,
    aux)``: ``x`` is the rank's rows (its data shard's, or the whole batch
    where the data axes do not split it), routed, capped and balanced on
    their own (``moe_apply(..., with_aux=True)`` over the model axis, the
    capacity that of the shard's rows), the FSDP gathers differentiable,
    and ``aux`` the shard's load-balance loss (the caller averages it over
    every rank, ``_lm_loss_mesh``); ``seq`` (sequence parallelism) the
    model axis' group over which the combine and the shared expert's
    ``w_down`` reduce-scatter the rows."""
    if rt.mesh is None:
        out, aux = MOE.moe_apply(p, x, cfg, with_aux=train)
        return (out, aux) if train else out
    mesh = rt.mesh
    ms = SH.moe_param_specs(cfg, mesh, serve=rt.serve_resident_moe)
    dp = SH.data_axes(mesh)
    resident = ms["strategy"] in RESIDENT and x.shape[1] == 1 and not train
    if not resident and rt.serve_resident_moe:
        ms = SH.moe_param_specs(cfg, mesh, serve=False)

    def working(nm: str, table: dict, leaf: torch.Tensor, gather: bool = True) -> tuple:
        key = nm[:-2] if nm.endswith("_q") else nm
        spec = table.get(nm, table.get(key, (None,) * leaf.dim()))
        g = ms["gather"].get(nm, ms["gather"].get(key)) if gather else None
        if g is not None:
            spec = spec[:g] + (None,) + spec[g + 1:]
        return spec

    pp = {}
    for nm, leaf in p.items():
        if nm == "shared":           # FFN-sliced over model, no FSDP dim to gather
            pp[nm] = {k: SH.reshard(v, stored[nm][k], working(k, ms["shared"], v, False),
                                    mesh) for k, v in leaf.items()}
        else:
            pp[nm] = SH.reshard(leaf, stored[nm], working(nm, ms["spec"], leaf), mesh)
    data = mesh.group(dp)
    rows = C.all_gather(x, data, dim=0) if split else x
    B, T, d = rows.shape
    shared = pp.pop("shared", None)
    aux = None
    if train:
        model = mesh.group(rt.model_axis)

        def combine(o):
            if seq is not None:
                return C.reduce_scatter(o, model, 1)
            return C.allreduce(o, model, rt.collective)
        out, aux = MOE.moe_apply(pp, rows, cfg, axis_name=rt.model_axis, mesh=mesh,
                                 reduce_fn=combine, with_aux=True)
    elif resident:
        ep_axes = ms["ep_axes"]
        if ms["strategy"] == "etp2":
            e_first, n_local = 0, None
        else:
            size = SH.axes_size(mesh, ep_axes)
            n_local = cfg.n_experts // size
            e_first = mesh.index(ep_axes) * n_local
        out, _ = MOE.moe_local(pp, rows.reshape(B * T, d), cfg, e_first=e_first,
                               n_local=n_local)
        axes = tuple(ep_axes) + ((rt.model_axis,) if ms["strategy"] == "ep_data" else ())
        if rt.collective == "htree":
            for a in axes:              # a tree a mesh axis, as the reference
                out = C.htree_allreduce(out, mesh.group(a))
        else:
            out = C.all_reduce(out, mesh.group(axes))
        out = out.reshape(B, T, d).to(x.dtype)
    else:
        model = mesh.group(rt.model_axis)
        out, _ = MOE.moe_apply(pp, rows, cfg, axis_name=rt.model_axis, mesh=mesh,
                               reduce_fn=lambda o: C.allreduce(o, model, rt.collective))
    if shared is not None and cfg.n_shared_experts:
        model = mesh.group(rt.model_axis)
        wd = stored["shared"].get("w_down", stored["shared"].get("w_down_q"))
        red = (L.RowReduce(model, rt.collective, 1 if seq is not None else None)
               if _split_over(wd, mesh, 0, rt.model_axis) else None)
        out = out + _seq_part(L.apply_mlp(shared, rows, cfg.mlp_type, reduce=red),
                              seq, red is not None).to(out.dtype)
    if split:
        n = x.shape[0]
        out = out[data.index * n:(data.index + 1) * n]
    return (out, aux) if train else out
