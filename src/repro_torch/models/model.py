"""Model facade: the entry points the serve engines and the train step call.

PyTorch counterpart of the ``repro.models.model`` facades that training
(:func:`train_loss`, :func:`model_flops`), the dry run
(:func:`abstract_params`, :func:`input_specs`, :func:`param_bytes`), the plain
decode path, the fused multi-step lane, chunked prefill (cold or warm from
the prefix cache) and the speculative lanes use, for GQA/MHA decoders
(token inputs, or the embeddings that a ``vlm`` configuration's stubbed
front end gives) and MLA decoders (with DeepSeek-V3's MTP head, which
drafts through :func:`mtp_draft` / :func:`mtp_draft_tree`), whose FFNs are
dense or mixture-of-experts (``models/moe.py``; token inputs), and SSM
(Mamba2) stacks, hybrid stacks that interleave SSM and GQA layers
(Jamba), and encoder-decoders (Whisper, ``models/encdec.py``: prefill from
``{"frames", "tokens"}``, then decode).  As in the reference,
``verify_step`` raises for stacks with SSM layers, and chunked prefill,
the fused multi-step lane and the speculative lanes raise for
encoder-decoders ("... targets decoder-only LMs").
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import encdec
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    serve (see :func:`transformer.check_supported`,
    :func:`encdec.check_supported`)."""
    if cfg.family == "encdec":
        encdec.check_supported(cfg)
    else:
        T.check_supported(cfg)


def _decoder_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(f"{what} targets decoder-only LMs")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    if cfg.family == "encdec":
        return encdec.init_params(cfg, seed=seed, device=device, dtype=dtype)
    return T.init_params(cfg, seed=seed, device=device, dtype=dtype)


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """The full parameter tree on the ``meta`` device: every leaf's shape
    and dtype, no storage (the dry run's counterpart of the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, device="meta", dtype=dtype)


def param_bytes(cfg: ModelConfig, bytes_per_param: int = 2) -> int:
    return cfg.param_count() * bytes_per_param


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for (arch x shape) as ``meta`` tensors with the
    reference's shapes and dtypes: tokens and labels for train, the prompt
    for prefill, the [B] token for decode (its position lives in the
    state); an encoder-decoder's ``frames`` (bf16, the stubbed front end's
    output), and bf16 embeddings where ``cfg.input_mode == "embeddings"``.
    The port's steps take float inputs as f32, as its engines land them."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"token": spec(B)}
    if cfg.family == "encdec":
        out = {"frames": spec(B, cfg.encoder_seq, cfg.d_model, dtype=torch.bfloat16),
               "tokens": spec(B, S)}
        return {**out, "labels": spec(B, S)} if shape.kind == "train" else out
    inp = (spec(B, S, cfg.d_model, dtype=torch.bfloat16) if cfg.input_mode == "embeddings"
           else spec(B, S))
    if shape.kind == "train":
        return {"inputs": inp, "labels": spec(B, S)}
    return {"inputs": inp}


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the reference's roofline convention, DESIGN.md Sec. 7)
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence against a seq_len cache
    return 2.0 * n_active * shape.global_batch


def train_loss(params: Params, cfg: ModelConfig, batch: dict, rt: Runtime,
               split: bool = False) -> torch.Tensor:
    """The training loss of one batch of tensors: ``inputs`` and ``labels``
    ([B, T]; ``inputs`` [B, T, d] embeddings where the configuration takes
    them), an encoder-decoder's ``frames``, ``tokens`` and ``labels``.  On
    ``rt.mesh`` the params are a rank's blocks with their ``specs`` and the
    batch is the rank's rows: its block over the data axes (``split``, as
    ``data/pipeline.py`` ``put_batch`` cuts it by ``input_shardings``) or
    the whole batch; the value is the whole loss on every rank and the
    gradient the rank's share (``transformer.mesh_loss``)."""
    if cfg.family == "encdec":
        return encdec.lm_loss(params, cfg, batch["frames"], batch["tokens"],
                              batch["labels"], rt, split)
    return T.lm_loss(params, cfg, batch["inputs"], batch["labels"], rt, split=split)


def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int,
            rt: Runtime):
    """``batch`` holds ``inputs`` ([B, T] int tokens, or [B, T, d] float
    embeddings where ``cfg.input_mode == "embeddings"``) and may carry
    ``lengths`` ([B] int32) for ragged right-padded prompts; an
    encoder-decoder's holds ``frames`` ([B, S_enc, d]) and ``tokens``
    ([B, T])."""
    if cfg.family == "encdec":
        return encdec.prefill(params, cfg, batch["frames"], batch["tokens"], max_len, rt)
    return T.prefill(params, cfg, batch["inputs"], max_len, rt,
                     lengths=batch.get("lengths"))


def decode_step(params: Params, cfg: ModelConfig, state: dict, token,
                rt: Runtime):
    if cfg.family == "encdec":
        return encdec.decode_step(params, cfg, state, token, rt)
    return T.decode_step(params, cfg, state, token, rt)


def init_decode_block(cfg: ModelConfig, n_slots: int, max_len: int, rt: Runtime,
                      device: str | torch.device = "cuda") -> dict:
    """A rank's block of a pool of ``n_slots`` on ``rt.mesh``: its slots
    and heads (see :func:`repro_torch.models.transformer.init_decode_block`),
    an encoder-decoder's self and cross K/V too."""
    if cfg.family != "encdec":
        return T.init_decode_block(cfg, n_slots, max_len, rt, device)
    T.check_mesh(cfg, rt)
    lo, hi = T.slot_block(n_slots, rt)
    state = encdec.init_decode_state(T.local_cfg(cfg, rt), hi - lo, max_len, device)
    state["block"], state["cuts"] = (lo, hi, n_slots), T.layer_cuts(cfg, rt)
    return state


def multi_decode_step(params: Params, cfg: ModelConfig, state: dict, token,
                      m: int, rt: Runtime):
    """``m`` greedy decode steps with the argmax fed back on the device ->
    (tokens [B, m] int32, state advanced by m); see
    :func:`repro_torch.models.transformer.multi_decode_step`."""
    _decoder_only(cfg, "fused multi-step decode")
    return T.multi_decode_step(params, cfg, state, token, m, rt)


def init_prefill_carry(cfg: ModelConfig, buf_len: int,
                       device: str | torch.device = "cuda") -> dict:
    """A zero float K/V carry of ``buf_len`` rows (``carry_len(max_len, chunk)``)
    for one chunked prefill; see
    :func:`repro_torch.models.transformer.init_prefill_carry`."""
    _decoder_only(cfg, "chunked prefill")
    return T.init_prefill_carry(cfg, buf_len, device)


def warm_prefill_carry(cfg: ModelConfig, state: dict, slot: int, n: int,
                       buf_len: int, tokens=None, rt: Runtime | None = None) -> dict:
    """A carry seeded from rows ``[0:n)`` of pool ``slot`` with its cursor
    at ``n`` (the prefix-cache warm start; ``rt`` the mesh's, where
    ``state`` is a rank's block); see
    :func:`repro_torch.models.transformer.warm_prefill_carry`."""
    _decoder_only(cfg, "chunked prefill")
    return T.warm_prefill_carry(cfg, state, slot, n, buf_len, tokens, rt)


def prefill_chunk(params: Params, cfg: ModelConfig, carry: dict, tokens,
                  n_real, rt: Runtime):
    """One ``[1, C]`` chunk (or ``[1, C, d]`` embeddings) at the carry's
    cursor -> (logits of its last real token [1, V], carry updated in
    place)."""
    _decoder_only(cfg, "chunked prefill")
    return T.prefill_chunk(params, cfg, carry, tokens, n_real, rt)


def finalize_prefill_carry(cfg: ModelConfig, carry: dict, max_len: int,
                           start: int = 0) -> dict:
    _decoder_only(cfg, "chunked prefill")
    return T.finalize_prefill_carry(cfg, carry, max_len, start)


def verify_step(params: Params, cfg: ModelConfig, state: dict, tokens,
                rt: Runtime, depth=None, anc=None):
    """Speculative-decode verify: ``tokens`` [B, T] (last committed token +
    T-1 drafts per slot) -> (logits [B, T, V], hidden [B, T, d], state with
    ``pos + T``).  With ``depth``/``anc`` ([B, T] int32) the window is a
    draft tree.  See :func:`repro_torch.models.transformer.verify_step`."""
    _decoder_only(cfg, "speculative decode")
    return T.verify_step(params, cfg, state, tokens, rt, depth=depth, anc=anc)


def tree_commit(state: dict, base, sel, keep, pos) -> dict:
    """Compact a verified tree window's accepted root-path rows into
    contiguous committed rows and rewind the cursor; see
    :func:`repro_torch.models.transformer.tree_commit`."""
    return T.tree_commit(state, base, sel, keep, pos)


def mtp_draft(params: Params, cfg: ModelConfig, hidden, token, pos, k: int,
              rt: Runtime):
    """Draft ``k`` tokens a slot from the MTP head (requires ``cfg.mtp``);
    see :func:`repro_torch.models.transformer.mtp_draft`."""
    _decoder_only(cfg, "speculative decode")
    return T.mtp_draft(params, cfg, hidden, token, pos, k, rt)


def mtp_draft_tree(params: Params, cfg: ModelConfig, hidden, token, pos, n: int,
                   branch: int, rt: Runtime):
    """Beam the MTP head into a static draft tree (tokens [B, n],
    chain-major; topology from
    :func:`repro_torch.models.transformer.mtp_chain_lengths`)."""
    _decoder_only(cfg, "speculative decode")
    return T.mtp_draft_tree(params, cfg, hidden, token, pos, n, branch, rt)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    if cfg.family == "encdec":
        return encdec.init_decode_state(cfg, batch, max_len, device)
    return T.init_decode_state(cfg, batch, max_len, device)
