"""Model facade: the entry points the serve engines call.

PyTorch counterpart of the ``repro.models.model`` facades that the plain
decode path, the fused multi-step lane, chunked prefill and the speculative
lanes use, for dense GQA decoders and SSM
(Mamba2) stacks; other families raise until their slice is ported (ROADMAP
A.11), and ``verify_step`` raises for SSM stacks, as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime  # noqa: F401

Params = dict[str, Any]


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    return T.init_params(cfg, seed=seed, device=device, dtype=dtype)


def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int,
            rt: Runtime):
    """``batch`` holds ``inputs`` ([B, T] int tokens) and may carry
    ``lengths`` ([B] int32) for ragged right-padded prompts."""
    return T.prefill(params, cfg, batch["inputs"], max_len, rt,
                     lengths=batch.get("lengths"))


def decode_step(params: Params, cfg: ModelConfig, state: dict, token,
                rt: Runtime):
    return T.decode_step(params, cfg, state, token, rt)


def multi_decode_step(params: Params, cfg: ModelConfig, state: dict, token,
                      m: int, rt: Runtime):
    """``m`` greedy decode steps with the argmax fed back on the device ->
    (tokens [B, m] int32, state advanced by m); see
    :func:`repro_torch.models.transformer.multi_decode_step`."""
    return T.multi_decode_step(params, cfg, state, token, m, rt)


def init_prefill_carry(cfg: ModelConfig, buf_len: int,
                       device: str | torch.device = "cuda") -> dict:
    """A zero float K/V carry of ``buf_len`` rows (``carry_len(max_len)``)
    for one chunked prefill; see
    :func:`repro_torch.models.transformer.init_prefill_carry`."""
    return T.init_prefill_carry(cfg, buf_len, device)


def prefill_chunk(params: Params, cfg: ModelConfig, carry: dict, tokens,
                  n_real, rt: Runtime):
    """One ``[1, C]`` chunk at the carry's cursor -> (logits of its last real
    token [1, V], carry updated in place)."""
    return T.prefill_chunk(params, cfg, carry, tokens, n_real, rt)


def finalize_prefill_carry(cfg: ModelConfig, carry: dict, max_len: int) -> dict:
    return T.finalize_prefill_carry(cfg, carry, max_len)


def verify_step(params: Params, cfg: ModelConfig, state: dict, tokens,
                rt: Runtime, depth=None, anc=None):
    """Speculative-decode verify: ``tokens`` [B, T] (last committed token +
    T-1 drafts per slot) -> (logits [B, T, V], hidden [B, T, d], state with
    ``pos + T``).  With ``depth``/``anc`` ([B, T] int32) the window is a
    draft tree.  See :func:`repro_torch.models.transformer.verify_step`."""
    return T.verify_step(params, cfg, state, tokens, rt, depth=depth, anc=anc)


def tree_commit(state: dict, base, sel, keep, pos) -> dict:
    """Compact a verified tree window's accepted root-path rows into
    contiguous committed rows and rewind the cursor; see
    :func:`repro_torch.models.transformer.tree_commit`."""
    return T.tree_commit(state, base, sel, keep, pos)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: str | torch.device = "cuda") -> dict:
    return T.init_decode_state(cfg, batch, max_len, device)
