"""Model facade: the entry points the serve engines call.

PyTorch counterpart of the ``repro.models.model`` facades that the plain
decode path and the speculative lanes use, for dense GQA decoders and SSM
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
