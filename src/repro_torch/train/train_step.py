"""Training step: loss -> grads -> AdamW, with remat and microbatch
gradient accumulation.

PyTorch-port counterpart of ``repro.train.train_step``'s
:func:`make_train_step`.  The gradients come from ``torch.autograd.grad``
over the parameter leaves (a view of each with ``requires_grad``, no copy);
a leaf the loss does not reach (an embedding table that embedding inputs
bypass) gets a zero gradient, as ``jax.grad`` gives it.  Microbatches are
summed in the reference's order (from a zero tree, one microbatch after
another) and divided by their count.  The sharded step
(``opt_state_shardings``, ``jit_train_step``) is mesh code (ROADMAP A.14b).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.data.pipeline import put_batch
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import AdamW, AdamWState


def value_and_grad(params: Any, cfg: ModelConfig, batch: dict, rt: Runtime
                   ) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree of ``params``' shape) of one batch of tensors."""
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t
    tracked = tree_map(params, track)
    loss = M.train_loss(tracked, cfg, batch, rt)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return loss.detach(), tree_map(params, lambda p: _zero_if_none(next(grads), p))


def _zero_if_none(g: torch.Tensor | None, p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def _on_device(batch: dict, device: torch.device) -> dict:
    if all(isinstance(v, torch.Tensor) and v.device == device for v in batch.values()):
        return batch
    return put_batch(batch, device)


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: AdamW, microbatches: int = 1):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` may hold numpy arrays (moved to the params'
    device).  The step updates ``params`` and the moments in place
    (:meth:`AdamW.update`); ``metrics`` holds ``loss`` and ``grad_norm`` as
    0-d device tensors."""

    def step(params, opt_state: AdamWState, batch: dict):
        dev = tree_leaves(params)[0].device
        batch = _on_device(batch, dev)
        if microbatches == 1:
            loss, grads = value_and_grad(params, cfg, batch, rt)
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=dev))
            for i in range(microbatches):
                l_i, g_i = value_and_grad(params, cfg, {k: split(v, i) for k, v in batch.items()},
                                          rt)
                loss = loss + l_i
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                del g_i
            count = torch.full((), float(microbatches), device=dev)
            loss = loss / count
            for g in tree_leaves(grads):
                g.div_(count)
        new_params, new_opt, gnorm = opt.update(grads, opt_state, params, cfg)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step

