"""Training step: loss -> grads -> AdamW, with remat and microbatch
gradient accumulation, on one device or over a (data, model) mesh.

PyTorch-port counterpart of ``repro.train.train_step``.  The gradients
come from ``torch.autograd.grad`` over the parameter leaves (a view of each
with ``requires_grad``, no copy); a leaf the loss does not reach (an
embedding table that embedding inputs bypass) gets a zero gradient, as
``jax.grad`` gives it.  Microbatches are summed in the reference's order
(from a zero tree, one microbatch after another) and divided by their
count.

On a mesh (:func:`jit_train_step`) the step runs on a rank's blocks: the
params and moments under their specs (``dist/sharding.py``
``param_shardings``, :func:`opt_state_shardings`), the batch's block over
the data axes.  Where the reference jits the one-device step with explicit
shardings and lets GSPMD place the collectives, the port's mesh forward
calls them itself (``models/transformer.py``), their adjoints give each
rank its share of the gradient, :func:`reduce_grads` sums the shares of a
leaf held on several ranks, and ``AdamW.update`` updates the blocks in
place (the reference's donation).  The steps are eager: no graph, no
compile.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.data.pipeline import put_batch
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import BLOCK, AdamW, AdamWState, _fallback, _zip_map


def value_and_grad(params: Any, cfg: ModelConfig, batch: dict, rt: Runtime,
                   split: bool = False) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree of ``params``' shape) of one batch of tensors.
    On a mesh ``params`` carries its ``specs`` (kept out of the gradient
    tree) and each leaf's gradient is the rank's share (see
    :func:`reduce_grads`); ``split`` as ``model.train_loss`` takes it."""
    specs = params.get("specs") if isinstance(params, dict) else None
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t
    body = {k: v for k, v in params.items() if k != "specs"} if specs is not None else params
    tracked = tree_map(body, track)
    if specs is not None:
        tracked["specs"] = specs
    loss = M.train_loss(tracked, cfg, batch, rt, split)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return loss.detach(), tree_map(body, lambda p: _zero_if_none(next(grads), p))


def _zero_if_none(g: torch.Tensor | None, p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def _on_device(batch: dict, device: torch.device) -> dict:
    if all(isinstance(v, torch.Tensor) and v.device == device for v in batch.values()):
        return batch
    return put_batch(batch, device)


def reduce_grads(grads: Any, specs: Any, mesh) -> Any:
    """Each leaf's gradient summed over the mesh axes that do not split it
    (the ranks holding copies of its block, each with its share) -> a new
    tree: every rank holds its block of the whole gradient, the same bits
    on every copy."""
    def one(g, spec):
        axes = tuple(a for a in mesh.axis_names
                     if a not in SH.split_axes(spec, mesh) and mesh.shape[a] > 1)
        return C.all_reduce(g, mesh.group(axes)) if axes else g
    return _zip_map(grads, specs, one)


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: AdamW, microbatches: int = 1,
                    specs: Any = None, split: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` may hold numpy arrays (moved to the params'
    device).  The step updates ``params`` and the moments in place
    (:meth:`AdamW.update`); ``metrics`` holds ``loss`` and ``grad_norm`` as
    0-d device tensors.  On ``rt.mesh`` the trees are a rank's blocks under
    ``specs`` (the params' spec tree; by default the ``specs`` key the
    params carry) and the batch is the rank's rows (``split``: its block
    over the data axes); see :func:`jit_train_step`."""
    mesh = rt.mesh

    def step(params, opt_state: AdamWState, batch: dict):
        tree_specs = specs if specs is not None else (
            params.get("specs") if isinstance(params, dict) else None)
        body = ({k: v for k, v in params.items() if k != "specs"}
                if isinstance(params, dict) and "specs" in params else params)
        if mesh is not None and tree_specs is None:
            raise ValueError("a mesh step needs the params' specs")
        run = dict(body, specs=tree_specs) if mesh is not None else body
        dev = tree_leaves(body)[0].device
        batch = _on_device(batch, dev)
        if microbatches == 1:
            loss, grads = value_and_grad(run, cfg, batch, rt, split)
        else:
            def part(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(body, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=dev))
            for i in range(microbatches):
                l_i, g_i = value_and_grad(run, cfg, {k: part(v, i) for k, v in batch.items()},
                                          rt, split)
                loss = loss + l_i
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                del g_i
            count = torch.full((), float(microbatches), device=dev)
            loss = loss / count
            for g in tree_leaves(grads):
                g.div_(count)
        if mesh is not None:
            grads = reduce_grads(grads, tree_specs, mesh)
        _, new_opt, gnorm = opt.update(grads, opt_state, body, cfg, mesh=mesh,
                                       specs=tree_specs)
        return params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def opt_state_shardings(opt: AdamW, params_abstract: Any, param_specs: Any, mesh
                        ) -> AdamWState:
    """The specs of the optimizer state: the moments shard exactly like the
    params; an int8 moment's block scales take the param's spec where its
    axes still tile the scales' collapsed last dim (``sharding.fit_spec``)
    and are replicated where the per-tensor fallback made them a scalar.
    ``params_abstract``: the whole tree (``meta`` tensors or any leaves
    with ``shape``)."""
    def msh(leaf, spec):
        if not opt.quantized_state:
            return spec
        shape = tuple(leaf.shape)
        if _fallback(shape):
            return {"q": spec, "s": SH.P()}
        return {"q": spec, "s": SH.fit_spec(spec, (*shape[:-1], shape[-1] // BLOCK), mesh)}
    body = {k: v for k, v in params_abstract.items() if k != "specs"}
    specs = {k: v for k, v in param_specs.items() if k != "specs"}
    m = _zip_map(body, specs, msh)
    return AdamWState(count=SH.P(), m=m, v=m)


def jit_train_step(cfg: ModelConfig, rt: Runtime, opt: AdamW, mesh, params_abstract: Any,
                   param_specs: Any, batch_specs: dict, microbatches: int = 1):
    """The reference's sharded step on a rank: ``step(params, opt_state,
    batch)`` over the rank's blocks of the params (under ``param_specs``),
    of the optimizer state (``opt.init(params, param_specs, mesh)``, placed
    as :func:`opt_state_shardings` gives) and of the batch (under
    ``batch_specs``, as ``put_batch(..., specs=batch_specs, mesh=mesh)``
    cuts it).  The gradients are reduced by their specs and the update
    runs in place (the reference donates the params and the state);
    ``loss`` and ``grad_norm`` come out equal on every rank.  Eager, as
    every step of the port.  ``params_abstract`` is the whole tree's shape
    (kept for the reference's signature: the blocks' specs say it)."""
    if rt.mesh is not mesh:
        raise ValueError("jit_train_step: rt.mesh must be the step's mesh")
    first = next(iter(batch_specs.values()))
    split = bool(first and SH.live(first, mesh)[0])
    return make_train_step(cfg, rt, opt, microbatches, specs=param_specs, split=split)
