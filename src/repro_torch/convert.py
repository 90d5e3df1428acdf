"""Parameter bridge from the reference's layout to the port's.

The reference stacks every layer's leaves under ``params["groups"]`` (a
tuple of groups, each a tuple of ``period`` slot trees whose leaves carry a
leading ``[n_p, ...]`` axis) and scans over them.  The port keeps one dict
per layer under ``params["layers"]``.  :func:`from_numpy` unstacks a
reference tree — float or ``quantize_tree``'d, with its leaves already
turned into numpy arrays — into port tensors, keeping every key name;
:func:`to_numpy` stacks a port tree back in the reference's groups.  An
encoder-decoder keeps its encoder and decoder layers under ``enc`` and
``dec``, each one stacked tree in the reference and a per-layer list in the
port.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def tree_map(tree: Any, fn) -> Any:
    """``fn`` of every leaf of a tree of dicts, lists and tuples (named
    tuples too), in the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(v, fn) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def to_device(params: Any, device: str | torch.device) -> Any:
    """A copy of a port parameter (or state) tree with every tensor on
    ``device``."""
    dev = resolve(device)
    return tree_map(params, lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t)


def from_numpy(params: dict, device: str | torch.device = "cuda") -> dict:
    """Reference params (numpy leaves) -> port params on ``device``.  Layer
    ``start + pi * period + s`` of group ``(start, count, period)`` is slot
    ``s``'s tree indexed at ``pi``; groups follow each other.  An
    encoder-decoder's stacked ``enc`` / ``dec`` trees become per-layer
    lists."""
    dev = resolve(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def unstack(tree):
        return [tree_map(tree, lambda a, i=i: tensor(a[i]))
                for i in range(tree_leaves(tree)[0].shape[0])]

    out = {k: unstack(v) if k in _ENCDEC else tree_map(v, tensor)
           for k, v in params.items() if k != "groups"}
    if "groups" in params:
        layers = []
        for slots in params["groups"]:
            n_p = tree_leaves(slots[0])[0].shape[0]
            for pi in range(n_p):
                for slot_tree in slots:
                    layers.append(tree_map(slot_tree, lambda a: tensor(a[pi])))
        out["layers"] = layers
    return out


_ENCDEC = ("enc", "dec")      # an encoder-decoder's stacked layer trees


def layer_groups(cfg) -> list[tuple[int, int, int]]:
    """The reference's ``[(start, count, period)]`` over ``cfg.n_layers``
    decoder layers: a hybrid stack one group whose period is ``attn_every``
    (a slot tree for each layer of a period), a stack with
    ``first_dense_layers`` two groups, every other stack one group of
    period 1."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        if n % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {n} layers are not whole periods of "
                             f"{cfg.attn_every}")
        return [(0, n, cfg.attn_every)]
    if cfg.first_dense_layers:
        f = cfg.first_dense_layers
        return [(0, f, 1), (f, n - f, 1)]
    return [(0, n, 1)]


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([t.detach().cpu().numpy() for t in trees])


def to_numpy(params: dict, cfg) -> dict:
    """Port params of configuration ``cfg`` -> the reference's layout with
    numpy leaves: the decoder layers go into the reference's groups
    (:func:`layer_groups`), an encoder-decoder's ``enc`` / ``dec`` lists are
    stacked back."""
    out = {k: _stack(v) if k in _ENCDEC else tree_map(v, lambda t: t.detach().cpu().numpy())
           for k, v in params.items() if k != "layers"}
    if "layers" not in params:
        return out
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree, "
                         f"{cfg.n_layers} in the configuration")
    out["groups"] = tuple(tuple(_stack(layers[start + s:start + count:period])
                                for s in range(period))
                          for start, count, period in layer_groups(cfg))
    return out
