"""Parameter bridge from the reference's layout to the port's.

The reference stacks every layer's leaves under ``params["groups"]`` (a
tuple of groups, each a tuple of ``period`` slot trees whose leaves carry a
leading ``[n_p, ...]`` axis) and scans over them.  The port keeps one dict
per layer under ``params["layers"]``.  :func:`from_numpy` unstacks a
reference tree — float or ``quantize_tree``'d, with its leaves already
turned into numpy arrays — into port tensors, keeping every key name;
:func:`to_numpy` stacks a port tree back, each run of consecutive layers of
one structure a group of period 1 (the dense and MoE decoders' layout; a
stack whose first layers are dense and the rest MoE gets two groups, as
the reference's ``first_dense_layers`` does).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def to_device(params: Any, device: str | torch.device) -> Any:
    """A copy of a port parameter (or state) tree with every tensor on
    ``device``."""
    dev = resolve(device)
    return _map(params, lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t)


def from_numpy(params: dict, device: str | torch.device = "cuda") -> dict:
    """Reference params (numpy leaves) -> port params on ``device``.  Layer
    ``start + pi * period + s`` of group ``(start, count, period)`` is slot
    ``s``'s tree indexed at ``pi``; groups follow each other."""
    dev = resolve(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    out = {k: _map(v, tensor) for k, v in params.items() if k != "groups"}
    layers = []
    for slots in params["groups"]:
        n_p = _leaves(slots[0])[0].shape[0]
        for pi in range(n_p):
            for slot_tree in slots:
                layers.append(_map(slot_tree, lambda a: tensor(a[pi])))
    out["layers"] = layers
    return out


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    return None


def to_numpy(params: dict) -> dict:
    """Port params -> the reference's layout with numpy leaves (each run of
    layers of one structure in a group of period 1)."""
    out = {k: _map(v, lambda t: t.detach().cpu().numpy())
           for k, v in params.items() if k != "layers"}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([t.detach().cpu().numpy() for t in trees])

    runs: list[list] = []
    for layer in params["layers"]:
        if runs and _structure(runs[-1][0]) == _structure(layer):
            runs[-1].append(layer)
        else:
            runs.append([layer])
    out["groups"] = tuple((stack(run),) for run in runs)
    return out
