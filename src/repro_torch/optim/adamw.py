"""AdamW with optional block-quantized int8 moments.

PyTorch-port counterpart of ``repro.optim.adamw``.  Block-wise int8 moments
(per-128-element absmax scales, the bitsandbytes trick) cut optimizer state
8x against f32 moments.  The arithmetic is the reference's, leaf for leaf;
three places where the port's per-layer parameter list differs from the
reference's stacked groups are bridged so that the port computes what the
reference computes:

* **Weight decay** goes to every leaf whose *reference* leaf has rank 2 or
  more.  The reference decides on its stacked leaves, so a layer's norm
  scale (``[n_layers_in_group, d]`` there, ``[d]`` here) is decayed while
  ``ln_f`` is not: a leaf under ``layers`` (or an encoder-decoder's
  ``enc`` / ``dec``) counts one rank more than it has.
* **The per-tensor fallback** of :func:`_q8` (a last axis that is not a
  multiple of ``BLOCK``) takes one scale over the whole stacked leaf in the
  reference, that is over every layer of one period slot of one group.
  :func:`_q8_stack` shares that scale across the same layers
  (``convert.layer_groups``), so the int8 codes are the reference's.
* **Division**: the quantizer divides by 127 and by its scales as IEEE
  divisions on every device (``core/quant.py`` :func:`div127`).

The update writes the new parameters and moments into the tensors it is
given and returns the same trees (the reference returns new arrays, and its
``jit_train_step`` donates the old ones): at full width the state is tens of
GB, and a second copy would not fit the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.convert import layer_groups, tree_leaves, tree_map
from repro_torch.core.quant import div127

BLOCK = 128
STACKED = ("layers", "enc", "dec")     # per-layer lists the reference stacks


def _fallback(shape: tuple[int, ...]) -> bool:
    """Whether :func:`_q8` takes one scale per tensor for a leaf of
    ``shape``: no axis, a last axis that is not a multiple of ``BLOCK``, or
    fewer than ``BLOCK`` elements."""
    return len(shape) == 0 or shape[-1] % BLOCK != 0 or math.prod(shape) < BLOCK


def _code(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.round(x / s).to(torch.int8)


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-quantize along the last axis (per-tensor if not divisible) ->
    (int8 codes of ``x``'s shape, f32 scales ``[..., last / BLOCK]`` or 0-d)."""
    if _fallback(tuple(x.shape)):
        s = div127(torch.clamp_min(torch.amax(torch.abs(x)), 1e-12))
        return _code(x, s), s.to(torch.float32)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // BLOCK, BLOCK)
    s = div127(torch.clamp_min(torch.amax(torch.abs(xb), dim=-1, keepdim=True), 1e-12))
    return _code(xb, s).reshape(x.shape), s[..., 0].to(torch.float32)


def _q8_stack(xs: list[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`_q8` of the leaves that the reference stacks into one (one
    layer each, in layer order): blocks along the last axis are each
    layer's own, and the per-tensor fallback shares one scale, the absmax
    over every layer of the stack, as the reference's stacked leaf has."""
    shape = (len(xs), *xs[0].shape) if len(xs) > 1 else tuple(xs[0].shape)
    if len(xs) == 1 or not _fallback(shape):
        return [_q8(x) for x in xs]
    amax = torch.amax(torch.stack([torch.amax(torch.abs(x)) for x in xs]))
    s = div127(torch.clamp_min(amax, 1e-12)).to(torch.float32)
    return [(_code(x, s), s) for x in xs]


def _dq8(q: torch.Tensor, s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if s.ndim == 0:
        return q.to(torch.float32) * s
    shp = (*like.shape[:-1], like.shape[-1] // BLOCK, BLOCK)
    return (q.reshape(shp).to(torch.float32) * s[..., None]).reshape(like.shape)


class AdamWState(NamedTuple):
    count: torch.Tensor       # 0-d int32
    m: Any                    # the params' tree: f32 moments or {"q", "s"}
    v: Any


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, tensor) for every leaf of a tree of dicts and lists, in order;
    a quantized moment ``{"q", "s"}`` counts as one leaf."""
    if isinstance(tree, dict) and set(tree) != {"q", "s"}:
        return [x for k, v in tree.items() for x in _paths(v, (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, (*prefix, i))]
    return [(prefix, tree)]


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _stacks(params: Any, cfg) -> list[list[tuple]]:
    """Paths of the parameter leaves grouped as the reference stacks them:
    a leaf under ``layers`` with the same leaf of the other layers of its
    group's period slot (``convert.layer_groups``), under an
    encoder-decoder's ``enc`` / ``dec`` with the same leaf of every layer
    there, any other leaf alone.  Each stack lists its layers in order."""
    slot_of: dict[int, tuple] = {}
    if isinstance(params, dict) and "layers" in params:
        if cfg is None:
            raise ValueError("a tree with per-layer 'layers' needs its config")
        for gi, (start, count, period) in enumerate(layer_groups(cfg)):
            for i in range(start, start + count):
                slot_of[i] = (gi, (i - start) % period)
    stacks: dict[tuple, list[tuple]] = {}
    for path, _ in _paths(params):
        if path[0] == "layers":
            key = ("layers", slot_of[path[1]], *path[2:])
        elif path[0] in STACKED:
            key = (path[0], *path[2:])
        else:
            key = path
        stacks.setdefault(key, []).append(path)
    return list(stacks.values())


def _ref_ndim(path: tuple, leaf: torch.Tensor) -> int:
    """The rank of the reference's leaf: one axis more under a stacked list."""
    return leaf.ndim + (path[0] in STACKED)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    quantized_state: bool = False
    clip_norm: float = 1.0

    # ------------------------------------------------------------------ #
    def init(self, params: Any) -> AdamWState:
        """Zero moments in the params' tree, on each leaf's device."""
        def zero(x):
            z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            if self.quantized_state:
                q, s = _q8(z)
                return {"q": q, "s": s}
            return z

        first = tree_leaves(params)[0]
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=first.device),
                          m=tree_map(params, zero), v=tree_map(params, zero))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warm-up then cosine decay, in f32 on ``step``'s device."""
        step = step.to(torch.float32)
        warm = torch.clamp_max(_div(step + 1, max(1, self.warmup_steps)), 1.0)
        prog = torch.clamp(_div(step - self.warmup_steps,
                                max(1, self.total_steps - self.warmup_steps)), 0.0, 1.0)
        return self.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))

    def update(self, grads: Any, state: AdamWState, params: Any, cfg=None
               ) -> tuple[Any, AdamWState, torch.Tensor]:
        """One step: global-norm clip, then AdamW on every leaf -> (params,
        state, the gradient's global norm before the clip).  ``params`` and
        the moments are updated in place (see the module's docstring).
        ``cfg`` is the model's configuration, needed for a tree with
        per-layer ``layers`` (which layers the reference stacks)."""
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for _, g in _paths(grads)))
        scale = torch.clamp_max(_div(self.clip_norm, torch.clamp_min(gnorm, 1e-9)), 1.0)
        count = state.count + 1
        lr = self.schedule(state.count)
        b1c = 1 - self.b1 ** count.to(torch.float32)
        b2c = 1 - self.b2 ** count.to(torch.float32)
        for stack in _stacks(params, cfg):
            first = _get(params, stack[0])
            shared = (self.quantized_state and len(stack) > 1
                      and _fallback((len(stack), *first.shape)))
            pending = []
            for path in stack:
                p, g = _get(params, path), _get(grads, path).to(torch.float32) * scale
                m, v = _get(state.m, path), _get(state.v, path)
                mf = _dq8(m["q"], m["s"], g) if isinstance(m, dict) else m
                vf = _dq8(v["q"], v["s"], g) if isinstance(v, dict) else v
                mf = self.b1 * mf + (1 - self.b1) * g
                vf = self.b2 * vf + (1 - self.b2) * g * g
                step_ = lr * (mf / b1c) / (torch.sqrt(vf / b2c) + self.eps)
                if _ref_ndim(path, p) >= 2:          # no decay on ln_f / biases
                    step_ = step_ + lr * self.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - step_).to(p.dtype))
                if shared:                           # quantized once the stack is done
                    pending.append((m, v, mf, vf))
                elif self.quantized_state:
                    _store(m, _q8(mf))
                    _store(v, _q8(vf))
                else:
                    m.copy_(mf)
                    v.copy_(vf)
            if pending:
                for (m, v, _, _), qm, qv in zip(pending, _q8_stack([x[2] for x in pending]),
                                                _q8_stack([x[3] for x in pending])):
                    _store(m, qm)
                    _store(v, qv)
        return params, AdamWState(count=count, m=state.m, v=state.v), gnorm


def _div(a, b) -> torch.Tensor:
    """``a / b`` for a tensor and a Python number, either way round, as an
    IEEE division (on CUDA, PyTorch divides by a Python scalar as a multiply
    by its reciprocal, and divides one by a tensor through its reciprocal)."""
    t = a if isinstance(a, torch.Tensor) else b
    a = a if isinstance(a, torch.Tensor) else torch.full((), float(a), device=t.device)
    b = b if isinstance(b, torch.Tensor) else torch.full((), float(b), device=t.device)
    return a / b


def _store(dst: dict, qs: tuple[torch.Tensor, torch.Tensor]) -> None:
    dst["q"].copy_(qs[0])
    dst["s"].copy_(qs[1])
