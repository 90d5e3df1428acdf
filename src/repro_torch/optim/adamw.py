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

On a mesh (``mesh`` and the params' ``specs``, ``dist/sharding.py``) every
tree holds the rank's blocks and the update computes what one device does
on the whole leaves: the global norm adds each leaf's block's squares over
exactly the axes that split it (a copy is counted once), and an int8
moment's scales are the whole leaf's.  The scales are placed as the
reference's ``opt_state_shardings`` places them (``sharding.fit_spec`` of
the leaf's spec on the scales' shape): where that keeps the last dim
split, the rank's block holds whole 128-blocks and quantizes alone; where
it does not, the rank gathers the last dim's blocks to quantize; and the
per-tensor fallback takes the max over the leaf's blocks (and over the
layers the reference stacks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.convert import layer_groups, tree_leaves, tree_map
from repro_torch.core.quant import div127
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH

BLOCK = 128
STACKED = ("layers", "enc", "dec")     # per-layer lists the reference stacks
_ZERO_SCALE = float(div127(torch.full((), 1e-12)))    # a zero moment's block scale


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


def _q8_stack(xs: list[torch.Tensor], over=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`_q8` of the leaves that the reference stacks into one (one
    layer each, in layer order): blocks along the last axis are each
    layer's own, and the per-tensor fallback shares one scale, the absmax
    over every layer of the stack, as the reference's stacked leaf has
    (``over``: on a mesh, the max over the leaf's blocks; the caller has
    taken the fallback by the whole leaf's shape)."""
    shape = (len(xs), *xs[0].shape) if len(xs) > 1 else tuple(xs[0].shape)
    if over is None and (len(xs) == 1 or not _fallback(shape)):
        return [_q8(x) for x in xs]
    amax = torch.amax(torch.stack([torch.amax(torch.abs(x)) for x in xs]))
    amax = over(amax) if over is not None else amax
    s = div127(torch.clamp_min(amax, 1e-12)).to(torch.float32)
    return [(_code(x, s), s) for x in xs]


class _Place:
    """A leaf's place on a mesh: its spec, whole shape and the scales'
    spec, and the quantizer that gives the whole leaf's scales on its
    block (:meth:`q8`)."""

    def __init__(self, leaf: torch.Tensor, spec: tuple, mesh):
        self.mesh, self.spec = mesh, tuple(spec) + (None,) * (leaf.dim() - len(spec))
        self.shape = SH.global_shape(leaf, self.spec, mesh)
        self.axes = SH.split_axes(self.spec, mesh)
        self.last = SH.live(self.spec, mesh)[-1] if leaf.dim() else ()
        if _fallback(self.shape):
            self.s_spec = ()
        else:
            self.s_spec = SH.fit_spec(self.spec, (*self.shape[:-1], self.shape[-1] // BLOCK),
                                      mesh)

    def scale_shape(self) -> tuple[int, ...]:
        """The rank's block of the whole leaf's scales."""
        if not self.s_spec:
            return ()
        whole = (*self.shape[:-1], self.shape[-1] // BLOCK)
        lv = SH.live(self.s_spec, self.mesh)
        return tuple(n // SH.axes_size(self.mesh, lv[d]) for d, n in enumerate(whole))

    def amax(self, local: torch.Tensor) -> torch.Tensor:
        """The max of ``local`` over the leaf's blocks."""
        return C.all_reduce(local, self.mesh.group(self.axes), "max") if self.axes else local

    def q8(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """:func:`_q8` of the whole leaf, the rank's block of its codes and
        of its scales."""
        if not self.s_spec:
            s = div127(torch.clamp_min(self.amax(torch.amax(torch.abs(x))), 1e-12))
            return _code(x, s), s.to(torch.float32)
        if not self.last or SH.live(self.s_spec, self.mesh)[-1]:
            return _q8(x)                   # whole 128-blocks on the rank
        g = self.mesh.group(self.last)      # the scales are whole: gather the row
        q, s = _q8(C.all_gather(x, g, dim=-1))
        w = x.shape[-1]
        return q.narrow(-1, g.index * w, w).contiguous(), s

    def dq8(self, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """:func:`_dq8` of the rank's block of codes, by the whole leaf's
        scales (each column by its 128-block's, where the scales are whole
        and the block starts inside one)."""
        if s.ndim == 0 or not self.last or SH.live(self.s_spec, self.mesh)[-1]:
            return _dq8(q, s, q)
        w = q.shape[-1]
        c0 = self.mesh.group(self.last).index * w
        cols = torch.div(torch.arange(c0, c0 + w, device=q.device), BLOCK, rounding_mode="floor")
        return q.to(torch.float32) * s[..., cols]


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
    def init(self, params: Any, specs: Any = None, mesh=None) -> AdamWState:
        """Zero moments in the params' tree, on each leaf's device; on a
        mesh (``specs`` the params' spec tree) the rank's blocks, the int8
        moments' scales placed as ``train_step.opt_state_shardings``
        places them."""
        def zero(x, spec=None):
            z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            if not self.quantized_state:
                return z
            q, s = _q8(z)
            if spec is not None:
                s = torch.full(_Place(x, spec, mesh).scale_shape(), _ZERO_SCALE,
                               dtype=torch.float32, device=x.device)
            return {"q": q, "s": s}

        first = tree_leaves(params)[0]
        if specs is None:
            m, v = tree_map(params, zero), tree_map(params, zero)
        else:
            m, v = (_zip_map(params, specs, zero) for _ in range(2))
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=first.device),
                          m=m, v=v)

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warm-up then cosine decay, in f32 on ``step``'s device."""
        step = step.to(torch.float32)
        warm = torch.clamp_max(_div(step + 1, max(1, self.warmup_steps)), 1.0)
        prog = torch.clamp(_div(step - self.warmup_steps,
                                max(1, self.total_steps - self.warmup_steps)), 0.0, 1.0)
        return self.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))

    def update(self, grads: Any, state: AdamWState, params: Any, cfg=None, mesh=None,
               specs: Any = None) -> tuple[Any, AdamWState, torch.Tensor]:
        """One step: global-norm clip, then AdamW on every leaf -> (params,
        state, the gradient's global norm before the clip).  ``params`` and
        the moments are updated in place (see the module's docstring).
        ``cfg`` is the model's configuration, needed for a tree with
        per-layer ``layers`` (which layers the reference stacks).  On a
        mesh every tree holds the rank's blocks under ``specs`` (the
        params' spec tree; see the module's docstring)."""
        place = ({path: _Place(_get(params, path), _get(specs, path), mesh)
                  for path, _ in _paths(params)} if mesh is not None else None)
        gnorm = torch.sqrt(self._sq_norm(grads, place, mesh))
        scale = torch.clamp_max(_div(self.clip_norm, torch.clamp_min(gnorm, 1e-9)), 1.0)
        count = state.count + 1
        lr = self.schedule(state.count)
        b1c = 1 - self.b1 ** count.to(torch.float32)
        b2c = 1 - self.b2 ** count.to(torch.float32)
        for stack in _stacks(params, cfg):
            first = _get(params, stack[0])
            shape = place[stack[0]].shape if place else tuple(first.shape)
            shared = (self.quantized_state and len(stack) > 1
                      and _fallback((len(stack), *shape)))
            pending = []
            for path in stack:
                p, g = _get(params, path), _get(grads, path).to(torch.float32) * scale
                m, v = _get(state.m, path), _get(state.v, path)
                dq = place[path].dq8 if place else lambda q, s_: _dq8(q, s_, g)
                mf = dq(m["q"], m["s"]) if isinstance(m, dict) else m
                vf = dq(v["q"], v["s"]) if isinstance(v, dict) else v
                mf = self.b1 * mf + (1 - self.b1) * g
                vf = self.b2 * vf + (1 - self.b2) * g * g
                step_ = lr * (mf / b1c) / (torch.sqrt(vf / b2c) + self.eps)
                if _ref_ndim(path, p) >= 2:          # no decay on ln_f / biases
                    step_ = step_ + lr * self.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - step_).to(p.dtype))
                if shared:                           # quantized once the stack is done
                    pending.append((m, v, mf, vf))
                elif self.quantized_state:
                    q8 = place[path].q8 if place else _q8
                    _store(m, q8(mf))
                    _store(v, q8(vf))
                else:
                    m.copy_(mf)
                    v.copy_(vf)
            if pending:
                amax = place[stack[0]].amax if place else None
                for (m, v, _, _), qm, qv in zip(pending,
                                                _q8_stack([x[2] for x in pending], amax),
                                                _q8_stack([x[3] for x in pending], amax)):
                    _store(m, qm)
                    _store(v, qv)
        return params, AdamWState(count=count, m=state.m, v=state.v), gnorm

    @staticmethod
    def _sq_norm(grads: Any, place: dict | None, mesh) -> torch.Tensor:
        """The squared global norm: on a mesh each leaf's block's squares
        are summed over the axes that split it (one all-reduce for each set
        of axes, in the mesh's order)."""
        if place is None:
            return sum(torch.sum(torch.square(g.to(torch.float32))) for _, g in _paths(grads))
        by_axes: dict[tuple, torch.Tensor] = {}
        for path, g in _paths(grads):
            axes = place[path].axes
            sq = torch.sum(torch.square(g.to(torch.float32)))
            by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
        order = sorted(by_axes, key=lambda a: [mesh.axis_names.index(x) for x in a])
        return sum(C.all_reduce(by_axes[a], mesh.group(a)) if a else by_axes[a] for a in order)


def _zip_map(tree: Any, specs: Any, fn) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(v, sp, fn) for v, sp in zip(tree, specs))
    return fn(tree, specs)


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
