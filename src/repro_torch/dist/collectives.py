"""Collectives over a mesh's process groups: the H-tree all-reduce, the
``allreduce`` hook that ``Runtime.collective`` selects, and the moves the
serving lanes make on a mesh (:func:`broadcast` of a row over the data
axes, :func:`send` / :func:`recv` of a block between two ranks of one
group, :func:`broadcast_object` of the leader's control messages).

PyTorch counterpart of ``repro.dist.collectives``.  The paper's
re-architected die replaces the shared output bus with a binary H-tree
whose internal RPUs add partial sums pairwise on the way to the root
(``core/htree.py``).  :func:`htree_allreduce` renders the reference's
pairwise ``ppermute`` rounds as ``send`` / ``recv`` between the same pairs:
each up-sweep round is one tree level (the receiver adds), the down-sweep
copies the root's total back out, ``core.htree.tree_depth(n)`` rounds each
way, the number the analytical model charges.

Every call goes through gloo on host memory: a CUDA tensor is copied into a
pinned host buffer, reduced there and copied back, so nothing depends on
gloo's partial support for CUDA tensors and ranks may share one card.  A
failed collective raises; nothing falls back.  :data:`stats` counts, per
process, the calls, payload bytes and seconds spent (host copies included)
since :func:`reset_stats`, apart the bytes of the serving lanes' row
moves (``move_bytes``: :func:`broadcast`, :func:`send`, :func:`recv`), and
the bytes of each call's result on the rank by kind (:data:`KINDS`, the
reference dry run's HLO names; :func:`kind_bytes`).

**Training.**  :func:`all_reduce` (sum), :func:`allreduce`,
:func:`htree_allreduce`, :func:`all_gather` and :func:`reduce_scatter`
are differentiable where their input records a gradient: each forward is
paired with its adjoint in the backward (sum <-> sum, all-gather <->
reduce-scatter, reduce-scatter <-> all-gather), counted in :data:`stats`
both ways.  With adjoint pairs the gradient every rank's backward gives is
that of the sum of the ranks' losses, so a loss that several ranks
compute alike (every rank of the model axis holds the same rows) enters
each at its share (``transformer.lm_loss``), and a leaf held on several
ranks gets the sum of their partial gradients (``train_step``
``reduce_grads``).  This is Megatron's pair, the row-parallel sum with an
identity backward and the column-parallel input's identity with a sum
backward, with the sum moved from the column input's backward to the row
sum's: one all-reduce a block each way in both.  A max carries no
gradient.  The serving paths record none, so they take the plain calls.
:func:`reduce_scatter` is an all-reduce and a slice of it on every torch
(gloo's reduce-scatter is missing from some releases): the bytes it
moves are the all-reduce's.

**Counting.**  A group of a ``launch.mesh.CountingMesh`` (``counting``)
has no process group: a collective over it takes ``meta`` tensors only,
returns the shape the real call would, and adds the bytes the real call
would add (a real tensor raises).  The dry run counts a production mesh's
rank so.
"""
from __future__ import annotations

import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.core.htree import tree_depth
from repro_torch.launch.mesh import AxisGroup

COLLECTIVES = ("psum", "htree")
# the bytes of each call's result on the rank, by kind (the reference dry
# run's HLO op names; send / recv and the H-tree's rounds are permutes)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute", "broadcast")
stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "htree_rounds": 0, "move_bytes": 0,
         **{k: 0 for k in KINDS}}
_pinned: dict[tuple, torch.Tensor] = {}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0.0 if k == "seconds" else 0


def kind_bytes(st: dict | None = None) -> dict:
    """The bytes by kind of ``st`` (default :data:`stats`) and their
    ``total``, the reference dry run's ``collectives`` record."""
    st = stats if st is None else st
    out = {k: int(st[k]) for k in KINDS if st[k]}
    out["total"] = sum(out.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _counted(kind: str, x: torch.Tensor, shape, n_bytes: int, kind_b: int,
             move: bool = False) -> torch.Tensor:
    """A counting group's call: ``x`` must be ``meta``; the real call's
    counts are added and a ``meta`` tensor of its result's ``shape``
    returned."""
    if x.device.type != "meta":
        raise ValueError("a counting mesh's collectives take meta tensors only "
                         f"(got one on {x.device}); it counts, it does not run a mesh")
    stats["calls"] += 1
    stats["bytes"] += n_bytes
    stats["move_bytes"] += n_bytes if move else 0
    stats[kind] += kind_b
    return torch.empty(tuple(shape), dtype=x.dtype, device="meta")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` for gloo: a pinned buffer reused for its shape
    and dtype where ``t`` is on the card, else a contiguous clone."""
    if not t.is_cuda:
        return t.detach().contiguous().clone()
    key = (tuple(t.shape), t.dtype)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h.to(like.device, copy=True) if like.is_cuda else h


class _Timed:
    def __init__(self, t: torch.Tensor, n_bytes: int | None = None, move: bool = False,
                 kind: str = "all-reduce", kind_b: int | None = None):
        self.n = _nbytes(t) if n_bytes is None else n_bytes
        self.move, self.kind = move, kind
        self.kind_b = self.n if kind_b is None else kind_b

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        stats["calls"] += 1
        stats["bytes"] += self.n
        stats["move_bytes"] += self.n if self.move else 0
        stats[self.kind] += self.kind_b
        stats["seconds"] += time.perf_counter() - self.t0


def _all_reduce(x: torch.Tensor, group: AxisGroup, op: str = "sum") -> torch.Tensor:
    if group.counting:
        return _counted("all-reduce", x, x.shape, _nbytes(x), _nbytes(x))
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _Timed(x):
        h = _host(x)
        dist.all_reduce(h, op=red, group=group.pg)
        return _back(h, x)


def _all_gather(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= group.size
    if group.counting:
        n = _nbytes(x) * group.size
        return _counted("all-gather", x, shape, n, n)
    with _Timed(x, _nbytes(x) * group.size, kind="all-gather"):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(group.size)]
        dist.all_gather(parts, h, group=group.pg)
        return _back(torch.cat(parts, dim=dim), x)


def _reduce_scatter(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"reduce-scatter of dim {n} over a group of {group.size}")
    w = n // group.size
    shape = list(x.shape)
    shape[dim] = w
    if group.counting:
        return _counted("reduce-scatter", x, shape, _nbytes(x), _nbytes(x) // group.size)
    with _Timed(x, kind="reduce-scatter", kind_b=_nbytes(x) // group.size):
        h = _host(x)
        dist.all_reduce(h, group=group.pg)
        return _back(h.narrow(dim, group.index * w, w).contiguous(), x)


def _htree_rounds(n: int, i: int):
    """The H-tree's rounds for member ``i`` of ``n``: ``("send" | "recv" |
    None, peer index, up-sweep)`` a round."""
    depth = tree_depth(n)
    for up, levels in ((True, range(depth)), (False, reversed(range(depth)))):
        for r in levels:
            span = 1 << r
            if n <= span:
                continue
            if i % (2 * span) == 0 and i + span < n:
                yield ("recv" if up else "send"), i + span, up
            elif i % (2 * span) == span:
                yield ("send" if up else "recv"), i - span, up
            else:
                yield None, None, up


def _htree(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    n, i = group.size, group.index
    moved = sum(_nbytes(x) for op, _, _ in _htree_rounds(n, i) if op)
    if group.counting:
        stats["htree_rounds"] += sum(1 for _ in _htree_rounds(n, i))
        return _counted("collective-permute", x, x.shape, _nbytes(x), moved)
    with _Timed(x, kind="collective-permute", kind_b=moved):
        h = _host(x)
        buf = torch.empty_like(h)
        for op, peer, up in _htree_rounds(n, i):
            stats["htree_rounds"] += 1
            if op == "send":
                dist.send(h, group.ranks[peer], group=group.pg)
            elif op == "recv" and up:            # the receiver adds
                dist.recv(buf, group.ranks[peer], group=group.pg)
                h += buf
            elif op == "recv":                   # the total comes back down
                dist.recv(h, group.ranks[peer], group=group.pg)
        return _back(h, x)


def _sum(x: torch.Tensor, group: AxisGroup, collective: str) -> torch.Tensor:
    if collective == "htree":
        return _htree(x, group)
    if collective == "psum":
        return _all_reduce(x, group)
    raise ValueError(f"unknown collective {collective!r}; want psum|htree")


class _Sum(torch.autograd.Function):
    """The sum over a group; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x, group, collective):
        ctx.group, ctx.collective = group, collective
        return _sum(x, group, collective)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group, ctx.collective), None, None


class _Gather(torch.autograd.Function):
    """The tiled all-gather; its adjoint is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """The reduce-scatter; its adjoint is the tiled all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def all_reduce(x: torch.Tensor, group: AxisGroup, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``group`` -> a new tensor
    on ``x``'s device; a group of one returns ``x``.  The sum is
    differentiable (its adjoint is itself); a max carries no gradient."""
    if group.size == 1:
        return x
    if op == "sum" and _tracked(x):
        return _Sum.apply(x, group, "psum")
    return _all_reduce(x.detach() if op == "max" else x, group, op)


def all_gather(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in the group's
    rank order (a tiled all-gather); a group of one returns ``x``.  Its
    adjoint is :func:`reduce_scatter`."""
    if group.size == 1:
        return x
    if _tracked(x):
        return _Gather.apply(x, group, _dim(x, dim))
    return _all_gather(x, group, _dim(x, dim))


def reduce_scatter(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this member's block of it along
    ``dim`` (an all-reduce, then the block); a group of one returns ``x``.
    Its adjoint is :func:`all_gather`."""
    if group.size == 1:
        return x
    if _tracked(x):
        return _Scatter.apply(x, group, _dim(x, dim))
    return _reduce_scatter(x, group, _dim(x, dim))


def htree_allreduce(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """All-reduce-sum ``x`` over ``group`` through a binary reduction tree:
    ``tree_depth(n)`` up-sweep rounds (at level r, group member ``i + 2^r``
    sends its partial sum to ``i``, which adds it) and as many down-sweep
    rounds (``i`` sends the total to ``i + 2^r``, which takes it).  Any
    size works: a ragged last level pairs fewer members.  Integer sums are
    exact, so they equal :func:`all_reduce`'s bits; float sums are equal up
    to the association.  Its adjoint is the same tree."""
    if group.size == 1:
        return x
    if _tracked(x):
        return _Sum.apply(x, group, "htree")
    return _htree(x, group)


def allreduce(x: torch.Tensor, group: AxisGroup, collective: str = "psum") -> torch.Tensor:
    """The sum of ``x`` over ``group`` by ``collective``: ``"psum"`` (one
    gloo all-reduce) or ``"htree"`` (:func:`htree_allreduce`)."""
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}; want psum|htree")
    if group.size == 1:
        return x
    if _tracked(x):
        return _Sum.apply(x, group, collective)
    return _sum(x, group, collective)


def broadcast(x: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """Member ``src`` (an index into ``group.ranks``) sends ``x`` to every
    member of ``group`` -> a new tensor on ``x``'s device, ``src``'s values
    (every member passes a tensor of the same shape and dtype); a group of
    one returns ``x``."""
    if group.size == 1:
        return x
    if group.counting:
        return _counted("broadcast", x, x.shape, _nbytes(x), _nbytes(x), move=True)
    with _Timed(x, move=True, kind="broadcast"):
        h = _host(x)
        dist.broadcast(h, group.ranks[src], group=group.pg)
        return _back(h, x)


def send(x: torch.Tensor, group: AxisGroup, dst: int) -> None:
    """Send ``x`` to member ``dst`` of ``group`` (blocking; the member
    takes it with :func:`recv`)."""
    if group.counting:
        _counted("collective-permute", x, x.shape, _nbytes(x), _nbytes(x), move=True)
        return
    with _Timed(x, move=True, kind="collective-permute"):
        dist.send(_host(x), group.ranks[dst], group=group.pg)


def recv(like: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """The tensor member ``src`` of ``group`` sends (:func:`send`), of
    ``like``'s shape and dtype, on ``like``'s device."""
    if group.counting:
        return _counted("collective-permute", like, like.shape, _nbytes(like), _nbytes(like),
                        move=True)
    with _Timed(like, move=True, kind="collective-permute"):
        h = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(h, group.ranks[src], group=group.pg)
        return _back(h, like)


def broadcast_object(obj, group: AxisGroup, src: int = 0):
    """Member ``src`` of ``group`` sends a picklable ``obj`` to every
    member; each returns ``src``'s object (``broadcast_object_list``: the
    pickle's length, then its bytes)."""
    if group.size == 1:
        return obj
    if group.counting:
        raise ValueError("a counting mesh sends no objects")
    objs = [obj if group.index == src else None]
    t0 = time.perf_counter()
    dist.broadcast_object_list(objs, group.ranks[src], group=group.pg)
    stats["calls"] += 2
    stats["bytes"] += 8 + len(pickle.dumps(objs[0]))
    stats["seconds"] += time.perf_counter() - t0
    return objs[0]
