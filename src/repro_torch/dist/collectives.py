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
since :func:`reset_stats`, and apart the bytes of the serving lanes' row
moves (``move_bytes``: :func:`broadcast`, :func:`send`, :func:`recv`).
"""
from __future__ import annotations

import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.core.htree import tree_depth
from repro_torch.launch.mesh import AxisGroup

COLLECTIVES = ("psum", "htree")
stats = {"calls": 0, "bytes": 0, "seconds": 0.0, "htree_rounds": 0, "move_bytes": 0}
_pinned: dict[tuple, torch.Tensor] = {}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0.0 if k == "seconds" else 0


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
    def __init__(self, t: torch.Tensor, n_bytes: int | None = None, move: bool = False):
        self.n = t.numel() * t.element_size() if n_bytes is None else n_bytes
        self.move = move

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        stats["calls"] += 1
        stats["bytes"] += self.n
        stats["move_bytes"] += self.n if self.move else 0
        stats["seconds"] += time.perf_counter() - self.t0


def all_reduce(x: torch.Tensor, group: AxisGroup, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``group`` -> a new tensor
    on ``x``'s device; a group of one returns ``x``."""
    if group.size == 1:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _Timed(x):
        h = _host(x)
        dist.all_reduce(h, op=red, group=group.pg)
        return _back(h, x)


def all_gather(x: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in the group's
    rank order (a tiled all-gather); a group of one returns ``x``."""
    if group.size == 1:
        return x
    with _Timed(x, x.numel() * x.element_size() * group.size):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(group.size)]
        dist.all_gather(parts, h, group=group.pg)
        return _back(torch.cat(parts, dim=dim), x)


def htree_allreduce(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """All-reduce-sum ``x`` over ``group`` through a binary reduction tree:
    ``tree_depth(n)`` up-sweep rounds (at level r, group member ``i + 2^r``
    sends its partial sum to ``i``, which adds it) and as many down-sweep
    rounds (``i`` sends the total to ``i + 2^r``, which takes it).  Any
    size works: a ragged last level pairs fewer members.  Integer sums are
    exact, so they equal :func:`all_reduce`'s bits; float sums are equal up
    to the association."""
    n = group.size
    if n == 1:
        return x
    i = group.index
    depth = tree_depth(n)
    with _Timed(x):
        h = _host(x)
        buf = torch.empty_like(h)
        for r in range(depth):                       # up-sweep
            span = 1 << r
            if n <= span:
                continue
            stats["htree_rounds"] += 1
            if i % (2 * span) == 0 and i + span < n:
                dist.recv(buf, group.ranks[i + span], group=group.pg)
                h += buf
            elif i % (2 * span) == span:
                dist.send(h, group.ranks[i - span], group=group.pg)
        for r in reversed(range(depth)):             # down-sweep
            span = 1 << r
            if n <= span:
                continue
            stats["htree_rounds"] += 1
            if i % (2 * span) == 0 and i + span < n:
                dist.send(h, group.ranks[i + span], group=group.pg)
            elif i % (2 * span) == span:
                dist.recv(h, group.ranks[i - span], group=group.pg)
        return _back(h, x)


def allreduce(x: torch.Tensor, group: AxisGroup, collective: str = "psum") -> torch.Tensor:
    """The sum of ``x`` over ``group`` by ``collective``: ``"psum"`` (one
    gloo all-reduce) or ``"htree"`` (:func:`htree_allreduce`)."""
    if collective == "htree":
        return htree_allreduce(x, group)
    if collective == "psum":
        return all_reduce(x, group)
    raise ValueError(f"unknown collective {collective!r}; want psum|htree")


def broadcast(x: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """Member ``src`` (an index into ``group.ranks``) sends ``x`` to every
    member of ``group`` -> a new tensor on ``x``'s device, ``src``'s values
    (every member passes a tensor of the same shape and dtype); a group of
    one returns ``x``."""
    if group.size == 1:
        return x
    with _Timed(x, move=True):
        h = _host(x)
        dist.broadcast(h, group.ranks[src], group=group.pg)
        return _back(h, x)


def send(x: torch.Tensor, group: AxisGroup, dst: int) -> None:
    """Send ``x`` to member ``dst`` of ``group`` (blocking; the member
    takes it with :func:`recv`)."""
    with _Timed(x, move=True):
        dist.send(_host(x), group.ranks[dst], group=group.pg)


def recv(like: torch.Tensor, group: AxisGroup, src: int) -> torch.Tensor:
    """The tensor member ``src`` of ``group`` sends (:func:`send`), of
    ``like``'s shape and dtype, on ``like``'s device."""
    with _Timed(like, move=True):
        h = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(h, group.ranks[src], group=group.pg)
        return _back(h, like)


def broadcast_object(obj, group: AxisGroup, src: int = 0):
    """Member ``src`` of ``group`` sends a picklable ``obj`` to every
    member; each returns ``src``'s object (``broadcast_object_list``: the
    pickle's length, then its bytes)."""
    if group.size == 1:
        return obj
    objs = [obj if group.index == src else None]
    t0 = time.perf_counter()
    dist.broadcast_object_list(objs, group.ranks[src], group=group.pg)
    stats["calls"] += 2
    stats["bytes"] += 8 + len(pickle.dumps(objs[0]))
    stats["seconds"] += time.perf_counter() - t0
    return objs[0]
