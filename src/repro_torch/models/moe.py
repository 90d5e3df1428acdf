"""Mixture-of-Experts FFN: top-k routing with per-expert capacity (a
dropping MoE), the experts' SwiGLU / relu2 / gelu FFNs, and the combine.

PyTorch counterpart of ``repro.models.moe``.  The router is a float
"controller op"; the expert weights are static, flash-resident stacks.
Float experts run a batched float product; quantized experts (weight-only
int8 from ``serve/quantize.py``) take per-row int8 activations through the
grouped B1 kernel (``kernels/int8_matmul.py``, one launch for every expert)
on CUDA tensors, or its plain version on CPU tensors: the integers and the
epilogue of the reference's ``_int8_expert_mm``.

Routing is the reference's, row for row.  A call routes its ``N`` rows
(``[B, T]`` flattened b-major) into ``N * k`` (token, choice) slots; expert
e keeps at most ``cap = ceil(N * k / E * CAPACITY_FACTOR)`` of them, the
earliest in slot order, and drops the rest (their weight is lost; nothing
renormalises).  The reference sorts the slots by expert with a stable
``argsort``; here a slot's rank is the count of earlier slots that chose
the same expert (a cumulative sum over one-hot choices), which gives the
same kept set in the same rows, with no sort, no host sync and no shape
that depends on the data, so a decode or verify step that routes can be
captured as a CUDA graph.  So whether a row reaches an expert depends on
the other rows of the same call, idle decode slots included.

The combine adds a token's kept expert rows in one fixed order, the order
in which the reference's scatter-add visits them (its ``[E, cap]`` buffer
flattened: ascending expert), each from a zero row: the same code on the
CPU and on the card, with no atomics, so a token's sum is the same bits
whatever its k (top-8 as top-2).

Expert parallelism (a mesh, ``launch/mesh.py``): a rank holds a window of
the experts (``e_first``, ``n_local``: ``ep``) or every expert's block of
the FFN dim (``etp``), routes every row of the call with the replicated
router (so every rank keeps the same set, under the call's capacity), runs
its window and adds its rows in the same ascending order; the ranks'
partial outputs are then summed by the combine collective, whose float
order differs from one device's (within the reference's rtol 2e-3 / atol
2e-4).  ``transformer._moe_block`` picks the layout (``dist/sharding.py``
``moe_param_specs``); in training a call's rows are a data shard's, and
its load-balance loss is theirs.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.kernels import int8_matmul_grouped as grouped_ops
from repro_torch.models import layers as L

Params = dict[str, Any]
CAPACITY_FACTOR = 2.0

# optional int64 [3] tensor that every moe_local call adds to (see
# count_routing)
_counter: torch.Tensor | None = None


def count_routing(counter: torch.Tensor | None) -> None:
    """From now on every :func:`moe_local` call on ``counter``'s device (an
    int64 [3] tensor) adds, in place, 1 to ``counter[0]``, the choices that
    capacity dropped to ``counter[1]`` and the experts that got a row to
    ``counter[2]``; ``None`` stops it.  A step captured as a CUDA graph
    while counting keeps adding to ``counter`` on every replay."""
    global _counter
    _counter = counter


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32) -> Params:
    """Random router and expert stacks (``router`` [d, E] f32, ``w_up`` /
    ``w_gate`` [E, d, ff], ``w_down`` [E, ff, d]) from ``gen``, scaled as the
    reference scales them, and a shared expert where the configuration has
    one."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dev = gen.device

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=dt, device=dev).mul_(scale)
    scale = 1.0 / math.sqrt(d)
    p = {"router": normal((d, E), scale, torch.float32),
         "w_up": normal((E, d, ff), scale),
         "w_down": normal((E, ff, d), 1.0 / math.sqrt(ff))}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = normal((E, d, ff), scale)
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts,
                                 cfg.mlp_type, dtype)
    return p


def _capacity(n_slots: int, n_experts: int) -> int:
    return max(1, math.ceil(n_slots / n_experts * CAPACITY_FACTOR))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row in descending order and their indices,
    a tie to the lower index (as ``jax.lax.top_k``): ``k`` rounds of
    ``torch.argmax``, which returns the first maximum (``torch.topk``
    promises no order among equal values)."""
    rest, vals, idx = probs, [], []
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def _expert_mm(x: torch.Tensor, p: Params, nm: str, counts: torch.Tensor) -> torch.Tensor:
    """[E, C, d] by expert stack ``nm`` -> [E, C, f].  Quantized: per-row
    int8 activations, int32 sums, ``(float(acc) * x_s) * w_s`` (grouped B1,
    expert e's rows at or past ``counts[e]`` zero, as the zero rows the
    reference multiplies give); float: the batched float product."""
    if nm + "_q" in p:
        x_q, x_s = quant.quantize_activation(x)
        return grouped_ops.int8_matmul_grouped(x_q, x_s, p[nm + "_q"], p[nm + "_s"],
                                          counts).to(x.dtype)
    return torch.bmm(x, p[nm].to(x.dtype))


def _expert_ffn(xe: torch.Tensor, p: Params, cfg: ModelConfig,
                counts: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d] through the expert stack."""
    up = _expert_mm(xe, p, "w_up", counts)
    if cfg.mlp_type == "swiglu":
        h = F.silu(_expert_mm(xe, p, "w_gate", counts)) * up
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(up))
    else:   # gelu (jax.nn.gelu's default is the tanh approximation)
        h = F.gelu(up, approximate="tanh")
    return _expert_mm(h, p, "w_down", counts)


class Routing(NamedTuple):
    """Where a call's routed choices go: expert e's buffer row r (of
    ``cap``) holds token ``toks[e, r]`` with weight ``ws[e, r]`` for
    ``r < counts[e]``; the rest of the rows are empty (token 0, weight 0)."""
    toks: torch.Tensor        # [E, cap] int64
    ws: torch.Tensor          # [E, cap] f32
    counts: torch.Tensor      # [E] int32
    order: torch.Tensor       # [N, k] int64: each token's buffer rows, ascending
    dropped: torch.Tensor     # 0-d int64: choices past an expert's capacity
    probs: torch.Tensor       # [N, E] f32: the router's softmax
    topi: torch.Tensor        # [N, k] int64: each token's experts, best first


def route(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Route ``x`` [N, d] over the ``E`` experts: top-k of the router's
    softmax (ties to the lower expert), weights renormalised over the k;
    slot ``n * k + j`` is token n's j-th choice; expert e's row r holds the
    r-th slot, in slot order, that chose e, and a slot of rank ``cap`` or
    more is dropped.  ``order[n]`` lists token n's buffer rows
    (``e * cap + r``) in ascending order, its dropped choices last as the
    spare row ``E * cap``."""
    N, _ = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    dev = x.device
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)   # controller op
    topw, topi = _top_k(probs, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    slot_e, slot_w = topi.reshape(-1), topw.reshape(-1)
    slot_tok = torch.arange(N * k, device=dev) // k
    hot = (slot_e[:, None] == torch.arange(E, device=dev)).to(torch.int64)
    rank = (torch.cumsum(hot, 0) - hot).gather(1, slot_e[:, None])[:, 0]
    cap = _capacity(N * k, E)
    kept = rank < cap
    # kept slot -> row slot_e * cap + rank; a dropped slot -> a spare last row
    rows = E * cap
    dest = torch.where(kept, slot_e * cap + rank, rows)
    toks = torch.zeros((rows + 1,), dtype=torch.int64, device=dev).scatter_(
        0, dest, slot_tok)[:rows].view(E, cap)
    ws = torch.zeros((rows + 1,), dtype=slot_w.dtype, device=dev).scatter_(
        0, dest, slot_w)[:rows].view(E, cap)
    counts = torch.clamp(hot.sum(0), max=cap).to(torch.int32)
    # a token's k rows in ascending order (its experts differ, so its kept
    # rows do; dropped ones tie at the spare row and keep choice order):
    # each row's place is the count of the token's rows that sort before it
    d = dest.view(N, k)
    j = torch.arange(k, device=dev)
    before = (d[:, None, :] < d[:, :, None]) | ((d[:, None, :] == d[:, :, None])
                                                & (j[None, :] < j[:, None]))
    order = torch.empty_like(d).scatter_(1, before.sum(-1), d)
    return Routing(toks, ws, counts, order, (~kept).sum(), probs, topi)


def combine(ye: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Each token's weighted expert rows (``ye`` [E, cap, d]) summed left to
    right from a zero row in the order of ``order`` [N, k] (the spare row
    ``E * cap`` adds an exact zero) -> [N, d]: the order the reference's
    scatter-add visits them, with no atomics and no shape that depends on
    the data."""
    rows = torch.cat([ye.reshape(-1, ye.shape[-1]), ye.new_zeros((1, ye.shape[-1]))])
    out = torch.zeros((order.shape[0], ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for i in range(order.shape[1]):
        out = out + rows[order[:, i]]
    return out


def moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              with_aux: bool = False, e_first: int = 0, n_local: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """MoE over ``x`` [N, d], routed by :func:`route`.  Returns
    ``(out [N, d], aux)``: ``aux`` is the Switch-style load-balance loss
    where ``with_aux`` asks for it (serving discards it, as the reference's
    serve paths do), else None.  Each expert's output row is scaled by its
    slot's weight, and a token's rows are summed by :func:`combine` in
    ascending expert order.

    On a mesh ``p`` holds the rank's expert stacks, experts ``[e_first,
    e_first + n_local)`` of the global ``E`` (``n_local`` None: all of
    them, or all with a block of the FFN dim): routing is global, only the
    window's rows run, and ``out`` is the rank's partial sum (the other
    experts' rows add exact zeros), which the caller sums over the ranks
    (a caller on a mesh passes no shared expert and runs it itself,
    ``transformer._moe_block``)."""
    N, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    n_local = E if n_local is None else int(n_local)
    r = route(p, x, cfg)
    if _counter is not None and _counter.device == x.device:
        _counter.add_(torch.stack([torch.ones_like(r.dropped), r.dropped,
                                   (r.counts > 0).sum()]))
    aux = None
    if with_aux:
        ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
            0, r.topi.reshape(-1), torch.ones((N * k,), dtype=torch.float32,
                                              device=x.device))
        aux = E * torch.sum(r.probs.mean(dim=0) * (ce / (N * k)))
    if n_local != E:
        return _moe_window(p, x, cfg, r, int(e_first), n_local), aux
    valid = torch.arange(r.toks.shape[1], device=x.device)[None, :] < r.counts[:, None]
    xe = x[r.toks] * valid[..., None].to(x.dtype)                    # gather
    ye = _expert_ffn(xe, p, cfg, r.counts)
    ye = ye * r.ws[..., None].to(ye.dtype)
    return _add_shared(combine(ye, r.order), p, x, cfg), aux


def _add_shared(out: torch.Tensor, p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """``out`` plus the shared expert's output where the configuration has
    one."""
    if not (cfg.n_shared_experts and "shared" in p):
        return out
    return out + L.apply_mlp(p["shared"], x, cfg.mlp_type)


def _moe_window(p: Params, x: torch.Tensor, cfg: ModelConfig, r: Routing,
                e_first: int, n_local: int) -> torch.Tensor:
    """:func:`moe_local`'s rank part for the expert window ``[e_first,
    e_first + n_local)``: the window's buffer rows through the rank's
    stacks, each token's window rows added in ascending order (rows of
    other experts point at the spare zero row)."""
    cap = r.toks.shape[1]
    win = slice(e_first, e_first + n_local)
    toks, ws, counts = r.toks[win], r.ws[win], r.counts[win]
    valid = torch.arange(cap, device=x.device)[None, :] < counts[:, None]
    xe = x[toks] * valid[..., None].to(x.dtype)
    ye = _expert_ffn(xe, p, cfg, counts) * ws[..., None].to(x.dtype)
    lo, hi = e_first * cap, (e_first + n_local) * cap
    local = (r.order >= lo) & (r.order < hi)
    order = torch.where(local, r.order - lo, n_local * cap)
    return _add_shared(combine(ye, order), p, x, cfg)


def ep_capable(cfg: ModelConfig, axis_size: int) -> bool:
    return cfg.n_experts % axis_size == 0 and cfg.n_experts >= axis_size


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, axis_name: str | None = None,
              with_aux: bool = False, mesh=None, reduce_fn=None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """MoE over ``x`` [B, T, d]: its ``B * T`` rows routed together, b-major,
    as the reference's call routes them.  Returns ``(out [B, T, d], aux)``
    (see :func:`moe_local`).  With ``axis_name`` (an axis of ``mesh``, a
    ``launch.mesh.Mesh``) ``p`` holds the rank's experts: a window of
    ``E / size`` where the axis tiles the experts (``ep``), else every
    expert's block of the FFN dim (``etp``), and the partial outputs are
    summed over the axis by ``reduce_fn`` (default: the gloo all-reduce;
    it takes the partial output as [B, T, d]).  ``with_aux`` on a mesh
    gives the load-balance loss of the call's rows, the same on every rank
    of the axis (the router is replicated; the reference's ``pmean`` over
    the axis leaves it as it is)."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    if axis_name is None:
        out, aux = moe_local(p, xf, cfg, with_aux=with_aux)
        return out.reshape(B, T, d).to(x.dtype), aux
    if mesh is None:
        raise ValueError(f"moe_apply over axis {axis_name!r} needs the mesh it names")
    from repro_torch.dist import collectives as C
    group = mesh.group(axis_name)
    if ep_capable(cfg, group.size):
        n_local = cfg.n_experts // group.size
        out, aux = moe_local(p, xf, cfg, with_aux=with_aux, e_first=group.index * n_local,
                             n_local=n_local)
    else:   # etp: all experts local, FFN dim sliced
        out, aux = moe_local(p, xf, cfg, with_aux=with_aux)
    out = out.reshape(B, T, d)
    out = reduce_fn(out) if reduce_fn is not None else C.all_reduce(out, group)
    return out.to(x.dtype), aux
