"""QLC-SLC hybrid KV cache (Sec. IV-A, Fig. 10d) with slotted residency.

PyTorch counterpart of ``repro.core.kvcache``.  The KV cache lives in the
fast-append "SLC region": int8 entries with per-(token, head) scales,
appended in place every generated token.  The batch axis is a pool of
*slots*, each at its own sequence position.

Unlike JAX's functional ``dynamic_update_slice``, the appends here write the
buffer **in place** (the pool never copies per token) and return it.  XLA
clamps an update's start index to ``[0, S - T]``; torch indexing does not,
so every writer clamps explicitly to keep the reference's semantics.

Layouts (per layer):
  k_q, v_q : [B, S_max, H_kv, D_h]  int8
  k_s, v_s : [B, S_max, H_kv, 1]    f32
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def slot_positions(pos: Any, batch: int,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Normalise a scalar or [B] position argument to a [B] int32 vector
    (on ``pos``'s device when it is a tensor, else on ``device``)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(torch.int32)
    else:
        pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(batch)


def batched_update(buf: torch.Tensor, new: torch.Tensor,
                   pos: Any) -> torch.Tensor:
    """Write ``new[b]`` into ``buf[b]`` at sequence offset ``pos[b]``, in
    place.  buf: [B, S, ...]; new: [B, T, ...]; pos: [B] (or scalar).  The
    start is clamped to ``[0, S - T]`` as XLA's ``dynamic_update_slice``
    clamps it."""
    B, S = buf.shape[:2]
    T = new.shape[1]
    if T > S:
        raise ValueError(f"update of {T} rows does not fit {S} cache rows")
    start = torch.clamp(slot_positions(pos, B, buf.device).to(buf.device),
                        0, S - T)
    rows = start[:, None].long() + torch.arange(T, device=buf.device)
    buf[torch.arange(B, device=buf.device)[:, None], rows] = new.to(buf.dtype)
    return buf


def chunk_update(buf: torch.Tensor, new: torch.Tensor, start: int
                 ) -> torch.Tensor:
    """Write a ``[B, C, ...]`` chunk into ``buf`` (``[B, S, ...]``) at the
    shared offset ``start`` (clamped to ``[0, S - C]``), in place."""
    S, C = buf.shape[1], new.shape[1]
    if C > S:
        raise ValueError(f"update of {C} rows does not fit {S} cache rows")
    s = min(max(int(start), 0), S - C)
    buf[:, s:s + C] = new.to(buf.dtype)
    return buf


def pool_headroom(spec_k: int = 0, spec_tree: int = 0,
                  multi_step: int = 1) -> int:
    """Scratch rows each slot needs past ``max_len``, the one sizing rule
    for every lane that writes ahead of the committed cursor: a linear
    verify window appends ``spec_k + 1`` rows at ``pos .. pos + spec_k``
    with ``pos <= max_len - 1`` (``spec_k`` rows of headroom), a tree
    window ``spec_tree + 1`` node rows (``spec_tree``), a fused multi-step
    block up to ``m`` rows (``m - 1``).  The lanes are exclusive per step,
    so the pool needs the max; rows beyond ``max_len + headroom`` would
    clamp onto live rows of the window itself."""
    if min(spec_k, spec_tree, multi_step - 1) < 0:
        raise ValueError("negative spec_k/spec_tree or multi_step < 1")
    return max(spec_k, spec_tree, multi_step - 1)


def path_gather(buf: torch.Tensor, base: Any, sel: Any, keep: Any
                ) -> torch.Tensor:
    """Compact an accepted tree path's scattered rows into contiguous rows,
    in place, and return ``buf``.

    buf: [B, S, ...] (one layer's leaf); base: [B] committed cursors; sel:
    [B, W] in-window node indices of the accepted root-path in order
    (``sel[b, w] >= w + 1``: nodes are topologically ordered, so a path
    only moves rows down); keep: [B] accepted path length (<= W).  Row
    ``base[b] + sel[b, w]`` moves to ``base[b] + 1 + w`` for ``w <
    keep[b]``; every other row stays as it was.  All source rows are
    gathered before any is written, since a write could otherwise land on
    a source still to be read.  The destination window starts at
    ``base + 1`` clamped to ``[0, S - W]``, as the reference's
    ``dynamic_update_slice`` clamps it."""
    B, S = buf.shape[:2]
    W = sel.shape[1]
    if W == 0:
        return buf
    dev = buf.device
    base = slot_positions(base, B, dev).to(dev).long()
    sel = torch.as_tensor(sel, device=dev).long()
    keep = torch.as_tensor(keep, device=dev).reshape(-1).long()
    w = torch.arange(W, device=dev)
    slots = torch.arange(B, device=dev)[:, None]
    rows = buf[slots, base[:, None] + sel]                          # gather ...
    dst = torch.clamp(base + 1, 0, S - W)[:, None] + w
    m = (w[None, :] < keep[:, None]).reshape((B, W) + (1,) * (buf.ndim - 2))
    buf[slots, dst] = torch.where(m, rows, buf[slots, dst])         # ... then write
    return buf


@dataclasses.dataclass
class KVCache:
    k_q: torch.Tensor            # [L, B, S, H_kv, D] int8
    k_s: torch.Tensor            # [L, B, S, H_kv, 1] f32
    v_q: torch.Tensor
    v_s: torch.Tensor
    lengths: torch.Tensor        # [B] int32 — tokens cached per slot

    @property
    def n_slots(self) -> int:
        return self.k_q.shape[1]

    @property
    def max_len(self) -> int:
        return self.k_q.shape[2]


def init_cache(n_layers: int, n_slots: int, max_len: int, n_kv_heads: int,
               head_dim: int, device: str | torch.device = "cuda") -> KVCache:
    from repro_torch.device import resolve
    dev = resolve(device)
    shape = (n_layers, n_slots, max_len, n_kv_heads, head_dim)
    sshape = (n_layers, n_slots, max_len, n_kv_heads, 1)
    return KVCache(
        k_q=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_s=torch.zeros(sshape, dtype=torch.float32, device=dev),
        v_q=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_s=torch.zeros(sshape, dtype=torch.float32, device=dev),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    )


def cache_bytes(tree: Any) -> int:
    """Bytes held by every tensor in a nested dict / list / tuple / KVCache."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return 0
