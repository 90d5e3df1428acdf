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

The :class:`KVCache` dataclass API (``append_layer`` /
``append_layer_chunk`` / ``layer_view``, ``alloc_slot`` / ``free_slot`` /
``bump_length`` / ``rewind_lengths`` / ``copy_prefix`` / ``gather_path``)
and MLA's :class:`LatentCache` (``init_latent_cache``, ``append_latent``)
are the reference model of the slot discipline, stacked over layers as the
reference stacks them; the serve engine runs the same moves on its
per-layer pooled decode state.  Appends write in place and return the
cache they were given.  The host-side :class:`SlotLedger` (the prefix cache's
refcounts) and :class:`ColdStore` (the tiered pool's cold tier) live here
too, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import _scale, quantize_kv


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


def append_layer(cache: KVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                 pos: Any) -> KVCache:
    """Append one step's k/v ([B, T, H_kv, D_h] float) to layer ``layer`` at
    ``pos``, a scalar (every slot aligned, the single-batch paper setting)
    or a [B] vector of per-slot positions, quantized on the way in
    (:func:`repro_torch.core.quant.quantize_kv`), in place; returns the
    cache."""
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    for buf, new in ((cache.k_q, k_q), (cache.k_s, k_s), (cache.v_q, v_q), (cache.v_s, v_s)):
        batched_update(buf[layer], new, pos)
    return cache


def append_layer_chunk(cache: KVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
                       start: int) -> KVCache:
    """Chunked-prefill append of ``[B, C, H_kv, D_h]`` float k/v into layer
    ``layer`` at the shared offset ``start`` (clamped as
    :func:`chunk_update` clamps it), quantized on the way in as
    :func:`append_layer`, in place; returns the cache.  Chunks appended in
    order give the bits of one :func:`append_layer` of their rows: the
    quantizer is per (token, head)."""
    k_q, k_s = quantize_kv(k)
    v_q, v_s = quantize_kv(v)
    for buf, new in ((cache.k_q, k_q), (cache.k_s, k_s), (cache.v_q, v_q), (cache.v_s, v_s)):
        chunk_update(buf[layer], new, start)
    return cache


def layer_view(cache: KVCache, layer: int) -> tuple[torch.Tensor, ...]:
    """Layer ``layer``'s ``(k_q, k_s, v_q, v_s)``, views into the cache."""
    return (cache.k_q[layer], cache.k_s[layer], cache.v_q[layer], cache.v_s[layer])


def bump_length(cache: KVCache, n: Any = 1) -> KVCache:
    """Advance per-slot lengths; ``n`` may be a scalar or a [B] mask/step."""
    return dataclasses.replace(cache, lengths=cache.lengths + torch.as_tensor(
        n, dtype=torch.int32, device=cache.lengths.device))


def rewind_lengths(cache: KVCache, lengths: Any) -> KVCache:
    """Speculative-decode rollback: set each slot's length to its committed
    prefix ([B] int32).  The rejected rows past the new length are not
    erased: the attention mask hides them and the next append overwrites
    them (the SLC write-in-place discipline that makes rollback a free
    cursor move)."""
    return dataclasses.replace(cache, lengths=torch.as_tensor(
        lengths, dtype=torch.int32, device=cache.lengths.device).reshape(-1).clone())


def alloc_slot(cache: KVCache, slot: int, length: int) -> KVCache:
    """Claim ``slot`` for a request whose prompt occupies ``length`` tokens."""
    lengths = cache.lengths.clone()
    lengths[int(slot)] = int(length)
    return dataclasses.replace(cache, lengths=lengths)


def free_slot(cache: KVCache, slot: int) -> KVCache:
    """Retire a slot: its length drops to 0 and the stale int8 rows are
    overwritten by the next resident (no erase cycle)."""
    return alloc_slot(cache, slot, 0)


def copy_prefix(cache: KVCache, src: int, dst: int, n: int) -> KVCache:
    """Row-range copy between slots, in place: ``dst``'s first ``n`` sequence
    rows of every leaf become ``src``'s (int8 payload and scales verbatim)
    and ``dst``'s length becomes ``n``, the prefix-cache admission gather.
    Rows at or past ``n`` in ``dst`` stay the dead entries they were."""
    rows = min(max(int(n), 0), cache.max_len)
    for buf in (cache.k_q, cache.k_s, cache.v_q, cache.v_s):
        buf[:, int(dst), :rows] = buf[:, int(src), :rows]
    return alloc_slot(cache, dst, n)


def gather_path(cache: KVCache, base: Any, sel: Any, keep: Any) -> KVCache:
    """Accepted-path compaction on the reference cache: :func:`path_gather`
    on every layer of every leaf (in place), and each slot's length becomes
    ``base + 1 + keep`` (root row plus accepted path), the tree-spec sibling
    of :func:`rewind_lengths`."""
    for buf in (cache.k_q, cache.k_s, cache.v_q, cache.v_s):
        for layer in buf:
            path_gather(layer, base, sel, keep)
    dev = cache.lengths.device
    lengths = (torch.as_tensor(base, dtype=torch.int32, device=dev).reshape(-1) + 1
               + torch.as_tensor(keep, dtype=torch.int32, device=dev).reshape(-1))
    return dataclasses.replace(cache, lengths=lengths)


class SlotLedger:
    """Host-side refcounts over pool slots for the prefix cache.

    A slot row can be held by a trie leaf (the cached prefix claims rows
    ``[0:n)``) and, while a request aliases that leaf, by an active writer:
    one hold each, counted here.  The slot returns to the scheduler's free
    heap exactly when its count drops to zero; releasing a hold that was
    never taken raises (a slot freed twice would be handed to two residents
    at once and the second would corrupt the first's KV rows).
    """

    def __init__(self) -> None:
        self._counts: dict[int, int] = {}

    def count(self, slot: int) -> int:
        return self._counts.get(slot, 0)

    def incref(self, slot: int) -> int:
        c = self._counts.get(slot, 0) + 1
        self._counts[slot] = c
        return c

    def decref(self, slot: int) -> int:
        c = self._counts.get(slot, 0)
        if c <= 0:
            raise RuntimeError(
                f"slot {slot}: release without a matching hold (double free)")
        c -= 1
        if c:
            self._counts[slot] = c
        else:
            del self._counts[slot]
        return c

    def held(self) -> set[int]:
        return set(self._counts)


class ColdStore:
    """Cold tier of the two-tier KV pool: evicted or preempted slot rows as
    quantized host-side blocks (the flash/SLC-resident side of the paper's
    hybrid; the hot tier is the int8 device pool).

    Blocks are keyed host trees (numpy, already truncated to their live rows
    by the swap layer) with LRU order and a row budget.  ``pinned`` blocks,
    swapped-out preemption victims that must survive until re-admission,
    are never evicted to make room; demoted prefix-cache leaves are
    best-effort and may be.  ``put`` reports which unpinned keys it evicted,
    so the owner (the prefix cache) can drop the matching leaves.
    """

    def __init__(self, row_budget: int) -> None:
        if row_budget < 0:
            raise ValueError("row_budget must be >= 0")
        self.row_budget = int(row_budget)
        # key -> (tree, n_rows, n_bytes, pinned); insertion order is LRU
        self._blocks: dict[Any, tuple[Any, int, int, bool]] = {}
        self.rows_used = 0
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def has(self, key: Any) -> bool:
        return key in self._blocks

    def rows_of(self, key: Any) -> int:
        return self._blocks[key][1]

    def put(self, key: Any, tree: Any, n_rows: int, *,
            pinned: bool = False) -> tuple[bool, list[Any]]:
        """Store a block, evicting unpinned LRU blocks to make room.

        Returns ``(ok, evicted_keys)``; on ``ok=False`` nothing was stored
        and nothing evicted: the caller falls back to dropping the rows
        (prefix leaf) or to recompute-preemption (swap victim)."""
        if key in self._blocks:
            self.drop(key)
        need = int(n_rows)
        free = self.row_budget - self.rows_used
        victims = []
        if need > free:
            reclaim = 0
            for k, (_, rows, _, pin) in self._blocks.items():
                if pin:
                    continue
                victims.append(k)
                reclaim += rows
                if need <= free + reclaim:
                    break
            if need > free + reclaim:
                return False, []
        for k in victims:
            self.drop(k)
        n_bytes = cache_bytes(tree)
        self._blocks[key] = (tree, need, n_bytes, bool(pinned))
        self.rows_used += need
        self.bytes_used += n_bytes
        return True, victims

    def pop(self, key: Any) -> tuple[Any, int]:
        """Remove and return ``(tree, n_rows)``, the swap-in side."""
        tree, n_rows, n_bytes, _ = self._blocks.pop(key)
        self.rows_used -= n_rows
        self.bytes_used -= n_bytes
        return tree, n_rows

    def get(self, key: Any) -> tuple[Any, int]:
        """Peek ``(tree, n_rows)`` without removing (a restored block kept
        as a recovery copy)."""
        tree, n_rows, _, _ = self._blocks[key]
        return tree, n_rows

    def unpin(self, key: Any) -> None:
        """Make a pinned block LRU-evictable (a restored victim's retained
        recovery copy is best-effort and must not strand row budget)."""
        tree, n_rows, n_bytes, _ = self._blocks[key]
        self._blocks[key] = (tree, n_rows, n_bytes, False)

    def pin(self, key: Any) -> None:
        """Make a block eviction-proof again (a retained recovery copy the
        scheduler has committed to restoring from)."""
        tree, n_rows, n_bytes, _ = self._blocks[key]
        self._blocks[key] = (tree, n_rows, n_bytes, True)

    def drop(self, key: Any) -> bool:
        if key not in self._blocks:
            return False
        self.pop(key)
        return True

    def touch(self, key: Any) -> None:
        """Refresh LRU recency of ``key`` (a cold-tier hit)."""
        self._blocks[key] = self._blocks.pop(key)


@dataclasses.dataclass
class LatentCache:
    """MLA compressed-latent cache (DeepSeek-V3): the SLC region holds one
    latent a token (``kv_lora_rank + qk_rope_head_dim`` wide) instead of
    per-head K/V, stacked over layers as the reference stacks it."""
    c_q: torch.Tensor            # [L, B, S, C] int8
    c_s: torch.Tensor            # [L, B, S, 1] f32
    lengths: torch.Tensor        # [B] int32

    @property
    def n_slots(self) -> int:
        return self.c_q.shape[1]

    @property
    def max_len(self) -> int:
        return self.c_q.shape[2]


def init_latent_cache(n_layers: int, n_slots: int, max_len: int, dim: int,
                      device: str | torch.device = "cuda") -> LatentCache:
    from repro_torch.device import resolve
    dev = resolve(device)
    return LatentCache(
        c_q=torch.zeros((n_layers, n_slots, max_len, dim), dtype=torch.int8, device=dev),
        c_s=torch.zeros((n_layers, n_slots, max_len, 1), dtype=torch.float32, device=dev),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    )


def append_latent(cache: LatentCache, layer: int, c: torch.Tensor, pos: Any) -> LatentCache:
    """Append latents ``c`` ([B, T, C] float) to layer ``layer`` at ``pos``
    (scalar or [B]), quantized per token: scale ``max(amax, 1e-8) / 127``
    (an IEEE division, ``core/quant.py`` ``_scale``), codes
    ``round(c / scale)`` clipped to +-127; in place, returns the cache."""
    scale = _scale(torch.amax(torch.abs(c), dim=-1, keepdim=True))
    c_q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    batched_update(cache.c_q[layer], c_q, pos)
    batched_update(cache.c_s[layer], scale, pos)
    return cache


def cache_bytes(tree: Any) -> int:
    """Bytes held by every tensor or numpy array in a nested dict / list /
    tuple / KVCache."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return 0
