"""Swap layer of the tiered KV pool: metered hot <-> cold row transfers.

PyTorch-port counterpart of ``repro.serve.kv_swap``.  The hot tier is the
engine's int8 decode pool (slot rows in the fast SLC region); this module
owns the **cold tier**, evicted or preempted slot rows held as quantized
host-side (numpy) blocks (the flash/SLC-resident side of the paper's
hybrid), and the explicit ``swap_out`` / ``swap_in`` transfers between
them.

Every transfer is metered twice:

* **bytes**: the truncated block's actual payload (int8 rows and scales,
  any fixed-size recurrent state, the cursor), the tier-transfer traffic
  the engine surfaces as ``swap_out_bytes`` / ``swap_in_bytes``;
* **modeled PIM cost**: :func:`repro_torch.core.pim.latency.tier_transfer`
  prices the same bytes on the paper's modeled NAND device (SLC program
  bandwidth out, Eq. (1) SLC page reads and the flash bus back in) in
  RPU-clock cycles, surfaced as ``swap_out_cycles`` / ``swap_in_cycles``.
  These are outputs of the paper's analytical model, not card times.

The swap-vs-replay crossover makes preemption a policy choice: a victim's
rows are worth swapping when the modeled round trip beats re-running its
tokens through the bandwidth-bound decode path (each recomputed token pays
a full weight-read pass, ``core.mapping.flash_tpot_for``).

Blocks round-trip byte-exactly.  The engine lifts a slot's live rows off
the pool with ``transformer.read_slot(state, slot, n)`` (the int8 payload
and scales verbatim; only the ``n`` live rows cross to the host, where the
reference lifts the whole row and truncates it on the host), and lands a
restored block with ``transformer.write_slot`` and zeroes the rest of the
slot on the device, where the reference zero-pads the block on the host
(``pad``) and writes the whole row: either way rows ``[0:n)`` come back
verbatim and the rest are zero and never attended.  The
port keeps per-layer dicts where the reference keeps stacked ``groups``;
the bytes a row takes, and so every metered number, are the same.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import kvcache as KV
from repro_torch.core.pim import latency as L
from repro_torch.core.pim.params import PlaneConfig
from repro_torch.serve.faults import ColdBlockCorrupt, FaultTolerance, _is_seq_block


def slot_template(state: dict) -> dict:
    """The shapes and numpy dtypes of one slot's row of a pooled decode
    state (``read_slot``'s batch=1 layout at the pool's full length), the
    source of the per-row byte count."""
    def spec(t):
        return (1,) + tuple(t.shape[1:]), np.dtype(str(t.dtype).replace("torch.", ""))
    return {"layers": [{k: spec(v) for k, v in c.items()} for c in state["layers"]],
            "pos": ((1,), np.dtype(np.int32))}


def to_host(one: dict) -> dict:
    """A batch=1 state of device tensors as a numpy host tree (the cold
    block's form)."""
    return {"layers": [{k: v.cpu().numpy() for k, v in c.items()}
                       for c in one["layers"]],
            "pos": one["pos"].cpu().numpy().astype(np.int32)}


class SwapManager:
    """Owns the cold tier (:class:`repro_torch.core.kvcache.ColdStore`) plus
    the truncate plumbing and the cost model for one engine's pool.

    ``template`` is :func:`slot_template` of the pool.  ``replay_tpot_s`` is
    the modeled seconds one recomputed token costs on the paper's device
    (``None`` disables the crossover: swap whenever the cold tier has
    room)."""

    def __init__(self, cold_rows: int, template: dict, *,
                 plane: PlaneConfig | None = None,
                 replay_tpot_s: float | None = None):
        self.store = KV.ColdStore(cold_rows)
        self._plane = plane
        self._ft: FaultTolerance | None = None
        self.replay_tpot_s = replay_tpot_s
        self.row_bytes = 0        # payload bytes per live sequence row
        self.fixed_bytes = 0      # fixed-size (SSM) state per block
        for b in template["layers"]:
            for shape, dtype in b.values():
                n = int(np.prod(shape)) * dtype.itemsize
                if _is_seq_block(b):
                    self.row_bytes += n // shape[1]
                else:
                    self.fixed_bytes += n

    def attach_faults(self, ft: FaultTolerance) -> None:
        """Wire the fault-tolerance layer in: ``swap_out`` records per-row
        checksums over the clean block, ``swap_in`` routes the read through
        the metered ECC and checksum pipeline (raising
        :class:`ColdBlockCorrupt` on an uncorrectable block, which is
        dropped first), and ``drop``/LRU eviction forget the sums."""
        self._ft = ft

    # -- cost model --------------------------------------------------------
    def block_bytes(self, n_rows: int) -> int:
        return self.fixed_bytes + n_rows * self.row_bytes

    def transfer_cost(self, n_bytes: int) -> L.TierTransfer:
        return L.tier_transfer(n_bytes, self._plane)

    def prefer_swap(self, n_rows: int, replay_tokens: int) -> bool:
        """The crossover rule: swap a preemption victim's ``n_rows`` when the
        modeled tier round trip (program out, page-read back) beats
        recomputing ``replay_tokens`` through the decode path."""
        if n_rows < 1 or n_rows > self.store.row_budget:
            return False
        if self.replay_tpot_s is None:
            return True
        tc = self.transfer_cost(self.block_bytes(n_rows))
        return tc.t_out + tc.t_in < replay_tokens * self.replay_tpot_s

    # -- block shaping -----------------------------------------------------
    def truncate(self, one: dict, n: int) -> dict:
        """Keep the ``n`` live sequence rows of a fetched batch=1 host state
        (fixed-size SSM state travels whole): the cold block payload."""
        layers = [{k: np.asarray(v)[:, :n] for k, v in b.items()} if _is_seq_block(b)
                  else {k: np.asarray(v) for k, v in b.items()}
                  for b in one["layers"]]
        return {"layers": layers, "pos": np.asarray([n], np.int32)}

    # -- transfers ---------------------------------------------------------
    def swap_out(self, key: Any, one: dict, n_rows: int, *,
                 pinned: bool = False
                 ) -> tuple[bool, list[Any], L.TierTransfer]:
        """Truncate a fetched slot row to its live prefix and store it cold.

        Returns ``(ok, evicted_keys, cost)``: ``evicted_keys`` are unpinned
        (prefix-leaf) blocks the store LRU-dropped to make room, whose trie
        leaves the caller must drop; on ``ok=False`` nothing was stored and
        the caller falls back (recompute-preemption, or a plain leaf
        drop)."""
        blob = self.truncate(one, int(n_rows))
        ok, evicted = self.store.put(key, blob, int(n_rows), pinned=pinned)
        if self._ft is not None:
            for k in evicted:
                self._ft.forget(k)
            if ok:
                self._ft.note_write(key, blob)
        cost = self.transfer_cost(KV.cache_bytes(blob) if ok else 0)
        return ok, evicted, cost

    def swap_in(self, key: Any, *, keep: bool = False
                ) -> tuple[dict, int, L.TierTransfer]:
        """Pop a cold block: ``(blob, n_rows, cost)``, ``blob`` the truncated
        host block (the engine lands its rows with ``write_slot`` and zeroes
        the rest of the slot).  Raises ``KeyError`` on
        a missing block.  ``keep=True`` leaves the block in the store after
        a verified read, unpinned and LRU-evictable (the fault-tolerance
        layer's recovery copy).  With that layer attached the read flows
        through the ECC and checksum pipeline, and an uncorrectable block
        raises :class:`ColdBlockCorrupt` (dropped first)."""
        if keep:
            blob, n_rows = self.store.get(key)
        else:
            blob, n_rows = self.store.pop(key)
        if self._ft is not None:
            try:
                blob = self._ft.read_block(key, blob)
            except ColdBlockCorrupt:
                if keep:
                    self.store.drop(key)
                raise
        if keep:
            self.store.unpin(key)
            self.store.touch(key)
        cost = self.transfer_cost(KV.cache_bytes(blob))
        return blob, n_rows, cost

    def drop(self, key: Any) -> bool:
        """Discard a cold block (a failed swapped-out request, or a demoted
        leaf whose trie entry died).  Idempotent."""
        if self._ft is not None:
            self._ft.forget(key)
        return self.store.drop(key)

    def has(self, key: Any) -> bool:
        return self.store.has(key)
