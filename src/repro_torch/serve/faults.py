"""NAND-grounded fault model + serve-path fault tolerance (DESIGN §1j).

PyTorch-port counterpart of ``repro.serve.faults``, on numpy: the port's
cold blocks are ``{"layers": [per-layer dict], "pos"}`` host trees (the
layout of ``transformer.read_slot``), and every payload traversal below
visits their leaves in the reference's byte order (see
:func:`_split_leaves`), so checksums and injected flips equal the
reference's on the same block and seed.  The engine's ``faults=``
(``serve/engine.py``) takes an injector (or ``True`` for detection alone),
builds the :class:`FaultTolerance` layer over its stats, and attaches it to
the tiered pool's swap layer (``serve/kv_swap.py``, ``attach_faults``).

The paper keeps weights and the KV pool in SLC 3D NAND, whose raw bit
errors are a first-class physical concern: retention errors accumulate
while a cold block rests (the 3-day relaxed-retention operating point of
``RETENTION_RELAX_FACTOR``), read disturb flips bits on hot pages, and a
whole plane can die.  Cambricon-LLM (PAPERS.md) makes on-die error
handling load-bearing for NAND-resident LLM state; this module gives the
serve stack the same property.  Three pieces:

* :class:`FaultInjector` — a deterministic, seeded chaos source.  It
  models (a) NAND bit-flips in cold-store blocks at a configurable BER
  (``retention`` / ``read_disturb`` modes, rates from
  ``core/pim/params``), (b) transient step failures (a device error
  mid-step, which leaves the in-place pool consumed), and (c) whole
  plane/slot loss.  Every draw is keyed by ``(seed, event)`` so the same
  configuration injects the same faults — the recovered run can be
  diffed token-for-token against a fault-free run.
* checksums — :func:`row_checksums` / :func:`verify_rows` compute
  per-sequence-row CRCs over a cold block's payload.  They are written
  over *clean* data at swap-out and verified at every tier crossing
  (swap-in, prefix-cache promote), which is exactly where the paper's
  device would run its ECC pass.
* :class:`FaultTolerance` — the detection pipeline one cold read flows
  through: meter the on-die BCH decode
  (:func:`repro_torch.core.pim.latency.ecc_decode`) into engine stats like
  ``tier_transfer``, correct transparently when every 256 B page holds
  at most ``ECC_T_PER_PAGE`` flips, and raise :class:`ColdBlockCorrupt`
  (after dropping the block) when a page is beyond ``t`` — the engine
  then falls back to deterministic recompute-replay, so the stream stays
  token-identical.

Recovery itself lives in ``serve/engine.py`` (pool rebuild from
committed host state, slot quarantine, bounded step retry); this module
is import-light on purpose — it must not import the engine or the swap
layer.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np

from repro_torch.core.pim import latency as L
from repro_torch.core.pim import params as P


class PoolConsumedError(RuntimeError):
    """An in-place update of the decode pool failed mid-call; the engine
    cannot continue serving its residents on this pool until it rebuilds it
    (see ``ContinuousBatchingEngine.step``)."""


class InjectedStepFailure(RuntimeError):
    """A :class:`FaultInjector`-scheduled transient device error mid-step."""


class ColdBlockCorrupt(RuntimeError):
    """A cold block failed its tier-crossing integrity check: some 256 B
    page held more raw bit-flips than the BCH code corrects, and the
    per-row checksums confirmed the payload is damaged.  The block has
    already been dropped (quarantined) by the time this propagates."""

    def __init__(self, key: Any, bad_rows: "list[int]"):
        self.key = key
        self.bad_rows = bad_rows
        super().__init__(
            f"cold block {key!r} uncorrectable: "
            f"{len(bad_rows)} damaged row(s) {bad_rows[:8]}")


def _is_seq_block(b: Any) -> bool:
    """An attention layer's cache block (``k_q`` ... or MLA's ``c_q`` /
    ``c_s`` leaves, sequence axis 1).  Everything else (SSM recurrent
    state) is fixed-size and travels whole (``serve/kv_swap.py`` splits
    blocks by it too)."""
    return isinstance(b, dict) and ("k_q" in b or "c_q" in b)


def _split_leaves(blob: dict) -> "tuple[list[np.ndarray], list[np.ndarray]]":
    """A cold block's payload leaves in deterministic traversal order:
    ``(seq, fixed)``, where ``seq`` leaves are attention layers' ``[1, n,
    ...]`` rows (truncated to the live rows) and ``fixed`` leaves are
    whole-block SSM state.  Each list runs key by key (sorted) and, within
    a key, layer by layer: the byte order of the reference's leaves, which
    stack a key's layers on a leading axis (``[n_layers, 1, n, ...]``), for
    a one-group stack.  (A stack the reference splits into groups, such as
    DeepSeek-V3's dense prefix and MoE tail, orders its bytes group by
    group there; an injected flip then lands on another byte of the block,
    but its page, and so every ECC verdict and counter, is the same.)"""
    layers = blob["layers"]
    seq_layers = [b for b in layers if _is_seq_block(b)]
    fixed_layers = [b for b in layers if not _is_seq_block(b)]

    def order(group: list) -> "list[np.ndarray]":
        if not group:
            return []
        return [np.asarray(b[k]) for k in sorted(group[0]) for b in group]
    return order(seq_layers), order(fixed_layers)


def _payload_bytes(blob: dict) -> int:
    seq, fixed = _split_leaves(blob)
    return sum(a.nbytes for a in seq) + sum(a.nbytes for a in fixed)


def row_checksums(blob: dict) -> np.ndarray:
    """Per-row CRC32s over a truncated cold block: entry ``r < n`` covers
    sequence row ``r`` across every attention leaf; the final entry
    covers the fixed-size (SSM) state.  ``pos`` is host-side ledger
    metadata, not NAND payload, and is not covered."""
    seq, fixed = _split_leaves(blob)
    n = int(np.asarray(blob["pos"])[0])
    sums = np.zeros(n + 1, np.uint32)
    for r in range(n):
        c = 0
        for leaf in seq:
            c = zlib.crc32(np.ascontiguousarray(leaf[:, r]).tobytes(), c)
        sums[r] = c
    c = 0
    for leaf in fixed:
        c = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), c)
    sums[n] = c
    return sums


def verify_rows(blob: dict, sums: np.ndarray) -> "list[int]":
    """Row indices whose checksum no longer matches (index ``n`` = the
    fixed-state entry).  Empty list == clean block."""
    fresh = row_checksums(blob)
    if fresh.shape != np.asarray(sums).shape:
        return list(range(len(fresh)))
    return [int(i) for i in np.nonzero(fresh != np.asarray(sums))[0]]


@dataclasses.dataclass
class FaultInjector:
    """Deterministic, seeded fault source for the serve path.

    ``ber`` overrides the params-derived raw bit-error rate (``None``
    selects ``RBER_SLC_RETENTION`` or ``RBER_SLC_READ_DISTURB`` by
    ``mode``).  ``step_fail_at`` / ``step_fail_every`` schedule transient
    device errors against the engine's ``stats["steps"]`` counter;
    ``slot_loss_at`` is a tuple of ``(step, slot)`` plane-loss events.
    Each scheduled event fires exactly once even though a retried step
    re-enters with an advanced counter (the ``seen`` sets below — same
    discipline as ``ft.failures.FailureInjector``).
    """

    seed: int = 0
    ber: "float | None" = None
    mode: str = "retention"            # "retention" | "read_disturb"
    step_fail_at: "tuple[int, ...]" = ()
    step_fail_every: int = 0
    slot_loss_at: "tuple[tuple[int, int], ...]" = ()

    def __post_init__(self) -> None:
        if self.mode not in ("retention", "read_disturb"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        self._seen_steps: set[int] = set()
        self._seen_losses: set[tuple[int, int]] = set()
        self._n_reads = 0
        self.injected = {"bitflip_reads": 0, "bitflips": 0,
                         "step_failures": 0, "slot_losses": 0}

    # -- shared -------------------------------------------------------------
    @property
    def bit_error_rate(self) -> float:
        if self.ber is not None:
            return float(self.ber)
        return (P.RBER_SLC_READ_DISTURB if self.mode == "read_disturb"
                else P.RBER_SLC_RETENTION)

    def _rng(self, *salt: Any) -> np.random.Generator:
        # crc32 of repr, not hash(): stable across processes/PYTHONHASHSEED
        return np.random.default_rng(
            [self.seed] + [zlib.crc32(repr(s).encode()) for s in salt])

    # -- (a) NAND bit-flips -------------------------------------------------
    def corrupt_block(self, key: Any, blob: dict
                      ) -> "tuple[dict, np.ndarray]":
        """Flip bits in a *copy* of a cold block at the configured BER,
        treating the payload leaves as one contiguous byte stream split
        into 256 B pages.  Returns ``(blob', flips_per_page)`` —
        ``flips_per_page`` is what the ECC model judges against ``t``.
        The input blob is never mutated (it may be a retained recovery
        copy)."""
        ber = self.bit_error_rate
        total_bits = 8 * _payload_bytes(blob)
        if ber <= 0.0 or total_bits == 0:
            return blob, np.zeros(0, np.int64)
        self._n_reads += 1
        rng = self._rng("read", self._n_reads, key)
        n_flips = int(rng.binomial(total_bits, min(1.0, ber)))
        if n_flips == 0:
            return blob, np.zeros(0, np.int64)
        bitpos = np.unique(rng.integers(0, total_bits, size=n_flips))
        new = {"layers": [{k: np.array(v) for k, v in b.items()}
                          for b in blob["layers"]],
               "pos": np.array(blob["pos"])}
        seq, fixed = _split_leaves(new)
        flats = [a.reshape(-1).view(np.uint8) for a in seq + fixed]
        offsets = np.cumsum([0] + [f.size for f in flats])
        bytepos = bitpos >> 3
        for bp, bit in zip(bytepos, bitpos & 7):
            i = int(np.searchsorted(offsets, bp, side="right")) - 1
            flats[i][int(bp) - int(offsets[i])] ^= np.uint8(1 << int(bit))
        flips_per_page = np.bincount(bytepos // P.PAGE_BYTES)
        self.injected["bitflip_reads"] += 1
        self.injected["bitflips"] += len(bitpos)
        return new, flips_per_page

    # -- (b) transient step failures ----------------------------------------
    def fail_step(self, step: int) -> bool:
        """True exactly once per scheduled step event (``step`` is the
        engine's monotonically increasing attempt counter)."""
        due = int(step) in self.step_fail_at or (
            self.step_fail_every > 0 and step % self.step_fail_every == 0
            and step > 0)
        if not due or step in self._seen_steps:
            return False
        self._seen_steps.add(int(step))
        self.injected["step_failures"] += 1
        return True

    # -- (c) plane / slot loss ----------------------------------------------
    def lost_slots(self, step: int) -> "list[int]":
        """Slots whose plane dies at or before ``step`` (fires once per
        scheduled event; late firing covers retry-inflated counters)."""
        out = []
        for when, slot in self.slot_loss_at:
            ev = (int(when), int(slot))
            if step >= when and ev not in self._seen_losses:
                self._seen_losses.add(ev)
                self.injected["slot_losses"] += 1
                out.append(int(slot))
        return out


class FaultTolerance:
    """Detection half of the fault-tolerance layer: per-row checksums
    written over clean blocks at swap-out, and the metered ECC pipeline
    every cold read flows through at a tier crossing.

    ``stats`` is the engine's stats dict; keys are bumped only when
    present (the engine decides which counters exist).  ``injector`` is
    optional — with no chaos source the pipeline still meters the ECC
    syndrome pass and verifies checksums, so a genuinely corrupted host
    block (or a software bug that scribbles on one) is caught the same
    way."""

    def __init__(self, stats: dict, injector: "FaultInjector | None" = None,
                 *, ecc_t: "int | None" = None):
        self.stats = stats
        self.injector = injector
        self.ecc_t = P.ECC_T_PER_PAGE if ecc_t is None else int(ecc_t)
        self._sums: dict[Any, np.ndarray] = {}

    def _bump(self, key: str, n: int = 1) -> None:
        if key in self.stats:
            self.stats[key] += n

    # -- write path ---------------------------------------------------------
    def note_write(self, key: Any, blob: dict) -> None:
        """Record checksums over a clean truncated block at swap-out."""
        self._sums[key] = row_checksums(blob)

    def forget(self, key: Any) -> None:
        self._sums.pop(key, None)

    # -- read path ----------------------------------------------------------
    def read_block(self, key: Any, blob: dict) -> dict:
        """One cold-tier read through the ECC + checksum pipeline.

        Meters the BCH syndrome pass over every page; if the injector
        flipped bits and every page stayed within ``t``, the decode
        corrects transparently (clean data returns, corrected bits are
        metered).  A page beyond ``t`` leaves damage in the payload; the
        per-row checksums catch it and :class:`ColdBlockCorrupt` is
        raised — the caller recovers (recompute-replay) and the stream
        stays token-identical."""
        flips = np.zeros(0, np.int64)
        read = blob
        if self.injector is not None:
            read, flips = self.injector.corrupt_block(key, blob)
        n_flips = int(flips.sum()) if flips.size else 0
        correctable = n_flips > 0 and int(flips.max()) <= self.ecc_t
        cost = L.ecc_decode(_payload_bytes(blob),
                            corrected_bits=n_flips if correctable else 0)
        self._bump("ecc_checks")
        self._bump("ecc_pages", cost.pages)
        self._bump("ecc_cycles", cost.cycles)
        if n_flips:
            self._bump("bitflips_injected", n_flips)
        if correctable:
            # in-range flips decode back to the written data bit-exactly
            self._bump("ecc_corrected_bits", n_flips)
            read = blob
        sums = self._sums.get(key)
        if sums is not None:
            bad = verify_rows(read, sums)
            if bad:
                self._bump("uncorrectable_blocks")
                self.forget(key)
                raise ColdBlockCorrupt(key, bad)
        elif n_flips and not correctable:
            # no checksum on record (block predates the FT layer): the
            # ECC verdict alone quarantines it
            self._bump("uncorrectable_blocks")
            raise ColdBlockCorrupt(key, [])
        return read
