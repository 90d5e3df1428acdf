"""Request queue + slot scheduler for continuous batching.

Host-side control plane for the serve engine: requests arrive with
variable-length prompts, wait in a queue, are admitted into free decode
*slots* (rows of the pooled SLC-region KV cache), and retire when they hit
their token budget or emit EOS — freeing the slot for the next queued
request mid-flight (backfill).  The device never sees any of this: it always
steps a fixed [n_slots] batch, and the scheduler just decides which rows are
live.

Admission *order* — and whether a running request gets bumped back to the
queue — is delegated to a pluggable :class:`SchedulingPolicy`:

* :class:`FIFOPolicy`        — arrival order (the original behaviour);
* :class:`PriorityPolicy`    — highest ``Request.priority`` first, optionally
  preempting a strictly lower-priority resident when the queue is blocked;
* :class:`SJFPolicy`         — shortest remaining work
  (prompt + budget - generated) first;
* :class:`FairSharePolicy`   — deficit round-robin over ``Request.user``
  with a per-residency token *quantum*: a resident that has generated its
  quantum while a less-served user waits is preempted back to the queue.

Preemption is a *policy choice* between two token-identical mechanisms.
Recompute-style (vLLM's default): the victim keeps its generated tokens,
its slot is freed, and on re-admission the engine re-prefills the prompt
and *replays* the kept tokens through the decode path.  Swap-style (the
tiered KV pool, ``serve/kv_swap.py``): the engine swaps the victim's
committed rows to the cold tier first and passes ``swapped_rows`` here, so
the request re-enters the queue with its prefill already credited
(``prefill_pos`` stays at the prompt length — SJF sees the reduced
remaining work) and re-admission restores the rows instead of recomputing.

The slot lifecycle mirrors the paper's SLC-region residency:

    QUEUED --admit--> PREFILLING --first token--> DECODING --retire--> FINISHED
                (slot allocated)         |                 (slot freed, reused)
                      ^                  | preempt (slot freed,
                      +------------------+  output kept, requeued)

Any non-terminal state can also exit via ``cancel`` (client disconnect:
slot freed mid-flight, partial output kept, state CANCELLED) or ``fail``
(admission/prefill raised: state FINISHED with ``error`` set).  Both
remove a QUEUED request from the queue so a terminal request can never
keep ``has_work()`` true.

``PREFILLING`` carries progress: ``Request.prefill_pos`` is the chunk cursor
— a request may stay PREFILLING across several engine iterations while its
prompt is consumed chunk by chunk under the per-iteration token budget.

Slots are reused lowest-index-first so admission order is deterministic and
testable.  All scheduling is O(queue) Python on the host — the jitted decode
step stays shape-stable.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMEOUT = "timeout"


@dataclasses.dataclass
class Request:
    """One generation request flowing through the engine."""
    rid: int
    prompt: list[int]                     # token ids (len >= 1)
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    priority: int = 0                     # higher = more urgent (PriorityPolicy)
    user: Optional[str] = None            # fair-share accounting key
    temperature: float = 0.0              # 0 = greedy argmax
    top_k: Optional[int] = None           # restrict sampling to top-k logits
    seed: Optional[int] = None            # per-request sampling seed
    deadline_s: Optional[float] = None    # wall budget from arrival; the
    #   engine times the request out (terminal TIMEOUT) once exceeded

    # filled in by the scheduler / engine
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    output: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0                  # chunked-prefill cursor (tokens done)
    replay_pos: int = 0                   # tokens re-fed after a preemption
    adopted_rows: int = 0                 # prefix rows already in own slot
    #   (reclaim adopted the matching leaf's slot — see RadixPrefixCache)
    swapped_rows: int = 0                 # committed rows held in the cold
    #   tier while QUEUED after a swap-based preemption (see kv_swap)
    n_preemptions: int = 0
    error: Optional[str] = None           # set when admission/prefill failed
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.TIMEOUT)

    @property
    def cancelled(self) -> bool:
        return self.state is RequestState.CANCELLED

    @property
    def timed_out(self) -> bool:
        return self.state is RequestState.TIMEOUT

    @property
    def remaining_work(self) -> int:
        """Tokens left to process (prefill + generate) — the SJF job size."""
        return max(0, self.prompt_len - self.prefill_pos) \
            + max(0, self.max_new_tokens - len(self.output))

    def should_stop(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return self.eos_id is not None and bool(self.output) \
            and self.output[-1] == self.eos_id

    def sort_key(self):
        """Deterministic tiebreak shared by every policy."""
        return (self.arrival_time, self.rid)


# ---------------------------------------------------------------------------
# scheduling policies
# ---------------------------------------------------------------------------
class SchedulingPolicy:
    """Admission ordering + optional preemption for the slot scheduler.

    Subclasses override :meth:`select` (which queued request is admitted
    next) and optionally :meth:`victims` (which residents to bump back to the
    queue this iteration).  The engine reports generation progress through
    the ``on_*`` hooks so stateful policies (fair share) can account service.
    """

    name = "base"

    # -- admission --------------------------------------------------------
    def select(self, queue: list[Request], now: float) -> Request:
        return min(queue, key=lambda r: r.sort_key())

    # -- preemption -------------------------------------------------------
    def victims(self, active: dict[int, "Request"], queue: list[Request],
                now: float) -> list[Request]:
        """Residents to preempt back to the queue (default: never)."""
        return []

    # -- accounting hooks -------------------------------------------------
    def on_admit(self, req: Request, now: float) -> None:
        pass

    def on_tokens(self, req: Request, n: int) -> None:
        pass

    def on_finish(self, req: Request, now: float) -> None:
        pass


class FIFOPolicy(SchedulingPolicy):
    """Arrival order — the baseline continuous-batching behaviour."""

    name = "fifo"


class PriorityPolicy(SchedulingPolicy):
    """Highest ``Request.priority`` first; FIFO within a priority class.

    With ``preemptive=True`` a queued request whose priority strictly
    exceeds a resident's bumps the lowest-priority resident back to the
    queue (at most one victim per engine iteration — admission latency of
    one step, zero wasted slots).
    """

    name = "priority"

    def __init__(self, preemptive: bool = False):
        self.preemptive = preemptive

    def select(self, queue, now):
        return min(queue, key=lambda r: (-r.priority,) + r.sort_key())

    def victims(self, active, queue, now):
        if not (self.preemptive and active and queue):
            return []
        # the challenger is whoever `select` would admit next — same
        # ordering (priority, then sort_key), so victim choice is
        # deterministic regardless of queue insertion order
        top = self.select(queue, now)
        victim = min(active.values(), key=lambda r: (r.priority,) + r.sort_key())
        if top.priority > victim.priority:
            return [victim]
        return []


class SJFPolicy(SchedulingPolicy):
    """Shortest job first: smallest remaining work (prompt left to prefill
    plus tokens left to generate).  Preempted requests keep credit for what
    they already generated, so a resumed short job stays short."""

    name = "sjf"

    def select(self, queue, now):
        return min(queue, key=lambda r: (r.remaining_work,) + r.sort_key())


class FairSharePolicy(SchedulingPolicy):
    """Deficit round-robin over users with budget-based preemption.

    Admission picks the queued request whose user has been served the fewest
    tokens (deficit round-robin — a flood from one user cannot starve
    another).  ``quantum`` bounds a residency: once a request has generated
    ``quantum`` tokens in its current residency while a strictly less-served
    user waits in the queue, it is preempted back to the queue — the
    time-slicing that bounds starvation even with fewer slots than users.
    """

    name = "fair"

    def __init__(self, quantum: int = 32):
        if quantum < 1:
            raise ValueError("fair-share quantum must be >= 1")
        self.quantum = quantum
        self.served: dict[str, int] = {}
        self._admit_len: dict[int, int] = {}    # rid -> len(output) at admit

    @staticmethod
    def _user(req: Request) -> str:
        return req.user if req.user is not None else f"rid{req.rid}"

    def select(self, queue, now):
        return min(queue, key=lambda r: (self.served.get(self._user(r), 0),)
                   + r.sort_key())

    def on_admit(self, req, now):
        self._admit_len[req.rid] = len(req.output)

    def on_tokens(self, req, n):
        u = self._user(req)
        self.served[u] = self.served.get(u, 0) + n

    def on_finish(self, req, now):
        self._admit_len.pop(req.rid, None)

    def residency_tokens(self, req: Request) -> int:
        return len(req.output) - self._admit_len.get(req.rid, 0)

    def victims(self, active, queue, now):
        if not queue:
            return []
        waiting = {}                      # user -> served (distinct waiters)
        for r in queue:
            u = self._user(r)
            waiting.setdefault(u, self.served.get(u, 0))
        eligible = [r for r in active.values()
                    if r.state is RequestState.DECODING
                    and self.residency_tokens(r) >= self.quantum]
        # bump the most-served residents first, at most one per strictly
        # less-served waiting user — preempting more would just re-admit
        # the extra victims next iteration after a wasted re-prefill
        eligible.sort(key=lambda r: (-self.served.get(self._user(r), 0),)
                      + r.sort_key())
        out = []
        for req in eligible:
            mine = self.served.get(self._user(req), 0)
            n_under = sum(1 for s in waiting.values() if s < mine)
            if len(out) < n_under:
                out.append(req)
        return out


POLICIES: dict[str, type[SchedulingPolicy]] = {
    "fifo": FIFOPolicy,
    "priority": PriorityPolicy,
    "sjf": SJFPolicy,
    "fair": FairSharePolicy,
}


def make_policy(spec: "str | SchedulingPolicy | None") -> SchedulingPolicy:
    """``"fifo" | "priority" | "sjf" | "fair" | "fair:8"`` (fair quantum) or
    an already-built policy instance."""
    if spec is None:
        return FIFOPolicy()
    if isinstance(spec, SchedulingPolicy):
        return spec
    name, _, arg = spec.partition(":")
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; one of {sorted(POLICIES)}")
    if name == "fair" and arg:
        return FairSharePolicy(quantum=int(arg))
    if name == "priority" and arg:
        return PriorityPolicy(preemptive=arg in ("1", "preempt", "true"))
    return POLICIES[name]()


# ---------------------------------------------------------------------------
# slot scheduler
# ---------------------------------------------------------------------------
class Scheduler:
    """Policy-driven admission into a fixed pool of decode slots.

    ``max_len`` bounds prompt + generation per slot; a request that cannot
    ever fit is rejected at submit time (ValueError) rather than deadlocking
    the queue.
    """

    def __init__(self, n_slots: int, max_len: int,
                 policy: "str | SchedulingPolicy | None" = None):
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.n_slots = n_slots
        self.max_len = max_len
        self.policy = make_policy(policy)
        self.queue: list[Request] = []
        self.free_slots: list[int] = list(range(n_slots))   # min-heap
        heapq.heapify(self.free_slots)
        self.active: dict[int, Request] = {}                # slot -> request
        self.quarantined: set[int] = set()       # dead planes — never reused
        self.prefix_cache = None                 # set via attach_prefix_cache

    # -- prefix cache ------------------------------------------------------
    def attach_prefix_cache(self, cache) -> None:
        """Wire a radix prefix cache (``RadixPrefixCache``) into
        the slot lifecycle: retirement publishes committed prefixes,
        admission may alias a cached leaf's slot or reclaim the LRU leaf
        when the free heap runs dry, and every slot free routes through
        the cache's refcounts (an aliased leaf's slot must decref its
        writer hold, never leak onto the free heap while the leaf still
        claims its rows)."""
        self.prefix_cache = cache
        cache._free = self._push_free

    def _push_free(self, slot: int) -> None:
        """Single gate onto the free heap: a quarantined slot (lost plane)
        never comes back into rotation."""
        if slot not in self.quarantined:
            heapq.heappush(self.free_slots, slot)

    def _free_slot(self, slot: int) -> None:
        """Refcount-aware slot free: an alias-held slot drops its writer
        hold (the cached leaf keeps the slot); anything else goes back on
        the free heap."""
        cache = self.prefix_cache
        if cache is not None and cache.manages(slot):
            cache.release_writer(slot)
        else:
            self._push_free(slot)

    # -- fault tolerance ---------------------------------------------------
    def quarantine_slot(self, slot: int) -> None:
        """Take a slot permanently out of rotation (a lost plane — see
        serve/faults.py).  The engine has already recovered or failed the
        resident; here the slot just stops being allocatable.  Fatal once
        every slot is quarantined: the engine cannot serve."""
        if slot in self.quarantined:
            return
        self.quarantined.add(slot)
        if slot in self.free_slots:
            self.free_slots.remove(slot)
            heapq.heapify(self.free_slots)
        if len(self.quarantined) >= self.n_slots:
            raise RuntimeError(
                f"all {self.n_slots} decode slots quarantined after plane "
                "losses; the engine has no healthy rows left to serve on")

    def timeout(self, req: Request, now: float = 0.0) -> None:
        """Deadline exceeded (``Request.deadline_s``): terminal TIMEOUT
        with the partial output kept, slot/queue entry released like a
        cancel.  Idempotent on an already-terminal request."""
        if req.done:
            return
        self._release(req)
        req.state = RequestState.TIMEOUT
        req.finish_time = now
        self.policy.on_finish(req, now)

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_len < 1:
            raise ValueError(
                f"request {req.rid}: empty prompt (prefill needs >= 1 token)")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 "
                "(prefill always emits the first token)")
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds slot capacity {self.max_len}")
        req.state = RequestState.QUEUED
        self.queue.append(req)

    # -- admission --------------------------------------------------------
    def admit(self, now: float = 0.0) -> list[Request]:
        """Move queued requests into free slots in policy order until slots
        run out.  Returns the newly admitted requests (slot assigned,
        PREFILLING, ``prefill_pos`` reset)."""
        cache = self.prefix_cache
        admitted = []
        while self.queue and (
                self.free_slots
                or (cache is not None and cache.has_reclaimable())):
            req = self.policy.select(self.queue, now)
            self.queue.remove(req)
            slot = None
            req.adopted_rows = 0
            if cache is not None and not req.swapped_rows:
                # zero-copy admission: decode in place on a fully-matched
                # cached leaf (writer hold taken; engine resolves the
                # match through leaf_for(slot)).  A swapped-out victim
                # never aliases: its cold-tier rows (prompt + generated)
                # restore into the slot and would clobber a live leaf.
                slot = cache.alias_slot(req.prompt, req.prompt_len - 1)
            if slot is None:
                if self.free_slots:
                    slot = heapq.heappop(self.free_slots)
                elif req.swapped_rows:
                    # any reclaimable slot serves a swap restore (the rows
                    # arrive from the cold tier, nothing in-place to spare)
                    slot, _ = cache.reclaim_slot()
                else:
                    # slot pressure: LRU cache rows yield to live work
                    # (evict-before-preempt — see engine preemption gate);
                    # the request's own best-match leaf is spared, or its
                    # slot adopted outright when it is the only candidate
                    slot, req.adopted_rows = cache.reclaim_slot(
                        protect_tokens=req.prompt,
                        max_rows=req.prompt_len - 1)
            if slot is None:                     # pragma: no cover - guard
                self.queue.append(req)
                break
            req.slot = slot
            req.state = RequestState.PREFILLING
            req.prefill_pos = 0
            req.replay_pos = 0
            req.admit_time = now
            self.active[slot] = req
            self.policy.on_admit(req, now)
            admitted.append(req)
        return admitted

    # -- preemption -------------------------------------------------------
    def preemption_victims(self, now: float = 0.0) -> list[Request]:
        return self.policy.victims(self.active, self.queue, now)

    def preempt(self, req: Request, now: float = 0.0,
                swapped_rows: int = 0) -> None:
        """Bump a resident back to the queue: the slot is freed, generated
        output is kept.  ``swapped_rows > 0`` records that the engine moved
        the victim's committed rows to the cold tier — the prefill cursor
        keeps its credit (no re-prefill on re-admission; SJF's
        ``remaining_work`` sees only the generation left) and the engine
        restores the rows instead of replaying.  ``swapped_rows == 0`` is
        the recompute path: the cursor resets and re-admission re-prefills
        the prompt and replays the kept tokens."""
        assert req.slot is not None and self.active.get(req.slot) is req
        del self.active[req.slot]
        self._free_slot(req.slot)
        req.slot = None
        req.state = RequestState.QUEUED
        req.swapped_rows = int(swapped_rows)
        req.prefill_pos = req.prompt_len if swapped_rows else 0
        req.n_preemptions += 1
        self.queue.append(req)

    # -- retirement -------------------------------------------------------
    def retire(self, req: Request, now: float = 0.0,
               publish_rows: int | None = None) -> None:
        """Finish a request and free its slot for backfill.

        With a prefix cache attached, ``publish_rows`` (the engine's
        committed row count for the slot) publishes the request's token
        prefix into the trie: on success the cache takes the slot (leaf
        claim — no free-heap push); on rejection (covered / over budget)
        the slot frees through the refcount-aware path like any other."""
        assert req.slot is not None and self.active.get(req.slot) is req
        slot = req.slot
        del self.active[slot]
        took = False
        if self.prefix_cache is not None and publish_rows:
            seq = (req.prompt + req.output)[:publish_rows]
            took = self.prefix_cache.publish(seq, slot, publish_rows)
        if not took:
            self._free_slot(slot)
        req.state = RequestState.FINISHED
        req.finish_time = now
        req.slot = None
        self.policy.on_finish(req, now)

    def _release(self, req: Request) -> None:
        """Detach a request from wherever it lives: a QUEUED request leaves
        the queue (a terminal request stuck in ``self.queue`` would keep
        ``has_work()`` true forever — ``drain()`` would spin); a resident's
        slot goes back to the free heap (no leak)."""
        if req in self.queue:
            self.queue.remove(req)
        if req.slot is not None and self.active.get(req.slot) is req:
            del self.active[req.slot]
            self._free_slot(req.slot)
        req.slot = None

    def fail(self, req: Request, now: float = 0.0,
             error: str = "admission failed") -> None:
        """Abort a request whose admission/prefill raised: the slot goes
        back to the free heap (no leak) and the request finishes with
        ``error`` set instead of wedging the engine."""
        self._release(req)
        req.state = RequestState.FINISHED
        req.error = error
        req.finish_time = now
        self.policy.on_finish(req, now)

    def cancel(self, req: Request, now: float = 0.0) -> None:
        """Client-side cancellation/disconnect: the request ends CANCELLED
        (its partial output kept, no ``error``) and, if resident, its slot
        is freed mid-flight for the next queued request.  Idempotent on an
        already-terminal request.  A cancelled alias writer decrefs its
        writer hold through ``_free_slot`` — the cached leaf keeps the
        slot, so cancellation can neither leak it nor double-free it."""
        if req.done:
            return
        self._release(req)
        req.state = RequestState.CANCELLED
        req.finish_time = now
        self.policy.on_finish(req, now)

    # -- introspection ----------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue or self.active)
