"""Radix prefix cache: shared-prompt KV reuse over the slotted int8 pool.

A copy of ``repro.serve.prefix_cache`` for the port (pure Python).

Millions of users mostly share prompt prefixes — system prompts, few-shot
headers, multi-turn history.  Causal-attention KV rows are a pure function
of the token prefix (row ``i`` depends only on tokens ``[0:i]``), and the
engine's int8 SLC rows never leave the pool (KVNAND's in-flash placement,
PAPERS.md), so a retired request's committed rows are exactly the cacheable
unit: this module indexes them by token prefix in an edge-compressed radix
trie so a later admission can start its chunked prefill at the longest
cached prefix instead of position 0.

Structure
---------
* Interior nodes carry edge-compressed token runs; a **leaf** at depth
  ``n`` references pool ``slot`` whose first ``n`` sequence rows hold the
  KV of the leaf's token prefix.  One leaf per slot (``_slots`` map).
* Lookup walks the query greedily (partial edge matches count): every leaf
  under the deepest matched point shares the matched prefix, so its slot's
  first ``matched`` rows serve the query — the prefix property is what
  makes one cached long prompt serve every shorter shared prefix without
  extra leaves.
* **Copy-on-write admission**: the engine gathers the matched rows into
  the new request's own slot (``transformer.copy_slot_prefix``) — the leaf
  is never written through.  When the match consumes an entire leaf and
  nobody else holds its slot, the scheduler *aliases* instead: the request
  is admitted into the cached slot itself, zero copies.  Aliasing is safe
  because (a) garbage decode appends on inactive slots only ever land at
  or above the retired cursor (>= every claimed row), and (b) the resumed
  prefill's finalize writes only the rows past the cached prefix
  (``transformer.finalize_prefill_carry(start=n)``), so the claimed rows
  keep their bits on any device.
* **Refcounts** (:class:`repro_torch.core.kvcache.SlotLedger`): a slot is held
  by its leaf claim and, while aliased, by one active writer.  The slot
  returns to the scheduler's free heap exactly at count zero; double
  frees raise.
* **Eviction** is LRU by leaf under ``row_budget`` claimed rows; only
  claim-only leaves (no writer) are evictable.  The scheduler reclaims the
  LRU leaf when admission finds the free heap empty — cache rows yield to
  live work *before* any resident is preempted.
* **Publish** at retirement inserts the request's committed rows.  A
  prefix already covered by an existing (equal or deeper) leaf is rejected
  — the cover is bumped instead — and a newly published extension evicts
  claim-only ancestor leaves it strictly covers, freeing their slots.
* **Cold tier** (:meth:`RadixPrefixCache.attach_cold_tier`): with the
  tiered KV pool on, eviction *demotes* a leaf instead of dropping it —
  the engine swaps its rows to the cold store and the leaf stays in the
  trie with ``slot=None`` and a cold-block key.  A later lookup that lands
  on a cold leaf is *promoted*: the engine swaps the block into the new
  request's own slot (consuming the leaf — retirement republishes the
  longer prefix hot).  Hot leaves always win lookups over cold ones, cold
  leaves never hold pool slots (no ledger entry, no ``row_budget`` rows —
  the cold store budgets them), and strictly-covered cold leaves drop with
  their covering publish like hot ancestors do.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.kvcache import SlotLedger


class _Node:
    __slots__ = ("edge", "children", "leaf", "parent")

    def __init__(self, edge: tuple = (), parent: "Optional[_Node]" = None):
        self.edge = tuple(edge)
        self.children: dict[int, _Node] = {}
        self.leaf: Optional[_Leaf] = None
        self.parent = parent


class _Leaf:
    __slots__ = ("tokens", "slot", "n_rows", "last_used", "node", "cold")

    def __init__(self, tokens: tuple, slot: int, node: _Node, tick: int):
        self.tokens = tokens
        self.slot = slot                  # pool slot (None once demoted)
        self.n_rows = len(tokens)
        self.last_used = tick
        self.node = node
        self.cold = None                  # cold-store key once demoted

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        tier = f"slot={self.slot}" if self.slot is not None \
            else f"cold={self.cold!r}"
        return (f"_Leaf({tier}, n_rows={self.n_rows}, "
                f"last_used={self.last_used})")


class RadixPrefixCache:
    """Trie index over token-id prefixes -> committed slot rows.

    ``row_budget`` caps the total claimed rows (LRU eviction keeps the
    cache under it; writer-held leaves may transiently overshoot).
    ``free_slot`` is the scheduler's callback for a slot whose refcount
    dropped to zero (heap push); reclaimed slots are returned directly
    instead.
    """

    def __init__(self, row_budget: int,
                 free_slot: Callable[[int], None] | None = None):
        if row_budget < 1:
            raise ValueError("prefix-cache row budget must be >= 1")
        self.row_budget = row_budget
        self._free = free_slot or (lambda slot: None)
        self.root = _Node()
        self.ledger = SlotLedger()
        self._slots: dict[int, _Leaf] = {}       # slot -> its leaf
        self._writers: set[int] = set()          # slots with an active alias
        self.cached_rows = 0
        self._clock = 0
        self._cold: dict[object, _Leaf] = {}     # cold key -> its leaf
        self._demote = None                      # engine swap-out callback
        self._cold_drop = None                   # engine block-drop callback
        self._next_cold_id = 0
        self.stats = {"publishes": 0, "rejects": 0, "evictions": 0,
                      "reclaims": 0, "aliases": 0, "demotions": 0,
                      "promotions": 0, "cold_drops": 0}

    # -- cold tier ---------------------------------------------------------
    def attach_cold_tier(self, demote, drop) -> None:
        """Wire the tiered-pool swap layer in: ``demote(slot, n_rows, key)``
        swaps a leaf's rows out to the cold store (returns False when the
        store refuses — the leaf drops as before), ``drop(key)`` discards a
        cold block whose leaf died (covered by a deeper publish, or
        ``clear``)."""
        self._demote = demote
        self._cold_drop = drop

    @property
    def n_cold_leaves(self) -> int:
        return len(self._cold)

    # -- internals --------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, tokens: tuple, limit: int) -> tuple[_Node, int]:
        """Greedy descent along ``tokens[:limit]``.  Returns ``(node, i)``:
        ``i`` tokens matched, and every leaf in ``node``'s subtree shares
        that matched prefix (partial edge matches descend into the child —
        its leaves continue the edge, which still extends the match)."""
        node, i = self.root, 0
        while i < limit:
            child = node.children.get(tokens[i])
            if child is None:
                break
            e = child.edge
            m = 0
            while m < len(e) and i + m < limit and e[m] == tokens[i + m]:
                m += 1
            i += m
            node = child
            if m < len(e):
                break
        return node, i

    def _best_leaf(self, node: _Node,
                   hot_only: bool = False) -> Optional[_Leaf]:
        """Most recently used leaf in ``node``'s subtree (LRU-friendly and
        deterministic: ties break toward the lower slot).  A hot leaf
        always beats a cold one — serving from pool rows is free, a cold
        hit pays a swap-in — and ``hot_only`` skips cold leaves entirely
        (publish covers and reclaim protection only care about pool rows)."""
        best_hot = best_cold = None
        stack = [node]
        while stack:
            cur = stack.pop()
            leaf = cur.leaf
            if leaf is not None:
                if leaf.slot is not None:
                    if (best_hot is None
                            or (leaf.last_used, -leaf.slot)
                            > (best_hot.last_used, -best_hot.slot)):
                        best_hot = leaf
                elif not hot_only:
                    if (best_cold is None
                            or leaf.last_used > best_cold.last_used):
                        best_cold = leaf
            stack.extend(cur.children.values())
        return best_hot if best_hot is not None else best_cold

    def _drop_leaf(self, leaf: _Leaf) -> None:
        leaf.node.leaf = None
        del self._slots[leaf.slot]
        self.cached_rows -= leaf.n_rows
        self._prune(leaf.node)

    def _prune(self, node: _Node) -> None:
        """Detach empty nodes / merge single-child runs back into edges."""
        while node is not self.root and node.leaf is None:
            parent = node.parent
            if not node.children:
                del parent.children[node.edge[0]]
            elif len(node.children) == 1:
                (child,) = node.children.values()
                child.edge = node.edge + child.edge
                child.parent = parent
                parent.children[child.edge[0]] = child
            else:
                break
            node = parent

    def _evict(self, leaf: _Leaf, *, reclaim: bool = False,
               demote: bool = True) -> int:
        """Remove a claim-only leaf's slot hold; frees (or returns) the
        slot.  With a cold tier attached the leaf is *demoted* first —
        its rows swap out and the leaf survives in the trie as a cold
        leaf — unless ``demote=False`` (a strictly-covered ancestor or an
        adopted reclaim: the rows live on hot, a cold copy is worthless)
        or the swap-out fails (cold store full), in which case the leaf
        drops exactly as without a cold tier."""
        slot = leaf.slot
        if demote and self._demote is not None and self._demote_leaf(leaf):
            pass                                 # leaf lives on cold
        else:
            self._drop_leaf(leaf)
        left = self.ledger.decref(slot)
        assert left == 0, f"evicted leaf on slot {slot} still held ({left})"
        self.stats["reclaims" if reclaim else "evictions"] += 1
        if not reclaim:
            self._free(slot)
        return slot

    def _demote_leaf(self, leaf: _Leaf) -> bool:
        """Swap a hot leaf's rows to the cold store; on success the leaf
        stays in the trie with ``slot=None`` and the cold-block key."""
        key = ("leaf", self._next_cold_id)
        self._next_cold_id += 1
        if not self._demote(leaf.slot, leaf.n_rows, key):
            return False
        del self._slots[leaf.slot]
        self.cached_rows -= leaf.n_rows
        leaf.slot = None
        leaf.cold = key
        self._cold[key] = leaf
        self.stats["demotions"] += 1
        return True

    def _drop_cold_leaf(self, leaf: _Leaf, *, drop_block: bool = True,
                        prune: bool = True) -> None:
        """Remove a cold leaf from the trie; ``drop_block`` also discards
        its block from the store (False when the store already evicted it,
        or when the caller — promotion — takes the block over).  ``prune``
        is False when the caller is about to attach a new leaf to the same
        node — pruning would detach the node the new leaf lives on."""
        key = leaf.cold
        del self._cold[key]
        leaf.node.leaf = None
        leaf.cold = None
        if prune:
            self._prune(leaf.node)
        if drop_block and self._cold_drop is not None:
            self._cold_drop(key)

    def drop_cold(self, key) -> None:
        """The cold store LRU-evicted this leaf's block to make room (the
        engine relays the eviction): drop the now-backless trie leaf."""
        leaf = self._cold.get(key)
        if leaf is not None:
            self._drop_cold_leaf(leaf, drop_block=False)
            self.stats["cold_drops"] += 1

    def promote(self, leaf: _Leaf):
        """Consume a cold leaf for a warm admission: the leaf leaves the
        trie and its cold key is returned — the engine pops the block and
        swaps it into the request's own slot (retirement republishes the
        longer prefix hot)."""
        assert leaf.slot is None and leaf.cold is not None
        key = leaf.cold
        self._drop_cold_leaf(leaf, drop_block=False)
        self.stats["promotions"] += 1
        return key

    def _evictable(self) -> list[_Leaf]:
        return [l for l in self._slots.values()
                if self.ledger.count(l.slot) == 1]

    # -- admission-side API ------------------------------------------------
    def lookup(self, tokens, max_rows: int) -> tuple[Optional[_Leaf], int]:
        """Longest cached prefix of ``tokens`` usable up to ``max_rows``
        rows.  Returns ``(leaf, n)``: the first ``n`` rows of
        ``leaf.slot`` hold the KV of ``tokens[:n]`` (``(None, 0)`` on a
        miss).  Bumps the leaf's LRU stamp."""
        tokens = tuple(tokens)
        node, i = self._walk(tokens, min(max_rows, len(tokens)))
        if i < 1:
            return None, 0
        leaf = self._best_leaf(node)
        if leaf is None:                         # pragma: no cover - guard
            return None, 0
        leaf.last_used = self._tick()
        return leaf, min(i, leaf.n_rows)

    def alias_slot(self, tokens, max_rows: int) -> Optional[int]:
        """Zero-copy admission: if the longest usable match consumes an
        entire leaf whose slot nobody else holds, take a writer hold and
        return that slot — the request decodes in place on the cached rows.
        The exact-leaf condition keeps one physical slot per leaf and makes
        the engine's own lookup agree (``leaf_for(slot)`` resolves the
        match), so no gather ever writes into an aliased leaf."""
        tokens = tuple(tokens)
        node, i = self._walk(tokens, min(max_rows, len(tokens)))
        if (i < 1 or node.leaf is None or node.leaf.slot is None
                or node.leaf.n_rows != i):
            return None                          # no hot exact-leaf match
        leaf = node.leaf
        if self.ledger.count(leaf.slot) != 1:
            return None                          # shared or already aliased
        self.ledger.incref(leaf.slot)            # writer hold
        self._writers.add(leaf.slot)
        leaf.last_used = self._tick()
        self.stats["aliases"] += 1
        return leaf.slot

    def leaf_for(self, slot: int) -> Optional[_Leaf]:
        return self._slots.get(slot)

    def manages(self, slot: int) -> bool:
        return slot in self._slots

    def release_writer(self, slot: int) -> None:
        """Drop an alias writer hold (cancel / preempt / failed admission /
        retire-without-publish).  The leaf claim stays — the cached prefix
        survives its writer — and the double-free guard in the ledger
        catches an unmatched release."""
        if slot not in self._writers:
            raise RuntimeError(
                f"slot {slot}: writer release without an active alias")
        self._writers.discard(slot)
        left = self.ledger.decref(slot)
        if left == 0:                            # pragma: no cover - guard
            self._free(slot)

    # -- retirement-side API -----------------------------------------------
    def publish(self, tokens, slot: int, n_rows: int) -> bool:
        """Insert ``tokens[:n_rows]`` -> ``slot`` at retirement.  Returns
        True when the cache took ownership of the slot (leaf claim held;
        the scheduler must not free it).  Rejects prefixes already covered
        by an equal-or-deeper leaf (the cover's LRU stamp is bumped) and
        prefixes over the row budget; evicts claim-only ancestors the new
        leaf strictly covers, then LRU leaves until back under budget."""
        tokens = tuple(tokens[:n_rows])
        n_rows = len(tokens)
        if n_rows < 1 or n_rows > self.row_budget:
            self.stats["rejects"] += 1
            return False
        node, i = self._walk(tokens, n_rows)
        if i == n_rows:
            # only a HOT equal-or-deeper leaf rejects: a cold cover's rows
            # cost a swap-in, so rows in hand always publish (the covered
            # cold leaves drop below, with the other strict covers)
            cover = self._best_leaf(node, hot_only=True)
            if cover is not None:
                cover.last_used = self._tick()
                self.stats["rejects"] += 1
                return False
        # descend again, splitting/creating nodes, collecting ancestor leaves
        ancestors: list[_Leaf] = []
        cur, j = self.root, 0
        while j < n_rows:
            if cur.leaf is not None:
                ancestors.append(cur.leaf)
            child = cur.children.get(tokens[j])
            if child is None:
                child = _Node(tokens[j:], parent=cur)
                cur.children[tokens[j]] = child
                cur, j = child, n_rows
                break
            e = child.edge
            m = 0
            while m < len(e) and j + m < n_rows and e[m] == tokens[j + m]:
                m += 1
            j += m
            if m == len(e):
                cur = child
                continue
            mid = _Node(e[:m], parent=cur)       # split the edge at m
            cur.children[e[0]] = mid
            child.edge = e[m:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            cur = mid
            if j < n_rows:
                tail = _Node(tokens[j:], parent=mid)
                mid.children[tokens[j]] = tail
                cur, j = tail, n_rows
            break
        assert j == n_rows, "publish descent fell short"
        if cur.leaf is not None:
            # an equal-prefix COLD leaf: the hot rows in hand replace it
            # (a hot equal leaf would have rejected above); prune=False —
            # the new leaf is about to land on this very node
            assert cur.leaf.slot is None, "covered prefix slipped in"
            self._drop_cold_leaf(cur.leaf, prune=False)
            self.stats["cold_drops"] += 1
        leaf = _Leaf(tokens, slot, cur, self._tick())
        cur.leaf = leaf
        self.ledger.incref(slot)                 # the new leaf claim
        self._slots[slot] = leaf  # may transiently shadow an old same-slot leaf
        self.cached_rows += n_rows
        self.stats["publishes"] += 1
        # an aliased writer retiring on its own leaf's slot: the old
        # (shorter) leaf is among the ancestors and hands its claim over
        for anc in ancestors:
            if anc.slot is None:
                # a strictly-covered cold leaf: its block is a prefix of
                # the new hot rows — worthless, free the cold budget
                self._drop_cold_leaf(anc)
                self.stats["cold_drops"] += 1
            elif anc.slot == slot:
                anc.node.leaf = None
                self.cached_rows -= anc.n_rows
                self._prune(anc.node)
                self.ledger.decref(slot)
            elif self.ledger.count(anc.slot) == 1:
                # strictly covered: free the slot, never demote (the rows
                # are a prefix of the new leaf's — a cold copy is dead)
                self._evict(anc, demote=False)
        if slot in self._writers:                # retiring writer's hold
            self._writers.discard(slot)
            self.ledger.decref(slot)
        while self.cached_rows > self.row_budget:
            lru = [l for l in self._evictable() if l is not leaf]
            if not lru:
                break                            # writer-held leaves linger
            self._evict(min(lru, key=lambda l: l.last_used))
        return True

    # -- eviction / reclaim -------------------------------------------------
    def has_reclaimable(self) -> bool:
        return bool(self._evictable())

    def reclaim_slot(self, protect_tokens=None,
                     max_rows: int = 0) -> tuple[Optional[int], int]:
        """Evict a claim-only leaf and hand its slot straight to the caller
        (admission under slot pressure — cache rows yield to live work
        before any resident is preempted).  Returns ``(slot, adopted)``.

        ``protect_tokens`` is the incoming request's prompt: the leaf that
        best matches it is spared (evicting the rows the request is about
        to reuse would turn its own warm start cold) — LRU runs over the
        *other* claim-only leaves.  When the match is the only reclaimable
        leaf, its slot is **adopted**: the leaf is evicted but ``adopted``
        reports how many of its rows already hold the request's prefix KV,
        so the admission still starts warm — in its own slot, zero copies.
        """
        lru = self._evictable()
        if not lru:
            return None, 0
        protected, n_match = None, 0
        if protect_tokens is not None and max_rows >= 1:
            tokens = tuple(protect_tokens)
            node, i = self._walk(tokens, min(max_rows, len(tokens)))
            if i >= 1:
                best = self._best_leaf(node, hot_only=True)
                if best is not None:
                    protected, n_match = best, min(i, best.n_rows)
        others = [l for l in lru if l is not protected]
        if others:
            # the reclaimed slot's rows are about to be overwritten by the
            # new resident — demoting first is exactly what keeps warm
            # prefixes alive under slot pressure
            slot = self._evict(min(others, key=lambda l: l.last_used),
                               reclaim=True)
            return slot, 0
        # last resort: the only reclaimable leaf IS the match — adopt its
        # slot (the prefix rows are already in place; no gather needed, and
        # no demotion: the rows keep serving the request hot)
        slot = self._evict(protected, reclaim=True, demote=False)
        return slot, n_match

    def drop_slot(self, slot: int) -> bool:
        """Fault path (lost plane — serve/faults.py): the rows on ``slot``
        are gone, so a claim-only leaf living there is dropped outright —
        no demotion, there is nothing valid to swap out.  Returns True
        when a leaf was dropped."""
        leaf = self._slots.get(slot)
        if leaf is None or self.ledger.count(slot) != 1:
            return False
        self._evict(leaf, demote=False)
        return True

    def drop_hot(self) -> int:
        """Fault path (pool rebuild): every hot leaf's rows died with the
        donated pool, so all claim-only leaves drop (slots return through
        the free callback).  Cold (demoted) leaves survive — their blocks
        live host-side and promote as usual.  Returns the drop count."""
        n = 0
        for leaf in list(self._evictable()):
            self._evict(leaf, demote=False)
            n += 1
        return n

    def clear(self) -> int:
        """Evict every claim-only leaf (slots return through the free
        callback) and drop every cold leaf (blocks discarded from the
        store); writer-held leaves stay.  Returns the eviction count —
        benches call this after compile-warming so the measured run starts
        from an empty trie."""
        n = 0
        for leaf in list(self._evictable()):
            self._evict(leaf, demote=False)
            n += 1
        for leaf in list(self._cold.values()):
            self._drop_cold_leaf(leaf)
            self.stats["cold_drops"] += 1
            n += 1
        return n

    # -- introspection ------------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self._slots)
