"""Serving engines: the paper's offload pipeline as a runnable system.

PyTorch counterpart of ``repro.serve.engine`` for the plain decode path.
``prefill`` is the "GPU stage" (full-precision summarization); its K/V land
quantized in the int8 SLC cache; decode loops the W8A8 PIM path.

* ``Engine`` — the paper's single-batch setting: one fixed batch of
  same-length prompts, prefill once, decode in lockstep.
* ``ContinuousBatchingEngine`` — a request queue + slot scheduler admits
  variable-length prompts (greedy, FIFO, one atomic bucketed prefill per
  admission), packs active requests into decode slots (rows of the pooled
  SLC cache at heterogeneous positions), retires finished sequences and
  backfills freed slots mid-flight.  The decode step always sees a fixed
  [n_slots] batch.  With ``spec_k`` (linear) or ``spec_tree`` (draft tree)
  every decode step is a speculative verify step instead: a drafter
  proposes tokens per slot, one batched verify pass scores them, each slot
  commits its accepted prefix (or root-path) plus one token of its own,
  and the cursors roll back over the rejected rows.  A linear verify row
  scores exactly as the sequential decode step would (a tree row past a
  skipped sibling up to the attention's summation order, as in the
  reference), so greedy speculation emits the plain lane's streams.

An SSM stack prefills at exact length (no bucket: padding would run
through the recurrent state) and keeps the one-token decode loop: its
state cannot rewind, so ``spec_k``, ``spec_tree``, ``chunk``,
``multi_step`` and the prefix cache are silently off there, as in the
reference.

The pool updates in place (the reference donates it); greedy tokens are
argmax'd on the device and only [n_slots] (verify: [n_slots, T]) int32
arrays cross to the host, through the metered ``_fetch`` / ``_push``
helpers (``xfer_bytes``, ``decode_xfer_bytes``).  Arguments of lanes not ported yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.device import resolve, set_float32_precision
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime
from repro_torch.serve.drafter import Drafter, make_drafter, tree_depths_ancestors
from repro_torch.serve.quantize import quantize_tree
from repro_torch.serve.scheduler import (FIFOPolicy, Request, RequestState,
                                         Scheduler)


DRAIN_STALL_LIMIT = 8     # idle iterations with work pending before drain() raises


class RequestFailedError(RuntimeError):
    """Raised by :meth:`ContinuousBatchingEngine.generate_all` when any
    request finished with ``.error`` set (failed admission/prefill).  The
    failed requests ride along in ``.failures``."""

    def __init__(self, failures: list[Request]):
        self.failures = failures
        super().__init__("; ".join(
            f"request {r.rid}: {r.error}" for r in failures))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _check_on(params: Any, device: torch.device) -> None:
    w = params["embed"]["w"]
    if w.device.type != device.type:
        raise ValueError(f"params live on {w.device}, engine runs on {device}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Engine:
    cfg: ModelConfig
    params: Any                       # float params (prefill path)
    rt: Runtime = dataclasses.field(default_factory=Runtime)
    max_len: int = 256
    quantize: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)
        set_float32_precision()
        T.check_supported(self.cfg)
        _check_on(self.params, self.device)
        self.qparams = quantize_tree(self.params) if self.quantize else self.params

    def generate(self, batch: dict, steps: int,
                 greedy: bool = True) -> tuple[torch.Tensor, dict]:
        """Prefill the prompt batch then generate ``steps`` greedy tokens.
        Returns (tokens [B, steps], per-stage timings)."""
        if not greedy:
            raise _not_ported("sampled decode", "A.7")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        t0 = time.perf_counter()
        logits, state = M.prefill(self.params, self.cfg, batch, self.max_len, self.rt)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0
        # KV handoff complete: decode runs against the quantized weights
        toks = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(steps):
            toks.append(tok)
            logits, state = M.decode_step(self.qparams, self.cfg, state, tok, self.rt)
            tok = torch.argmax(logits, -1).to(torch.int32)
        _sync(self.device)
        t_decode = time.perf_counter() - t0
        return (torch.stack(toks, dim=1),
                {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tpot_s": t_decode / max(1, steps)})


class ContinuousBatchingEngine:
    """Iteration-level scheduling over a fixed pool of decode slots.

    Each ``step()`` is one serving iteration: retire finished requests,
    admit queued requests into free slots in FIFO order (one atomic
    single-request prefill each, bucketed to multiples of
    ``prefill_bucket`` and masked to the true length, landing its int8 KV
    row in the pool), then one batched W8A8 decode step over all slots;
    slots with a DECODING resident emit their next greedy token, the others
    compute into masked garbage.  ``spec_k`` / ``spec_tree`` (with
    ``spec_branch`` and ``drafter``) turn that step into a speculative
    verify step; the tree lane takes precedence over the linear one."""

    def __init__(self, cfg: ModelConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 256, quantize: bool = True,
                 rt: Runtime | None = None, prefill_bucket: int = 16,
                 policy: Any = "fifo", chunk: int | None = None,
                 spec_k: int = 0, spec_tree: int = 0, spec_branch: int = 2,
                 drafter: str | Drafter | None = "ngram", multi_step: int = 1,
                 prefix_cache: bool = False, kv_swap: bool = False,
                 faults: Any = None, device: str | torch.device = "cuda"):
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = no speculation)")
        if spec_tree < 0:
            raise ValueError("spec_tree must be >= 0 (0 = no tree drafts)")
        if spec_tree > 30:
            # the ancestor bitmask is one int32 per window row: node w owns
            # bit w, the root bit 0, so spec_tree drafted nodes need bits
            # 1..spec_tree and bit 31 (the sign bit) stays unused
            raise ValueError("spec_tree must be <= 30 (int32 ancestor mask)")
        if spec_branch < 1:
            raise ValueError("spec_branch must be >= 1")
        self._has_ssm = T.has_ssm(cfg)
        if self._has_ssm:
            # an SSM stack's recurrent state cannot rewind or restart
            # mid-prompt: these lanes are silently off, as in the reference
            chunk, multi_step, prefix_cache, spec_k, spec_tree = None, 1, False, 0, 0
        for what, on, item in (("chunked prefill (chunk)", chunk is not None, "A.7"),
                               ("fused multi-step decode", multi_step != 1, "A.9"),
                               ("the prefix cache", prefix_cache, "A.10"),
                               ("the tiered KV pool (kv_swap)", kv_swap, "A.10"),
                               ("fault injection (faults)", faults, "A.10")):
            if on:
                raise _not_ported(what, item)
        if not (policy in (None, "fifo") or isinstance(policy, FIFOPolicy)):
            raise _not_ported(f"scheduling policy {policy!r}", "A.7")
        self.device = resolve(device)
        set_float32_precision()
        T.check_supported(cfg)
        _check_on(params, self.device)
        self.cfg = cfg
        self.params = params
        self.rt = rt or Runtime()
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.spec_k = int(spec_k)
        self.spec_tree = int(spec_tree)
        self.spec_branch = int(spec_branch)
        self.qparams = quantize_tree(params) if quantize else params
        self.scheduler = Scheduler(n_slots, max_len, policy)
        self.policy = self.scheduler.policy
        # headroom rows past max_len, so that a verify window starting at the
        # last live position never clamps back onto live rows
        rows = max_len + KV.pool_headroom(spec_k=self.spec_k, spec_tree=self.spec_tree)
        self.state = M.init_decode_state(cfg, n_slots, rows, self.device)
        self._last_tok = np.zeros((n_slots,), np.int32)
        self._slot_pos = np.zeros((n_slots,), np.int64)   # host cursor mirror
        self._next_rid = 0
        self._t0 = time.monotonic()
        self.stats = {"steps": 0, "decode_steps": 0, "prefill_tokens": 0,
                      "max_step_prefill_tokens": 0, "max_step_total_tokens": 0,
                      "verify_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
                      "xfer_bytes": 0, "decode_xfer_bytes": 0,
                      "device_s": 0.0, "step_s": 0.0}
        if self.spec_k or self.spec_tree:
            # the tree lane takes precedence, so the draft budget is the
            # window that runs; the histogram counts drafted tokens committed
            # per verify pass (0 .. budget)
            self._drafter = make_drafter(drafter, cfg)
            w = self.spec_tree if self.spec_tree else self.spec_k
            self.stats["spec_accept_hist"] = [0] * (w + 1)

    # -- request intake ---------------------------------------------------
    def submit(self, prompt: Iterable[int], max_new_tokens: int,
               eos_id: int | None = None,
               arrival_time: float | None = None, *,
               temperature: float = 0.0,
               deadline_s: float | None = None) -> Request:
        if temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if temperature > 0:
            raise _not_ported("sampled decode (temperature > 0)", "A.7")
        if deadline_s is not None:
            raise _not_ported("request deadlines", "A.10")
        req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_time=(self._now() if arrival_time is None
                                    else arrival_time))
        self._next_rid += 1
        self.scheduler.submit(req)
        return req

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def now(self) -> float:
        """Engine timebase (monotonic seconds since construction or
        :meth:`reset_clock`); every request timestamp comes from it."""
        return self._now()

    def reset_clock(self) -> None:
        self._t0 = time.monotonic()

    # -- host<->device transfer discipline --------------------------------
    def _fetch(self, x: torch.Tensor, decode: bool = False) -> np.ndarray:
        """Explicit device->host fetch (counted; timed as device wait)."""
        t0 = time.perf_counter()
        out = x.cpu().numpy()
        self.stats["device_s"] += time.perf_counter() - t0
        self.stats["xfer_bytes"] += out.nbytes
        if decode:
            self.stats["decode_xfer_bytes"] += out.nbytes
        return out

    def _push(self, arr: np.ndarray, decode: bool = False) -> torch.Tensor:
        """Explicit host->device transfer (counted)."""
        self.stats["xfer_bytes"] += arr.nbytes
        if decode:
            self.stats["decode_xfer_bytes"] += arr.nbytes
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _dev(self, fn, *args, **kwargs):
        """Dispatch device work under the device-time clock."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stats["device_s"] += time.perf_counter() - t0
        return out

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy next token per slot (or per verify row): argmax on the
        device, one int32 per slot (row) crosses (ties go to the lowest id,
        as in the reference)."""
        return self._fetch(torch.argmax(logits, -1).to(torch.int32), decode=True)

    # -- admission: prefill into a slot -----------------------------------
    def _bucket(self, n: int) -> int:
        if self._has_ssm:
            return n                       # exact: no padding through SSM state
        b = self.prefill_bucket
        return min(self.max_len, -(-n // b) * b)

    def _emit(self, req: Request, tok: int) -> None:
        """Append one token to a request's output and make it its slot's
        next input."""
        req.output.append(tok)
        req.replay_pos = len(req.output)
        self.policy.on_tokens(req, 1)
        self._last_tok[req.slot] = tok

    def _emit_first(self, req: Request, logits: torch.Tensor) -> None:
        """A request's prefill just completed: emit its first token and move
        it to DECODING."""
        tok = int(self._fetch(torch.argmax(logits, -1).to(torch.int32))[0])
        self._emit(req, tok)
        req.first_token_time = self._now()
        req.state = RequestState.DECODING
        self._slot_pos[req.slot] = req.prompt_len
        if req.should_stop():
            self._retire(req, self._now())            # budget of 1 token

    def _prefill_into_slot(self, req: Request, toks: np.ndarray, plen: int):
        batch = {"inputs": torch.from_numpy(toks).to(self.device)}
        if not self._has_ssm:
            batch["lengths"] = torch.tensor([plen], dtype=torch.int32,
                                            device=self.device)
        logits, one = M.prefill(self.params, self.cfg, batch, self.max_len, self.rt)
        T.write_slot(self.state, req.slot, one)
        return logits

    def _admit_atomic(self, req: Request) -> int:
        """One full-prompt prefill lands the int8 KV row.  A failed prefill
        frees the slot and fails the request instead of leaking the slot."""
        plen = req.prompt_len
        toks = np.zeros((1, self._bucket(plen)), np.int64)
        toks[0, :plen] = req.prompt
        try:
            logits = self._dev(self._prefill_into_slot, req, toks, plen)
        except (RuntimeError, ValueError) as e:
            self._fail(req, f"{type(e).__name__}: {e}")
            return 0
        req.prefill_pos = plen
        self._emit_first(req, logits)
        return plen

    def _retire(self, req: Request, now: float) -> None:
        self.scheduler.retire(req, now)

    def _fail(self, req: Request, error: str) -> None:
        self.scheduler.fail(req, self._now(), error=error)

    # -- one serving iteration --------------------------------------------
    def step(self) -> bool:
        """Run one engine iteration; returns True if any work was done."""
        t0 = time.perf_counter()
        try:
            return self._step()
        finally:
            self.stats["step_s"] += time.perf_counter() - t0

    def _step(self) -> bool:
        now = self._now()
        self.stats["steps"] += 1
        for req in list(self.scheduler.active.values()):
            if req.state is RequestState.DECODING and req.should_stop():
                self._retire(req, now)
        step_pf = 0
        for req in self.scheduler.admit(now):
            step_pf += self._admit_atomic(req)
        self.stats["prefill_tokens"] += step_pf
        self.stats["max_step_prefill_tokens"] = max(
            self.stats["max_step_prefill_tokens"], step_pf)
        dec = [(slot, r) for slot, r in self.scheduler.active.items()
               if r.state is RequestState.DECODING]
        self.stats["max_step_total_tokens"] = max(
            self.stats["max_step_total_tokens"], step_pf + len(dec))
        if not dec:
            return step_pf > 0
        self.stats["decode_steps"] += 1
        if self.spec_tree:
            self._spec_tree_decode(dec)
            return True
        if self.spec_k:
            self._spec_decode(dec)
            return True
        logits, self.state = self._dev(
            M.decode_step, self.qparams, self.cfg, self.state,
            self._push(self._last_tok, decode=True), self.rt)
        nxt = self._next_tokens(logits)
        now = self._now()
        for slot, req in dec:
            self._slot_pos[slot] += 1      # host mirror of the device cursor
            self._emit(req, int(nxt[slot]))
            if req.should_stop():
                self._retire(req, now)
        return True

    # -- speculative decode lane -------------------------------------------
    def _draft_for(self, req: Request) -> list[int]:
        """``spec_k`` draft tokens for one slot, from its committed context
        (the port has no preempt-replay yet, so there is no recorded tail to
        re-feed)."""
        return self._drafter.draft(req.prompt + req.output, self.spec_k)

    def _spec_decode(self, dec: list[tuple[int, Request]]) -> None:
        """One verify pass over the decode pool: feed [last committed token,
        k drafts] per slot, accept each slot's matching prefix, emit the
        first non-matching (or bonus) token, and roll the per-slot cursor
        back to the committed prefix (rejected rows die in place)."""
        k = self.spec_k
        toks = np.zeros((self.n_slots, k + 1), np.int32)
        toks[:, 0] = self._last_tok
        drafts: dict[int, list[int]] = {}
        for slot, req in dec:
            drafts[slot] = self._draft_for(req)
            toks[slot, 1:] = drafts[slot]
        logits, _, self.state = self._dev(
            M.verify_step, self.qparams, self.cfg, self.state,
            self._push(toks, decode=True), self.rt)
        self.stats["verify_steps"] += 1
        chosen = self._next_tokens(logits)
        now = self._now()
        for slot, req in dec:
            fed = drafts[slot]
            committed = 0                 # accepted K/V rows past toks[:, 0]
            for i in range(k + 1):
                # row i is the next-token choice after toks[slot, :i+1], valid
                # because reaching it means every earlier draft was accepted
                tok = int(chosen[slot, i])
                self._emit(req, tok)
                accepted = i < k and tok == fed[i]
                if i < k:
                    self.stats["spec_drafted"] += 1
                    self.stats["spec_accepted"] += int(accepted)
                if req.should_stop():
                    committed += int(accepted)
                    self._retire(req, now)
                    break
                if not accepted:
                    break
                committed += 1
            self.stats["spec_accept_hist"][committed] += 1
            self._slot_pos[slot] += 1 + committed
        self.state = T.rewind_pos(self.state, self._pos_device())

    def _spec_tree_decode(self, dec: list[tuple[int, Request]]) -> None:
        """One tree-verify pass over the decode pool: feed [root = last
        committed token, ``spec_tree`` tree-drafted nodes] per slot with
        per-row depths and ancestor bitmasks, walk the verified tree on the
        host for the longest accepted root-path, then move the path's
        scattered K/V rows into contiguous committed rows (``tree_commit``);
        the rejected branches die in place."""
        n = self.spec_tree
        Tw = n + 1
        toks = np.zeros((self.n_slots, Tw), np.int32)
        toks[:, 0] = self._last_tok
        # every batched row needs a valid topology: inactive slots verify a
        # dummy chain whose rows the commit leaves alone (keep = 0)
        depth = np.tile(np.arange(Tw, dtype=np.int32), (self.n_slots, 1))
        anc = np.tile(((1 << (np.arange(Tw) + 1)) - 1).astype(np.int32),
                      (self.n_slots, 1))
        parents: dict[int, list[int]] = {}
        for slot, req in dec:
            d_toks, parents[slot] = self._drafter.draft_tree(
                req.prompt + req.output, n, self.spec_branch)
            toks[slot, 1:] = d_toks
            depth[slot], anc[slot] = tree_depths_ancestors(parents[slot])
        logits, _, self.state = self._dev(
            M.verify_step, self.qparams, self.cfg, self.state,
            self._push(toks, decode=True), self.rt,
            depth=self._push(depth, decode=True), anc=self._push(anc, decode=True))
        self.stats["verify_steps"] += 1
        chosen = self._next_tokens(logits)
        # the commit's base: each slot's cursor before this window (window
        # node w's K/V row sits at base + w)
        base = np.asarray(self._slot_pos, np.int32)
        sel = np.zeros((self.n_slots, n), np.int32)
        keep = np.zeros((self.n_slots,), np.int32)
        now = self._now()
        for slot, req in dec:
            # children of each window node in draft order; siblings carry
            # distinct tokens, so the walk is unambiguous
            kids: dict[int, list[int]] = {}
            for i, p in enumerate(parents[slot]):
                kids.setdefault(p + 1, []).append(i + 1)
            cur = 0                        # window node whose row we read
            path: list[int] = []           # accepted nodes, root-path order
            while True:
                tok = int(chosen[slot, cur])
                self._emit(req, tok)
                nxt = next((c for c in kids.get(cur, ())
                            if int(toks[slot, c]) == tok), None)
                if kids.get(cur):
                    self.stats["spec_drafted"] += 1
                    self.stats["spec_accepted"] += int(nxt is not None)
                if req.should_stop():
                    if nxt is not None:    # the stopping token was drafted:
                        path.append(nxt)   # commit its row, as the linear
                    self._retire(req, now)         # lane's bonus accept
                    break
                if nxt is None:
                    break
                path.append(nxt)
                cur = nxt
            sel[slot, :len(path)] = path
            keep[slot] = len(path)
            self.stats["spec_accept_hist"][len(path)] += 1
            self._slot_pos[slot] += 1 + len(path)
        self.state = self._dev(
            M.tree_commit, self.state, self._push(base, decode=True),
            self._push(sel, decode=True), self._push(keep, decode=True),
            self._pos_device())

    def _pos_device(self) -> torch.Tensor:
        return self._push(np.asarray(self._slot_pos, np.int32), decode=True)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify steps accepted."""
        d = self.stats["spec_drafted"]
        return self.stats["spec_accepted"] / d if d else float("nan")

    # -- drive to completion ----------------------------------------------
    def drain(self) -> None:
        """Step until the queue and all slots are empty; ``DRAIN_STALL_LIMIT``
        consecutive no-work iterations with work pending raise instead of
        looping forever."""
        stalls = 0
        while self.scheduler.has_work():
            stalls = 0 if self.step() else stalls + 1
            if stalls >= DRAIN_STALL_LIMIT:
                stuck = [f"rid={r.rid}:{r.state.value}"
                         for r in list(self.scheduler.queue)
                         + list(self.scheduler.active.values())]
                raise RuntimeError(
                    f"drain() stalled: {stalls} consecutive iterations did no "
                    f"work but {len(stuck)} request(s) are still pending "
                    f"[{', '.join(stuck)}]")

    def generate_all(self, prompts: list[list[int]],
                     max_new_tokens: int | list[int],
                     eos_id: int | None = None, *,
                     raise_on_error: bool = True) -> list[list[int]]:
        """Submit a ragged batch of prompts, run to completion, return the
        outputs in submission order; any failed request raises
        :class:`RequestFailedError` unless ``raise_on_error=False``."""
        budgets = (max_new_tokens if isinstance(max_new_tokens, list)
                   else [max_new_tokens] * len(prompts))
        reqs = [self.submit(p, m, eos_id) for p, m in zip(prompts, budgets)]
        self.drain()
        failures = [r for r in reqs if r.error is not None]
        if failures and raise_on_error:
            raise RequestFailedError(failures)
        return [r.output for r in reqs]
