"""Serving engines: the paper's offload pipeline as a runnable system.

PyTorch counterpart of ``repro.serve.engine`` on one device.  ``prefill``
is the "GPU stage" (full-precision summarization); its K/V land quantized
in the int8 SLC cache; decode loops the W8A8 PIM path.

* ``Engine`` — the paper's single-batch setting: one fixed batch of
  same-length prompts, prefill once, decode in lockstep (greedy, or sampled
  from an explicit ``torch.Generator``).
* ``ContinuousBatchingEngine`` — a request queue and a slot scheduler admit
  variable-length prompts in the order of a pluggable policy (FIFO,
  priority with or without preemption, SJF, fair share), pack active
  requests into decode slots (rows of the pooled SLC cache at
  heterogeneous positions), retire finished sequences and backfill freed
  slots mid-flight.  The decode step always sees a fixed [n_slots] batch.
  Admission is one atomic bucketed prefill, or with ``chunk=c`` chunked
  prefill: each iteration packs the resident decode slots plus at most
  ``max_step_tokens - n_decoding`` prompt tokens, in chunks of at most c.
  A preempted request is recomputed: re-prefilled on re-admission and its
  recorded tokens replayed through the decode path, so it reproduces its
  unpreempted output.  Each request is greedy or samples on the host from
  its own seeded numpy stream (temperature, top-k), bit for bit as the
  reference does.  With ``multi_step=m`` the engine fuses m greedy decode
  iterations into one step whenever the pool is in pure decode steady
  state (no queue, no prefill, no replay, all greedy); an EOS or budget
  overshoot unwinds through the cursor rewind.  With ``spec_k`` (linear)
  or ``spec_tree`` (draft tree) every decode step is a speculative verify
  step instead: a drafter proposes tokens per slot, one batched verify
  pass scores them, each slot commits its accepted prefix (or root-path)
  plus one token of its own, and the cursors roll back over the rejected
  rows.  A linear verify row scores exactly as the sequential decode step
  would (a tree row past a skipped sibling up to the attention's summation
  order, as in the reference), so greedy speculation emits the plain
  lane's streams.

On the card every decode and verify step replays a CUDA graph captured
once over the pool and static input buffers (``models/graphs.py``), the
counterpart of the reference's compiled, donated steps, and a fused block
replays the decode step's graph m times with the argmax fed back on the
device; inputs are copied into those buffers.  Prefill stays eager.

An SSM stack prefills at exact length (no bucket: padding would run
through the recurrent state) and keeps the one-token decode loop: its
state cannot rewind, so ``spec_k``, ``spec_tree``, ``chunk``,
``multi_step`` and the prefix cache are silently off there, as in the
reference.

The pool updates in place (the reference donates it); greedy tokens are
argmax'd on the device and only [n_slots] (verify: [n_slots, T]; fused:
[n_slots, m]) int32 arrays cross to the host; sampled slots get a device
top-k pre-select ([n_slots, k] values and indices).  Every transfer goes
through the metered ``_fetch`` / ``_push`` helpers (``xfer_bytes``,
``decode_xfer_bytes``).  Arguments of lanes not ported yet raise
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
from repro_torch.models import graphs as G
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime
from repro_torch.serve.drafter import (Drafter, chain_parents, make_drafter,
                                       tree_depths_ancestors)
from repro_torch.serve.quantize import quantize_tree
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         SchedulingPolicy)


DRAIN_STALL_LIMIT = 8     # idle iterations with work pending before drain() raises
ADMIT_ERRORS = (RuntimeError, ValueError)   # a failed prefill fails one request


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


def device_topk(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest logits along the last axis, descending, ties lowest id
    first (the host's stable order), and their int32 ids."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


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
        self._steps: dict[int, G.ServeSteps] = {}     # batch -> captured step

    def _steps_for(self, batch: int) -> G.ServeSteps:
        steps = self._steps.get(batch)
        if steps is None:
            state = M.init_decode_state(self.cfg, batch, self.max_len, self.device)
            steps = self._steps[batch] = G.ServeSteps(self.qparams, self.cfg,
                                                      self.rt, state)
        return steps

    def generate(self, batch: dict, steps: int, greedy: bool = True,
                 generator: torch.Generator | None = None
                 ) -> tuple[torch.Tensor, dict]:
        """Prefill the prompt batch then generate ``steps`` tokens.  Returns
        (tokens [B, steps], per-stage timings).  ``greedy=False`` samples
        each step's token from the softmax of its logits with ``generator``
        (a ``torch.Generator`` on the engine's device), which it requires;
        its draws are torch's, not ``jax.random``'s."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) needs a torch.Generator "
                             "to sample from")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        t0 = time.perf_counter()
        logits, one = M.prefill(self.params, self.cfg, batch, self.max_len, self.rt)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0
        # KV handoff: the prefilled state lands in the captured step's pool,
        # and decode runs against the quantized weights
        step = self._steps_for(logits.shape[0])
        for full, row in zip(G.state_tensors(step.state), G.state_tensors(one)):
            full.copy_(row)
        del one
        toks = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(steps):
            toks.append(tok)
            step.tok.copy_(tok)
            logits, nxt = step.decode()
            if greedy:
                tok = nxt.clone()
            else:
                probs = torch.softmax(logits.to(torch.float32), -1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
        _sync(self.device)
        t_decode = time.perf_counter() - t0
        return (torch.stack(toks, dim=1),
                {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tpot_s": t_decode / max(1, steps)})


class ContinuousBatchingEngine:
    """Iteration-level scheduling over a fixed pool of decode slots.

    Each ``step()`` is one serving iteration:

      1. retire finished requests (slots freed for backfill);
      2. preempt residents the policy bumps back to the queue (only when
         the queue is blocked on slots), recompute-style: output is kept
         and replayed through the decode path on re-admission;
      3. admit queued requests into free slots in policy order;
      4. advance in-flight prefills: unchunked, one atomic single-request
         prefill per admission (bucketed to multiples of
         ``prefill_bucket`` and masked to the true length), landing its
         int8 KV row in the pool; chunked (``chunk=c``), PREFILLING slots
         consume ``[1, c]`` chunks at their ``prefill_pos`` cursor against
         a float K/V carry, within the iteration's token budget
         (``max_step_tokens`` minus one a resident decode slot), the last
         chunk quantizing the carry into the slot row and emitting the
         request's first token;
      5. one batched W8A8 decode step over all slots; slots with a
         DECODING resident emit their next token (greedy or sampled), the
         others compute into masked garbage.  ``spec_k`` / ``spec_tree``
         (with ``spec_branch`` and ``drafter``) turn it into a speculative
         verify step (the tree lane takes precedence, and either over
         ``multi_step``); ``multi_step`` fuses m of them in steady state."""

    def __init__(self, cfg: ModelConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 256, quantize: bool = True,
                 rt: Runtime | None = None, prefill_bucket: int = 16,
                 policy: str | SchedulingPolicy | None = "fifo",
                 chunk: int | None = None, max_step_tokens: int | None = None,
                 spec_k: int = 0, spec_tree: int = 0, spec_branch: int = 2,
                 drafter: str | Drafter | None = "ngram", multi_step: int = 1,
                 topk_preselect: bool = True, prefix_cache: bool = False,
                 kv_swap: bool = False, faults: Any = None,
                 device: str | torch.device = "cuda"):
        self._has_ssm = T.has_ssm(cfg)
        # an SSM stack's recurrent state cannot rewind or restart
        # mid-prompt: these lanes are silently off, as in the reference
        self.chunk = None if (chunk is None or self._has_ssm) else int(chunk)
        if self.chunk is not None and self.chunk < 1:
            raise ValueError("chunk must be >= 1")
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
        if multi_step < 1:
            raise ValueError("multi_step must be >= 1 (1 = per-token loop)")
        self.spec_k = 0 if self._has_ssm else int(spec_k)
        self.spec_tree = 0 if self._has_ssm else int(spec_tree)
        self.spec_branch = int(spec_branch)
        # the fused block unwinds an overshoot through the cursor rewind
        self.multi_step = 1 if self._has_ssm else int(multi_step)
        for what, on, item in (("the prefix cache", prefix_cache and not self._has_ssm,
                                "A.10"),
                               ("the tiered KV pool (kv_swap)", kv_swap, "A.10"),
                               ("fault injection (faults)", faults, "A.10")):
            if on:
                raise _not_ported(what, item)
        self.topk_preselect = bool(topk_preselect)
        if self.chunk:
            self.max_step_tokens = (max_step_tokens if max_step_tokens
                                    else n_slots + self.chunk)
            if self.max_step_tokens < n_slots + 1:
                raise ValueError(
                    f"max_step_tokens {self.max_step_tokens} leaves no room "
                    f"for prefill progress beside {n_slots} decode slots "
                    f"(need >= n_slots + 1)")
        else:
            self.max_step_tokens = max_step_tokens
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
        self.qparams = quantize_tree(params) if quantize else params
        self.scheduler = Scheduler(n_slots, max_len, policy)
        self.policy = self.scheduler.policy
        if self.spec_k or self.spec_tree:
            # the tree lane takes precedence, so the draft budget is the
            # window that runs
            self._drafter = make_drafter(drafter, cfg)
        # headroom rows past max_len, so that no lane's in-place appends
        # starting at the last live position clamp back onto live rows
        rows = max_len + KV.pool_headroom(spec_k=self.spec_k, spec_tree=self.spec_tree,
                                          multi_step=self.multi_step)
        self.state = M.init_decode_state(cfg, n_slots, rows, self.device)
        spec = bool(self.spec_k or self.spec_tree)
        self._steps = G.ServeSteps(
            self.qparams, cfg, self.rt, self.state, decode=not spec,
            verify=(self.spec_k + 1,) if self.spec_k and not self.spec_tree else (),
            tree=(self.spec_tree + 1,) if self.spec_tree else ())
        # the eager commits' static inputs
        self._pos_buf = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        if self.spec_tree:
            self._base_buf = torch.zeros_like(self._pos_buf)
            self._keep_buf = torch.zeros_like(self._pos_buf)
            self._sel_buf = torch.zeros((n_slots, self.spec_tree), dtype=torch.int32,
                                        device=self.device)
        self._last_tok = np.zeros((n_slots,), np.int32)
        self._slot_pos = np.zeros((n_slots,), np.int64)   # host cursor mirror
        self._carries: dict[int, dict] = {}                # slot -> prefill carry
        self._rngs: dict[int, np.random.Generator] = {}   # rid -> sampler
        self._next_rid = 0
        self._t0 = time.monotonic()
        self.stats = {"steps": 0, "decode_steps": 0, "prefill_tokens": 0,
                      "chunks": 0, "prefill_pieces": 0, "max_step_prefill_tokens": 0,
                      "max_step_total_tokens": 0, "preemptions": 0,
                      "verify_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
                      "multi_blocks": 0, "multi_tokens": 0,
                      "xfer_bytes": 0, "decode_xfer_bytes": 0,
                      "device_s": 0.0, "step_s": 0.0}
        if spec:
            # the histogram counts drafted tokens committed per verify pass
            w = self.spec_tree if self.spec_tree else self.spec_k
            self.stats["spec_accept_hist"] = [0] * (w + 1)

    # -- request intake ---------------------------------------------------
    def submit(self, prompt: Iterable[int], max_new_tokens: int,
               eos_id: int | None = None,
               arrival_time: float | None = None, *,
               priority: int = 0, user: str | None = None,
               temperature: float = 0.0, top_k: int | None = None,
               seed: int | None = None,
               deadline_s: float | None = None) -> Request:
        if temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if top_k is not None and top_k < 1:
            raise ValueError("top_k must be >= 1")
        if deadline_s is not None:
            raise _not_ported("request deadlines", "A.10")
        req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_time=(self._now() if arrival_time is None
                                    else arrival_time),
                      priority=priority, user=user, temperature=temperature,
                      top_k=top_k, seed=seed)
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
    def _fetch(self, x, decode: bool = False):
        """Explicit device->host fetch of a tensor or a tuple of tensors
        (counted; timed as device wait)."""
        t0 = time.perf_counter()
        out = (tuple(t.cpu().numpy() for t in x) if isinstance(x, tuple)
               else x.cpu().numpy())
        self.stats["device_s"] += time.perf_counter() - t0
        n = sum(a.nbytes for a in out) if isinstance(out, tuple) else out.nbytes
        self.stats["xfer_bytes"] += n
        if decode:
            self.stats["decode_xfer_bytes"] += n
        return out

    def _push(self, arr: np.ndarray, into: torch.Tensor,
              decode: bool = False) -> torch.Tensor:
        """Explicit host->device transfer into the static buffer ``into``
        (counted)."""
        self.stats["xfer_bytes"] += arr.nbytes
        if decode:
            self.stats["decode_xfer_bytes"] += arr.nbytes
        return into.copy_(torch.from_numpy(np.ascontiguousarray(arr)).reshape(into.shape))

    def _dev(self, fn, *args, **kwargs):
        """Dispatch device work under the device-time clock."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stats["device_s"] += time.perf_counter() - t0
        return out

    def _device_topk(self, logits: torch.Tensor, k: int):
        """The sampled path's device pre-select: [..., k] values and int32
        ids instead of full-vocab rows, in the host's stable order, so
        pre-selected sampling stays bit-identical to the full-vocab path."""
        return self._dev(device_topk, logits, k)

    # -- per-request sampling ---------------------------------------------
    def _rng_for(self, req: Request) -> np.random.Generator:
        rng = self._rngs.get(req.rid)
        if rng is None:
            seed = req.seed if req.seed is not None else req.rid
            rng = self._rngs[req.rid] = np.random.default_rng(seed)
        return rng

    def _draw_from(self, req: Request, idx: np.ndarray,
                   logits: np.ndarray) -> int:
        """One cumulative draw over candidate ids ``idx`` (ascending) with
        aligned f64 temperature-scaled logits.  One uniform per token, so a
        preempted request's replay re-consumes the stream identically."""
        z = logits - logits.max()
        p = np.exp(z)
        p /= p.sum()
        u = self._rng_for(req).random()
        j = min(int(np.searchsorted(np.cumsum(p), u, side="right")),
                len(idx) - 1)
        return int(idx[j])

    def _sample_token(self, req: Request, row: np.ndarray) -> int:
        """Next token for one slot from a full-vocab logits row: greedy
        argmax at temperature 0, else top-k temperature sampling from a
        per-request deterministic stream (seeded by ``req.seed``, falling
        back to the rid)."""
        if req.temperature <= 0:
            return int(row.argmax())
        logits = row.astype(np.float64) / req.temperature
        if req.top_k is not None and req.top_k < logits.size:
            # exactly top_k candidates: every id strictly above the k-th
            # largest value is in, and the ids tied at it fill the tail
            # lowest id first
            k = req.top_k
            part = np.argpartition(-logits, k - 1)[:k]
            vth = logits[part].min()
            above = np.nonzero(logits > vth)[0]
            ties = np.nonzero(logits == vth)[0][:k - above.size]
            idx = np.sort(np.concatenate([above, ties]))
        else:
            idx = np.arange(logits.size)
        return self._draw_from(req, idx, logits[idx])

    def _sample_candidates(self, req: Request, vals: np.ndarray,
                           idx: np.ndarray) -> int:
        """:meth:`_sample_token` over device-pre-selected candidates:
        ``vals``/``idx`` are the row's top-k logits descending (ties lowest
        id first), so the first ``req.top_k`` entries are exactly the
        full-vocab candidate set and the f64 softmax/cumsum below is
        bit-identical."""
        if req.temperature <= 0:
            return int(idx[0])                    # argmax == top-1
        k = len(idx) if req.top_k is None else min(req.top_k, len(idx))
        order = np.asarray(idx[:k])
        perm = np.argsort(order, kind="stable")   # ids back to ascending
        logits = vals[:k].astype(np.float64)[perm] / req.temperature
        return self._draw_from(req, order[perm], logits)

    def _preselect(self, dec: list[tuple[int, Request]]) -> int | None:
        """The pre-select width when every sampled slot has a bounded
        ``top_k`` (k < V; at k >= V it would ship the whole vocab twice),
        else None."""
        ks = [req.top_k for _, req in dec if req.temperature > 0]
        if self.topk_preselect and all(
                k is not None and k < self.cfg.vocab_size for k in ks):
            return max(ks)
        return None

    def _next_tokens(self, logits: torch.Tensor, argmax: torch.Tensor,
                     dec: list[tuple[int, Request]]) -> np.ndarray:
        """Next token per decoding slot from the [B, V] logits.  Greedy pools
        fetch the device argmax (one int32 a slot); sampled slots with
        bounded ``top_k`` get the device pre-select ([B, k] values and ids);
        only unbounded sampling ships whole rows."""
        if all(req.temperature <= 0 for _, req in dec):
            return self._fetch(argmax, decode=True)
        out = np.zeros((self.n_slots,), np.int64)
        kmax = self._preselect(dec)
        if kmax is not None:
            vals, idx = self._fetch(self._device_topk(logits, kmax), decode=True)
            for slot, req in dec:
                out[slot] = self._sample_candidates(req, vals[slot], idx[slot])
            return out
        rows = self._fetch(logits, decode=True).astype(np.float32)
        for slot, req in dec:
            out[slot] = self._sample_token(req, rows[slot])
        return out

    # -- admission: prefill into a slot -----------------------------------
    def _bucket(self, n: int) -> int:
        if self._has_ssm:
            return n                       # exact: no padding through SSM state
        b = self.prefill_bucket
        return min(self.max_len, -(-n // b) * b)

    def _first_token(self, req: Request, logits: torch.Tensor) -> int:
        """First token from the prefill logits ([1, V]): the device argmax
        for greedy, the pre-select for bounded sampling, the full row only
        for unbounded sampling."""
        if req.temperature <= 0:
            return int(self._fetch(torch.argmax(logits, -1).to(torch.int32))[0])
        if (self.topk_preselect and req.top_k is not None
                and req.top_k < self.cfg.vocab_size):
            vals, idx = self._fetch(self._device_topk(logits, req.top_k))
            return self._sample_candidates(req, vals[0], idx[0])
        return self._sample_token(req, self._fetch(logits)[0].astype(np.float32))

    def _emit_first(self, req: Request, logits: torch.Tensor) -> None:
        """A request's prefill just completed: emit its first token (or
        re-feed the recorded one when resuming after preemption) and move
        it to DECODING."""
        # the draw always runs, so a resumed request's sampling stream stays
        # aligned with its original run
        tok = self._first_token(req, logits)
        if req.output:                     # resumed: the recorded token wins
            tok = req.output[0]
            req.replay_pos = 1
        else:
            req.output.append(tok)
            req.replay_pos = len(req.output)
            req.first_token_time = self._now()
            self.policy.on_tokens(req, 1)
        req.state = RequestState.DECODING
        self._last_tok[req.slot] = tok
        # host mirror of the slot cursor: after prefill the cache holds
        # exactly the prompt
        self._slot_pos[req.slot] = req.prompt_len
        if req.replay_pos >= len(req.output) and req.should_stop():
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
        except ADMIT_ERRORS as e:
            self._fail(req, f"{type(e).__name__}: {e}")
            return 0
        req.prefill_pos = plen
        self.stats["prefill_pieces"] += T.prefill_pieces(self.cfg, toks.shape[1])
        self._emit_first(req, logits)
        return plen

    def _admit_chunked(self, req: Request) -> None:
        """Chunked admission: a cold float carry at cursor 0 (the warm,
        prefix-cache branch is ROADMAP A.10), as long as one-shot
        prefill's."""
        self._carries[req.slot] = self._dev(
            M.init_prefill_carry, self.cfg, T.carry_len(self.max_len), self.device)

    def _finalize_into_slot(self, slot: int, carry: dict) -> None:
        T.write_slot(self.state, slot,
                     M.finalize_prefill_carry(self.cfg, carry, self.max_len))

    def _run_chunk(self, req: Request, n: int) -> int:
        """Advance one PREFILLING slot by ``n`` prompt tokens (one [1, chunk]
        call; the tail beyond ``n`` is padding), finalizing into the pool on
        the last chunk.  Exception-safe like :meth:`_admit_atomic`."""
        slot = req.slot
        toks = np.zeros((1, self.chunk), np.int64)
        toks[0, :n] = req.prompt[req.prefill_pos:req.prefill_pos + n]
        try:
            logits, self._carries[slot] = self._dev(
                M.prefill_chunk, self.params, self.cfg, self._carries[slot],
                torch.from_numpy(toks).to(self.device), n, self.rt)
            self.stats["prefill_pieces"] += T.chunk_pieces(req.prefill_pos, n)
            req.prefill_pos += n
            self.stats["chunks"] += 1
            if req.prefill_pos >= req.prompt_len:
                self._dev(self._finalize_into_slot, slot, self._carries.pop(slot))
                self._emit_first(req, logits)
        except ADMIT_ERRORS as e:
            self._carries.pop(slot, None)
            self._fail(req, f"{type(e).__name__}: {e}")
            return 0
        return n

    def _preempt(self, req: Request, now: float) -> None:
        """Bump a resident back to the queue, recompute-style (the tiered
        pool's swap path is ROADMAP A.10): re-admission re-prefills the
        prompt and replays the kept tokens."""
        self._carries.pop(req.slot, None)
        self._rngs.pop(req.rid, None)      # the replay re-consumes the stream
        self.scheduler.preempt(req, now, swapped_rows=0)
        self.stats["preemptions"] += 1

    def _retire(self, req: Request, now: float) -> None:
        self.scheduler.retire(req, now)
        self._rngs.pop(req.rid, None)      # release the per-request sampler

    def _fail(self, req: Request, error: str) -> None:
        if req.slot is not None:           # died mid-chunk: drop its carry
            self._carries.pop(req.slot, None)
        self.scheduler.fail(req, self._now(), error=error)
        self._rngs.pop(req.rid, None)

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
        step_pf = 0
        for req in list(self.scheduler.active.values()):
            if (req.state is RequestState.DECODING
                    and req.replay_pos >= len(req.output)
                    and req.should_stop()):
                self._retire(req, now)
        # preemption only when the queue is blocked on slots
        if not self.scheduler.free_slots:
            for req in self.scheduler.preemption_victims(now):
                self._preempt(req, now)
        for req in self.scheduler.admit(now):
            if self.chunk:
                try:
                    self._admit_chunked(req)
                except ADMIT_ERRORS as e:
                    self._fail(req, f"{type(e).__name__}: {e}")
            else:
                step_pf += self._admit_atomic(req)
        if self.chunk:
            step_pf += self._run_chunks()
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
        elif self.spec_k:
            self._spec_decode(dec)
        elif self._can_fuse(dec):
            self._multi_decode(dec)
        else:
            self._decode(dec)
        return True

    def _run_chunks(self) -> int:
        """This iteration's chunked prefill work within the token budget:
        ``max_step_tokens`` minus one a resident decode slot, and one more
        reserved for each finalizing chunk, whose slot decodes in this same
        iteration (or the finalize waits).  Returns the prompt tokens run."""
        budget = self.max_step_tokens - sum(
            1 for r in self.scheduler.active.values()
            if r.state is RequestState.DECODING)
        done = 0
        for slot in sorted(self.scheduler.active):
            req = self.scheduler.active[slot]
            while budget > 0 and req.state is RequestState.PREFILLING:
                n = min(self.chunk, req.prompt_len - req.prefill_pos, budget)
                if req.prefill_pos + n >= req.prompt_len:
                    if n + 1 > budget:
                        n = budget - 1
                    if n <= 0:
                        break
                got = self._run_chunk(req, n)
                if not got:
                    break
                budget -= got + (1 if req.state is RequestState.DECODING else 0)
                done += got
        return done

    def _decode(self, dec: list[tuple[int, Request]]) -> None:
        """One decode step over the pool: each DECODING slot emits its next
        token, or re-feeds its next recorded one while it replays."""
        self._push(self._last_tok, self._steps.tok, decode=True)
        logits, argmax = self._dev(self._steps.decode)
        nxt = self._next_tokens(logits, argmax, dec)
        now = self._now()
        for slot, req in dec:
            self._slot_pos[slot] += 1      # host mirror of the device cursor
            if req.replay_pos < len(req.output):
                # resuming after preemption: this step recomputed a token
                # already emitted; re-feed the recorded one, no append
                tok = req.output[req.replay_pos]
                req.replay_pos += 1
                self._last_tok[slot] = tok
                continue
            tok = int(nxt[slot])
            req.output.append(tok)
            req.replay_pos = len(req.output)
            self._last_tok[slot] = tok
            self.policy.on_tokens(req, 1)
            if req.should_stop():
                self._retire(req, now)

    # -- fused multi-step decode lane ---------------------------------------
    def _can_fuse(self, dec: list[tuple[int, Request]]) -> bool:
        """Fuse only in pure decode steady state: no queued request, no
        in-flight prefill, every resident greedy and past its replay, so a
        fused block never defers a scheduling decision."""
        if self.multi_step <= 1 or self.scheduler.queue:
            return False
        if any(r.state is not RequestState.DECODING
               for r in self.scheduler.active.values()):
            return False
        return all(req.temperature <= 0 and req.replay_pos >= len(req.output)
                   for _, req in dec)

    def _multi_decode(self, dec: list[tuple[int, Request]]) -> None:
        """One fused block: ``multi_step`` greedy decode steps (replays of
        the decode step) with the argmax fed back on the device; the host
        sees only the
        [n_slots, m] int32 block.  A slot that stops mid-block commits its
        emitted prefix and the overshoot unwinds like a rejected
        speculative suffix: the cursor rewinds in place and the dead rows
        are overwritten by the slot's next resident."""
        m = self.multi_step
        self.stats["decode_steps"] += m - 1       # step() counted one
        self.stats["multi_blocks"] += 1
        self._push(self._last_tok, self._steps.tok, decode=True)
        blk = self._fetch(self._dev(self._steps.multi, m), decode=True)
        now = self._now()
        stopped_early = False
        block_tokens = 0
        for slot, req in dec:
            emitted = 0
            for i in range(m):
                tok = int(blk[slot, i])
                req.output.append(tok)
                req.replay_pos = len(req.output)
                self._last_tok[slot] = tok
                self.policy.on_tokens(req, 1)
                emitted += 1
                if req.should_stop():
                    self._retire(req, now)
                    break
            self._slot_pos[slot] += emitted
            self.stats["multi_tokens"] += emitted
            block_tokens += emitted
            stopped_early |= emitted < m
        # a fused iteration emits up to len(dec) * m tokens; it never runs
        # beside prefill work, so the chunked budget is unaffected
        self.stats["max_step_total_tokens"] = max(
            self.stats["max_step_total_tokens"], block_tokens)
        if stopped_early:
            self._dev(T.rewind_pos, self.state, self._pos_device())

    # -- speculative decode lanes -------------------------------------------
    def _row_token_fn(self, logits: torch.Tensor, argmax: torch.Tensor,
                      dec: list[tuple[int, Request]]):
        """Fetch the verify logits under the decode lane's transfer
        discipline and return a ``(req, slot, i) -> int`` row sampler: the
        [B, T] argmax for all-greedy pools, [B, T, kmax] values and ids for
        bounded-top-k sampled pools, the full [B, T, V] rows otherwise."""
        rows = greedy_tok = vals_h = idx_h = None
        if all(req.temperature <= 0 for _, req in dec):
            greedy_tok = self._fetch(argmax, decode=True)
        else:
            kmax = self._preselect(dec)
            if kmax is not None:
                vals_h, idx_h = self._fetch(self._device_topk(logits, kmax),
                                            decode=True)
            else:
                rows = self._fetch(logits, decode=True).astype(np.float32)

        def row_token(req: Request, slot: int, i: int) -> int:
            if greedy_tok is not None:
                return int(greedy_tok[slot, i])
            if rows is not None:
                return self._sample_token(req, rows[slot, i])
            return self._sample_candidates(req, vals_h[slot, i], idx_h[slot, i])

        return row_token

    def _draft_for(self, req: Request) -> list[int]:
        """``spec_k`` drafts for one slot.  A replaying (preempt-resumed)
        request drafts its own recorded tokens, perfect drafts, so replay
        advances k + 1 positions a verify step and stays token-identical;
        the tail past the recording comes from the drafter."""
        k = self.spec_k
        d = list(req.output[req.replay_pos:req.replay_pos + k])
        if len(d) < k:
            ctx = req.prompt + req.output[:req.replay_pos] + d
            d += self._drafter.draft(ctx, k - len(d))
        return d

    def _emit_row(self, req: Request, slot: int, i: int, row_token) -> tuple[int, bool]:
        """The token at verify row ``i`` of one slot: a replaying request
        re-feeds its recorded token (still drawing, and discarding, a sampled
        row so its stream stays aligned), others emit the model's.  Returns
        (token, replaying)."""
        replaying = req.replay_pos < len(req.output)
        if replaying:
            if req.temperature > 0:
                row_token(req, slot, i)
            tok = req.output[req.replay_pos]
            req.replay_pos += 1
        else:
            tok = row_token(req, slot, i)
            req.output.append(tok)
            req.replay_pos = len(req.output)
            self.policy.on_tokens(req, 1)
        self._last_tok[slot] = tok
        return tok, replaying

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
        self._push(toks, self._steps.window[k + 1], decode=True)
        logits, argmax = self._dev(self._steps.verify, k + 1)
        self.stats["verify_steps"] += 1
        row_token = self._row_token_fn(logits, argmax, dec)
        now = self._now()
        for slot, req in dec:
            fed = drafts[slot]
            committed = 0                 # accepted K/V rows past toks[:, 0]
            for i in range(k + 1):
                # row i is the next-token choice after toks[slot, :i+1], valid
                # because reaching it means every earlier draft was accepted
                tok, replaying = self._emit_row(req, slot, i, row_token)
                accepted = i < k and tok == fed[i]
                if not replaying and i < k:
                    self.stats["spec_drafted"] += 1
                    self.stats["spec_accepted"] += int(accepted)
                if req.replay_pos >= len(req.output) and req.should_stop():
                    committed += int(accepted)
                    self._retire(req, now)
                    break
                if not accepted:
                    break
                committed += 1
            self.stats["spec_accept_hist"][committed] += 1
            self._slot_pos[slot] += 1 + committed
        self._dev(T.rewind_pos, self.state, self._pos_device())

    def _tree_draft_for(self, req: Request) -> tuple[list[int], list[int]]:
        """(tokens, draft-space parents) of one slot's tree window.  A
        replaying request drafts its recorded tokens as a linear chain
        (perfect drafts), its tail from the drafter's chain; others get the
        drafter's tree."""
        n = self.spec_tree
        rec = list(req.output[req.replay_pos:req.replay_pos + n])
        if not rec:
            return self._drafter.draft_tree(req.prompt + req.output, n,
                                            self.spec_branch)
        if len(rec) < n:
            ctx = req.prompt + req.output[:req.replay_pos] + rec
            rec += self._drafter.draft(ctx, n - len(rec))
        return rec, chain_parents(n)

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
            d_toks, parents[slot] = self._tree_draft_for(req)
            toks[slot, 1:] = d_toks
            depth[slot], anc[slot] = tree_depths_ancestors(parents[slot])
        self._push(toks, self._steps.window[Tw], decode=True)
        self._push(depth, self._steps.depth[Tw], decode=True)
        self._push(anc, self._steps.anc[Tw], decode=True)
        logits, argmax = self._dev(self._steps.tree, Tw)
        self.stats["verify_steps"] += 1
        row_token = self._row_token_fn(logits, argmax, dec)
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
                tok, replaying = self._emit_row(req, slot, cur, row_token)
                nxt = next((c for c in kids.get(cur, ())
                            if int(toks[slot, c]) == tok), None)
                if not replaying and kids.get(cur):
                    self.stats["spec_drafted"] += 1
                    self.stats["spec_accepted"] += int(nxt is not None)
                if req.replay_pos >= len(req.output) and req.should_stop():
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
        self._dev(M.tree_commit, self.state,
                  self._push(base, self._base_buf, decode=True),
                  self._push(sel, self._sel_buf, decode=True),
                  self._push(keep, self._keep_buf, decode=True),
                  self._pos_device())

    def _pos_device(self) -> torch.Tensor:
        return self._push(np.asarray(self._slot_pos, np.int32), self._pos_buf,
                          decode=True)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of (non-replay) drafted tokens the verify steps accepted."""
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
