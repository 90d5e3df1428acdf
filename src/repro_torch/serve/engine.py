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
  lane's streams.  The drafter is a host one (``"ngram"``) or, on a
  configuration with DeepSeek-V3's MTP head, the model (``"mtp"``): it
  drafts every slot at once on the device, eagerly, from a hidden carry
  the engine keeps there (each slot's post-``ln_f`` hidden at the window
  row it emitted last, zeroed at a prefill or a restore).

On the card every decode and verify step replays a CUDA graph captured
once over the pool and static input buffers (``models/graphs.py``), the
counterpart of the reference's compiled, donated steps, and a fused block
replays the decode step's graph m times with the argmax fed back on the
device; inputs are copied into those buffers.  Prefill stays eager.

With ``prefix_cache=True`` (and ``chunk``) a radix trie over token-id
prefixes indexes retired requests' committed int8 rows
(``serve/prefix_cache.py``): an admission that shares a cached prefix
copies those rows into its slot (or takes the cached slot itself) and
resumes chunked prefill at the match instead of position 0.  With
``kv_swap=True`` the pool gets a cold tier (``serve/kv_swap.py``): a
preempted decoding resident's rows swap out to host memory when the
paper's modeled tier round trip beats replaying its tokens, and come back
verbatim on re-admission; with both on, an LRU-evicted prefix leaf is
demoted to the cold tier and promoted back by a later hit.

An SSM stack prefills at exact length (no bucket: padding would run
through the recurrent state) and keeps the one-token decode loop: its
state cannot rewind, so ``spec_k``, ``spec_tree``, ``chunk``,
``multi_step`` and the prefix cache are silently off there, as in the
reference.  An MLA stack runs every lane but the prefix cache (its latent
cannot seed the float carry), which is silently off there, as in the
reference.

The engine survives transient device errors as the reference does: a
step whose in-place pool update raised (or an injected failure) is retried
with backoff, each retry first rebuilding the pool from committed host
state (every resident recovers by cold re-read or recompute-replay, so its
stream stays token-identical).  The rebuild zeroes the pool's tensors in
place, so the captured steps stay valid.  ``faults=`` adds the seeded
fault injector (cold-block bit flips, step failures, lost slots) and the
ECC and checksum layer over the cold tier; a lost slot is quarantined.
``cancel()`` frees a request's slot at the next iteration boundary, and a
request past its ``deadline_s`` ends ``TIMEOUT``.

The pool updates in place (the reference donates it); greedy tokens are
argmax'd on the device and only [n_slots] (verify: [n_slots, T]; fused:
[n_slots, m]) int32 arrays cross to the host; sampled slots get a device
top-k pre-select ([n_slots, k] values and indices).  Every transfer goes
through the metered ``_fetch`` / ``_push`` helpers (``xfer_bytes``,
``decode_xfer_bytes``).  A family not ported yet raises
``NotImplementedError`` naming its ROADMAP item.

With a ``Runtime`` whose ``mesh`` is set both engines serve over a (data,
model) mesh of processes, one engine a rank, as the reference's sharded
engines do: each rank keeps only its blocks of the float tree (prefill),
the QLC tree (decode; resident experts with ``serve_resident_moe``) and
the slot pool (its slots over the data axes, its KV heads over ``model``;
``transformer.init_decode_block``).  ``params`` is a whole float tree
(quantized whole, then cut) or a rank's ``transformer.MeshParams``.  The
host scheduler runs the same on every rank (same trace, same decisions);
a prefill runs on every rank, replicated over the data axes, and the
slot's owner lands its row; the decode lanes' per-slot outputs (tokens,
the host sampler's logits or its top-k) are gathered over the data axes,
so every rank emits the same streams.  A mesh engine runs its steps
eagerly (its gloo collectives copy through host memory, which a CUDA
graph cannot hold); training on a mesh is ``train/train_step.py``
``jit_train_step``'s, over the same placements.  Every lane serves on a
mesh, for every family the port serves (``Engine`` for an
encoder-decoder):

* the tiered pool: a swapped-out row is whole and replicated on the host
  of every rank (``transformer.gather_slot_row``: the owners all-gather
  the heads over ``model``, the data owner broadcasts the row over the
  data axes), so the cold store, its checksums, injected flips and the
  NAND model see one device's bytes on every rank; a swap-in lands each
  rank's block of it (``write_slot``);
* the prefix cache: the trie and the ledger are host-side and the same on
  every rank; a cached prefix copied to a slot of another data owner moves
  point to point (``copy_slot_prefix``), and the warm carry takes the
  owner's rows broadcast over the data axes (``warm_prefill_carry``);
* faults: every rank builds the same injector, so injected failures land
  on the same step; each step's outcome (ok or failed, and the count of
  uncorrectable cold blocks) is agreed with a MAX over the whole mesh
  before a retry, and ranks that disagree raise.  A rank whose step raises
  outside an injection ends: its peers' next collective fails (or gloo's
  timeout bounds the wait);
* the clock: world rank 0 (the leader) owns every decision that reads a
  clock.  Before each iteration it broadcasts its time, the requests
  submitted to it since the last one (with their arrival times) and the
  cancellations it takes, and the followers apply them
  (:meth:`ContinuousBatchingEngine._sync_control`), so a streaming front
  end on the leader alone drives every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core.mapping import flash_tpot_for
from repro_torch.device import resolve, set_float32_precision
from repro_torch.dist import collectives as C
from repro_torch.ft.failures import StragglerWatchdog
from repro_torch.models import graphs as G
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime
from repro_torch.serve.drafter import (Drafter, chain_parents, make_drafter,
                                       tree_depths_ancestors)
from repro_torch.serve.faults import (ColdBlockCorrupt, FaultInjector,
                                      FaultTolerance, InjectedStepFailure,
                                      PoolConsumedError)
from repro_torch.serve.kv_swap import SwapManager, slot_template, to_host
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         SchedulingPolicy)


DRAIN_STALL_LIMIT = 8     # idle iterations with work pending before drain() raises
_STOP = "stop"            # the leader's control message that ends its followers


class _Stop(Exception):
    """A follower's control sync received the leader's stop message."""


class RequestFailedError(RuntimeError):
    """Raised by :meth:`ContinuousBatchingEngine.generate_all` when any
    request finished with ``.error`` set (failed admission/prefill).  The
    failed requests ride along in ``.failures``."""

    def __init__(self, failures: list[Request]):
        self.failures = failures
        super().__init__("; ".join(
            f"request {r.rid}: {r.error}" for r in failures))


def _check_on(params: Any, device: torch.device) -> None:
    if isinstance(params, T.MeshParams):
        params = params.params
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
        M.check_supported(self.cfg)
        _check_on(self.params, self.device)
        T.check_mesh(self.cfg, self.rt)
        self.params, self.qparams = T.place_params(self.cfg, self.params, self.quantize,
                                                   self.rt)
        self._steps: dict[int, G.ServeSteps] = {}     # batch -> captured step

    def _steps_for(self, batch: int) -> G.ServeSteps:
        steps = self._steps.get(batch)
        if steps is None:
            state = (M.init_decode_state(self.cfg, batch, self.max_len, self.device)
                     if self.rt.mesh is None else
                     M.init_decode_block(self.cfg, batch, self.max_len, self.rt, self.device))
            steps = self._steps[batch] = G.ServeSteps(self.qparams, self.cfg,
                                                      self.rt, state)
        return steps

    def generate(self, batch: dict, steps: int, greedy: bool = True,
                 generator: torch.Generator | None = None
                 ) -> tuple[torch.Tensor, dict]:
        """Prefill the prompt batch then generate ``steps`` tokens.  Returns
        (tokens [B, steps], per-stage timings).  ``batch["inputs"]`` may be
        [B, T, d] embeddings where the configuration takes them (float
        inputs land on the card as f32); decode then feeds token ids, as
        the reference's does.  An encoder-decoder's batch holds ``frames``
        [B, S_enc, d] and ``tokens`` [B, T].  ``greedy=False`` samples
        each step's token from the softmax of its logits with ``generator``
        (a ``torch.Generator`` on the engine's device), which it requires;
        its draws are torch's, not ``jax.random``'s."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) needs a torch.Generator "
                             "to sample from")
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        batch = {k: v.to(torch.float32) if v.is_floating_point() else v
                 for k, v in batch.items()}
        t0 = time.perf_counter()
        logits, one = M.prefill(self.params, self.cfg, batch, self.max_len, self.rt)
        _sync(self.device)
        t_prefill = time.perf_counter() - t0
        # KV handoff: the prefilled state lands in the captured step's pool,
        # and decode runs against the quantized weights
        step = self._steps_for(logits.shape[0])
        lo, hi, _ = step.state.get("block", (0, logits.shape[0], None))
        for full, row in zip(G.state_tensors(step.state), G.state_tensors(one)):
            full.copy_(row[lo:hi])          # on a mesh: the rank's slots
        del one
        toks = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(steps):
            toks.append(tok)
            step.tok.copy_(tok[lo:hi])
            logits, nxt = step.decode()
            logits = T.gather_rows(logits, step.state, self.rt)
            nxt = T.gather_rows(nxt, step.state, self.rt)
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
         ``multi_step``); ``multi_step`` fuses m of them in steady state.

    With the tiered pool on (``kv_swap``), preemption is a policy choice:
    a decoding victim's committed rows swap out to the cold tier when the
    modeled round trip beats recomputing them, and a swapped victim's
    re-admission restores its rows and resumes decoding without a
    prefill.  With the prefix cache on, admission reclaims a cached leaf's
    slot before any resident is preempted."""

    def __init__(self, cfg: ModelConfig, params: Any, *, n_slots: int = 4,
                 max_len: int = 256, quantize: bool = True,
                 rt: Runtime | None = None, prefill_bucket: int = 16,
                 policy: str | SchedulingPolicy | None = "fifo",
                 chunk: int | None = None, max_step_tokens: int | None = None,
                 spec_k: int = 0, spec_tree: int = 0, spec_branch: int = 2,
                 drafter: str | Drafter | None = "ngram", multi_step: int = 1,
                 topk_preselect: bool = True, prefix_cache: bool = False,
                 prefix_cache_rows: int | None = None, kv_swap: bool = False,
                 cold_rows: int | None = None,
                 drain_stall_limit: int = DRAIN_STALL_LIMIT,
                 faults: FaultInjector | bool | None = None, max_step_retries: int = 3,
                 retry_backoff_s: float = 0.02, watchdog_factor: float = 8.0,
                 device: str | torch.device = "cuda"):
        if cfg.family == "encdec":
            raise NotImplementedError("continuous batching targets decoder-only LMs")
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
        if drain_stall_limit < 1:
            raise ValueError("drain_stall_limit must be >= 1")
        self.drain_stall_limit = int(drain_stall_limit)
        if max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._watchdog = StragglerWatchdog(factor=watchdog_factor)
        # faults=True arms the checksums and the metered ECC pipeline with no
        # chaos source; an injector adds one.  The retry and rebuild
        # machinery in step() is always armed.
        self._injector = faults if isinstance(faults, FaultInjector) else None
        self._faults_on = bool(faults)
        self._ft = None
        self.topk_preselect = bool(topk_preselect)
        rt = rt or Runtime()
        T.check_mesh(cfg, rt)
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
        self.rt = rt
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.params, self.qparams = T.place_params(cfg, params, quantize, rt)
        self.scheduler = Scheduler(n_slots, max_len, policy)
        self.policy = self.scheduler.policy
        # the prefix cache: radix-indexed KV reuse over the slot pool, for
        # GQA attention stacks (SSM state cannot restart mid-prompt, and an
        # MLA latent cannot seed the float carry: silently off for both)
        self._pcache = None
        if prefix_cache and not self._has_ssm and cfg.attn_type != "mla":
            if self.chunk is None:
                raise ValueError(
                    "prefix_cache needs chunked prefill (chunk=c): warm "
                    "admissions resume the chunked cursor mid-prompt")
            self._pcache = RadixPrefixCache(prefix_cache_rows if prefix_cache_rows
                                            else n_slots * max_len)
            self.scheduler.attach_prefix_cache(self._pcache)
        self._h_last = None
        if self.spec_k or self.spec_tree:
            # the tree lane takes precedence, so the draft budget is the
            # window that runs
            self._drafter = make_drafter(
                drafter, cfg, self.rt, self.spec_tree or self.spec_k,
                tree_branch=self.spec_branch if self.spec_tree else None)
        # headroom rows past max_len, so that no lane's in-place appends
        # starting at the last live position clamp back onto live rows
        rows = max_len + KV.pool_headroom(spec_k=self.spec_k, spec_tree=self.spec_tree,
                                          multi_step=self.multi_step)
        self.state = (M.init_decode_state(cfg, n_slots, rows, self.device) if rt.mesh is None
                      else T.init_decode_block(cfg, n_slots, rows, rt, self.device))
        # the rank's slots of the pool (all of them off a mesh)
        self._lo, self._hi, _ = self.state.get("block", (0, n_slots, n_slots))
        # the tiered pool: hot slot rows stay in the pool above, the cold
        # tier holds swapped-out victims and demoted prefix leaves as host
        # blocks; the crossover prices a victim's replay at the paper's
        # modeled per-token decode cost
        self._swap = None
        if kv_swap:
            # a cold row is a whole row (every head) on every rank of a mesh
            self._swap = SwapManager(
                cold_rows if cold_rows is not None else n_slots * max_len,
                slot_template(self.state if rt.mesh is None
                              else M.init_decode_state(cfg, 1, rows, "meta")),
                replay_tpot_s=float(flash_tpot_for(cfg, context_len=max_len)["total"]))
        # (direction, bytes, seconds) of every block copy between the pool
        # and the cold tier, each timed between two device synchronizations
        self.swap_copies: list[tuple[str, int, float]] = []
        spec = bool(self.spec_k or self.spec_tree)
        self._steps = G.ServeSteps(
            self.qparams, cfg, self.rt, self.state, decode=not spec,
            verify=(self.spec_k + 1,) if self.spec_k and not self.spec_tree else (),
            tree=(self.spec_tree + 1,) if self.spec_tree else ())
        # the eager commits' static inputs
        self._pos_buf = torch.zeros((self._hi - self._lo,), dtype=torch.int32,
                                    device=self.device)
        if self.spec_tree:
            self._base_buf = torch.zeros_like(self._pos_buf)
            self._keep_buf = torch.zeros_like(self._pos_buf)
            self._sel_buf = torch.zeros((self._hi - self._lo, self.spec_tree),
                                        dtype=torch.int32, device=self.device)
        if spec and self._drafter.kind == "model":
            # the model drafter's inputs on the device: the hidden carry (the
            # post-ln_f hidden at each slot's last committed position, kept
            # on the card), the last tokens and, for each verify step, the
            # window row each slot emitted last (-1: the slot did not run)
            # (every slot's on every rank of a mesh: the drafts run the
            # MTP layer's MoE over all of them, as one device does)
            self._h_last = torch.zeros((n_slots, cfg.d_model), dtype=torch.float32,
                                       device=self.device)
            self._tok_buf = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
            self._hrow_buf = torch.zeros_like(self._tok_buf)
            self._dpos_buf = torch.zeros_like(self._tok_buf)
        self._last_tok = np.zeros((n_slots,), np.int32)
        self._slot_pos = np.zeros((n_slots,), np.int64)   # host cursor mirror
        self._carries: dict[int, dict] = {}                # slot -> prefill carry
        self._warm_rows: dict[int, int] = {}               # slot -> cached rows
        self._rngs: dict[int, np.random.Generator] = {}   # rid -> sampler
        self._next_rid = 0
        # cancellation inbox: cancel() only appends, so a server may call it
        # from another thread while step() runs; the next step drains it
        self._cancels: list[Request] = []
        # on a mesh: the whole world's group, the leader (world rank 0),
        # the submissions the leader took since its last broadcast, the
        # requests by rid (a follower applies the leader's cancellations by
        # rid), the cancellations and the time of the current iteration
        self._world = rt.mesh.group(rt.mesh.axis_names) if rt.mesh is not None else None
        self._leader = self._world is None or self._world.index == 0
        self._log: list[tuple[int, dict]] = []
        self._reqs: dict[int, Request] = {}
        self._step_cancels: list[Request] = []
        self._clock = 0.0
        # set from the start of an in-place pool update until it returns: a
        # call that raised left the pool in an unknown state (the reference's
        # failed donated call deletes its pool), which only a rebuild clears
        self._pool_dirty = False
        self._t0 = time.monotonic()
        # prefill pieces the admissions ran, each one norm launch a norm (the
        # card's launch accounting reads it; not a stat of the reference)
        self.prefill_pieces = 0
        self.stats = {"steps": 0, "decode_steps": 0, "prefill_tokens": 0,
                      "chunks": 0, "max_step_prefill_tokens": 0,
                      "max_step_total_tokens": 0, "preemptions": 0,
                      "verify_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
                      "multi_blocks": 0, "multi_tokens": 0,
                      "xfer_bytes": 0, "decode_xfer_bytes": 0,
                      "device_s": 0.0, "step_s": 0.0,
                      # the recovery machinery is always armed, so these
                      # counters always exist
                      "timeouts": 0, "slow_steps": 0, "step_failures": 0,
                      "step_retries": 0, "pool_rebuilds": 0}
        # the features' keys exist only when they are on, as in the reference
        if self._pcache is not None:
            self.stats.update({"prefix_hits": 0, "cached_tokens": 0,
                               "prefill_tokens_saved": 0})
        if self._swap is not None:
            self.stats.update({"swap_outs": 0, "swap_ins": 0,
                               "swap_out_bytes": 0, "swap_in_bytes": 0,
                               "swap_out_cycles": 0, "swap_in_cycles": 0,
                               "preempt_swaps": 0, "preempt_recomputes": 0})
        if self._faults_on:
            # the fault layer's ECC metering and recovery counters
            self.stats.update({"ecc_checks": 0, "ecc_pages": 0, "ecc_cycles": 0,
                               "ecc_corrected_bits": 0, "bitflips_injected": 0,
                               "uncorrectable_blocks": 0, "cold_rereads": 0,
                               "recovery_recomputes": 0, "slot_losses": 0,
                               "quarantined_slots": 0})
            self._ft = FaultTolerance(self.stats, self._injector)
            if self._swap is not None:
                self._swap.attach_faults(self._ft)
        if self._pcache is not None and self._swap is not None:
            # LRU pressure demotes prefix leaves to the cold tier instead of
            # dropping them; the store's evictions relay back as drop_cold
            self._pcache.attach_cold_tier(self._demote_leaf_rows, self._swap.drop)
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
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 when set")
        req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival_time=(self._now() if arrival_time is None
                                    else arrival_time),
                      priority=priority, user=user, temperature=temperature,
                      top_k=top_k, seed=seed, deadline_s=deadline_s)
        self._next_rid += 1
        self.scheduler.submit(req)
        if self._world is not None:
            self._reqs[req.rid] = req
            if self._leader:
                self._log.append((req.rid, dict(
                    prompt=req.prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    arrival_time=req.arrival_time, priority=priority, user=user,
                    temperature=temperature, top_k=top_k, seed=seed, deadline_s=deadline_s)))
        return req

    def _now(self) -> float:
        """The engine's time; a follower on a mesh reads the leader's, as of
        the current iteration (:meth:`_sync_control`)."""
        if not self._leader:
            return self._clock
        return time.monotonic() - self._t0

    def follow(self) -> None:
        """A follower's serve loop on a mesh: one :meth:`step` each time the
        leader steps (its front end drives the world), until the leader's
        :meth:`stop_followers`."""
        if self._leader:
            raise RuntimeError("follow() runs on a follower of a mesh (world rank > 0)")
        try:
            while True:
                self.step()
        except _Stop:
            pass

    def stop_followers(self) -> None:
        """The leader ends its followers' :meth:`follow` loops."""
        if self._world is not None and self._leader:
            C.broadcast_object(_STOP, self._world, 0)

    def _sync_control(self) -> None:
        """On a mesh, the leader's decisions for this iteration: its time,
        the requests submitted to it since its last broadcast (a follower
        submits those it lacks and takes the leader's arrival time for the
        rest) and the cancellations it takes now, broadcast from world rank
        0 and applied by every rank; the leader's straggler count too."""
        if self._world is None:
            return
        msg = None
        if self._leader:
            n = len(self._cancels)             # cancel() may append meanwhile
            take, self._cancels[:n] = self._cancels[:n], []
            msg = (self._now(), self._log, [r.rid for r in take], self.stats["slow_steps"])
            self._log = []
        msg = C.broadcast_object(msg, self._world, 0)
        if msg == _STOP:
            raise _Stop
        now, subs, cancels, slow = msg
        if not self._leader:
            self._clock = now
            for rid, kw in subs:
                req = self._reqs.get(rid)
                if req is None:
                    req = self.submit(**kw)
                    if req.rid != rid:
                        raise RuntimeError(f"follower's request {req.rid} is the leader's {rid}")
                else:
                    req.arrival_time = kw["arrival_time"]
            self.stats["slow_steps"] = slow
        self._clock = now
        self._step_cancels = [self._reqs[rid] for rid in cancels]

    def now(self) -> float:
        """Engine timebase (monotonic seconds since construction or
        :meth:`reset_clock`); every request timestamp comes from it."""
        return self._now()

    def reset_clock(self) -> None:
        self._t0 = time.monotonic()

    # -- host<->device transfer discipline --------------------------------
    def _fetch(self, x, decode: bool = False, rows: bool = True):
        """Explicit device->host fetch of a tensor or a tuple of tensors
        (counted; timed as device wait); ``rows``: a decode fetch's dim 0 is
        the rank's slots (not every slot's row already)."""
        t0 = time.perf_counter()
        if decode and rows:          # on a mesh: every slot's row, on every rank
            x = (tuple(T.gather_rows(t, self.state, self.rt) for t in x)
                 if isinstance(x, tuple) else T.gather_rows(x, self.state, self.rt))
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
        (counted: every slot's bytes, as one device moves them); on a mesh a
        per-slot array lands the rank's slots."""
        self.stats["xfer_bytes"] += arr.nbytes
        if decode:
            self.stats["decode_xfer_bytes"] += arr.nbytes
        if arr.shape[:1] == (self.n_slots,) and into.shape[0] != self.n_slots:
            arr = arr[self._lo:self._hi]
        return into.copy_(torch.from_numpy(np.ascontiguousarray(arr)).reshape(into.shape))

    def _dev(self, fn, *args, **kwargs):
        """Dispatch device work under the device-time clock."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stats["device_s"] += time.perf_counter() - t0
        return out

    def _in_place(self, fn, *args):
        """:meth:`_dev` for work that updates the pool in place (a replayed
        step, a slot write, a gather, a commit or a rewind): the pool counts
        as consumed until ``fn`` returns."""
        self._pool_dirty = True
        out = self._dev(fn, *args)
        self._pool_dirty = False
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
        if self._h_last is not None:
            self._h_last[req.slot].zero_()     # the MTP head runs from the embedding
        if req.replay_pos >= len(req.output) and req.should_stop():
            self._retire(req, self._now())            # budget of 1 token

    def _prefill(self, toks: np.ndarray, plen: int):
        batch = {"inputs": torch.from_numpy(toks).to(self.device)}
        if not self._has_ssm:
            batch["lengths"] = torch.tensor([plen], dtype=torch.int32,
                                            device=self.device)
        return M.prefill(self.params, self.cfg, batch, self.max_len, self.rt)

    def _admit_atomic(self, req: Request) -> int:
        """One full-prompt prefill lands the int8 KV row.  A failed prefill
        frees the slot and fails the request instead of leaking the slot
        (unless the failure left the pool consumed)."""
        plen = req.prompt_len
        toks = np.zeros((1, self._bucket(plen)), np.int64)
        toks[0, :plen] = req.prompt
        try:
            logits, one = self._dev(self._prefill, toks, plen)
            self._in_place(T.write_slot, self.state, req.slot, one)
        except Exception as e:                        # noqa: BLE001
            self._fail(req, f"{type(e).__name__}: {e}")
            self._check_pool_alive(e)
            return 0
        req.prefill_pos = plen
        self.prefill_pieces += T.prefill_pieces(self.cfg, toks.shape[1])
        self._emit_first(req, logits)
        return plen

    def _cold_carry(self, slot: int) -> None:
        self._warm_rows.pop(slot, None)
        self._carries[slot] = self._dev(
            M.init_prefill_carry, T.local_cfg(self.cfg, self.rt),
            T.carry_len(self.max_len, self.chunk), self.device)

    def _drop_carry(self, slot: int) -> None:
        self._carries.pop(slot, None)
        self._warm_rows.pop(slot, None)

    def _admit_chunked(self, req: Request) -> None:
        """Chunked admission: a float carry as long as one-shot prefill's,
        cold (zeros, cursor 0) or, on a prefix-cache hit, warm.

        A warm admission takes the longest cached prefix of the prompt
        (capped at ``prompt_len - 1``, so at least one token runs through
        chunked prefill and emits the first token): the rows are already in
        the slot when the scheduler aliased the cached leaf's slot or
        adopted it, a demoted (cold) leaf is swapped into the slot, and
        otherwise the matched rows are copied in from the leaf's slot.
        They dequantize into the carry, whose cursor starts at the match:
        ``prefill_pos`` moves past the cached tokens without running them,
        and the finalize writes only the rows past them."""
        if self._pcache is None:
            self._cold_carry(req.slot)
            return
        src = n_hit = None
        leaf = self._pcache.leaf_for(req.slot)
        if leaf is not None:                  # aliased: rows already here
            src, n_hit = req.slot, leaf.n_rows
        elif req.adopted_rows >= 1:           # reclaim adopted the match's
            src, n_hit = req.slot, req.adopted_rows   # slot: rows in place
        else:
            hit, n = self._pcache.lookup(req.prompt, req.prompt_len - 1)
            if hit is not None and n >= 1:
                if hit.slot is None:          # cold leaf: promote via swap-in
                    n = self._promote_cold_hit(hit, req, n)
                    if n >= 1:
                        src, n_hit = req.slot, n
                else:
                    src, n_hit = hit.slot, n
        if src is None:
            self._cold_carry(req.slot)
            return
        if src != req.slot:
            self._in_place(T.copy_slot_prefix, self.state, src, req.slot, n_hit, self.rt)
        self._carries[req.slot] = self._dev(
            M.warm_prefill_carry, self.cfg, self.state, req.slot, n_hit,
            T.carry_len(self.max_len, self.chunk), req.prompt[:n_hit], self.rt)
        self._warm_rows[req.slot] = n_hit
        req.prefill_pos = n_hit
        self.stats["prefix_hits"] += 1
        self.stats["prefill_tokens_saved"] += n_hit
        self.stats["cached_tokens"] = self._pcache.cached_rows

    def _promote_cold_hit(self, leaf, req: Request, n: int) -> int:
        """A warm admission matched a demoted (cold) leaf: consume it, swap
        its block into the request's own slot and resume chunked prefill at
        the match (no copy: the rows land where they are needed; retirement
        republishes the longer prefix hot).  Returns the usable row count, 0
        when the block failed its tier-crossing check (it is dropped: a cold
        prefill recomputes the same rows) or is gone."""
        try:
            blob, rows, cost = self._swap.swap_in(self._pcache.promote(leaf))
        except (ColdBlockCorrupt, KeyError):
            return 0
        self._land_block(req.slot, blob)
        self.stats["swap_ins"] += 1
        self.stats["swap_in_bytes"] += cost.n_bytes
        self.stats["swap_in_cycles"] += cost.cycles_in
        return min(n, rows)

    def _finalize_into_slot(self, slot: int, carry: dict, start: int) -> None:
        T.write_slot(self.state, slot,
                     M.finalize_prefill_carry(self.cfg, carry, self.max_len, start),
                     start)

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
            self.prefill_pieces += T.chunk_pieces(self.cfg, req.prefill_pos, n)
            req.prefill_pos += n
            self.stats["chunks"] += 1
            if req.prefill_pos >= req.prompt_len:
                self._in_place(self._finalize_into_slot, slot, self._carries.pop(slot),
                               self._warm_rows.pop(slot, 0))
                self._emit_first(req, logits)
        except Exception as e:                        # noqa: BLE001
            self._drop_carry(slot)
            self._fail(req, f"{type(e).__name__}: {e}")
            self._check_pool_alive(e)
            return 0
        return n

    def _preempt(self, req: Request, now: float) -> None:
        """Bump a resident back to the queue.  With the tiered pool on, a
        DECODING victim's committed rows swap out to the cold tier when the
        modeled tier round trip beats replaying its tokens
        (``SwapManager.prefer_swap``); otherwise (the crossover says
        recompute, the cold tier is full, or the victim is mid-prefill) it
        is recomputed: re-admission re-prefills the prompt and replays the
        kept tokens."""
        self._drop_carry(req.slot)
        swapped = 0
        if self._swap is not None and req.state is RequestState.DECODING:
            swapped = self._swap_out_victim(req)
        if swapped:
            # the sampled stream continues where it left off (no replay
            # draws), so the per-request sampler survives the round trip
            self.stats["preempt_swaps"] += 1
        else:
            if self._swap is not None:
                self.stats["preempt_recomputes"] += 1
            self._rngs.pop(req.rid, None)  # the replay re-consumes the stream
        self.scheduler.preempt(req, now, swapped_rows=swapped)
        self.stats["preemptions"] += 1

    # -- the tiered pool's transfers ----------------------------------------
    def _lift_rows(self, slot: int, n: int) -> dict:
        """The first ``n`` rows of ``slot`` as a numpy host block: copied out
        of the pool on the device, then one timed, metered device-to-host
        copy (only the live rows cross).  On a mesh the block is the whole
        row, on every rank (``transformer.gather_slot_row``)."""
        one = (self._dev(T.read_slot, self.state, slot, n) if self.rt.mesh is None
               else self._dev(T.gather_slot_row, self.cfg, self.state, slot, n, self.rt))
        _sync(self.device)
        t0 = time.perf_counter()
        host = to_host(one)
        dt = time.perf_counter() - t0
        n_bytes = KV.cache_bytes(host)
        self.stats["device_s"] += dt
        self.stats["xfer_bytes"] += n_bytes
        self.swap_copies.append(("d2h", n_bytes, dt))
        return host

    def _land_block(self, slot: int, blob: dict) -> None:
        """Land a cold block in ``slot``: one timed, metered host-to-device
        copy of its rows, written at rows ``[0, n)`` with the rest of the
        slot's attention rows zeroed (the slot the reference's padded
        ``write_slot`` leaves) and the cursor at ``n``."""
        n = int(np.asarray(blob["pos"])[0])
        _sync(self.device)
        t0 = time.perf_counter()
        one = {"layers": [{k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                           for k, v in b.items()} for b in blob["layers"]],
               "pos": torch.from_numpy(np.asarray(blob["pos"], np.int32)).to(self.device)}
        _sync(self.device)
        dt = time.perf_counter() - t0
        n_bytes = KV.cache_bytes(blob)
        self.stats["xfer_bytes"] += n_bytes
        self.swap_copies.append(("h2d", n_bytes, dt))
        self._in_place(self._write_block, slot, one, n)

    def _write_block(self, slot: int, one: dict, n: int) -> None:
        T.write_slot(self.state, slot, one)
        mine = T.local_slot(self.state, slot)
        if mine is None:
            return                         # another data rank holds the slot
        for cache in self.state["layers"]:
            if T.is_seq_cache(cache):
                for buf in cache.values():
                    buf[mine, n:].zero_()

    def _relay_cold_evictions(self, evicted: list) -> None:
        """Unpinned (prefix-leaf) blocks the cold store LRU-dropped to make
        room: the trie drops the matching cold leaves too."""
        if self._pcache is not None:
            for key in evicted:
                self._pcache.drop_cold(key)

    def _swap_out_victim(self, req: Request) -> int:
        """Lift the victim's committed rows off the pool and store them cold
        under ``("req", rid)``, pinned (a preempted resident's rows are never
        LRU-dropped).  Returns the swapped row count, 0 on a fallback to
        recompute."""
        n = int(self._slot_pos[req.slot])
        if n < 1 or not self._swap.prefer_swap(n, req.prompt_len + len(req.output)):
            return 0
        ok, evicted, cost = self._swap.swap_out(
            ("req", req.rid), self._lift_rows(req.slot, n), n, pinned=True)
        self._relay_cold_evictions(evicted)
        if not ok:
            return 0
        self.stats["swap_outs"] += 1
        self.stats["swap_out_bytes"] += cost.n_bytes
        self.stats["swap_out_cycles"] += cost.cycles_out
        return n

    def _admit_swapped(self, req: Request) -> bool:
        """Re-admission of a swap-preempted victim: swap its cold block into
        the assigned slot and resume DECODING with no prefill, replaying only
        the recorded tokens past the block's rows (none for a fresh block; a
        stale recovery copy, after a slot loss, replays the tail).  The
        restored rows are byte-identical to the ones that left, so the
        continuation is token-identical to an unpreempted run.

        With the fault layer on, the read crosses the ECC and checksum
        pipeline; an uncorrectable block (or a recovery copy the store has
        since evicted) falls back to recompute-replay in this admission.  A
        greedy request keeps its block in the store as a recovery copy; a
        sampled one must not restore from a stale copy (a tail replay would
        draw again from its stream), so its block is popped.

        Returns True when the request was handled here (restored, or
        failed), False to fall through to the recompute admission."""
        n = req.swapped_rows
        req.swapped_rows = 0
        keep = self._ft is not None and req.temperature <= 0
        try:
            blob, rows, cost = self._swap.swap_in(("req", req.rid), keep=keep)
        except (ColdBlockCorrupt, KeyError):
            self._bump("recovery_recomputes")
            self._rngs.pop(req.rid, None)  # the replay re-consumes the stream
            req.prefill_pos = 0
            req.replay_pos = 0
            return False
        except Exception as e:                        # noqa: BLE001
            self._fail(req, f"{type(e).__name__}: {e}")
            return True
        try:
            self._land_block(req.slot, blob)
        except Exception as e:                        # noqa: BLE001
            self._fail(req, f"{type(e).__name__}: {e}")
            self._check_pool_alive(e)
            return True
        assert rows == n, f"cold block rows {rows} != ledger {n}"
        self.stats["swap_ins"] += 1
        self.stats["swap_in_bytes"] += cost.n_bytes
        self.stats["swap_in_cycles"] += cost.cycles_in
        fed = rows - req.prompt_len        # output tokens already in the rows
        assert 0 <= fed < len(req.output), \
            f"cold rows {rows} outside prompt {req.prompt_len} + output {len(req.output)}"
        req.prefill_pos = req.prompt_len
        req.replay_pos = fed + 1
        req.state = RequestState.DECODING
        self._last_tok[req.slot] = req.output[fed]
        self._slot_pos[req.slot] = rows
        if self._h_last is not None:
            self._h_last[req.slot].zero_()     # the MTP head runs from the embedding
        return True

    def _demote_leaf_rows(self, slot: int, n_rows: int, key) -> bool:
        """Prefix-cache demotion hook: move an LRU-evicted leaf's rows to the
        cold tier (unpinned: the store may LRU-drop them later), so a later
        warm admission can promote instead of prefilling cold."""
        ok, evicted, cost = self._swap.swap_out(
            key, self._lift_rows(slot, n_rows), n_rows, pinned=False)
        self._relay_cold_evictions(evicted)
        if ok:
            self.stats["swap_outs"] += 1
            self.stats["swap_out_bytes"] += cost.n_bytes
            self.stats["swap_out_cycles"] += cost.cycles_out
        return ok

    def _retire(self, req: Request, now: float) -> None:
        publish = None
        if self._pcache is not None and req.slot is not None:
            # committed rows = the host cursor mirror (prompt + every fed
            # generated token), capped at max_len - 1 so that a claimed row
            # never meets a clamped garbage append on an inactive slot
            # (appends clamp to rows >= state rows - T >= max_len - 1)
            publish = min(int(self._slot_pos[req.slot]), self.max_len - 1)
        self.scheduler.retire(req, now, publish_rows=publish)
        if self._swap is not None:
            # a recovery copy kept on restore dies with the request
            self._swap.drop(("req", req.rid))
        if self._pcache is not None:
            self.stats["cached_tokens"] = self._pcache.cached_rows
        self._rngs.pop(req.rid, None)      # release the per-request sampler

    def _fail(self, req: Request, error: str) -> None:
        if req.slot is not None:           # died mid-chunk: drop its carry
            self._drop_carry(req.slot)
        if self._swap is not None:         # an orphaned cold block, if any
            self._swap.drop(("req", req.rid))
        self.scheduler.fail(req, self._now(), error=error)
        self._rngs.pop(req.rid, None)

    def _check_pool_alive(self, cause: Exception) -> None:
        """Admission is exception-safe (one request fails, serving goes on)
        unless the failing call was an in-place pool update: then the pool
        cannot serve the other residents, and the step fails now (step()
        rebuilds the pool and retries)."""
        if self._pool_consumed():
            raise PoolConsumedError(
                "the decode pool was left mid-update by a failed call; the "
                "engine cannot continue serving its residents") from cause

    def _pool_consumed(self) -> bool:
        return self._pool_dirty

    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a stats counter only when it exists (the recovery
        machinery is always armed; its fault-layer counters are not)."""
        if key in self.stats:
            self.stats[key] += n

    # -- cancellation -------------------------------------------------------
    def cancel(self, req: Request) -> None:
        """Cancel a request (a client disconnect): at the next iteration
        boundary its slot is freed (mid-decode, mid-chunked-prefill or
        between spec windows), its partial output is kept and it ends
        CANCELLED.  Safe to call from another thread while ``step()`` runs
        (an append-only inbox)."""
        self._cancels.append(req)

    def _release(self, req: Request) -> None:
        """Slot hygiene of a request that ends early: its prefill carry,
        cold block and sampler go with it."""
        if req.slot is not None:
            self._drop_carry(req.slot)
        if self._swap is not None:
            self._swap.drop(("req", req.rid))
        self._rngs.pop(req.rid, None)

    def _apply_cancels(self, now: float) -> bool:
        """Drain the cancellation inbox.  A cancelled DECODING resident's
        committed cursor is already what ``_slot_pos`` mirrors (every lane
        that overshoots rewinds before its step ends), so freeing the slot
        needs no device work: the row is dead in place until the next
        admission overwrites it."""
        did = False
        inbox = self._cancels if self._world is None else self._step_cancels
        while inbox:
            req = inbox.pop(0)
            if req.done:
                continue                   # raced with retire or fail
            self._release(req)
            self.scheduler.cancel(req, now)
            did = True
        return did

    # -- fault recovery -----------------------------------------------------
    def _apply_deadlines(self, now: float) -> None:
        """Terminal TIMEOUT for any request, queued or resident, past its
        ``deadline_s``; the hygiene of a cancel, the partial output kept."""
        for req in list(self.scheduler.queue) + list(self.scheduler.active.values()):
            if req.deadline_s is None or req.done:
                continue
            if now - req.arrival_time < req.deadline_s:
                continue
            self._release(req)
            self.scheduler.timeout(req, now)
            self.stats["timeouts"] += 1

    def _recover_resident(self, req: Request, now: float) -> None:
        """Move a resident off a dead pool or slot with its stream intact: a
        greedy resident with a retained cold copy re-enters the queue as a
        swap restore (possibly stale rows, then a tail replay; greedy only,
        since a sampled tail replay would draw again from its stream);
        everything else recompute-replays from scratch."""
        self._drop_carry(req.slot)
        key = ("req", req.rid)
        if (self._swap is not None and req.temperature <= 0
                and req.output and self._swap.has(key)):
            rows = self._swap.store.rows_of(key)
            if 0 <= rows - req.prompt_len < len(req.output):
                # the copy carries the request until re-admission: pin it so
                # that no LRU pass evicts it from under the ledger
                self._swap.store.pin(key)
                self.scheduler.preempt(req, now, swapped_rows=rows)
                self._bump("cold_rereads")
                return
            self._swap.drop(key)           # a copy the ledger cannot use
        self._rngs.pop(req.rid, None)      # the replay re-consumes the stream
        self.scheduler.preempt(req, now, swapped_rows=0)
        self._bump("recovery_recomputes")

    def _lose_slot(self, slot: int, now: float) -> None:
        """A whole plane (slot) is lost: its resident recovers (cold re-read
        or recompute-replay), cached leaf rows living there are dropped, and
        the slot is quarantined for good.  It still rides in the captured
        [n_slots] step, a dead row whose appends clamp inside the pool's
        headroom.  Fatal once no healthy slot remains
        (``Scheduler.quarantine_slot`` raises)."""
        if slot in self.scheduler.quarantined or not 0 <= slot < self.n_slots:
            return
        self._bump("slot_losses")
        req = self.scheduler.active.get(slot)
        if req is not None:
            self._recover_resident(req, now)
        if self._pcache is not None:
            self._pcache.drop_slot(slot)
        self.scheduler.quarantine_slot(slot)
        if "quarantined_slots" in self.stats:
            self.stats["quarantined_slots"] = len(self.scheduler.quarantined)

    def _poison_pool(self) -> None:
        """An injected device error mid-step: the pool is left as a failed
        in-place update could leave it, every int8 code nonzero and every
        float NaN, so a rebuild that does not clear it shows in the tokens."""
        self._pool_dirty = True
        for t in G.state_tensors(self.state):
            t.fill_(float("nan") if t.is_floating_point() else 1)

    def _rebuild_pool(self) -> None:
        """Rebuild the pool from committed host state after a failed step
        consumed it.  Every resident preempts off the dead pool (cold
        re-read where a recovery copy exists, else recompute-replay;
        token-identical either way), in-flight carries die with it, hot
        prefix-cache leaves are dropped (demoted cold leaves live on the
        host and survive), and the pool is zeroed in place, cursors
        included, with the captured steps' static inputs: the graphs were
        captured over these tensors and stay valid.  Every slot ends free
        or quarantined."""
        now = self._now()
        self.stats["pool_rebuilds"] += 1
        self._carries.clear()
        self._warm_rows.clear()
        for _, req in sorted(self.scheduler.active.items()):
            self._recover_resident(req, now)
        if self._pcache is not None:
            self._pcache.drop_hot()
        for t in G.state_tensors(self.state) + self._static_inputs():
            t.zero_()
        self._slot_pos[:] = 0
        self._last_tok[:] = 0
        self._pool_dirty = False

    def _static_inputs(self) -> list[torch.Tensor]:
        """The captured steps' input buffers and the eager commits'."""
        bufs = self._steps.inputs() + [self._pos_buf]
        if self.spec_tree:
            bufs += [self._base_buf, self._keep_buf, self._sel_buf]
        if self._h_last is not None:
            bufs += [self._h_last, self._tok_buf, self._hrow_buf, self._dpos_buf]
        return bufs

    # -- one serving iteration --------------------------------------------
    def step(self) -> bool:
        """Run one engine iteration; returns True if any work was done.

        A step that left the pool consumed (an in-place update that raised,
        or an injected failure) is retried with exponential backoff, at most
        ``max_step_retries`` times, each retry first rebuilding the pool from
        committed host state (:meth:`_rebuild_pool`); any other error, and
        an exhausted budget, propagate.  A sticky device error fails the
        rebuild or every retry, so it surfaces as the error or as an
        exhausted budget.  A straggler watchdog counts slow iterations in
        ``stats["slow_steps"]``.  All device work of a step runs on the
        calling thread, under the engine's device."""
        t0 = time.perf_counter()
        try:
            with self._on_device():
                self._sync_control()
                attempt = 0
                while True:
                    try:
                        did, e = self._step(), None
                    except Exception as err:          # noqa: BLE001
                        if not (isinstance(err, InjectedStepFailure)
                                or self._pool_consumed()):
                            raise
                        did, e = None, err
                    if not self._agree(e is not None):
                        return did
                    if e is None:
                        e = InjectedStepFailure("a failure on another rank of the mesh")
                    self.stats["step_failures"] += 1
                    if attempt >= self.max_step_retries:
                        raise RuntimeError(
                            f"engine step failed {attempt + 1} time(s); "
                            "retry budget exhausted") from e
                    if self.retry_backoff_s > 0:
                        time.sleep(self.retry_backoff_s * (2.0 ** attempt))
                    attempt += 1
                    self.stats["step_retries"] += 1
                    self._rebuild_pool()
        finally:
            dt = time.perf_counter() - t0
            self.stats["step_s"] += dt
            if self._watchdog.observe(self.stats["steps"], dt):
                self.stats["slow_steps"] += 1

    def _agree(self, failed: bool) -> bool:
        """Whether this attempt failed, agreed over the mesh: a MAX over the
        whole world of (failed, uncorrectable cold blocks so far) and of
        their negations; ranks that disagree raise (their host state has
        parted).  Off a mesh, ``failed``."""
        if self._world is None:
            return failed
        mine = [int(failed), int(self.stats.get("uncorrectable_blocks", 0))]
        got = C.all_reduce(torch.tensor(mine + [-v for v in mine]), self._world,
                           "max").tolist()
        if got[:2] != [-v for v in got[2:]]:
            raise RuntimeError(f"the ranks disagree on the step's outcome "
                               f"(failed, uncorrectable blocks: max {got[:2]}, "
                               f"min {[-v for v in got[2:]]})")
        return bool(got[0])

    def _on_device(self):
        """The engine's card as the calling thread's current device (a
        server steps the engine on a worker thread); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _step(self) -> bool:
        now = self._now() if self._world is None else self._clock
        self.stats["steps"] += 1
        step_pf = 0
        cancelled = self._apply_cancels(now)
        for req in list(self.scheduler.active.values()):
            if (req.state is RequestState.DECODING
                    and req.replay_pos >= len(req.output)
                    and req.should_stop()):
                self._retire(req, now)
        self._apply_deadlines(now)
        if self._injector is not None:
            for slot in self._injector.lost_slots(self.stats["steps"]):
                self._lose_slot(slot, now)
        # preemption only when the queue is blocked on slots, and a
        # reclaimable prefix leaf means it is not (cached rows yield first)
        if not self.scheduler.free_slots and not (
                self._pcache is not None and self._pcache.has_reclaimable()):
            for req in self.scheduler.preemption_victims(now):
                self._preempt(req, now)
        for req in self.scheduler.admit(now):
            # a swap-preempted victim restores its rows and resumes
            # decoding; an uncorrectable block falls through to recompute
            if req.swapped_rows and (self._admit_swapped(req) or req.done):
                continue
            if self.chunk:
                try:
                    self._admit_chunked(req)
                except Exception as e:                # noqa: BLE001
                    self._fail(req, f"{type(e).__name__}: {e}")
                    self._check_pool_alive(e)
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
            return step_pf > 0 or cancelled
        self.stats["decode_steps"] += 1
        if self._injector is not None and self._injector.fail_step(self.stats["steps"]):
            # a device error mid-step, at the reference's point of the step
            # (the injector's schedule counts every attempt)
            self._poison_pool()
            raise InjectedStepFailure(
                f"injected device error at step {self.stats['steps']}")
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
        logits, argmax = self._in_place(self._steps.decode)
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
        blk = self._fetch(self._in_place(self._steps.multi, m), decode=True)
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
            self._in_place(T.rewind_pos, self.state, self._pos_device())

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

    def _model_drafts(self, tree: bool = False) -> np.ndarray | None:
        """The model drafter's [n_slots, window] drafts (a chain, or the
        tree's nodes) for every slot (idle ones included: the MTP layer
        routes the rows together), drafted eagerly on the device from the
        hidden carry, the last tokens and the cursors, and fetched; None
        for a host drafter."""
        if self._h_last is None:
            return None
        fn = self._drafter.draft_tree_batch if tree else self._drafter.draft_batch
        tok = self._push(self._last_tok, self._tok_buf, decode=True)
        pos = self._push(np.asarray(self._slot_pos, np.int32), self._dpos_buf, decode=True)
        return self._fetch(self._dev(fn, self.qparams, self._h_last, tok, pos),
                           decode=True, rows=False)

    def _carry_hidden(self, rows: np.ndarray) -> None:
        """After a verify step: each slot's hidden carry becomes the step's
        hidden at the window row it emitted last (``rows[slot]``; -1 keeps
        the carry), as the reference's host loop leaves it."""
        if self._h_last is None:
            return
        r = self._push(rows, self._hrow_buf, decode=True)
        n = torch.arange(self.n_slots, device=self.device)
        hidden = T.gather_rows(self._steps.hidden, self.state, self.rt)
        got = hidden[n, torch.clamp(r, min=0).long()]
        self._h_last.copy_(torch.where((r >= 0)[:, None], got, self._h_last))

    def _draft_for(self, req: Request, dr: np.ndarray | None) -> list[int]:
        """``spec_k`` drafts for one slot.  A replaying (preempt-resumed)
        request drafts its own recorded tokens, perfect drafts, so replay
        advances k + 1 positions a verify step and stays token-identical;
        the tail past the recording comes from the drafter (``dr``: the
        model drafter's drafts)."""
        k = self.spec_k
        d = list(req.output[req.replay_pos:req.replay_pos + k])
        if len(d) < k:
            if dr is not None:
                d += [int(t) for t in dr[req.slot, :k - len(d)]]
            else:
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
        dr = self._model_drafts()
        drafts: dict[int, list[int]] = {}
        for slot, req in dec:
            drafts[slot] = self._draft_for(req, dr)
            toks[slot, 1:] = drafts[slot]
        self._push(toks, self._steps.window[k + 1], decode=True)
        logits, argmax = self._in_place(self._steps.verify, k + 1)
        self.stats["verify_steps"] += 1
        row_token = self._row_token_fn(logits, argmax, dec)
        last_row = np.full((self.n_slots,), -1, np.int32)
        now = self._now()
        for slot, req in dec:
            fed = drafts[slot]
            committed = 0                 # accepted K/V rows past toks[:, 0]
            for i in range(k + 1):
                # row i is the next-token choice after toks[slot, :i+1], valid
                # because reaching it means every earlier draft was accepted
                tok, replaying = self._emit_row(req, slot, i, row_token)
                last_row[slot] = i
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
        self._carry_hidden(last_row)
        self._in_place(T.rewind_pos, self.state, self._pos_device())

    def _tree_draft_for(self, req: Request, dr: np.ndarray | None
                        ) -> tuple[list[int], list[int]]:
        """(tokens, draft-space parents) of one slot's tree window.  A
        replaying request drafts its recorded tokens as a linear chain
        (perfect drafts), its tail from the drafter's chain (the model
        drafter's first chain, ``dr``); others get the drafter's tree."""
        n = self.spec_tree
        rec = list(req.output[req.replay_pos:req.replay_pos + n])
        if not rec:
            if dr is not None:
                return [int(t) for t in dr[req.slot]], list(self._drafter.tree_parents)
            return self._drafter.draft_tree(req.prompt + req.output, n,
                                            self.spec_branch)
        if len(rec) < n:
            if dr is not None:
                rec += [int(t) for t in dr[req.slot, :n - len(rec)]]
            else:
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
        dr = self._model_drafts(tree=True)
        for slot, req in dec:
            d_toks, parents[slot] = self._tree_draft_for(req, dr)
            toks[slot, 1:] = d_toks
            depth[slot], anc[slot] = tree_depths_ancestors(parents[slot])
        self._push(toks, self._steps.window[Tw], decode=True)
        self._push(depth, self._steps.depth[Tw], decode=True)
        self._push(anc, self._steps.anc[Tw], decode=True)
        logits, argmax = self._in_place(self._steps.tree, Tw)
        self.stats["verify_steps"] += 1
        row_token = self._row_token_fn(logits, argmax, dec)
        # the commit's base: each slot's cursor before this window (window
        # node w's K/V row sits at base + w)
        base = np.asarray(self._slot_pos, np.int32)
        sel = np.zeros((self.n_slots, n), np.int32)
        keep = np.zeros((self.n_slots,), np.int32)
        last_row = np.full((self.n_slots,), -1, np.int32)
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
                last_row[slot] = cur
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
        self._carry_hidden(last_row)
        self._in_place(M.tree_commit, self.state,
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
        """Step until the queue and all slots are empty;
        ``drain_stall_limit`` consecutive no-work iterations with work
        pending raise instead of looping forever."""
        stalls = 0
        while self.scheduler.has_work():
            stalls = 0 if self.step() else stalls + 1
            if stalls >= self.drain_stall_limit:
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
