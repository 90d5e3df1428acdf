"""Serving entry point: batched prompts -> prefill -> W8A8 PIM-path decode.

PyTorch-port counterpart of ``repro.launch.serve``, with its modes and
flags.  Weights are random, from ``init_params(cfg, seed=0)``.  Everything
runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions).

Fixed single-batch mode (the paper's setting):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-125m --reduced \\
        --batch 4 --prompt-len 32 --steps 32

Continuous-batching mode (variable-length prompts through the slot
scheduler, with queueing and mid-flight backfill):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-125m --reduced \\
        --continuous --requests 12 --slots 4 --steps 32

Chunked prefill and a scheduling policy (``--max-step-tokens`` caps decode
slots plus prefill chunk tokens an iteration):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced \\
        --continuous --chunk 8 --policy sjf --requests 16 --slots 4

Speculative decode, linear (``--spec-k``) or a draft tree (``--spec-tree``,
``--spec-branch``), and fused multi-step decode (``--multi-step``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced \\
        --continuous --chunk 4 --spec-k 4 --drafter ngram

DeepSeek-V3's MTP head drafts instead with ``--drafter mtp``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \\
        --reduced --continuous --spec-k 3 --drafter mtp --device cpu

Streaming front end (the async serve loop: per-request token streams with
bounded-queue backpressure, live admission, and one request cancelled
after its first tokens); it ends by printing ``SERVE_SHUTDOWN_CLEAN``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced \\
        --serve --requests 3 --slots 2 --device cpu

Fault injection (``--ber``, ``--fault-steps``, ``--fault-every``,
``--slot-loss``), request deadlines (``--deadline``) and the fault layer
alone (``--faults``) work in both engine modes.  ``--arch`` takes every
configuration of the reference's registry (chameleon-34b prompts with
token ids here, as the reference's CLI does).  An encoder-decoder
(whisper-tiny) serves in the fixed-batch mode only, from frame embeddings
drawn from the seed; the continuous engine refuses it as the reference's
does.

Either engine mode accepts ``--mesh DxM`` to serve over a (data, model)
mesh: ``D * M`` ranks (processes) are spawned in a gloo world, each draws
its blocks of the seeded weights (``transformer.init_params_sharded``) and
runs the mode with ``Runtime(mesh=..., data_axes=("data",),
serve_resident_moe=True)``, as the reference's ``make_serve_runtime``
builds it (slot pool over the data axis, heads, FFN and experts over
``model``); rank 0 prints.  With ``--device cuda`` every rank uses the one
card (the collectives go through host memory); without a card it raises.
Every family and every flag serves on a mesh (an encoder-decoder in the
fixed-batch mode).  With ``--serve`` rank 0 is the leader: it runs the
streaming front end and owns every decision that reads a clock
(admissions, the cancellation, deadlines, the straggler watchdog), which
it broadcasts before each engine iteration; the other ranks follow
(``ContinuousBatchingEngine.follow``) until it stops them:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --reduced --continuous --mesh 2x2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --reduced --serve --requests 3 --slots 2 --mesh 1x2 --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_local_mesh, parse_mesh, spawn
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.faults import FaultInjector


def make_serve_runtime(spec: str | None) -> Runtime:
    """``--mesh DxM`` -> a serve Runtime over the (data, model) mesh of
    this process's world (a rank :func:`main` spawned), as the reference's
    over its first DxM devices; no spec, the one-device Runtime."""
    if not spec:
        return Runtime()
    d, m = parse_mesh(spec)
    return Runtime(mesh=make_local_mesh(d, m), data_axes=("data",),
                   serve_resident_moe=True)


def _run_fixed(cfg, params, rt, args):
    eng = Engine(cfg=cfg, params=params, max_len=args.prompt_len + args.steps + 1,
                 rt=rt, quantize=not args.no_quantize, device=args.device)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g)
    if cfg.family == "encdec":         # the stubbed front end's frame embeddings
        batch = {"frames": torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                                       generator=g), "tokens": tokens}
    else:
        batch = {"inputs": tokens}
    toks, times = eng.generate(batch, steps=args.steps)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"steps={args.steps}")
    print(f"prefill: {times['prefill_s']*1e3:.1f} ms   "
          f"decode: {times['decode_s']*1e3:.1f} ms   "
          f"TPOT: {times['tpot_s']*1e3:.2f} ms")
    print("sample tokens:", toks[0, :10].tolist())


def _make_prompts(cfg, args, rng):
    """Ragged random prompts; with ``--prefix-cache`` they share a system
    prefix (half the prompt budget) so the warm path has something to hit."""
    if not args.prefix_cache:
        return [rng.integers(0, cfg.vocab_size,
                             rng.integers(4, args.prompt_len + 1)).tolist()
                for _ in range(args.requests)]
    shared = rng.integers(0, cfg.vocab_size, max(2, args.prompt_len // 2)).tolist()
    return [shared + rng.integers(
                0, cfg.vocab_size,
                rng.integers(2, max(3, args.prompt_len - len(shared) + 1))).tolist()
            for _ in range(args.requests)]


def _print_prefix_stats(eng):
    if eng._pcache is None:
        return
    print(f"prefix cache: hits={eng.stats['prefix_hits']} "
          f"saved={eng.stats['prefill_tokens_saved']} tokens "
          f"cached_rows={eng.stats['cached_tokens']} "
          f"leaves={eng._pcache.n_leaves} "
          f"aliases={eng._pcache.stats['aliases']} "
          f"evictions={eng._pcache.stats['evictions']} "
          f"reclaims={eng._pcache.stats['reclaims']}")


def _print_swap_stats(eng):
    if eng._swap is None:
        return
    print(f"kv swap: preempt_swaps={eng.stats['preempt_swaps']} "
          f"recomputes={eng.stats['preempt_recomputes']} "
          f"out={eng.stats['swap_outs']}/{eng.stats['swap_out_bytes']}B"
          f"/{eng.stats['swap_out_cycles']}cyc "
          f"in={eng.stats['swap_ins']}/{eng.stats['swap_in_bytes']}B"
          f"/{eng.stats['swap_in_cycles']}cyc "
          f"cold_rows={eng._swap.store.rows_used}/{eng._swap.store.row_budget}")


def _make_faults(args):
    """CLI flags -> a seeded FaultInjector (or None when chaos is off)."""
    on = (args.faults or args.ber is not None or args.fault_steps
          or args.slot_loss or args.fault_every)
    if not on:
        return None
    losses = []
    for spec in (args.slot_loss or "").split(","):
        if spec:
            step, slot = (int(s) for s in spec.split(":"))
            losses.append((step, slot))
    return FaultInjector(
        seed=args.fault_seed,
        ber=args.ber,
        mode=args.fault_mode,
        step_fail_at=tuple(int(s) for s in (args.fault_steps or "").split(",") if s),
        step_fail_every=args.fault_every,
        slot_loss_at=tuple(losses))


def _print_fault_stats(eng):
    if eng._injector is None and not eng._faults_on:
        return
    s = eng.stats
    print(f"faults: ecc={s.get('ecc_checks', 0)}chk"
          f"/{s.get('ecc_pages', 0)}pg"
          f"/{s.get('ecc_cycles', 0)}cyc "
          f"corrected_bits={s.get('ecc_corrected_bits', 0)} "
          f"flips={s.get('bitflips_injected', 0)} "
          f"uncorrectable={s.get('uncorrectable_blocks', 0)} "
          f"cold_rereads={s.get('cold_rereads', 0)} "
          f"recomputes={s.get('recovery_recomputes', 0)} "
          f"step_failures={s['step_failures']} "
          f"retries={s['step_retries']} "
          f"pool_rebuilds={s['pool_rebuilds']} "
          f"slot_losses={s.get('slot_losses', 0)} "
          f"quarantined={s.get('quarantined_slots', 0)} "
          f"timeouts={s['timeouts']} slow_steps={s['slow_steps']}")


def _make_engine(cfg, params, rt, args) -> ContinuousBatchingEngine:
    return ContinuousBatchingEngine(
        cfg, params, n_slots=args.slots, max_len=args.prompt_len + args.steps + 1,
        rt=rt, quantize=not args.no_quantize, policy=args.policy, chunk=args.chunk,
        max_step_tokens=args.max_step_tokens, spec_k=args.spec_k,
        spec_tree=args.spec_tree, spec_branch=args.spec_branch, drafter=args.drafter,
        multi_step=args.multi_step, prefix_cache=args.prefix_cache,
        prefix_cache_rows=args.prefix_rows, kv_swap=args.kv_swap,
        cold_rows=args.cold_rows, drain_stall_limit=args.drain_stall_limit,
        faults=_make_faults(args), max_step_retries=args.max_step_retries,
        device=args.device)


def _trace(cfg, args):
    rng = np.random.default_rng(0)
    prompts = _make_prompts(cfg, args, rng)
    budgets = [int(rng.integers(max(1, args.steps // 2), args.steps + 1))
               for _ in range(args.requests)]
    return prompts, budgets


def _run_continuous(cfg, params, rt, args):
    eng = _make_engine(cfg, params, rt, args)
    prompts, budgets = _trace(cfg, args)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m, temperature=args.temperature, top_k=args.top_k,
                       deadline_s=args.deadline)
            for p, m in zip(prompts, budgets)]
    eng.drain()
    wall = time.perf_counter() - t0
    gen = sum(len(r.output) for r in reqs)
    lat = sorted(r.finish_time - r.arrival_time for r in reqs)
    mode = f"chunk={eng.chunk} budget={eng.max_step_tokens}" if eng.chunk \
        else "atomic prefill"
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"policy={eng.policy.name} {mode} prompts 4..{args.prompt_len} "
          f"budgets {args.steps//2}..{args.steps}")
    print(f"generated {gen} tokens in {wall:.2f}s -> {gen/wall:.1f} tok/s | "
          f"latency p50 {lat[len(lat)//2]*1e3:.0f} ms  "
          f"p99 {lat[min(len(lat)-1, int(0.99*len(lat)))]*1e3:.0f} ms")
    print(f"steps={eng.stats['steps']} chunks={eng.stats['chunks']} "
          f"preemptions={eng.stats['preemptions']} "
          f"max prefill tokens/step={eng.stats['max_step_prefill_tokens']}")
    if eng.spec_k or eng.spec_tree:
        lane = (f"tree={eng.spec_tree} branch={eng.spec_branch}"
                if eng.spec_tree else f"k={eng.spec_k}")
        print(f"spec: {lane} drafter={eng._drafter.name} "
              f"verify_steps={eng.stats['verify_steps']} "
              f"acceptance={eng.acceptance_rate:.2%} "
              f"accept_hist={eng.stats['spec_accept_hist']}")
    if eng.multi_step > 1:
        print(f"multi-step: m={eng.multi_step} "
              f"blocks={eng.stats['multi_blocks']} "
              f"fused_tokens={eng.stats['multi_tokens']}")
    _print_prefix_stats(eng)
    _print_swap_stats(eng)
    _print_fault_stats(eng)
    steps = max(1, eng.stats["steps"])
    print(f"host {1e3 * (eng.stats['step_s'] - eng.stats['device_s']) / steps:.2f} ms/step  "
          f"device {1e3 * eng.stats['device_s'] / steps:.2f} ms/step  "
          f"decode xfer {eng.stats['decode_xfer_bytes'] / max(1, eng.stats['decode_steps']):.0f}"
          f" B/decode-step")
    print("sample tokens:", reqs[0].output[:10])


def _run_serve(cfg, params, rt, args):
    """Async streaming demo: submit ``--requests`` live, stream them
    concurrently, cancel the second one after its first two tokens, and
    shut down cleanly.  On a mesh the leader streams and its followers
    step with it."""
    eng = _make_engine(cfg, params, rt, args)
    if not eng._leader:               # a follower on a mesh: the leader drives
        eng.follow()
        return
    try:
        _stream(eng, cfg, args)
    finally:
        eng.stop_followers()


def _stream(eng, cfg, args):
    from repro_torch.serve.server import AsyncServer, RequestTimedOut

    prompts, budgets = _trace(cfg, args)
    cancel_at = 1 if args.requests > 1 else None   # disconnect this stream

    async def consume(i, stream):
        toks = []
        try:
            async for tok in stream:
                toks.append(tok)
                if i == cancel_at and len(toks) >= 2:
                    stream.cancel()
        except RequestTimedOut:
            pass                      # deadline hit; partial tokens stand
        return toks

    async def demo():
        t0 = eng.now()
        async with AsyncServer(eng, stream_buffer=args.stream_buffer) as srv:
            streams = [await srv.submit(p, m, temperature=args.temperature,
                                        top_k=args.top_k, deadline_s=args.deadline)
                       for p, m in zip(prompts, budgets)]
            outs = await asyncio.gather(*(consume(i, s) for i, s in enumerate(streams)))
        return streams, outs, eng.now() - t0

    streams, outs, wall = asyncio.run(demo())
    gen = sum(len(o) for o in outs)
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"policy={eng.policy.name} streamed")
    for i, (s, o) in enumerate(zip(streams, outs)):
        state = "cancelled" if s.cancelled else "finished"
        print(f"  req {i}: {state} after {len(o)} tokens "
              f"(budget {budgets[i]}) {o[:8]}")
    print(f"streamed {gen} tokens in {wall:.2f}s -> {gen/wall:.1f} tok/s | "
          f"steps={eng.stats['steps']} preemptions={eng.stats['preemptions']}")
    _print_prefix_stats(eng)
    _print_swap_stats(eng)
    _print_fault_stats(eng)
    assert all(s.request.done for s in streams)
    assert not eng.scheduler.has_work() and not eng._carries
    if cancel_at is not None:
        assert streams[cancel_at].cancelled
    print("SERVE_SHUTDOWN_CLEAN")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a ragged request stream via the slot scheduler")
    ap.add_argument("--serve", action="store_true",
                    help="async streaming front-end demo: live admission, "
                         "per-request token streams, one mid-stream cancel, "
                         "clean shutdown")
    ap.add_argument("--stream-buffer", type=int, default=16,
                    help="per-stream token queue bound (backpressure)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="fifo",
                    help='admission policy: fifo | priority[:preempt] | sjf '
                         '| fair[:quantum] (e.g. "fair:8")')
    ap.add_argument("--chunk", type=int, default=None, metavar="C",
                    help="chunked prefill: consume prompts [1, C] tokens per "
                         "engine iteration instead of one atomic prefill")
    ap.add_argument("--max-step-tokens", type=int, default=None,
                    help="per-iteration token budget (decode slots + prefill "
                         "chunk tokens); default slots + chunk")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decode: draft K tokens per slot and "
                         "verify all K+1 positions in one batched step "
                         "(0 = off)")
    ap.add_argument("--spec-tree", type=int, default=0, metavar="N",
                    help="tree-draft speculative decode: draft a token tree "
                         "of N nodes per slot and verify the whole tree in "
                         "one ancestor-masked step (0 = off; takes "
                         "precedence over --spec-k)")
    ap.add_argument("--spec-branch", type=int, default=2, metavar="B",
                    help="tree-draft branching factor (with --spec-tree)")
    ap.add_argument("--drafter", default="ngram",
                    help='draft proposer: ngram[:N] (prompt lookup) | mtp '
                         '(multi-token-prediction head)')
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: retired requests publish their "
                         "committed KV rows; later admissions sharing a "
                         "prompt prefix start chunked prefill at the cached "
                         "cursor (needs --chunk)")
    ap.add_argument("--prefix-rows", type=int, default=None,
                    help="prefix-cache row budget (LRU eviction above it); "
                         "default slots * max_len")
    ap.add_argument("--kv-swap", action="store_true",
                    help="tiered KV pool: preemption victims swap their "
                         "committed rows to a metered cold tier (restored "
                         "on re-admission) when the modeled transfer beats "
                         "replay; prefix-cache evictions demote instead of "
                         "dropping")
    ap.add_argument("--cold-rows", type=int, default=None,
                    help="cold-tier row budget (with --kv-swap); default "
                         "slots * max_len")
    ap.add_argument("--drain-stall-limit", type=int, default=8,
                    help="consecutive no-progress drain() iterations before "
                         "the engine raises instead of spinning")
    ap.add_argument("--faults", action="store_true",
                    help="enable the fault-tolerance layer (checksums + ECC "
                         "metering) even with no injected faults")
    ap.add_argument("--ber", type=float, default=None,
                    help="cold-store raw bit error rate for injected NAND "
                         "bit-flips (default: the params.py rate for "
                         "--fault-mode)")
    ap.add_argument("--fault-mode", default="retention",
                    choices=("retention", "read_disturb"),
                    help="which SLC error mechanism sets the default BER")
    ap.add_argument("--fault-steps", default=None, metavar="S1,S2",
                    help="inject transient device failures at these engine "
                         "steps (comma-separated; each leaves the pool "
                         "consumed and is recovered by a rebuild)")
    ap.add_argument("--fault-every", type=int, default=0, metavar="N",
                    help="inject a transient device failure every N engine "
                         "steps (0 = off)")
    ap.add_argument("--slot-loss", default=None, metavar="STEP:SLOT,...",
                    help="permanently lose (quarantine) decode slots at the "
                         'given steps, e.g. "12:0,40:2"')
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault injector")
    ap.add_argument("--max-step-retries", type=int, default=3,
                    help="bounded retries (with pool rebuild) after a failed "
                         "step before the engine gives up")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="per-request deadline; requests still unfinished "
                         "this long after arrival finish as TIMEOUT")
    ap.add_argument("--multi-step", type=int, default=1, metavar="M",
                    help="fused multi-step decode: run M greedy iterations "
                         "per step (argmax fed back on the device) when the "
                         "pool is in pure decode steady state (1 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help='serve over a (data, model) mesh of D*M spawned ranks, '
                         'e.g. "2x4"')
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the card, the default) or "cpu" (the '
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mesh:
        d, m = parse_mesh(args.mesh)
        resolve(args.device)                  # no card: raise before spawning
        T.check_mesh_family(cfg)
        spawn(_mesh_rank, d * m, args, threads=max(1, (os.cpu_count() or 1) // (d * m)))
        return
    rt = make_serve_runtime(None)
    params = M.init_params(cfg, seed=0, device=args.device)
    if args.serve:
        _run_serve(cfg, params, rt, args)
    elif args.continuous:
        _run_continuous(cfg, params, rt, args)
    else:
        _run_fixed(cfg, params, rt, args)


def _mesh_rank(rank: int, args) -> None:
    """One rank of ``--mesh``: its blocks of the seeded weights, then the
    mode; only rank 0 prints (under ``--serve`` it leads, the others
    follow)."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rt = make_serve_runtime(args.mesh)
    params = T.init_params_sharded(cfg, rt, seed=0, device=args.device,
                                   quantize=not args.no_quantize)
    if args.serve:
        _run_serve(cfg, params, rt, args)
    elif args.continuous:
        _run_continuous(cfg, params, rt, args)
    else:
        _run_fixed(cfg, params, rt, args)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
