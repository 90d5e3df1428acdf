#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases (any failure makes the script exit non-zero):

1. card and build: the card's name and power limit, and ``nvcc -Xptxas -v``
   (registers, shared memory, spills) for every kernel in ``csrc/``, all
   compiled at once, the attention body's per mask;
2. kernel parity and timing at full llama3-8b width: each kernel against its
   plain PyTorch version on the card (B1/B5 bit-exact, B2 within
   rtol=3e-5, atol=3e-6), B5's int32 sums against B1's, CUDA-event times
   beside the plain version's, a library call's where one computes the same
   function, and the bound (the larger of bytes / 3.35 TB/s and operations
   / the type's peak); B1 also at the verify M (20, 28) and at mamba2-2.7b's
   linears, and its device operations a call (one kernel, gated); B5 on
   the weight's bytes at M 1, 4, 20 and 28 (bit-equal to B1 and to the
   plain version, with and without its int32 sums; beside
   ``torch._int_mm`` with the same epilogue; its launch plan), and its
   device operations a call (one cluster kernel, gated); B2 at S 512 and
   S 4,096, and its device operations a call (one cluster kernel, gated);
3. ``Engine`` at full width (llama3-8b, random f32 weights from a seeded
   ``torch.Generator``) under ``fused_int8``: 4 prompts of 64 tokens, 16
   greedy steps, with the launch counts that show B1 and B2 ran; one decode
   step from one state under ``fused_int8``, ``pim_bitserial`` (B5) and
   ``ref_int8`` (plain), and where the decode step's time goes under
   ``fused_int8`` and under ``pim_bitserial``; and the reduced config on
   the card against the same model on the CPU (plain versions);
4. ``ContinuousBatchingEngine`` at full width: 8 ragged requests on 4 slots,
   greedy FIFO — the main path, whose launch counts the ``kernels`` line
   reports for B1 and B2; then the same trace under ``pim_bitserial``
   (B5's launch count in the ``kernels`` line) and under ``ref_int8``,
   gated token-identical.  Every decode and verify step of both engines
   replays a CUDA graph captured when the engine (or, for ``Engine``, its
   first batch) is built, and credits the launches it captured (a fused
   block replays the decode graph m times); prefill is eager, in pieces of
   64 rows;
``graphs``: the captured steps at full width on 4 slots at ragged cursors:
   decode, ``spec_k`` verify (T 5), ``spec_tree`` verify (T 7) and the fused
   block (m 4), each gated bit-equal to the eager step over 8 steps (logits
   or tokens, and every state tensor) with exact launch counts a replay,
   and one replay profiled with each hand kernel's device events gated
   equal to the launches it credits (up to 3 profiles, then one in a fresh
   process: a profile can miss records); an eager decode and verify step
   profiled beside the replayed ones; the
   phase-4 trace served with ``multi_step = 4`` and with ``chunk = 32``
   under FIFO, SJF, preemptive priority and fair share (per-request
   priorities and users), each gated token-identical to the plain trace;
   and a sampled run (temperature 0.8, top-k 40, seeds) gated to repeat
   itself;
5. the speculative lanes: B3 (``verify_attn``) and B4 (``verify_tree_attn``)
   at full width against their plain versions, in pools of 256 and 4,096
   rows plus the window, with the two bit-exact invariants (B3 at each row
   equals B2 at that row's length; B4 on a chain equals B3), also across
   pool sizes (B2 in a pool of ``max_len`` rows) at cursors whose rows
   cross the body's 64-key chunk boundaries, times and bounds;
   ``verify_step`` on the reduced config, card
   against CPU, linear and tree; and the phase-4 trace served again with
   ``spec_k = 4`` and with ``spec_tree = 6, spec_branch = 2``, whose launch
   counts the ``kernels`` line reports for B3 and B4; and where the
   verify window parts from sequential decode (reduced config on both
   devices, full width on the card, each float stage at B*T rows against B),
   gated: the RMSNorm kernel is row-invariant bit for bit and the full-width
   window's K/V entries equal sequential decode's in every layer;
``prefix``: the radix prefix cache and the tiered KV pool on llama3-8b at
   full width (4 slots, ``max_len`` 1024, ``chunk`` 64): which division
   the three quantizers run on the card, over a row for every float32
   mantissa in [1, 2) (gated: IEEE ``amax / 127`` in all three), and
   whether a dequantize-requantize round trip of ``quantize_kv`` keeps its
   scales and codes (gated: it moves none); a trace of 3 groups of 4 requests sharing a 384-token system
   prompt each, served without the cache, with it (each group's leader to
   completion, then its 3 followers: gated to 9 warm admissions of 384-388
   tokens whose sum is ``prefill_tokens_saved``), and with a small cache
   over the cold tier (the 3 leaders, then the 9 followers: gated to at
   least one demoted leaf promoted), each run with exact launch counts,
   every slot's system rows gated byte-identical to a one-shot prefill of
   its system prompt in all 32 layers, and every token that parts from the
   cache-off trace gated to a near-tie (single-request reruns of both lanes
   reproduce their tokens, the cache-off lane's best two lie closer than
   the lanes' logit rows lie apart, and those within 10% of the logit
   scale); warm and cold TTFT and every block copy's time recorded; then
   the phase-4 trace under preemptive priority with ``kv_swap`` (requests
   4-7 arrive at a higher priority once 0-3 decode), gated 8 of 8 equal to
   the plain trace with every preemption swapped, ``swap_in_bytes ==
   swap_out_bytes``, each request prefilled once and exact launch counts;
``server``: the engine as a live service, llama3-8b at full width under
   ``fused_int8`` on 4 slots: the phase-4 trace by ``drain()`` and then
   streamed through ``AsyncServer`` on the same engine (8 of 8 streams
   equal to the plain trace, exact B1 / B2 / RMSNorm launches; both rates
   recorded), a disconnect after a stream's second token (a prefix of its
   plain stream, CANCELLED, its slot taken by a queued request, the ledger
   balanced, the other 7 unchanged), a deadline at half a request's
   ``drain()`` latency (TIMEOUT, ``RequestTimedOut`` in its stream, a
   prefix); the swap trace streamed with injected step failures and a lost
   slot, and with NAND bit flips at BER 2e-4 (8 of 8 equal to the plain
   trace, one retry and one in-place pool rebuild an injected failure, each
   rebuild's wall recorded, the pool's addresses and captured graphs kept,
   nothing captured again, one slot quarantined; corrected bits and no
   uncorrectable block at BER 2e-4); and ``python -m
   repro_torch.launch.serve --serve`` in a subprocess (exit 0,
   ``SERVE_SHUTDOWN_CLEAN``);
6. ``ssm``: mamba2-2.7b (64 layers, d 2560, 80 SSM heads of 64, state 128,
   vocab 50280) after llama3-8b's parameters are freed.  B6 (``ssd_chunk``)
   against its plain version at full width (Q 128, 37, 1 and 33; B and C
   per group, as the model passes them) with its time,
   bound and ``ptxas`` line, and the RMSNorm kernel's; the RMSNorm fused
   with the activation quantizer (``rms_norm_quant``) at every width an
   RMSNorm feeds quantized linears at (1536 to 18432), gated bit-equal to
   the RMSNorm kernel followed by ``quantize_activation``, row-invariant, one
   kernel node a call and equal on two replays, timed at [4, 4096] and
   [4, 5120] beside that unfused pair captured as a graph; ``ssd_forward`` over
   two chunks against the model's chunked tensor path; the reduced config
   on the card against the CPU; and the full-width model served by
   ``Engine`` and ``ContinuousBatchingEngine`` under ``fused_int8`` with
   exact launch counts (its serve run's counts are what the ``kernels``
   line reports for B6 and the RMSNorm kernel), then the same trace under
   ``ref_int8`` (plain SSD, plain int8 matmul); its captured decode step
   gated bit-equal to eager (every SSM state) over 8 steps, and its
   profiled replay's kernel events equal to its credited launches;
7. ``families``: the paper's OPT-30B at full width (d 7168, 56 heads of 128,
   MHA, ff 28672, gelu, LayerNorm, sinusoidal positions, tied vocab 50272)
   with 16 of its 48 layers (its 118 GB of f32 weights do not fit one
   card), after mamba2's weights are freed: B1 and B5 over one OPT layer's
   linears at M 4 (bit-equal to their plain versions, beside
   ``torch._int_mm``), B2 / B3 / B4 at G 56, rep 1, D 128 in pools of
   512 rows (B3's rows equal to B2, B4 on a chain equal to B3), the
   LayerNorm kernel (``layer_norm``; within rtol 1e-6 of its plain version,
   row-invariant at 1, 4, 20 and 28 rows a call; its time at [4, 7168],
   [4, 384], [1024, 768] and [1024, 4096] beside ``F.layer_norm``), the
   LayerNorm fused with the activation quantizer (``layer_norm_quant``) at
   d 96 to 24576, gated bit-equal to the LayerNorm kernel followed by
   ``quantize_activation``, row-invariant, one kernel node a call and
   equal on 8 replays, timed at [4, 7168] and [4, 384] beside that
   unfused pair captured as a graph, the reduced config on the card
   against the CPU, the
   phase-4 trace under ``fused_int8``, ``pim_bitserial`` and ``ref_int8``
   (gated token-identical), ``Engine``, ``spec_k = 4`` and ``spec_tree = 6,
   spec_branch = 2`` with the verify window's K/V gated equal to
   sequential decode's in every layer, ``multi_step = 4`` and ``chunk = 32``
   (each lane gated 8 of 8 equal to the plain trace; its ``fused_int8``
   run's LayerNorm launches, unfused and fused, are what the ``kernels``
   line reports), and its
   captured decode step gated bit-equal to eager over 8 steps with its
   replayed wall, device-busy time and idle share; then granite-3-8b (8 of
   its 40 layers) and phi3-mini-3.8b (8 of its 32) at full width, each with
   B1 / B5 / B2-B4 at its shapes (phi3's attention at G 32, rep 1, D 96), its reduced config
   on the card against the CPU, served under ``fused_int8``,
   ``pim_bitserial`` and ``ref_int8`` (``pim_bitserial`` gated
   token-identical to ``ref_int8``; where ``fused_int8`` parts from them, a
   single-request rerun must reproduce the fused lane's token at a gap
   smaller than the two lanes' logit rows lie apart, within 10% of the
   logit scale), and its captured decode step against eager; then
   chameleon-34b (d 8192, 64 heads of 128 in 8 groups, QK-norm, ff 22016
   SwiGLU, untied vocab 65536, embedding inputs) at full width with 16 of
   its 48 layers (133 GB of f32 weights at 48; 44.3 GB at 16): B1 / B5 at
   K 8192 and 22016, B2-B4 at G 8, rep 8, D 128, QK-norm's rows through
   the RMSNorm kernel row-invariant at 1, 4, 20 and 28 tokens a call, the
   reduced model prefilled from embeddings on the card against the CPU,
   the three backends (``pim_bitserial`` gated equal to ``ref_int8``,
   ``fused_int8`` held as granite's), ``Engine`` from a [4, 64, 8192]
   embedding prompt for 16 steps with exact launch counts, ``spec_k = 4``
   and ``spec_tree = 6, spec_branch = 2`` gated 8 of 8 equal to the plain
   ``fused_int8`` trace with the verify window's K/V equal to sequential
   decode's, and its captured decode step; and nemotron-4-340b (d 18432,
   96 heads of 192 in 8 groups, relu2, ff 73728, untied vocab 256000) at
   full width with 2 of its 96 layers (65.4 GB of f32 weights; 3 layers do
   not fit): B1 / B5 at its linears (K up to 73728), B2-B4 at G 8, rep 12,
   D 192 (the body's wider instance) also across pool sizes, the reduced
   model, the three backends, and its captured decode step; then
   grok-1-314b (d 6144, 48 heads of 128 in 8 groups, 8 SwiGLU experts of
   32768 with top-2 routing and capacity, untied vocab 131072) at full
   width with 2 of its 64 layers (39.4 GB of f32 layers, 6.4 GB of
   embedding and head; a third layer does not fit): B1 / B5 at its
   attention linears, the grouped B1 (``int8_matmul_grouped``) at its
   expert stacks (K 6144 / 32768) for C 2 (a decode step at 4 slots) and
   C 10 (a ``spec_k = 4`` window) with experts of 0, 1 and C rows,
   bit-equal to its plain version and to B1 on each expert's slice, beside
   the summed per-expert ``torch._int_mm``, with the kernel's own plan (its
   persistent grid, full waves and cut tiles); B2-B4 at G 8, rep 6, D 128,
   also across pool sizes; the reduced model and the same at 8 experts on
   the card against the CPU; the three backends (``pim_bitserial`` gated
   equal to ``ref_int8``, the dropped choices on the trace gated above 0,
   ``fused_int8`` held to the served rows' near-ties), ``Engine``,
   ``multi_step = 4`` (gated 8 of 8 on a lockstep trace) and its captured
   decode step; then deepseek-v3-671b (d 7168, MLA with 128 heads, q_lora
   1536, kv_lora 512, nope 128, rope 64, v 128; 3 dense SwiGLU layers of
   18432, then MoE layers of 256 SwiGLU experts of 2048, top-8, one shared
   expert; untied vocab 129280; the MTP head) at full width with 4 of its
   61 layers (the 3 dense and 1 MoE) and the MTP head, its int8 tree (32.6
   GB) drawn and quantized a part at a time, an expert at a time (the f32
   tree, about 107 GB, does not fit), prefill served int8 too: B1 / B5 over
   the MLA linears (N 576 included) and the dense FFN at M 4, the grouped
   B1 at E 256 for C 1 and C 2 with experts of 0, 1 and C rows, RMSNorm at
   1536, 512 and 7168 (all gated as for the other families), the reduced
   model on the card against the CPU (logits, and the served streams under
   the three backends and the MTP lanes ``spec_k = 3`` and ``spec_tree =
   3, spec_branch = 2``, gated equal to the CPU's), the phase-4 trace under
   ``fused_int8``, ``pim_bitserial`` and ``ref_int8`` (gated 8 of 8 equal,
   exact launch counts, the dropped choices gated above 0), the MTP lanes
   ``spec_k = 4`` and ``spec_tree = 6, spec_branch = 2`` (each run twice,
   gated equal, at budget, with verify steps and exact launch counts), the
   top-8 combine on the card (bit-equal to the CPU's sums, repeating its
   bits), the decode step's parts timed apart, and the captured verify and
   decode steps against eager; then jamba-1.5-large-398b (the hybrid stack:
   d 8192, Mamba2 SSD layers of 256 heads of 64 with state 128, GQA of 64
   heads of 128 in 8 groups every 8th layer, 16 SwiGLU experts of 24576
   top-2 on every other layer, dense SwiGLU of 24576 on the rest, untied
   vocab 65536) at full width with 8 of its 72 layers, one period of its
   interleave (SSM at 0-3 and 5-7, attention at 4), its int8 tree (about
   48 GB) drawn a part at a time (the f32 tree, about 180 GB, does not
   fit), prefill served int8 at exact length: B1 / B5 over an attention
   layer's, an SSM layer's and a dense FFN's linears at M 4, B2 at rep 8,
   B6 at 256 heads, the grouped B1 at E 16 for C 1 and C 13, RMSNorm at
   8192 and 16384 (all gated as for the other families), the reduced model
   on the card against the CPU (logits, and its streams under the three
   backends), the phase-4 trace under ``fused_int8``, ``pim_bitserial``
   and ``ref_int8`` (exact launch counts, B6 on prefill; ``pim_bitserial``
   gated equal to ``ref_int8``, the dropped choices gated above 0, and
   where ``fused_int8`` parts, ``ref_int8`` on the fused lane's own inputs
   and the first parting step's served rows gated to near-ties), B6 against its plain version on the
   trace's prefills, ``Engine``, and the captured decode step against
   eager; then whisper-tiny (the encoder-decoder: 4 encoder and 4 decoder
   layers, d 384, 6 heads of 64, gelu, LayerNorm, 1,500 frames from the
   stubbed front end, tied vocab 51865) uncut: B1 / B5 over a decoder
   layer's linears, B2 at rep 1, D 64, the reduced model on the card
   against the CPU (logits and ``Engine`` streams under the three
   backends), ``Engine.generate`` from seeded frames [4, 1500, 384] under
   the three backends (exact launch counts, ``pim_bitserial`` gated equal
   to ``ref_int8``, ``fused_int8`` held to near-ties where it parts) and
   its captured decode step against eager; each family's peak device
   memory recorded;
8. ``train`` (the training path, after every family's weights are freed):
   both norms' backward kernels against autograd of their plain versions
   at [1024, 4096] and [1024, 768] (within 1e-5 of the gradient's scale,
   the same bits on a second call; each handed the forward's statistics,
   the same bits without them, one device kernel a call and the same bits
   on two graph replays), timed beside the plain version
   and ``torch.ops.aten``'s fused backward, with their byte bounds; llama3-8b
   at full width with 8 of its 32 layers in f32, batch 8 x 128 from the
   seeded synthetic stream: one step's gradient through the norm kernels
   against the plain norms (every leaf within 1e-3 of its scale, every
   norm scale's gradient nonzero, one forward and one backward launch a
   norm), then 4 AdamW steps on the repeated batch under f32 and under
   int8 moments (gated: finite losses that fall), with step time, tokens a
   second, peak memory and 6 N tokens over the step; and opt-125m uncut
   through ``ResilientRunner`` (checkpoints every 5 steps, failures
   injected at steps 7 and 13, 20 steps, int8 moments) in a process of its
   own under ``torch.use_deterministic_algorithms(True)``, gated bit-equal
   to a clean run (final weights and every logged loss);
9. ``plan`` (last): ``Runtime.dmvm_dtype`` on the card: llama3-8b at full
   width (int8 tree, 4 slots at ragged cursors) one decode step under
   ``fused_int8`` gated bit-equal at bf16 and f32 (B1 and B2 take no
   dtype), and under ``ref_int8`` the bf16 step's captured replay gated
   bit-equal to eager over 8 steps, its gap from f32 recorded, the bf16
   and f32 steps held against the CPU's from the same state (within 10%
   of the logit scale: 32 random layers carry an ulp's code flip that
   far) and one layer's attention at bf16 and f32 against the CPU's
   within 1e-3 of its scale, nearer than bf16 lies to f32;
   deepseek-v3-671b's part runs in phase ``families`` where its tree
   lives (an MLA layer's attention timed at bf16 beside f32, 4 B1
   launches a call, its output held against the CPU's within 1e-3 of its
   scale, the bf16 captured decode step gated bit-equal to eager) and is
   gated here to have run; the per-layer cache API
   (``append_layer``, ``append_layer_chunk``, ``append_latent``,
   ``layer_view``) gated bit-equal to the CPU's; ``python -m
   repro_torch.launch.dryrun --quick`` and ``--arch llama3-8b`` in a process
   of their own (every record ``ok`` or skipped for ``applicable``'s own
   reason, counted flops > 0, ``model_flops`` equal to the host's, each
   decode cell's peak over a real step that launched B1, and B2 where the
   stack attends); and ``examples/quickstart_torch.py`` on the card.

Every path runs a row-invariant norm kernel for every norm on the card
(``rms_norm``, or ``layer_norm`` for OPT; QK-norm's two a layer through
``rms_norm``); each serve run's launch counts include it.  Under
``fused_int8`` and ``pim_bitserial`` a norm whose output feeds quantized
linears on the int8 tree runs its fused entry instead (``rms_norm_quant``,
``layer_norm_quant``), which also writes the output's int8 codes and
scales for those linears; ``ref_int8`` quantizes a linear's input in each
linear.  The training
path's norms run it through an autograd Function whose backward is the
norm's backward kernel (``rms_norm_backward``, ``layer_norm_backward``).

The script prints its seconds; its last three lines are the
``kernels`` JSON, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  The full record goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12       # dense int8 tensor rate
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor rate
L2_BYTES = 50e6


def bound_ms(n_bytes: float, ops: list[tuple[float, float]]) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the memory rate and
    the sum of operations over their type's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in ops)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn(i)`` over ``iters`` calls, CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device milliseconds per call: ``iters`` calls captured into one CUDA
    graph and replayed between CUDA events, so host launch overhead (which
    ``cuda_ms`` of back-to-back eager calls includes) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timed(torch, fn, iters: int) -> dict:
    """Both times of ``fn``: device time (graph replay) and the per-call
    time of eager back-to-back calls (launch overhead included)."""
    return {"device_ms": graph_ms(torch, fn, iters),
            "eager_ms": cuda_ms(torch, fn, iters)}


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []
        self.record: dict = {}

    def phase(self, name: str, fn) -> None:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            self.record[name] = fn()
        except Exception as e:  # noqa: BLE001 - every phase reports, then the script fails
            import traceback
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
        self.record.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        print(f"   {name}: {self.record['phase_s'][name]:.1f} s", flush=True)


def copies(torch, make, n_bytes: int) -> list:
    """Enough independent input sets that cycling through them keeps the
    50 MB L2 cold, as each layer's weights are on the decode path."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / n_bytes)))]


def phase_build(torch, build) -> dict:
    t0 = time.perf_counter()
    logs = build.build()
    out = {"build_s": time.perf_counter() - t0, "ptxas": {}}
    for name, log in logs.items():
        keep = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        out["ptxas"][name] = keep
        for ln in keep:
            print(f"   {name}: {ln}")
    print(f"   built {sorted(logs)} in {out['build_s']:.1f} s")
    out["decode_attn_body"] = attn_body_resources(logs.get("decode_attn", ""))
    # the two kernels' dynamic shared memory a block at the main path's shapes
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ssd_chunk as ssd
    out["smem_bytes"] = {
        "int8_matmul": {f"M{m}_K{k}_N{n}": mm.launch_plan(m, k, n, 132).smem_bytes
                        for m in (4, 28) for k, n in (*LINEAR_SHAPES, *MAMBA2_LINEAR_SHAPES)},
        "ssd_chunk": {f"Q{q}": ssd.smem_bytes(q, SSD_HEADS, SSD_GROUPS, SSD_HEAD_DIM, SSD_STATE)
                      for q in (128, 37, 1)}}
    for name, per in out["smem_bytes"].items():
        print(f"   {name}: dynamic shared memory a block {per}")
    return out


def attn_body_resources(log: str) -> list:
    """Registers, spilled bytes and static shared memory of each mask's
    instantiation of the attention body (B2 0, B3 1, B4 2) at each head-dim
    instance (128: D <= 128; 192: above, whose shared memory is dynamic),
    read from ``ptxas -v``; empty when the library was already built."""
    import re

    from repro_torch.kernels import decode_attn as da
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"attn_kernelILi(\d)ELi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            cur = {"mask": int(m.group(1)), "dm": int(m.group(2)),
                   "smem_bytes_a_cta": da.smem_bytes(int(m.group(2)))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(m.group(1)) if m else 0
    for r in sorted(rows, key=lambda r: (r["dm"], r["mask"])):
        print(f"   decode_attn body, D <= {r['dm']}, mask {r['mask']}: {r.get('registers')} "
              f"registers, {r.get('spill_bytes')} bytes spilled, {r['smem_bytes_a_cta']} bytes "
              f"shared memory a CTA ({r.get('static_smem_bytes')} static), 128 threads, "
              f"clusters of 8 CTAs")
    return rows


LINEAR_SHAPES = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}


def linear_inputs(torch, g, M: int, K: int, N: int, w_low: int = -127) -> tuple:
    """A linear's kernel inputs on the card: x_q int8 [M,K], x_s f32 [M,1],
    w_q int8 [K,N] in [w_low, 127], w_s f32 [N]."""
    return (torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8),
            torch.rand((M, 1), generator=g, device="cuda") * 0.01 + 1e-3,
            torch.randint(w_low, 128, (K, N), generator=g, device="cuda", dtype=torch.int8),
            torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3)


def phase_linears(torch, mm, pim, quant) -> dict:
    """B1 at M = 4 over one llama3-8b layer's linears (wq, wo: 4096x4096;
    wk, wv: 4096x1024; w_up, w_gate: 4096x14336; w_down: 14336x4096); B1's
    device operations a call; B1 per llama layer at the verify M (20, 28)
    and per mamba2-2.7b layer at M 4 (w_z, w_x: 2560x5120; out_proj:
    5120x2560); B5 per llama layer at M 1, 4, 20 and 28 and its device
    operations a call."""
    g = torch.Generator(device="cuda").manual_seed(1)
    M = 4
    res = {"shapes": [], "int8_matmul": {}}
    for (K, N), count in LINEAR_SHAPES.items():
        def make():
            return linear_inputs(torch, g, M, K, N)
        x_q, x_s, w_q, w_s = make()
        out_k, acc_k = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
        out_n, _ = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s, with_acc=False)
        out_p, acc_p = mm.int8_matmul_plain(x_q, x_s, w_q, w_s)
        torch.cuda.synchronize()
        checks = {"b1_acc_eq_plain": torch.equal(acc_k, acc_p),
                  "b1_out_eq_plain": torch.equal(out_k, out_p),
                  "b1_out_without_acc_eq_plain": torch.equal(out_n, out_p)}
        err1 = float((out_k - out_p).abs().max())
        if not all(checks.values()):
            raise AssertionError(f"K={K} N={N}: {checks}")

        sets = copies(torch, make, K * N)
        n = len(sets)
        t_b1 = timed(torch, lambda i: mm.int8_matmul_cuda(*sets[i % n], with_acc=False), 50)
        t_b1p = timed(torch, lambda i: mm.int8_matmul_plain(*sets[i % n]), 5)
        # the library int8 GEMM, timed as a yardstick only: it needs M > 16,
        # so x is zero-padded to 32 rows
        pads = [torch.cat([s_[0], s_[0].new_zeros((32 - M, K))]) for s_ in sets]
        t_lib, lib_note, lib_layouts = int_mm_ms(torch, pads, [s_[2] for s_ in sets])
        io = M * K + 4 * M + 4 * N + 4 * M * N
        b1_bound = bound_ms(io + K * N, [(2 * M * K * N, INT8_OPS_PER_S)])
        row = {"K": K, "N": N, "count_per_layer": count, "checks": checks,
               "b1_bound_by": b1_bound[1],
               "b1_ms": t_b1["device_ms"], "b1_plain_ms": t_b1p["device_ms"],
               "b1_bound_ms": b1_bound[0], "b1_eager_ms": t_b1["eager_ms"],
               "library_ms": t_lib, "library": lib_note, "library_layouts_ms": lib_layouts,
               "b1_max_abs_err": err1}
        res["shapes"].append(row)
        lib_us = "n/a" if t_lib is None else f"{t_lib * 1e3:.1f}"
        print(f"   M={M} K={K:5d} N={N:5d} (us, device / eager): B1 "
              f"{row['b1_ms'] * 1e3:.1f} / {row['b1_eager_ms'] * 1e3:.1f} (bound "
              f"{b1_bound[0] * 1e3:.1f}, plain {row['b1_plain_ms'] * 1e3:.1f}, "
              f"library {lib_us} [{lib_note}])  {checks}")
        del sets, pads
    rows = res["shapes"]
    lib = [r["library_ms"] for r in rows]
    res["int8_matmul"] = {
        "ms": sum(r["b1_ms"] * r["count_per_layer"] for r in rows),
        "plain_ms": sum(r["b1_plain_ms"] * r["count_per_layer"] for r in rows),
        "bound_ms": sum(r["b1_bound_ms"] * r["count_per_layer"] for r in rows),
        "library_ms": (None if None in lib else
                       sum(r["library_ms"] * r["count_per_layer"] for r in rows)),
        "max_abs_err": max(r["b1_max_abs_err"] for r in rows),
        "bound_by": max(rows, key=lambda r: r["b1_bound_ms"] * r["count_per_layer"])[
            "b1_bound_by"]}
    res["one_call"] = b1_device_ops(torch, mm, g)
    res["verify_m"] = {M: b1_per_layer(torch, mm, g, M, LINEAR_SHAPES) for M in (20, 28)}
    res["mamba2"] = b1_per_layer(torch, mm, g, 4, MAMBA2_LINEAR_SHAPES)
    res["b5"] = {M: b5_per_layer(torch, mm, pim, quant, g, M) for M in B5_M}
    res["pim_mvm"] = res["b5"][4]
    res["b5_one_call"] = b5_device_ops(torch, pim, g)
    return res


def device_ops(torch, fn) -> list:
    """The names of the device operations (kernels, memsets, copies) of one
    ``fn()``, from ``torch.profiler``, after one warm-up call; a trace that
    recorded no device event at all is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if names:
            break
    return names


def b1_device_ops(torch, mm, g) -> dict:
    """The device operations of one B1 call on the model path (K 4096,
    N 1024, M 4 and 20), from ``torch.profiler``: one kernel, no memset, no
    copy."""
    out = {}
    for M in (4, 20):
        args = linear_inputs(torch, g, M, 4096, 1024)
        names = device_ops(torch, lambda: mm.int8_matmul_cuda(*args, with_acc=False))
        out[M] = names
        print(f"   one B1 call at M={M}, K=4096, N=1024: {len(names)} device operation(s) "
              f"{[n[:48] for n in names]}; plan {mm.launch_plan(M, 4096, 1024, 132)}")
        if len(names) != 1 or "int8_mm_cluster" not in names[0]:
            raise AssertionError(f"B1 at M={M} issued {names}, not one kernel")
    return out


def b5_device_ops(torch, pim, g) -> dict:
    """The device operations of one B5 call on the model path (K 4096,
    N 1024, M 1, 4 and 20), from ``torch.profiler``: one kernel, no memset,
    no copy, no epilogue kernel."""
    out = {}
    for M in (1, 4, 20):
        args = linear_inputs(torch, g, M, 4096, 1024)
        names = device_ops(torch, lambda: pim.pim_mvm_cuda(*args, with_acc=False))
        out[M] = names
        print(f"   one B5 call at M={M}, K=4096, N=1024: {len(names)} device operation(s) "
              f"{[n[:48] for n in names]}; plan {pim.launch_plan(M, 4096, 1024, 132)}")
        if len(names) != 1 or "pim_mvm_cluster" not in names[0]:
            raise AssertionError(f"B5 at M={M} issued {names}, not one kernel")
    return out


def int_mm_ms(torch, xs: list, ws: list, epilogue=None) -> tuple:
    """Device ms of ``torch._int_mm`` cycling over the given operands, with
    the weight row-major and column-major (cuBLASLt's TN layout) in turn,
    followed by ``epilogue(acc, i)`` where one is given; returns the faster
    time and its note, and both layouts' times (None where the library
    refuses the layout)."""
    n = len(xs)
    times = {}
    for layout in ("row-major", "column-major"):
        w_l = ws if layout == "row-major" else [w.t().contiguous().t() for w in ws]
        if epilogue is None:
            def fn(i):
                return torch._int_mm(xs[i % n], w_l[i % n])
        else:
            def fn(i):
                return epilogue(torch._int_mm(xs[i % n], w_l[i % n]), i % n)
        try:
            times[layout] = timed(torch, fn, 50)["device_ms"]
        except RuntimeError as e:
            times[layout] = None
            times[layout + " refused"] = str(e).splitlines()[0][:120]
        del w_l
    ok = {k: times[k] for k in ("row-major", "column-major") if times[k] is not None}
    if not ok:
        return None, "torch._int_mm refused both layouts", times
    best = min(ok, key=ok.get)
    what = "int32 product, no epilogue" if epilogue is None else "int32 product, f32 epilogue"
    return ok[best], f"torch._int_mm, {best} weight ({what})", times


MAMBA2_LINEAR_SHAPES = {(2560, 5120): 2, (5120, 2560): 1}   # w_z, w_x; out_proj


def b1_per_layer(torch, mm, g, M: int, shapes: dict) -> dict:
    """B1 at M rows over one layer's linears (llama3-8b's at the verify M,
    n_slots x window = 4 x 5 or 4 x 7; mamba2-2.7b's at M 4), bit-exact
    against the plain version, beside the plain version's and
    ``torch._int_mm``'s times (x zero-padded to 32 rows where M <= 16, as
    the library needs); the output is checked with and without the integer
    sums (the model path takes none)."""
    tot = {"b1_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "shapes": []}
    for (K, N), count in shapes.items():
        def make():
            return linear_inputs(torch, g, M, K, N)
        sets = copies(torch, make, K * N)
        n = len(sets)
        out_k, acc_k = mm.int8_matmul_cuda(*sets[0])
        out_n, _ = mm.int8_matmul_cuda(*sets[0], with_acc=False)
        out_p, acc_p = mm.int8_matmul_plain(*sets[0])
        if not (torch.equal(acc_k, acc_p) and torch.equal(out_k, out_p)
                and torch.equal(out_n, out_p)):
            raise AssertionError(f"B1 at M={M} K={K} N={N} differs from its plain version")
        t_b1 = graph_ms(torch, lambda i: mm.int8_matmul_cuda(*sets[i % n], with_acc=False), 50)
        t_plain = graph_ms(torch, lambda i: mm.int8_matmul_plain(*sets[i % n]), 5)
        xs = [s_[0] if M > 16 else torch.cat([s_[0], s_[0].new_zeros((32 - M, K))])
              for s_ in sets]
        t_lib, note, layouts = int_mm_ms(torch, xs, [s_[2] for s_ in sets])
        b = bound_ms(M * K + 4 * M + 4 * N + 4 * M * N + K * N,
                     [(2 * M * K * N, INT8_OPS_PER_S)])
        tot["b1_ms"] += t_b1 * count
        tot["plain_ms"] += t_plain * count
        tot["library_ms"] = (None if t_lib is None or tot["library_ms"] is None
                             else tot["library_ms"] + t_lib * count)
        tot["bound_ms"] += b[0] * count
        tot["shapes"].append({"K": K, "N": N, "count_per_layer": count, "b1_ms": t_b1,
                              "plain_ms": t_plain, "bound_ms": b[0], "library_ms": t_lib,
                              "library": note, "library_layouts_ms": layouts,
                              "plan": mm.launch_plan(M, K, N, 132)._asdict()})
        lib_us = "n/a" if t_lib is None else f"{t_lib * 1e3:.1f}"
        print(f"   M={M} K={K:5d} N={N:5d}: B1 {t_b1 * 1e3:.1f} us (bound {b[0] * 1e3:.1f}, "
              f"plain {t_plain * 1e3:.1f}), library {lib_us} us  [{note}; {layouts}]")
        del sets, xs
    lib = tot["library_ms"]
    print(f"   M={M} per layer: B1 {tot['b1_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.3f} ms, library {'n/a' if lib is None else f'{lib:.4f}'} ms")
    return tot


B5_M = (1, 4, 20, 28)    # the paper's single batch, 4 slots, the verify windows


def b5_per_layer(torch, mm, pim, quant, g, M: int, shapes: dict = LINEAR_SHAPES) -> dict:
    """B5 at M rows over one layer's linears (llama3-8b's by default), on the weight's
    bytes as the model passes them: its sums and output bit-equal to B1's
    and to the plain version's (on the two cell planes), with and without
    the integer sums; timed (graph replay, the L2 kept cold) beside the
    plain version and ``torch._int_mm`` followed by the same f32 epilogue
    (x zero-padded to 32 rows where M <= 16, as the library needs; its
    output also checked equal to B5's); the bound counts each weight's two
    cells as its one byte and Eq. 2's 32*M*K*N operations at the int8 tensor
    rate; the launch plan (rows of x a pass, passes) printed."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "eager_ms": 0.0,
           "max_abs_err": 0.0, "shapes": []}
    by = {}
    for (K, N), count in shapes.items():
        def make():     # every weight byte, -128 (both sign cells set) included
            return linear_inputs(torch, g, M, K, N, w_low=-128)
        sets = copies(torch, make, K * N)
        n = len(sets)
        x_q, x_s, w_q, w_s = sets[0]
        out5, acc5 = pim.pim_mvm_cuda(x_q, x_s, w_q, w_s)
        out5n, none = pim.pim_mvm_cuda(x_q, x_s, w_q, w_s, with_acc=False)
        out1, acc1 = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
        out_p, acc_p = pim.pim_mvm_plain(x_q, x_s, *quant.pack_qlc(w_q), w_s)
        pad = 32 - M if M <= 16 else 0
        xs_l = [torch.cat([s_[0], s_[0].new_zeros((pad, K))]) for s_ in sets]

        def epilogue(acc, i):
            return (acc[:M].to(torch.float32) * sets[i][1]) * sets[i][3]
        out_lib = epilogue(torch._int_mm(xs_l[0], w_q), 0)
        torch.cuda.synchronize()
        checks = {"acc_eq_b1": torch.equal(acc5, acc1), "acc_eq_plain": torch.equal(acc5, acc_p),
                  "out_eq_b1": torch.equal(out5, out1), "out_eq_plain": torch.equal(out5, out_p),
                  "out_without_acc_eq_plain": none is None and torch.equal(out5n, out_p),
                  "library_out_eq_b5": torch.equal(out_lib, out5)}
        if not all(checks.values()):
            raise AssertionError(f"B5 at M={M} K={K} N={N}: {checks}")
        t = timed(torch, lambda i: pim.pim_mvm_cuda(*sets[i % n], with_acc=False), 30)
        t_plain = graph_ms(torch, lambda i: pim.pim_mvm_plain(
            sets[i % n][0], sets[i % n][1], *quant.pack_qlc(sets[i % n][2]), sets[i % n][3]), 3)
        t_lib, note, layouts = int_mm_ms(torch, xs_l, [s_[2] for s_ in sets], epilogue)
        b = bound_ms(M * K + 4 * M + 4 * N + 4 * M * N + K * N,
                     [(32 * M * K * N, INT8_OPS_PER_S)])
        plan = pim.launch_plan(M, K, N, 132)
        tot["ms"] += t["device_ms"] * count
        tot["eager_ms"] += t["eager_ms"] * count
        tot["plain_ms"] += t_plain * count
        tot["library_ms"] = (None if t_lib is None or tot["library_ms"] is None
                             else tot["library_ms"] + t_lib * count)
        tot["bound_ms"] += b[0] * count
        by[b[1]] = by.get(b[1], 0.0) + b[0] * count
        tot["max_abs_err"] = max(tot["max_abs_err"], float((out5 - out_p).abs().max()))
        tot["shapes"].append({"K": K, "N": N, "count_per_layer": count, "ms": t["device_ms"],
                              "eager_ms": t["eager_ms"], "plain_ms": t_plain,
                              "bound_ms": b[0], "bound_by": b[1], "library_ms": t_lib,
                              "library": note, "library_layouts_ms": layouts,
                              "checks": checks, "plan": plan._asdict()})
        lib_us = "n/a" if t_lib is None else f"{t_lib * 1e3:.1f}"
        print(f"   M={M} K={K:5d} N={N:5d}: B5 {t['device_ms'] * 1e3:.1f} us (eager "
              f"{t['eager_ms'] * 1e3:.1f}; bound {b[0] * 1e3:.1f} by {b[1]}, plain "
              f"{t_plain * 1e3:.1f}), library {lib_us} us [{note}]; plan {tuple(plan)}; "
              f"bit-equal to B1 and plain, with and without acc")
        del sets, xs_l
    tot["bound_by"] = max(by, key=by.get)
    lib = tot["library_ms"]
    print(f"   M={M} per layer: B5 {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['bound_by']}), plain {tot['plain_ms']:.3f} ms, library "
          f"{'n/a' if lib is None else f'{lib:.4f}'} ms")
    return tot


# B2, B3 and B4 share one body (csrc/decode_attn.cu): llama3-8b's groups at
# 4 slots (B, G, rep, D), B2 in a pool of S rows at the given lengths
ATTN_B, ATTN_G, ATTN_REP, ATTN_D = 4, 8, 4, 128
LLAMA_ATTN = (ATTN_B, ATTN_G, ATTN_REP, ATTN_D)
B2_SHAPES = ((512, (1, 200, 377, 512)), (4096, (1, 1000, 2500, 4096)))
# B3 / B4 windows (name, T, max_len, cursors) in their lanes' pools of
# max_len + T - 1 rows: T 5 is ``spec_k = 4``, T 7 ``spec_tree = 6``, T 31
# ``spec_tree = 30``; the last cursor a slot at max_len - 1
VERIFY_CASES = (("verify_attn", 5, 256, (3, 90, 177, 255)),
                ("verify_tree_attn", 7, 256, (3, 90, 177, 255)),
                ("verify_tree_attn_31", 31, 256, (3, 90, 177, 255)),
                ("verify_attn_long", 5, 4096, (3, 1000, 2500, 4095)),
                ("verify_tree_attn_long", 7, 4096, (3, 1000, 2500, 4095)))
# B3 against B2 across pools: cursors whose window rows pos + t land on a
# chunk boundary (64 keys) -1, 0 and +1, and on a cluster round (8 chunks)
CROSS_POOL = ((256, (61, 125, 190, 251)), (4096, (61, 509, 2045, 4091)))


def kv_pool(torch, quant, g, S: int, attn: tuple = LLAMA_ATTN) -> tuple:
    """A random int8 K/V pool of S rows for the (B, G, rep, D) of ``attn``:
    k_q, k_s, v_q, v_s as the kernels take them."""
    shape = (attn[0], S, attn[1], attn[3])
    k_q, k_s = quant.quantize_kv(torch.randn(shape, generator=g, device="cuda"))
    v_q, v_s = quant.quantize_kv(torch.randn(shape, generator=g, device="cuda"))
    return k_q, k_s[..., 0].contiguous(), v_q, v_s[..., 0].contiguous()


def b2_case(torch, da, quant, S: int, lengths: tuple, attn: tuple = LLAMA_ATTN) -> dict:
    """B2 in a pool of S rows at ragged lengths, at the (B, G, rep, D) of
    ``attn``: parity with the plain version (gated), device / eager / plain
    times, bound."""
    g = torch.Generator(device="cuda").manual_seed(2)
    B, G, rep, D = attn
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def make():
        q_q, q_s = quant.quantize_kv(torch.randn((B, G * rep, D), generator=g, device="cuda"))
        return (q_q.reshape(B, G, rep, D), q_s.reshape(B, G, rep, 1),
                *kv_pool(torch, quant, g, S, attn), lengths)
    args = make()
    out_k = da.decode_attn_cuda(*args)
    out_p = da.decode_attn_plain(*args)
    torch.testing.assert_close(out_k, out_p, rtol=3e-5, atol=3e-6)
    err = float((out_k - out_p).abs().max())
    live = int(lengths.sum())
    n_bytes = (B * G * rep * (D + 4) + 2 * live * G * (D + 4) + 4 * B
               + 4 * B * G * rep * D)
    sets = copies(torch, make, 2 * B * S * G * (D + 4))
    n = len(sets)
    tk = timed(torch, lambda i: da.decode_attn_cuda(*sets[i % n]), 50)
    tp = timed(torch, lambda i: da.decode_attn_plain(*sets[i % n]), 10)
    t_k, t_p = tk["device_ms"], tp["device_ms"]
    b = bound_ms(n_bytes, [(2 * live * G * rep * D, INT8_OPS_PER_S),
                           (2 * live * G * rep * D, FP32_FLOPS_PER_S)])
    print(f"   B={B} G={G} rep={rep} D={D} S={S} lengths={lengths.tolist()}: "
          f"B2 {t_k * 1e3:.1f} us device / {tk['eager_ms'] * 1e3:.1f} eager (bound "
          f"{b[0] * 1e3:.2f}, plain {t_p * 1e3:.1f}) "
          f"max_abs_err {err:.3g}")
    return {"ms": t_k, "plain_ms": t_p, "bound_ms": b[0], "bound_by": b[1],
            "eager_ms": tk["eager_ms"], "plain_eager_ms": tp["eager_ms"],
            "library_ms": None, "max_abs_err": err,
            "shape": {"B": B, "G": G, "rep": rep, "D": D, "S": S,
                      "lengths": lengths.tolist()}}


def b2_device_ops(torch, da, quant) -> list:
    """The device operations of one B2 call at the phase shape, from
    ``torch.profiler``: one cluster kernel, no memset, no copy (gated)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(5)
    B, G, rep, D = ATTN_B, ATTN_G, ATTN_REP, ATTN_D
    q_q, q_s = quant.quantize_kv(torch.randn((B, G * rep, D), generator=g, device="cuda"))
    args = (q_q.reshape(B, G, rep, D), q_s.reshape(B, G, rep, 1),
            *kv_pool(torch, quant, g, 512),
            torch.tensor(B2_SHAPES[0][1], dtype=torch.int32, device="cuda"))
    da.decode_attn_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        da.decode_attn_cuda(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    print(f"   one B2 call: {len(names)} device operation(s) {[n[:48] for n in names]}")
    if len(names) != 1 or "attn_kernel" not in names[0]:
        raise AssertionError(f"B2 issued {names}, not one kernel")
    return names


def phase_attention(torch, da, quant) -> dict:
    """B2 at B 4, G 8, rep 4, D 128 at S 512 (the record the ``kernels``
    line reports) and at S 4,096; one device operation a call."""
    (S, lengths), (S_long, lengths_long) = B2_SHAPES
    rec = b2_case(torch, da, quant, S, lengths)
    rec["long"] = b2_case(torch, da, quant, S_long, lengths_long)
    rec["one_call"] = b2_device_ops(torch, da, quant)
    return rec


# the device kernel of each hand kernel's wrapper: B2, B3 and B4 launch one
# attention body
DEVICE_KERNELS = {"int8_matmul": "int8_mm_cluster", "int8_matmul_grouped": "int8_mm_grouped",
                  "pim_mvm": "pim_mvm_cluster",
                  "decode_attn": "attn_kernel", "verify_attn": "attn_kernel",
                  "verify_tree_attn": "attn_kernel", "ssd_chunk": "ssd_chunk_kernel",
                  "rms_norm": "rms_norm_kernel", "rms_norm_quant": "rms_norm_quant_kernel",
                  "layer_norm": "layer_norm_kernel",
                  "layer_norm_quant": "layer_norm_quant_kernel",
                  "rms_norm_backward": "rms_norm_bwd",
                  "layer_norm_backward": "layer_norm_bwd"}


def device_launches(counts: dict) -> dict:
    """Wrapper launch counts summed by the device kernel they launch."""
    out = dict.fromkeys(DEVICE_KERNELS.values(), 0)
    for name, n in counts.items():
        out[DEVICE_KERNELS[name]] += n
    return out


def profile_step(torch, fn, what: str = "decode") -> dict:
    """Where one full-width decode (or verify) step's time goes: its wall time (host
    clock, ended by a synchronize), the device's busy time (the sum of the
    kernels' own durations under ``torch.profiler``), the idle share, the
    kernels and host ops that take the most, and the device events of each
    hand kernel (``hand_kernels``, by the names in ``DEVICE_KERNELS``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels: dict[str, list] = {}
    kinds = {"kernel": 0, "memset": 0, "memcpy": 0}
    hand = dict.fromkeys(DEVICE_KERNELS.values(), 0)
    fills = 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            for name in hand:
                if name in e.name:
                    hand[name] += 1
            fills += "FillFunctor" in e.name
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
            low = e.name.lower()
            kinds["memset" if "memset" in low else "memcpy" if "memcpy" in low else "kernel"] += 1
    busy = sum(v[1] for v in kernels.values())
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    out = {"wall_us": wall_us, "device_busy_us": busy,
           "idle_share": max(0.0, 1 - busy / wall_us),
           "device_kernels": sum(v[0] for v in kernels.values()),
           "fill_kernels": fills,
           "device_events_by_kind": kinds, "hand_kernels": hand,
           "top_kernels": [{"name": n, "count": c, "us": u} for n, (c, u) in
                           sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
           "top_host_ops": [{"name": a.key, "count": a.count,
                             "self_cpu_us": a.self_cpu_time_total} for a in host]}
    print(f"   one {what} step: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {out['idle_share']:.3f}, "
          f"{out['device_kernels']} device events {kinds}, {out['fill_kernels']} fills")
    for k in out["top_kernels"]:
        print(f"     kernel {k['name']:60s} x{k['count']:4d} {k['us']:9.1f} us")
    for h in out["top_host_ops"]:
        print(f"     host   {h['name'][:60]:60s} x{h['count']:4d} {h['self_cpu_us']:9.1f} us")
    return out


def clone_state(state: dict) -> dict:
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
            "pos": state["pos"].clone()}


def phase_engine(torch, ctx) -> dict:
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantize_tree

    cfg = registry.get("llama3-8b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    ctx["params"] = params
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=128)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    eng.generate({"inputs": prompts}, steps=1)                # warm-up
    steps = 16
    reset_launch_counts()
    toks, tm = eng.generate({"inputs": prompts}, steps=steps)
    counts = launch_counts()
    want = want_launches(cfg, steps, [prompts.shape[1]], "decode_attn",
                         prefills=T.prefill_pieces(cfg, prompts.shape[1]))
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if tuple(toks.shape) != (4, steps) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    out = {"init_s": init_s, "quantize_s": quant_s, "prefill_s": tm["prefill_s"],
           "tpot_s": tm["tpot_s"], "decode_s": tm["decode_s"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "tokens_row0": toks[0].tolist()}
    print(f"   init {init_s:.1f} s, quantize {quant_s:.1f} s, prefill "
          f"{tm['prefill_s'] * 1e3:.1f} ms, TPOT {tm['tpot_s'] * 1e3:.2f} ms, "
          f"peak {out['max_memory_allocated'] / 1e9:.2f} GB, launches {counts}")

    # one decode step from one state under each kernel backend and the plain one
    logits0, state = M.prefill(params, cfg, {"inputs": prompts}, 128, Runtime("fused_int8"))
    tok = torch.argmax(logits0, -1).to(torch.int32)
    step = {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        reset_launch_counts()
        lg, _ = M.decode_step(eng.qparams, cfg, clone_state(state), tok, Runtime(backend))
        torch.cuda.synchronize()
        step[backend] = (lg, launch_counts())
    ctx["pim_launches"] = step["pim_bitserial"][1]["pim_mvm"]
    lf, lp, lr = (step[b][0] for b in ("fused_int8", "pim_bitserial", "ref_int8"))
    if step["pim_bitserial"][1] != dict(want_launches(cfg, 1, [], None, "pim_bitserial"),
                                        pim_mvm=7 * cfg.n_layers):
        raise AssertionError(f"pim_bitserial launches {step['pim_bitserial'][1]}")
    if not torch.isfinite(lf).all():
        raise AssertionError("non-finite fused_int8 logits")
    # B5's sums equal the plain int32 sums and both backends run the plain
    # attention, so the two are bit-equal.  fused_int8's B2 sums its softmax
    # in another order (last-bit differences); requantizing each attention
    # output to int8 turns a few of them into flipped codes, and the flips
    # compound over 32 layers of random weights, so that step is held to the
    # argmax and to 10% of the logit scale
    if not torch.equal(lp, lr):
        raise AssertionError("pim_bitserial logits differ from ref_int8's")
    diff = float((lf - lr).abs().max())
    scale = float(lr.abs().max())
    if not torch.equal(lf.argmax(-1), lr.argmax(-1)) or diff > 0.1 * scale:
        raise AssertionError(f"fused_int8 vs ref_int8: max diff {diff} (scale {scale})")
    out["step_compare"] = {"pim_eq_ref_int8": True, "fused_vs_ref_max_abs": diff,
                           "logit_scale": scale,
                           "launches": {b: v[1] for b, v in step.items()}}
    print(f"   one decode step: pim_bitserial == ref_int8 bit for bit; "
          f"fused_int8 vs ref_int8 max |diff| {diff:.3g} of {scale:.3g}, argmax equal")
    try:        # a measurement, not a check: a profiler fault is recorded
        out["decode_profile"] = profile_step(
            torch, lambda: M.decode_step(eng.qparams, cfg, clone_state(state), tok,
                                         Runtime("fused_int8")))
    except Exception as e:  # noqa: BLE001
        out["decode_profile"] = {"error": f"{type(e).__name__}: {e}"}
        print(f"   profile failed: {out['decode_profile']['error']}")
    try:
        out["pim_decode_profile"] = profile_step(
            torch, lambda: M.decode_step(eng.qparams, cfg, clone_state(state), tok,
                                         Runtime("pim_bitserial")), "pim_bitserial decode")
    except Exception as e:  # noqa: BLE001
        out["pim_decode_profile"] = {"error": f"{type(e).__name__}: {e}"}
        print(f"   profile failed: {out['pim_decode_profile']['error']}")
    del eng, state, step, lf, lp, lr
    torch.cuda.empty_cache()

    out.update(reduced_vs_cpu(torch, cfg))
    return out


def reduced_vs_cpu(torch, cfg, embeddings: bool = False, rcfg=None) -> dict:
    """A small input against a reference: the reduced model (``rcfg``, by
    default ``cfg.reduced()``) under ``fused_int8`` on the card (kernels)
    and on the CPU (plain versions), prefill (from [2, 24, d] embeddings
    where ``embeddings``; an encoder-decoder's from [2, S_enc, d] frames and
    24 tokens) plus one decode step from the same weights and prompts,
    within 2% of the logit scale, argmax equal."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    rcfg = cfg.reduced() if rcfg is None else rcfg
    rp_cpu = M.init_params(rcfg, seed=0, device="cpu")
    rp_gpu = convert.to_device(rp_cpu, "cuda")
    rq_cpu = quantize_tree(rp_cpu)
    rq_gpu = convert.to_device(rq_cpu, "cuda")
    rprompts = (torch.randn((2, 24, rcfg.d_model), generator=torch.Generator().manual_seed(3))
                * 0.5 if embeddings else
                torch.randint(0, rcfg.vocab_size, (2, 24),
                              generator=torch.Generator().manual_seed(3)))
    batch = {"inputs": rprompts}
    if rcfg.family == "encdec":
        batch = {"frames": torch.randn((2, rcfg.encoder_seq, rcfg.d_model),
                                       generator=torch.Generator().manual_seed(4)),
                 "tokens": rprompts}
    rt = Runtime("fused_int8")
    res, out = {}, {}
    for dev, p, q in (("cpu", rp_cpu, rq_cpu), ("cuda", rp_gpu, rq_gpu)):
        lg0, st = M.prefill(p, rcfg, {k: v.to(dev) for k, v in batch.items()}, 64, rt)
        t0 = torch.argmax(lg0, -1).to(torch.int32)
        lg1, _ = M.decode_step(q, rcfg, st, t0, rt)
        res[dev] = (lg0.cpu(), lg1.cpu())
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["cpu"][i], res["cuda"][i]
        d, sc = float((a - b).abs().max()), float(a.abs().max())
        if not torch.equal(a.argmax(-1), b.argmax(-1)) or d > 2e-2 * sc:
            raise AssertionError(f"reduced {what}: card vs cpu max diff {d} (scale {sc})")
        out[f"reduced_{what}_max_abs"] = d
        out[f"reduced_{what}_logit_scale"] = sc
    print(f"   reduced {rcfg.name}{' from embeddings' if embeddings else ''}"
          f"{f' at {rcfg.n_experts} experts' if rcfg.n_experts else ''}, card (kernels) "
          f"vs CPU (plain): prefill max |diff| "
          f"{out['reduced_prefill_max_abs']:.3g} of {out['reduced_prefill_logit_scale']:.3g}, "
          f"decode {out['reduced_decode_max_abs']:.3g} of "
          f"{out['reduced_decode_logit_scale']:.3g}, argmax equal")
    return out


def serve_trace(vocab_size: int) -> tuple[list, list]:
    """8 ragged requests (prompts 16-200 tokens, budgets 8-32), seed 3."""
    import numpy as np
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab_size, int(rng.integers(16, 201))).tolist()
               for _ in range(8)]
    budgets = [int(rng.integers(8, 33)) for _ in range(8)]
    return prompts, budgets


def norm_kernel(cfg) -> str:
    """The norm kernel a configuration's every norm launches."""
    return "layer_norm" if cfg.norm_type == "layernorm" else "rms_norm"


def linears_per_layer(cfg, i: int = 0) -> int:
    """W8A8 linears of layer ``i``'s step through B1 (or B5): an SSM
    layer's w_z, w_x and out_proj or an attention layer's wq, wk, wv and
    wo, then its MLP's w_up and w_down, with w_gate under SwiGLU (a MoE
    layer's experts run B1's grouped entry instead:
    :func:`expert_launches_per_layer`); an encoder-decoder's decoder layer
    its self-attention's 4, its cross-attention's wq and wo (the cross K/V
    are cached) and its MLP's."""
    mlp = 3 if cfg.mlp_type == "swiglu" else 2
    if cfg.family == "encdec":
        return 4 + 2 + mlp
    mixer = 3 if cfg.layer_kind(i) == "ssm" else 4
    return mixer + (0 if cfg.is_moe_layer(i) or not cfg.d_ff else mlp)


def norms_per_pass(cfg) -> int:
    """Norm launches of one pass over the decoder layers (a decode step or
    a prefill call): each layer's ``ln1``, an SSM layer's gated norm, each
    FFN's ``ln2``, then ``ln_f``; an encoder-decoder's decoder layer adds
    ``ln_x`` before its cross-attention."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1
    return 1 + sum(1 + (cfg.layer_kind(i) == "ssm") + bool(cfg.is_moe_layer(i) or cfg.d_ff)
                   for i in range(cfg.n_layers))


def fused_norms_per_pass(cfg) -> int:
    """Norm launches of one pass over a quantized tree under a kernel
    backend that the norm's entry fused with the activation quantizer
    (``rms_norm_quant``, or ``layer_norm_quant`` for a LayerNorm stack)
    takes: the norms whose output feeds quantized linears, each layer's
    ``ln1``, an SSM layer's gated norm, a dense FFN's ``ln2`` and an MLA
    layer's ``q_norm``; an encoder-decoder's decoder layer its ``ln1``,
    ``ln_x`` (the cross-attention's ``wq`` reads it) and ``ln2`` (a MoE
    layer's ``ln2``, MLA's ``kv_norm``, QK-norm and ``ln_f`` keep the
    unfused kernel)."""
    if cfg.family == "encdec":
        return 3 * cfg.n_layers
    return sum(1 + (cfg.layer_kind(i) == "ssm")
               + bool(cfg.d_ff and not cfg.is_moe_layer(i))
               + (cfg.attn_type == "mla" and cfg.layer_kind(i) != "ssm")
               for i in range(cfg.n_layers))


def expert_launches_per_layer(cfg, i: int = 0) -> int:
    """Grouped B1 launches of layer ``i``'s step: one an expert stack of a
    MoE layer (w_up, w_down and, under SwiGLU, w_gate), under every
    backend (quantized experts on the card always run the grouped entry)."""
    if not cfg.is_moe_layer(i):
        return 0
    return 3 if cfg.mlp_type == "swiglu" else 2


def want_launches(cfg, steps: int, prompt_lens: list[int], attn: str | None,
                  backend: str = "fused_int8", prefills: int | None = None,
                  int8_prefill: bool = False, draft_cells: int = 0) -> dict:
    """Exact kernel launches of ``steps`` decode (or verify) steps plus one
    prefill per prompt (or ``prefills`` prefill calls: the chunks of a
    chunked admission, an admission again after a preemption): each norm one
    launch of the configuration's norm kernel (two a layer, one for
    ``ln_f``), and under QK-norm two RMSNorm launches more a layer; under ``fused_int8`` an attention layer's step one B1 launch
    a linear (7 for llama's SwiGLU, 6 for OPT's gelu) and one of ``attn``,
    a mamba2 layer's step 3 B1 launches (w_z, w_x, out_proj), and a mamba2
    prefill one B6 launch per layer and 128-token chunk (float weights: no
    B1 in prefill); under ``pim_bitserial`` the same linears launch B5
    instead, and attention runs its plain version.  A MoE layer's step
    launches B1's grouped entry once an expert stack under every backend
    (3 under SwiGLU), besides its 4 attention linears.  An MLA layer's
    step runs 4 linears too (wq_a, wq_b, wkv_a, wo: decode dequantizes
    wkv_b) and two RMSNorm launches more (q_norm, kv_norm), its attention
    plain under every backend.  ``int8_prefill`` (a tree served int8 from
    prefill on, deepseek-v3-671b's) adds each prefill call's linears (an
    MLA layer's wkv_b too) and expert stacks; ``draft_cells`` counts the
    MTP head's cells, each a MoE layer's norms, 5 linears and expert
    stacks (its ``mtp_proj`` is float).  A hybrid stack counts each layer
    by its kind (B6 in prefill for its SSM layers, ``attn`` in decode for
    its attention layers); an encoder-decoder's prefill adds its encoder's
    norms (two a layer and ``ln_enc``; its float prefill runs no linear
    kernel).  Under ``fused_int8`` and ``pim_bitserial`` the norms of each
    pass over the int8 tree (decode and verify steps, an int8 prefill, the
    MTP cells' ``ln1`` and ``q_norm``) whose outputs feed quantized linears
    launch the norm's fused entry (``rms_norm_quant`` in place of
    ``rms_norm``, ``layer_norm_quant`` in place of ``layer_norm``:
    :func:`fused_norms_per_pass`); ``ref_int8`` keeps the unfused norm and
    the per-linear quantizer."""
    L = cfg.n_layers
    mla = cfg.attn_type == "mla"
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(L))
    prefills = len(prompt_lens) if prefills is None else prefills
    want = {"int8_matmul": 0, "int8_matmul_grouped": 0, "pim_mvm": 0, "decode_attn": 0,
            "verify_attn": 0, "verify_tree_attn": 0, "ssd_chunk": 0, "rms_norm": 0,
            "rms_norm_quant": 0, "layer_norm": 0, "layer_norm_quant": 0,
            "rms_norm_backward": 0, "layer_norm_backward": 0}
    want[norm_kernel(cfg)] = norms_per_pass(cfg) * (steps + prefills) + 4 * draft_cells
    if cfg.family == "encdec":
        want[norm_kernel(cfg)] += (2 * cfg.encoder_layers + 1) * prefills
    if cfg.use_qk_norm or mla:   # QK-norm's q and k, or MLA's q_norm and kv_norm
        want["rms_norm"] += 2 * L * (steps + prefills)
    if backend in ("fused_int8", "pim_bitserial"):
        fused = norm_kernel(cfg) + "_quant"
        passes = steps + (prefills if int8_prefill else 0)
        want[fused] = (fused_norms_per_pass(cfg) * passes
                       + 2 * draft_cells * (cfg.attn_type == "mla"))
        want[norm_kernel(cfg)] -= want[fused]
    linears = sum(linears_per_layer(cfg, i) for i in range(L))
    experts = sum(expert_launches_per_layer(cfg, i) for i in range(L))
    cell = expert_launches_per_layer(cfg, L - 1)
    want["int8_matmul_grouped"] = (experts * (steps + (prefills if int8_prefill else 0))
                                   + cell * draft_cells)
    linears = (linears * steps + (linears + L * mla) * prefills * int8_prefill
               + 5 * draft_cells)
    if backend == "pim_bitserial":
        want["pim_mvm"] = linears
    if backend == "fused_int8":
        want["int8_matmul"] = linears
        want["ssd_chunk"] = n_ssm * sum(math.ceil(n / 128) for n in prompt_lens)
        if attn is not None and not mla:
            want[attn] = (L - n_ssm) * steps
    return want


def prefill_calls(cb, reqs) -> int:
    """Prefill calls of a served trace, each one RMSNorm launch a norm: an
    attention stack prefills in pieces of ``PREFILL_PIECE`` rows, once an
    admission and again after each preemption (a chunked admission runs the
    pieces its chunks touch, which the engine counts); an SSM stack once an
    admission."""
    from repro_torch.models import transformer as T
    if cb.chunk:
        return cb.prefill_pieces
    return sum((1 + r.n_preemptions) * T.prefill_pieces(cb.cfg, cb._bucket(r.prompt_len))
               for r in reqs)


SERVE_SLOTS, SERVE_ROWS = 4, 256     # the phase-4 trace's pool: slots, rows a slot


def mtp_cells(lane: dict) -> int:
    """MTP head cells a verify step of ``lane`` drafts with: ``spec_k``
    cells a chain, a tree of n nodes on b branches 1 + n - b."""
    if lane.get("drafter") != "mtp":
        return 0
    n = lane.get("spec_tree") or lane.get("spec_k")
    return 1 + n - min(lane.get("spec_branch", 2), n) if lane.get("spec_tree") else n


def serve(torch, cfg, params, lane: dict, attn: str | None,
          backend: str = "fused_int8", request=None, trace: tuple | None = None,
          setup=None, quantized: bool = False) -> tuple:
    """Serve the trace (``trace``: other (prompts, budgets)) on 4 slots
    (``max_len`` 256) under ``backend`` with the given lane arguments
    (``request(i)``: request i's extra ``submit`` arguments), the launch
    counts reset just before and read just after; they must equal
    :func:`want_launches`.  ``setup(engine)``, where given, runs once the
    engine is built.  Every step on the card replays a CUDA graph, captured
    when the engine is built; prefill is eager.  ``quantized``: ``params``
    is already the int8 tree, served as it is (prefill too)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cb = ContinuousBatchingEngine(cfg, params, n_slots=SERVE_SLOTS, max_len=SERVE_ROWS,
                                  rt=Runtime(backend), quantize=not quantized, **lane)
    prompts, budgets = trace or serve_trace(cfg.vocab_size)
    if setup is not None:
        setup(cb)
    torch.cuda.synchronize()
    cb.reset_clock()
    reset_launch_counts()                      # the path's run starts here
    t0 = time.perf_counter()
    reqs = [cb.submit(p, b, **(request(i) if request else {}))
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    cb.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()                   # ... and ends here
    steps = cb.stats["decode_steps"]
    want = want_launches(cfg, steps, [len(p) for p in prompts], attn, backend,
                         prefill_calls(cb, reqs), int8_prefill=quantized,
                         draft_cells=mtp_cells(lane) * cb.stats["verify_steps"])
    if counts != want or steps < 1:
        raise AssertionError(f"launch counts {counts} != {want}")
    return cb, reqs, wall, counts


def serve_record(reqs, wall: float, cfg) -> dict:
    """Per-request TTFT, latency and TPOT of a served trace, every request
    checked to its budget and its tokens in range."""
    per = []
    for r in reqs:
        if r.error is not None or len(r.output) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: error {r.error}, {len(r.output)} tokens")
        if min(r.output) < 0 or max(r.output) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of range")
        per.append({"rid": r.rid, "prompt": r.prompt_len, "tokens": len(r.output),
                    "ttft_s": r.first_token_time - r.arrival_time,
                    "tpot_s": (r.finish_time - r.first_token_time) / max(1, len(r.output) - 1),
                    "latency_s": r.finish_time - r.arrival_time})
    served = sum(p["tokens"] for p in per)
    return {"wall_s": wall, "tokens_served": served, "tokens_per_s": served / wall,
            "requests": per}


def phase_serve(torch, ctx) -> dict:
    from repro_torch.configs import registry

    cfg = registry.get("llama3-8b")
    cb, reqs, wall, counts = serve(torch, cfg, ctx["params"], {}, "decode_attn")
    ctx["main_launches"] = counts
    ctx["plain_outputs"] = [list(r.output) for r in reqs]
    rec = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats), launches=counts)
    for r in rec["requests"]:
        print(f"   req {r['rid']}: prompt {r['prompt']:3d} -> {r['tokens']:2d} tokens, "
              f"TTFT {r['ttft_s'] * 1e3:7.1f} ms, latency {r['latency_s']:.3f} s")
    print(f"   served {rec['tokens_served']} tokens in {wall:.2f} s; stats {cb.stats}; "
          f"launches {counts}")
    del cb
    # the same trace under pim_bitserial (B5) and ref_int8 (plain int8
    # matmul): both run the plain attention on the same int32 sums, so
    # their streams must be token-identical; B5's launches over this run are
    # the ones the kernels line reports
    outs = {}
    for backend in ("pim_bitserial", "ref_int8"):
        cb, reqs, wall, counts = serve(torch, cfg, ctx["params"], {}, None, backend)
        outs[backend] = [list(r.output) for r in reqs]
        rec[backend] = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats),
                            launches=counts)
        if backend == "pim_bitserial":
            ctx["pim_launches"] = counts["pim_mvm"]
        print(f"   {backend}: served {rec[backend]['tokens_served']} tokens in {wall:.2f} s; "
              f"{cb.stats['decode_steps']} decode steps; launches {counts}")
        del cb
    same = sum(a == b for a, b in zip(outs["pim_bitserial"], outs["ref_int8"]))
    rec["pim_eq_ref_int8_requests"] = same
    print(f"   pim_bitserial vs ref_int8: {same} of {len(outs['ref_int8'])} requests "
          f"token-identical")
    if same != len(outs["ref_int8"]):
        raise AssertionError(f"pim_bitserial and ref_int8 part: {same} of "
                             f"{len(outs['ref_int8'])} requests equal")
    return rec


def verify_bound(B, G, T, rep, D, S, pos, visible) -> tuple[float, str]:
    """Bound of one verify window: each live K/V row (D int8 + one f32 scale;
    keys up to pos + T per slot) read once, q and out once; the int8 scores
    and the f32 P.V over the ``visible`` (row, key) pairs."""
    live = sum(min(p + T, S) for p in pos)
    R = T * rep
    n_bytes = (2 * live * G * (D + 4) + B * G * R * (D + 4) + 4 * B * (T + 1)
               + 4 * B * G * R * D)
    ops = 2 * D * G * rep * visible
    return bound_ms(n_bytes, [(ops, INT8_OPS_PER_S), (ops, FP32_FLOPS_PER_S)])


def chain_anc(torch, B: int, T: int):
    """[B, T] ancestor bits of a chain: row t sees window keys 0..t."""
    return ((1 << torch.arange(1, T + 1, dtype=torch.int64)) - 1).to(
        torch.int32).expand(B, T).contiguous().to("cuda")


def window_q(torch, va, g, T: int, attn: tuple = LLAMA_ATTN) -> tuple:
    B, G, rep, D = attn
    q = torch.randn((B, T, G * rep, D), generator=g, device="cuda")
    return va.quantize_window(q, G)


def verify_case(torch, da, va, vt, quant, drafter, name: str, T: int, max_len: int,
                pos: tuple, attn: tuple = LLAMA_ATTN) -> dict:
    """B3 (``verify_attn*``) or B4 (random branching trees) for a window of
    T tokens at the given cursors, in a pool of max_len + T - 1 rows, at the
    (B, G, rep, D) of ``attn``: parity with the plain version, B3's rows
    equal to B2 and B4 on a chain equal to B3 in the same pool (all gated),
    device / eager / plain times and bound."""
    import numpy as np
    g = torch.Generator(device="cuda").manual_seed(4)
    B, G, rep, D = attn
    S = max_len + T - 1
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    lengths = (pos[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                           device="cuda")).contiguous()
    rng = np.random.default_rng(T)
    anc = torch.tensor([drafter.tree_depths_ancestors(
        [int(rng.integers(-1, i)) for i in range(T - 1)])[1] for _ in range(B)],
        dtype=torch.int32, device="cuda")

    def make():
        return (*window_q(torch, va, g, T, attn), *kv_pool(torch, quant, g, S, attn))
    args = make()
    b3 = va.verify_attn_cuda(*args, lengths)
    rows_eq_b2 = all(torch.equal(b3[:, :, t], da.decode_attn_cuda(
        args[0][:, :, t].contiguous(), args[1][:, :, t].contiguous(), *args[2:],
        lengths[:, t].contiguous())) for t in range(T))
    chain_eq_b3 = torch.equal(vt.verify_tree_attn_cuda(*args, pos, chain_anc(torch, B, T)), b3)
    if name.startswith("verify_attn"):
        def fn(a):
            return va.verify_attn_cuda(*a, lengths)

        def plain(a):
            return va.verify_attn_plain(*a, lengths)
        visible = int(lengths.sum())
    else:
        def fn(a):
            return vt.verify_tree_attn_cuda(*a, pos, anc)

        def plain(a):
            return vt.verify_tree_attn_plain(*a, pos, anc)
        visible = int(pos.sum()) * T + sum(bin(a).count("1") for a in anc.reshape(-1).tolist())
    got, want = fn(args), plain(args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-6)
    if not (rows_eq_b2 and chain_eq_b3):
        raise AssertionError(f"{name}: B3 rows == B2 {rows_eq_b2}, "
                             f"B4 chain == B3 {chain_eq_b3}")
    err = float((got - want).abs().max())
    sets = copies(torch, make, 2 * B * S * G * (D + 4))
    n = len(sets)
    tk = timed(torch, lambda i: fn(sets[i % n]), 50)
    tp = timed(torch, lambda i: plain(sets[i % n]), 10)
    b = verify_bound(B, G, T, rep, D, S, pos.tolist(), visible)
    print(f"   {name} T={T} (R={T * rep}) S={S}: {tk['device_ms'] * 1e3:.1f} us device / "
          f"{tk['eager_ms'] * 1e3:.1f} eager (bound {b[0] * 1e3:.2f}, plain "
          f"{tp['device_ms'] * 1e3:.1f}) max_abs_err {err:.3g}; B3 rows == B2 "
          f"{rows_eq_b2}, B4 chain == B3 {chain_eq_b3}")
    return {"ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
            "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "max_abs_err": err, "rows_eq_b2": rows_eq_b2, "chain_eq_b3": chain_eq_b3,
            "shape": {"B": B, "G": G, "T": T, "rep": rep, "D": D, "S": S,
                      "pos": pos.tolist(), "row_blocks": -(-T * rep // 16)}}


def cross_pool(torch, da, va, vt, quant, attn: tuple = LLAMA_ATTN,
               shapes: tuple = CROSS_POOL) -> dict:
    """B3's rows and B4's on a chain (T 5, the ``spec_k`` window) in a pool
    of max_len + T - 1 rows against B2 in a pool of max_len rows holding the
    same live K/V, bit for bit (gated), at cursors whose rows cross chunk
    boundaries, at the (B, G, rep, D) of ``attn``."""
    g = torch.Generator(device="cuda").manual_seed(6)
    T, out = 5, {}
    for max_len, pos in shapes:
        q_q, q_s = window_q(torch, va, g, T, attn)
        cache = kv_pool(torch, quant, g, max_len + T - 1, attn)
        small = tuple(c[:, :max_len].contiguous() for c in cache)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lengths = (pos_t[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                                 device="cuda")).contiguous()
        b3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
        b4 = vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos_t, chain_anc(torch, attn[0], T))
        rows = []
        for t in range(T):
            b2 = da.decode_attn_cuda(q_q[:, :, t].contiguous(), q_s[:, :, t].contiguous(),
                                     *small, lengths[:, t].contiguous())
            rows.append([torch.equal(b3[:, :, t], b2), torch.equal(b4[:, :, t], b2)])
        out[max_len] = {"pos": list(pos), "rows_b3_b4_eq_b2": rows}
        print(f"   across pools (B3 / B4 chain at S {max_len + T - 1}, B2 at S {max_len}), "
              f"(B, G, rep, D) {attn}, cursors {list(pos)}: rows equal {rows}")
        if not all(all(r) for r in rows):
            raise AssertionError(f"B3 / B4 rows differ from B2 across pools at max_len "
                                 f"{max_len}: {rows}")
    return out


def verify_kernels(torch, da, va, vt, quant, drafter) -> dict:
    """B3 and B4 at every window of :data:`VERIFY_CASES` (B = 4, G = 8,
    rep = 4, D = 128), and B3 / B4 against B2 across pool sizes."""
    out = {name: verify_case(torch, da, va, vt, quant, drafter, name, T, max_len, pos)
           for name, T, max_len, pos in VERIFY_CASES}
    out["cross_pool"] = cross_pool(torch, da, va, vt, quant)
    return out


def layer_diffs(a: dict, b: dict) -> list[int]:
    """Per layer, the cache entries (int8 codes and f32 scales) in which two
    decode states differ."""
    return [sum(int((x[k].cpu() != y[k].cpu()).sum()) for k in x)
            for x, y in zip(a["layers"], b["layers"])]


def window_vs_decode(torch, M, cfg, q, state, toks, rt) -> tuple[dict, tuple]:
    """``verify_step`` over the window ``toks`` [B, T] against T sequential
    ``decode_step`` calls from the same state on the same device: per row,
    whether the logits are bit-equal and their max |diff|; per layer, the
    cache entries the two wrote differently.  The first layer with a
    difference is where the two paths part; logits that differ while every
    layer's entries are equal point at ``ln_f`` or the ``lm_head``.  Also
    returns (verify logits, decode logits, verify state)."""
    B, T = toks.shape
    sv, sd = clone_state(state), clone_state(state)
    lv, _, _ = M.verify_step(q, cfg, sv, toks, rt)
    rows = []
    for t in range(T):
        lg, sd = M.decode_step(q, cfg, sd, toks[:, t].contiguous(), rt)
        rows.append(lg)
    ld = torch.stack(rows, 1)
    per_layer = layer_diffs(sv, sd)
    rec = {"rows_equal": [bool(torch.equal(lv[:, t], ld[:, t])) for t in range(T)],
           "rows_max_abs": [float((lv[:, t] - ld[:, t]).abs().max()) for t in range(T)],
           "logit_scale": float(ld.abs().max()),
           "layer_entries_differing": per_layer,
           "first_layer_differing": next((i for i, n in enumerate(per_layer) if n), None)}
    return rec, (lv, ld, sv)


def describe_window(rec: dict) -> str:
    return (f"rows bit-equal {rec['rows_equal']}, max |diff| per row "
            f"{[f'{d:.3g}' for d in rec['rows_max_abs']]} of {rec['logit_scale']:.3g}; "
            f"first layer whose K/V entries differ {rec['first_layer_differing']} "
            f"({sum(rec['layer_entries_differing'])} entries in all)")


def reduced_verify(torch, drafter) -> dict:
    """``verify_step`` on the reduced config: the card (kernels) against the
    CPU (plain versions), linear and tree windows, from the same prefilled
    state; within 2% of the logit scale, argmax equal.  On each device the
    linear window is also held against sequential decode steps
    (:func:`window_vs_decode`), and the card's sequential decode against
    the CPU's, which says whether the card's verify path or the card as a
    whole parts from the CPU.  At this width no float stage sums a row in
    an order that depends on the row count, so the window must equal
    sequential decode bit for bit on both devices."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    cfg = registry.get("llama3-8b").reduced()
    p_cpu = M.init_params(cfg, seed=0, device="cpu")
    q_cpu = quantize_tree(p_cpu)
    rt = Runtime("fused_int8")
    cpu_gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), generator=cpu_gen)
    T = 5
    toks = torch.randint(0, cfg.vocab_size, (2, T), generator=cpu_gen, dtype=torch.int32)
    depth, anc = zip(*[drafter.tree_depths_ancestors(par)
                       for par in ([-1, -1, 0, 2], [-1, 0, -1, 1])])
    tree = {"depth": torch.tensor(depth, dtype=torch.int32),
            "anc": torch.tensor(anc, dtype=torch.int32)}
    out = {}
    for mode, kw in (("linear", {}), ("tree", tree)):
        res = {}
        for dev in ("cpu", "cuda"):
            p, q = convert.to_device(p_cpu, dev), convert.to_device(q_cpu, dev)
            _, st = M.prefill(p, cfg, {"inputs": prompts.to(dev)}, 64, rt)
            if mode == "linear":
                rec, (lg, ld, sv) = window_vs_decode(torch, M, cfg, q, st, toks.to(dev), rt)
                out[f"window_vs_decode_{dev}"] = rec
                print(f"   reduced, {dev}: verify_step vs sequential decode_step: "
                      f"{describe_window(rec)}")
                res[dev] = (lg.cpu(), ld.cpu(), sv)
            else:
                sv = clone_state(st)
                lg, _, _ = M.verify_step(q, cfg, sv, toks.to(dev), rt,
                                         **{k: v.to(dev) for k, v in kw.items()})
                res[dev] = (lg.cpu(), None, sv)
        a, b = res["cpu"][0], res["cuda"][0]
        d, sc = float((a - b).abs().max()), float(a.abs().max())
        if not torch.equal(a.argmax(-1), b.argmax(-1)) or d > 2e-2 * sc:
            raise AssertionError(f"reduced verify ({mode}): card vs cpu max diff {d} (scale {sc})")
        out[mode] = {"max_abs": d, "logit_scale": sc,
                     "layer_entries_differing": layer_diffs(res["cpu"][2], res["cuda"][2])}
        if mode == "linear":
            out[mode]["decode_max_abs"] = float((res["cpu"][1] - res["cuda"][1]).abs().max())
    for dev in ("cpu", "cuda"):
        w = out[f"window_vs_decode_{dev}"]
        if not all(w["rows_equal"]) or w["first_layer_differing"] is not None:
            raise AssertionError(f"reduced, {dev}: the verify window differs from "
                                 f"sequential decode: {describe_window(w)}")
    print(f"   reduced llama3-8b verify_step, card (B3/B4) vs CPU (plain): linear max |diff| "
          f"{out['linear']['max_abs']:.3g}, tree {out['tree']['max_abs']:.3g} of "
          f"{out['linear']['logit_scale']:.3g}, argmax equal; the same tokens by sequential "
          f"decode, card vs CPU: {out['linear']['decode_max_abs']:.3g}; K/V entries "
          f"differing per layer, card vs CPU: linear {out['linear']['layer_entries_differing']}, "
          f"tree {out['tree']['layer_entries_differing']}")
    return out


def row_invariance(torch, cfg, params, B: int, T: int, q: dict) -> dict:
    """The float stages that a verify step runs over B*T rows and a decode
    step over B, each run on the same random rows once as the verify step
    calls it and T times as the decode step does: how many outputs differ,
    and by how much.  The norm (the configuration's norm kernel, RMSNorm or
    LayerNorm) and the int8 pair it hands the attention linears of ``q``
    (the int8 tree) under ``fused_int8`` (``norm_pair``: the norm's entry
    fused with the quantizer) must differ in none."""
    from repro_torch.core import quant
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT
    from repro_torch.models.transformer import Runtime

    g = torch.Generator(device="cuda").manual_seed(6)
    d = cfg.d_model
    x = torch.randn((B, T, d), generator=g, device="cuda")
    rt = Runtime("fused_int8")
    ln = params["layers"][0]["ln1"]
    norm = norm_kernel(cfg)
    stages = {
        norm: lambda h: L.apply_norm(ln, h),
        "norm_pair": lambda h: torch.cat(
            [t.to(torch.float32) for t in L.apply_norm_q(
                ln, h, "fused_int8", q["layers"][0]["attn"], A.INPUT_LINEARS)[1]], -1),
        "quantize_activation": lambda h: torch.cat(
            [t.to(torch.float32) for t in quant.quantize_activation(h)], -1),
        "lm_head": lambda h: TT._lm_head(params, cfg, h.reshape(-1, d), rt).reshape(
            h.shape[0], h.shape[1], -1),
    }
    out = {}
    for name, fn in stages.items():
        whole = fn(x)
        rows = torch.cat([fn(x[:, t:t + 1].contiguous()) for t in range(T)], 1)
        out[name] = {"differing": int((whole != rows).sum()), "of": whole.numel(),
                     "max_abs": float((whole - rows).abs().max())}
    print(f"   float stages at M = {B * T} against M = {B} rows: " + ", ".join(
        f"{k} {v['differing']} of {v['of']} differ (max {v['max_abs']:.3g})"
        for k, v in out.items()))
    if out[norm]["differing"] or out["norm_pair"]["differing"]:
        raise AssertionError(f"apply_norm or its int8 pair is not row-invariant: {out}")
    return out


def full_width_parity(torch, params, cfg, q, state, toks) -> dict:
    """Where the full-width verify step parts from sequential decode on the
    card: the float stages' row invariance (the norm gated), and the window
    against sequential decode steps under the port's own ``apply_norm``,
    whose K/V entries must equal sequential decode's in every layer (the
    kernels and the other stages are row-invariant); what is left in the
    logits is the ``lm_head`` GEMM."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    rt = Runtime("fused_int8")
    B, T = toks.shape
    out = {"row_invariance": row_invariance(torch, cfg, params, B, T, q),
           "window_vs_decode": window_vs_decode(torch, M, cfg, q, state, toks, rt)[0]}
    print(f"   full width, verify_step vs sequential decode_step: "
          f"{describe_window(out['window_vs_decode'])}")
    if out["window_vs_decode"]["first_layer_differing"] is not None:
        raise AssertionError("the verify window's K/V entries differ from sequential "
                             "decode's under the row-invariant norm")
    return out


def decode_margin(torch, cfg, params, qparams, prompt: list, prefix: list,
                  toks: tuple, backend: str = "fused_int8", slots: int = 1,
                  rows: int | None = None) -> dict:
    """The logits that chose output token ``len(prefix)`` of a request in a
    lane, from a single-request rerun of it under ``backend`` (the engine's
    prefill, bucketed to 16 and masked to the prompt, or at exact length for
    an SSM, then ``prefix`` fed back one decode step at a time; every stage
    but the ``lm_head`` and an SSM's float projections is row-invariant, so
    these are the lane's logits up to its last bits): the two candidate
    tokens' logits, their gap, the gap between the best two, and the row.
    With ``slots`` and ``rows`` the rerun has the served steps' shapes: the
    prefilled request is copied into each of ``slots`` slots of ``rows``
    rows, so the plain attention sums over the served pool's rows and the
    ``lm_head`` and an SSM's projections run at M ``slots``; the row is
    slot 0's."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    rt = Runtime(backend)
    if cfg.family == "ssm":
        padded, batch = prompt, {}
    else:
        padded = prompt + [0] * (-len(prompt) % 16)
        batch = {"lengths": torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")}
    lg, st = M.prefill(params, cfg, dict(batch, inputs=torch.tensor([padded], device="cuda")),
                       rows or len(padded) + len(prefix) + 1, rt)
    if slots > 1:
        st = {"layers": [{k: v.repeat(slots, *[1] * (v.dim() - 1)) for k, v in c.items()}
                         for c in st["layers"]],
              "pos": st["pos"].repeat(slots)}
    for tok in prefix:
        lg, st = M.decode_step(qparams, cfg, st, torch.full((slots,), tok, dtype=torch.int32,
                                                             device="cuda"), rt)
    row = lg[0].float()
    top = torch.topk(row, 2).values
    a, b = (float(row[t]) for t in toks)
    return {"tokens": list(toks), "logits": [a, b], "gap": abs(a - b),
            "top2_gap": float(top[0] - top[1]), "logit_scale": float(row.abs().max()),
            "argmax": int(row.argmax()), "row": row}


def tree_vs_path(torch, cfg, q, state, toks, drafter) -> dict:
    """A draft tree whose accepted root path skips a sibling (window nodes
    0 -> 1 -> 3 -> 4, node 2 a sibling of node 1), verified and committed
    with ``tree_commit``, against sequential decode of the path's tokens
    from the same state: the path rows' logits, and per layer the committed
    K/V entries that differ.  Node 3's key sits one row further from its
    ancestors in the window than in sequential decode, so the attention
    kernels sum its row in another order (the reference holds such rows
    to about 1 ulp, not bit for bit)."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    rt = Runtime("fused_int8")
    B = toks.shape[0]
    depth, anc = drafter.tree_depths_ancestors([-1, -1, 0, 2])
    path = [0, 1, 3, 4]
    dev = toks.device
    sv, sd = clone_state(state), clone_state(state)
    base = state["pos"].to(torch.int32)
    lv, _, sv = M.verify_step(q, cfg, sv, toks[:, :5].contiguous(), rt,
                              depth=torch.tensor([depth] * B, dtype=torch.int32, device=dev),
                              anc=torch.tensor([anc] * B, dtype=torch.int32, device=dev))
    sv = M.tree_commit(sv, base, torch.tensor([path[1:]] * B, dtype=torch.int32, device=dev),
                       torch.full((B,), 3, dtype=torch.int32, device=dev), base + len(path))
    rows = []
    for i in path:
        lg, sd = M.decode_step(q, cfg, sd, toks[:, i].contiguous(), rt)
        rows.append(lg)
    end = int(base.max()) + len(path)
    per_layer = [sum(int((x[k][:, :end] != y[k][:, :end]).sum()) for k in x)
                 for x, y in zip(sv["layers"], sd["layers"])]
    out = {"path": path, "rows_equal": [bool(torch.equal(lv[:, i], r))
                                        for i, r in zip(path, rows)],
           "rows_max_abs": [float((lv[:, i] - r).abs().max()) for i, r in zip(path, rows)],
           "layer_entries_differing": per_layer,
           "first_layer_differing": next((i for i, n in enumerate(per_layer) if n), None)}
    print(f"   tree window (path 0-1-3-4 past sibling 2) vs sequential decode of the path: "
          f"rows bit-equal {out['rows_equal']}, max |diff| "
          f"{[f'{d:.3g}' for d in out['rows_max_abs']]}; first layer whose committed K/V "
          f"entries differ {out['first_layer_differing']} ({sum(per_layer)} entries in all)")
    return out


def phase_verify(torch, ctx, da, va, vt, quant) -> dict:
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve import drafter

    out = {"kernels": verify_kernels(torch, da, va, vt, quant, drafter),
           "reduced": reduced_verify(torch, drafter)}
    cfg = registry.get("llama3-8b")
    plain = ctx.get("plain_outputs")
    for lane, attn in (({"spec_k": 4}, "verify_attn"),
                       ({"spec_tree": 6, "spec_branch": 2}, "verify_tree_attn")):
        label = "spec_k" if "spec_k" in lane else "spec_tree"
        cb, reqs, wall, counts = serve(torch, cfg, ctx["params"], lane, attn)
        ctx[f"{attn}_launches"] = counts[attn]
        for r in reqs:
            if r.error is not None or len(r.output) != r.max_new_tokens:
                raise AssertionError(f"{label} request {r.rid}: error {r.error}, "
                                     f"{len(r.output)} tokens")
            if min(r.output) < 0 or max(r.output) >= cfg.vocab_size:
                raise AssertionError(f"{label} request {r.rid}: token out of range")
        served = sum(len(r.output) for r in reqs)
        # reported, not gated: with the row-invariant norm every layer's K/V
        # entries equal sequential decode's (full_width_parity), and only the
        # lm_head GEMM's last bits differ between B and B*T rows; a request
        # that still parts from the plain lane is traced to its logit margin
        first = ([next((i for i, (a, b) in enumerate(zip(r.output, p)) if a != b), None)
                  for r, p in zip(reqs, plain)] if plain else None)
        margins = {}
        for r, p, f in zip(reqs, plain or [], first or []):
            if f is not None:
                m = decode_margin(torch, cfg, ctx["params"], cb.qparams, r.prompt, p[:f],
                                  (p[f], r.output[f]))
                m.pop("row")
                margins[r.rid] = dict(m, index=f)
        st = cb.stats
        rec = {"lane": lane, "wall_s": wall, "tokens_served": served,
               "verify_steps": st["verify_steps"],
               # the first token of each request comes from its prefill
               "tokens_per_verify_step": (served - len(reqs)) / st["verify_steps"],
               "acceptance_rate": cb.acceptance_rate,
               "spec_accept_hist": st["spec_accept_hist"], "stats": dict(st),
               "launches": counts,
               "ttft_s": [r.first_token_time - r.arrival_time for r in reqs],
               "latency_s": [r.finish_time - r.arrival_time for r in reqs],
               "same_as_plain": None if first is None else sum(f is None for f in first),
               "first_divergence": first, "divergence_margins": margins}
        print(f"   {label} {lane}: served {served} tokens in {wall:.2f} s, "
              f"{st['verify_steps']} verify steps, "
              f"{rec['tokens_per_verify_step']:.2f} tokens per verify step, acceptance "
              f"{cb.acceptance_rate:.3f}, hist {st['spec_accept_hist']}, launches {counts}")
        print(f"     TTFT first {rec['ttft_s'][0] * 1e3:.1f} ms, last "
              f"{rec['ttft_s'][-1] * 1e3:.1f} ms; requests equal to the plain lane's "
              f"tokens: {rec['same_as_plain']} of {len(reqs)} (first divergence {first})")
        for rid, m in margins.items():
            print(f"     request {rid} token {m['index']}: plain {m['tokens'][0]} vs "
                  f"{label} {m['tokens'][1]}, logits {m['logits'][0]:.7g} / "
                  f"{m['logits'][1]:.7g} (gap {m['gap']:.3g}, top-2 gap {m['top2_gap']:.3g}, "
                  f"scale {m['logit_scale']:.3g})")
        if label == "spec_k":
            g = torch.Generator(device="cuda").manual_seed(2)
            prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
            _, state = M.prefill(ctx["params"], cfg, {"inputs": prompts}, 128,
                                 Runtime("fused_int8"))
            toks = torch.randint(0, cfg.vocab_size, (4, 5), generator=g, device="cuda",
                                 dtype=torch.int32)
            try:        # a measurement, not a check: a profiler fault is recorded
                rec["verify_profile"] = profile_step(
                    torch, lambda: M.verify_step(cb.qparams, cfg, clone_state(state), toks,
                                                 Runtime("fused_int8")), "verify (T = 5)")
            except Exception as e:  # noqa: BLE001
                rec["verify_profile"] = {"error": f"{type(e).__name__}: {e}"}
                print(f"   profile failed: {rec['verify_profile']['error']}")
            out["full_width_parity"] = full_width_parity(torch, ctx["params"], cfg,
                                                         cb.qparams, state, toks)
            out["tree_vs_path"] = tree_vs_path(torch, cfg, cb.qparams, state, toks, drafter)
            del state
        out[label] = rec
        del cb, reqs
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase graphs: the serve steps as CUDA graphs, and the A.7 / A.9 lanes
# ---------------------------------------------------------------------------
GRAPH_STEPS = 8                 # consecutive steps held bit-equal to eager
PROFILE_TRIES = 3               # profiled replays to find every credited kernel
RAGGED_LENS = (37, 64, 91, 130)  # the pool's cursors: 4 slots at other positions
TREE_PARENTS = [-1, -1, 0, 0, 1, 2]   # a 6-node draft tree (T 7): two chains


def drawn_int8(cfg) -> bool:
    """Whether the script serves ``cfg`` from an int8 tree drawn a part at
    a time (:func:`int8_params`): its f32 tree does not fit the card."""
    return cfg.attn_type == "mla" or cfg.family == "hybrid"


def ragged_pool(torch, cfg, params, rows: int, max_len: int, seed: int = 4) -> dict:
    """A pool of ``len(RAGGED_LENS)`` slots and ``rows`` rows, each slot
    prefilled (full width, ``fused_int8``) with its own random prompt (an
    encoder-decoder's with its own random frames too)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime

    state = M.init_decode_state(cfg, len(RAGGED_LENS), rows, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    for slot, n in enumerate(RAGGED_LENS):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda")
        batch = {"inputs": toks}
        if cfg.family == "encdec":
            batch = {"frames": torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g,
                                           device="cuda"), "tokens": toks}
        _, one = M.prefill(params, cfg, batch, max_len, Runtime("fused_int8"))
        T.write_slot(state, slot, one)
    return state


def same_state(torch, a: dict, b: dict) -> list[str]:
    """Names of the state tensors that differ (``L<i>.<leaf>``, ``pos``)."""
    bad = [f"L{i}.{k}" for i, (la, lb) in enumerate(zip(a["layers"], b["layers"]))
           for k in la if not torch.equal(la[k], lb[k])]
    return bad + ([] if torch.equal(a["pos"], b["pos"]) else ["pos"])


def replay_vs_eager(torch, cfg, qparams, state: dict, kind: str, width: int = 0,
                    release=None, fresh: bool = False, rt=None, profile: bool = True) -> dict:
    """``GRAPH_STEPS`` consecutive steps of one kind (``decode``, ``verify``
    at T ``width``, ``tree`` at T ``width``, ``multi``: a fused block of m
    ``width``, m replays of the decode graph), replayed from the engine's
    captured graph (``models/graphs.py``) on one copy of ``state`` and run
    eagerly on another: logits (the fused block's tokens) and every state
    tensor bit-equal after every step, the graph's captured launches and
    each replay's credited launches equal to :func:`want_launches`.  Between
    verify steps both states commit the same way (a cursor rewind, or a tree
    commit), as the engine does.  Then a replay is profiled (up to
    ``PROFILE_TRIES`` times, then once in a fresh process, since a profile
    can miss records), and its device events of each hand kernel must
    equal the launches the replay credits: the graph runs the kernels it is
    credited with; where the fresh process profiles, its record is the
    step's profile.  With ``fresh`` only the fresh process profiles (phases
    ``ssm`` and ``families``, late in this process).  ``release`` (optional) drops the caller's references
    to ``qparams`` and ``state``: it is called before a fresh process
    profiles, so that a model that fills the card leaves it the memory
    (the steps and the replayed state then come back as None).  ``rt``
    (default ``fused_int8``) is the Runtime the graph is captured under
    and the eager steps run; ``profile=False`` stops after the bit-equal
    steps."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import graphs as G
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime

    rt = rt or Runtime("fused_int8")
    eager, replay = clone_state(state), clone_state(state)
    t0 = time.perf_counter()
    steps = G.ServeSteps(qparams, cfg, rt, replay, decode=kind in ("decode", "multi"),
                         verify=(width,) if kind == "verify" else (),
                         tree=(width,) if kind == "tree" else ())
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    key = ("decode",) if kind in ("decode", "multi") else (kind, width)
    attn = {"tree": "verify_tree_attn", "verify": "verify_attn"}.get(
        kind, None if cfg.family == "ssm" else "decode_attn")
    per = want_launches(cfg, width if kind == "multi" else 1, [], attn, rt.backend, prefills=0)
    want = {k: v for k, v in want_launches(cfg, 1, [], attn, rt.backend, prefills=0).items()
            if v}
    if steps.graphs[key].launches != want:
        raise AssertionError(f"{kind} graph captured {steps.graphs[key].launches} != {want}")
    rng = np.random.default_rng(5)
    n = len(RAGGED_LENS)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, n).astype(np.int32)).cuda()
    depth, anc = (torch.tensor(x, dtype=torch.int32, device="cuda").repeat(n, 1)
                  for x in drafter_tree(width)) if kind == "tree" else (None, None)
    def call():
        return getattr(steps, kind)(*(() if kind == "decode" else (width,)))
    for i in range(GRAPH_STEPS // (width if kind == "multi" else 1)):
        if kind in ("verify", "tree"):
            win = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, width))
                                   .astype(np.int32)).cuda()
            win[:, 0] = tok
            steps.window[width].copy_(win)
            if kind == "tree":
                steps.depth[width].copy_(depth)
                steps.anc[width].copy_(anc)
        else:
            steps.tok.copy_(tok)
        reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        if launch_counts() != per:
            raise AssertionError(f"{kind} replay {i} credited {launch_counts()} != {per}")
        if kind == "decode":
            lg, _ = M.decode_step(qparams, cfg, eager, tok, rt)
            out, out_g, tok = lg, got[0], torch.argmax(lg, -1).to(torch.int32)
        elif kind == "multi":
            blk, _ = M.multi_decode_step(qparams, cfg, eager, tok, width, rt)
            out, out_g, tok = blk, got, blk[:, -1].contiguous()
        else:
            kw = {"depth": depth, "anc": anc} if kind == "tree" else {}
            lg, _, _ = M.verify_step(qparams, cfg, eager, win, rt, **kw)
            out, out_g = lg, got[0]
        if not torch.equal(out, out_g):
            raise AssertionError(f"{kind} step {i}: replayed output differs from eager "
                                 f"(max |diff| {float((out.float() - out_g.float()).abs().max())})")
        if kind == "verify":
            # commit 1 + i % width rows of each slot's window
            pos = (eager["pos"] - width + 1 + (i % width)).cpu().numpy()
            for st in (eager, replay):
                T.rewind_pos(st, pos)
            tok = out[:, i % width].argmax(-1).to(torch.int32)
        elif kind == "tree":
            # commit the tree's longest root-path (window nodes 1, 3, 6), cut
            # to i % 4 nodes
            base = (eager["pos"] - width).to(torch.int32)
            keep = torch.full((n,), i % 4, dtype=torch.int32, device="cuda")
            sel = torch.tensor([1, 3, 6] + [0] * (width - 4), dtype=torch.int32,
                               device="cuda").repeat(n, 1)
            for st in (eager, replay):
                M.tree_commit(st, base, sel, keep, base + 1 + keep)
            tok = out[:, 0].argmax(-1).to(torch.int32)
        bad = same_state(torch, eager, replay)
        if bad:
            raise AssertionError(f"{kind} step {i}: state differs in {bad[:6]} "
                                 f"({len(bad)} tensors)")
    rec = {"kind": kind, "width": width, "steps": GRAPH_STEPS, "capture_s": capture_s,
           "launches_a_replay": steps.graphs[key].launches}
    print(f"   {kind}{f' ({width})' if width else ''}: {GRAPH_STEPS} steps replayed "
          f"bit-equal to eager (logits and every state tensor); captured in "
          f"{capture_s:.2f} s with launches {rec['launches_a_replay']} a replay")
    if not profile:
        return rec, steps, replay
    # the profiler may miss device records, never add one, and a replay runs
    # the same nodes every time: one profiled replay whose hand-kernel events
    # equal the credits shows the graph runs the kernels it is credited
    # with.  Late in this long process a profile of mamba2's replay missed
    # 5 of its 4,615 records in every try, while a fresh process missed
    # none, so the last resort is a fresh process's profile of the same step.
    # Later still, a profile that held every record of OPT-30B's replay
    # (1,762) summed B1's 96 launches to 2.21 ms, half their CUDA-event
    # time: there, only a fresh process profiles
    credited, rec["profile_tries"] = device_launches(per), []
    for _ in range(0 if fresh else PROFILE_TRIES):
        rec["profile"] = profile_step(torch, call, f"replayed {kind}")
        ran = rec["profile"]["hand_kernels"]
        rec["profile_tries"].append(ran)
        if any(ran[k] > credited[k] for k in ran):
            raise AssertionError(f"{kind}: the profiled replay ran {ran} hand-kernel "
                                 f"events, more than the credited {credited}")
        if ran == credited:
            break
    else:
        if release is not None:         # the child needs the card's memory
            release()
            del qparams, state, eager, call
            steps = replay = None
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        rec["profile"] = profile_in_child(cfg, kind, width)
        ran = rec["profile"]["hand_kernels"]
        rec["profile_tries"].append({"fresh_process": ran})
        if ran != credited:
            raise AssertionError(f"{kind}: {len(rec['profile_tries']) - 1} profiled replays "
                                 f"here and one in a fresh process ran "
                                 f"{rec['profile_tries']} hand-kernel events, credited "
                                 f"{credited}")
    print(f"   {kind}: the profiled replay ran the credited kernels {ran} "
          f"(profile {len(rec['profile_tries'])} of at most {PROFILE_TRIES + 1})")
    return rec, steps, replay


def replay_profile_child(arch: str, kind: str, width: int, n_layers: int) -> dict:
    """The :func:`profile_step` record (hand-kernel events, wall, device-busy
    time, idle share) of one profiled replay of ``kind`` at ``width`` (as in
    :func:`replay_vs_eager`) of ``arch`` at full width and ``n_layers``
    layers on a fresh 4-slot pool at ragged cursors; run by
    :func:`profile_in_child` in a process of its own."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.device import set_float32_precision
    from repro_torch.models import graphs as G
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    set_float32_precision()
    cfg = dataclasses.replace(registry.get(arch), n_layers=n_layers)
    if drawn_int8(cfg):                 # its f32 tree does not fit: int8 from the draw
        params = qparams = int8_params(torch, cfg)
    else:
        params = M.init_params(cfg, seed=0, device="cuda")
        qparams = quantize_tree(params)
    state = ragged_pool(torch, cfg, params, 320, 256)
    del params
    torch.cuda.empty_cache()
    steps = G.ServeSteps(qparams, cfg, Runtime("fused_int8"), state,
                         decode=kind in ("decode", "multi"),
                         verify=(width,) if kind == "verify" else (),
                         tree=(width,) if kind == "tree" else ())
    return profile_step(torch, lambda: getattr(steps, kind)(*(() if kind == "decode"
                                                              else (width,))),
                        f"replayed {kind} (fresh process)")


def profile_in_child(cfg, kind: str, width: int) -> dict:
    """:func:`replay_profile_child` in a fresh Python process (waited for,
    killed at its time limit): its :func:`profile_step` record; a child
    that fails fails the caller."""
    code = ("import json, sys; sys.path[:0] = ['src', '.']; import torch; "
            "import chip_smoke as S; print('CHILD ' + json.dumps("
            "S.replay_profile_child(sys.argv[1], sys.argv[2], int(sys.argv[3]), "
            "int(sys.argv[4]))))")
    child = subprocess.run([sys.executable, "-c", code, cfg.name, kind, str(width),
                            str(cfg.n_layers)],
                           cwd=Path(__file__).resolve().parent, capture_output=True,
                           text=True, timeout=900)
    line = next((x for x in child.stdout.splitlines() if x.startswith("CHILD ")), None)
    if child.returncode != 0 or line is None:
        raise AssertionError(f"{kind}: the fresh-process profile failed (exit "
                             f"{child.returncode}): {child.stderr[-2000:]}")
    prof = json.loads(line[6:])
    print(f"   {kind}: a fresh process's profiled replay ran {prof['hand_kernels']}: wall "
          f"{prof['wall_us'] / 1e3:.2f} ms, device busy {prof['device_busy_us'] / 1e3:.2f} ms, "
          f"idle share {prof['idle_share']:.3f}, {prof['device_kernels']} device events")
    return prof


def drafter_tree(width: int) -> tuple[list[int], list[int]]:
    from repro_torch.serve.drafter import tree_depths_ancestors
    return tree_depths_ancestors(TREE_PARENTS[:width - 1])


def phase_graphs(torch, ctx) -> dict:
    """The serve steps as CUDA graphs at full width (llama3-8b, 4 slots at
    ragged cursors): decode, ``spec_k`` verify (T 5), ``spec_tree`` verify
    (T 7) and the fused block (m 4), each over ``GRAPH_STEPS`` steps bit-equal
    to eager with exact launch counts, and one replay profiled with its
    hand-kernel events equal to its credited launches; an eager decode and
    verify step profiled beside the replayed ones; then the phase-4 trace served with
    ``multi_step = 4`` and with ``chunk = 32`` under each policy, each
    token-identical to the plain trace, and a sampled run twice from its
    seeds, identical."""
    from repro_torch.configs import registry
    from repro_torch.core import kvcache as KV
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    cfg = registry.get("llama3-8b")
    params = ctx["params"]
    qparams = quantize_tree(params)
    max_len = 256
    rows = max_len + KV.pool_headroom(spec_k=4, spec_tree=6, multi_step=4)
    state = ragged_pool(torch, cfg, params, rows, max_len)
    out = {"pool": {"slots": len(RAGGED_LENS), "rows": rows, "cursors": list(RAGGED_LENS)}}
    rt = Runtime("fused_int8")
    for kind, width in (("decode", 0), ("verify", 5), ("tree", 7), ("multi", 4)):
        rec, steps, replayed = replay_vs_eager(torch, cfg, qparams, state, kind, width)
        if kind in ("decode", "verify"):
            fn = ((lambda: M.decode_step(qparams, cfg, replayed, steps.tok, rt))
                  if kind == "decode" else
                  (lambda: M.verify_step(qparams, cfg, replayed, steps.window[width], rt)))
            try:    # a measurement, not a check: a profiler fault is recorded
                rec["eager_profile"] = profile_step(torch, fn, f"eager {kind}")
            except Exception as e:  # noqa: BLE001
                rec["eager_profile"] = {"error": f"{type(e).__name__}: {e}"}
                print(f"   profile failed: {rec['eager_profile']['error']}")
        out[kind if not width else f"{kind}_{width}"] = rec
        del steps, replayed
        torch.cuda.empty_cache()
    del state, qparams
    torch.cuda.empty_cache()

    plain = ctx["plain_outputs"]
    runs = {"multi_step_4": ({"multi_step": 4}, None)}
    for policy in ("fifo", "sjf", "priority:preempt", "fair"):
        runs[f"chunk_32_{policy}"] = ({"chunk": 32, "policy": policy}, policy)
    for label, (lane, policy) in runs.items():
        request = ((lambda i: {"priority": i % 3, "user": "AB"[i % 2]})
                   if policy in ("priority:preempt", "fair") else None)
        cb, reqs, wall, counts = serve(torch, cfg, params, lane, "decode_attn",
                                       request=request)
        outs = [list(r.output) for r in reqs]
        same = sum(a == b for a, b in zip(outs, plain))
        rec = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats), launches=counts,
                   same_as_plain=same,
                   first_divergence=[next((i for i, (x, y) in enumerate(zip(a, b))
                                           if x != y), None) for a, b in zip(outs, plain)])
        out[label] = rec
        print(f"   {label}: served {rec['tokens_served']} tokens in {wall:.2f} s "
              f"({rec['tokens_per_s']:.1f} tokens/s), {cb.stats['decode_steps']} decode "
              f"steps, {cb.stats['multi_blocks']} fused blocks, {cb.stats['chunks']} chunks, "
              f"{cb.stats['preemptions']} preemptions; {same} of {len(plain)} requests "
              f"token-identical to the plain trace (first divergence "
              f"{rec['first_divergence']})")
        del cb
        if same != len(plain):
            raise AssertionError(f"{label}: {same} of {len(plain)} requests equal the "
                                 "plain trace")
    sampled = []
    for _ in range(2):
        cb, reqs, wall, counts = serve(
            torch, cfg, params, {}, "decode_attn",
            request=lambda i: {"temperature": 0.8, "top_k": 40, "seed": 100 + i})
        sampled.append([list(r.output) for r in reqs])
        out.setdefault("sampled", []).append(dict(serve_record(reqs, wall, cfg),
                                                  stats=dict(cb.stats)))
        del cb
    print(f"   sampled (temperature 0.8, top-k 40, seeds 100-107): two runs "
          f"{'identical' if sampled[0] == sampled[1] else 'DIFFER'}; "
          f"{sum(a == b for a, b in zip(sampled[0], plain))} of {len(plain)} requests "
          f"equal the greedy trace")
    if sampled[0] != sampled[1]:
        raise AssertionError("a sampled run does not repeat itself from its seeds")
    return out


# ---------------------------------------------------------------------------
# phase prefix: the radix prefix cache and the tiered KV pool (A.10)
# ---------------------------------------------------------------------------
PREFIX_SYSTEM = 384          # tokens of a group's shared system prompt
PREFIX_MAX_LEN = 1024
PREFIX_CHUNK = 64
PREFIX_TIER_ROWS = 1100      # run (c)'s cache rows: about two leaves hot


def prefix_trace(vocab_size: int) -> tuple[list, list, list]:
    """12 requests in 3 groups of 4 (seed 3): each group shares a 384-token
    system prompt, each request has its own 16-128-token tail and a budget
    of 8-32 tokens.  Request ``4 g`` leads group g."""
    import numpy as np
    rng = np.random.default_rng(3)
    systems = [rng.integers(0, vocab_size, PREFIX_SYSTEM).tolist() for _ in range(3)]
    prompts, budgets = [], []
    for g in range(3):
        for _ in range(4):
            prompts.append(systems[g] + rng.integers(0, vocab_size,
                                                     int(rng.integers(16, 129))).tolist())
            budgets.append(int(rng.integers(8, 33)))
    return systems, prompts, budgets


def quantize_round_trip(torch) -> dict:
    """The three quantizers' division on the card, and whether
    ``quantize_kv``'s scales come back after dequantizing: rows whose largest
    magnitude is each of the 2^23 floats in [1, 2) (every mantissa), each
    quantizer's scales against float32 ``amax / 127`` (IEEE division) and
    ``amax * fl(1/127)`` (a multiply by the reciprocal) computed on the host
    (gated: IEEE division in all three), then ``quantize_kv``'s rows
    dequantized and quantized again (gated: no scale and no code moves)."""
    import numpy as np
    from repro_torch.core import quant

    amax = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(127 << 23)).view(np.float32)
    rows = torch.from_numpy(np.stack([amax, -0.5 * amax], -1)).cuda()
    ieee = amax / np.float32(127.0)
    recip = amax * (np.float32(1.0) / np.float32(127.0))
    out = {"n_scales": int(amax.size), "ieee_ne_reciprocal": int((ieee != recip).sum()),
           "quantizers": {}}
    for name, fn in (("quantize_weight", lambda x: quant.quantize_weight(x.T, axis=0)),
                     ("quantize_activation", quant.quantize_activation),
                     ("quantize_kv", lambda x: quant.quantize_kv(x[:, None, :]))):
        card = fn(rows)[1].reshape(-1).cpu().numpy()
        rec = {"card_ne_ieee_division": int((card != ieee).sum()),
               "card_ne_reciprocal_multiply": int((card != recip).sum())}
        rec["division"] = ("ieee" if not rec["card_ne_ieee_division"] else
                           "reciprocal" if not rec["card_ne_reciprocal_multiply"] else "neither")
        out["quantizers"][name] = rec
        print(f"   {name} on the card: scale = amax / 127 as {rec['division']} (differs "
              f"from IEEE division in {rec['card_ne_ieee_division']} and from a reciprocal "
              f"multiply in {rec['card_ne_reciprocal_multiply']} of {out['n_scales']} "
              f"mantissas)")
    q, s = quant.quantize_kv(rows[:, None, :])
    q2, s2 = quant.quantize_kv(quant.dequantize_kv(q, s))
    out["round_trip_scale_drift"] = int((s2 != s).sum())
    out["round_trip_code_drift"] = int((q2 != q).sum())
    out["division"] = out["quantizers"]["quantize_kv"]["division"]
    print(f"   quantize_kv: dequantize -> quantize moves {out['round_trip_scale_drift']} "
          f"scales and {out['round_trip_code_drift']} codes")
    bad = [k for k, v in out["quantizers"].items() if v["division"] != "ieee"]
    if bad or out["round_trip_scale_drift"] or out["round_trip_code_drift"]:
        raise AssertionError(f"quantizers not dividing as IEEE: {bad}; round trip moves "
                             f"{out['round_trip_scale_drift']} scales, "
                             f"{out['round_trip_code_drift']} codes")
    del rows, q, s, q2, s2
    return out


def system_rows(torch, cfg, params, systems: list) -> list:
    """Each system prompt's int8 K/V rows from a one-shot prefill of it alone:
    the rows every leaf of its group holds (the prompt fills whole 64-row
    pieces, so a longer prompt's prefill computes them with the same bits)."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    rows = []
    for sys_prompt in systems:
        _, st = M.prefill(params, cfg, {"inputs": torch.tensor([sys_prompt], device="cuda")},
                          PREFIX_SYSTEM, Runtime("fused_int8"))
        rows.append([{k: v[0, :PREFIX_SYSTEM].clone() for k, v in lay.items()}
                     for lay in st["layers"]])
        del st
    return rows


def serve_prefix(torch, cfg, params, lane: dict, order: str, expected: list) -> tuple:
    """The prefix trace on 4 slots (``max_len`` 1024, ``chunk`` 64) with the
    lane's arguments, the launch counts reset just before and read just
    after, gated exact.  ``order`` "groups": each group's leader to
    completion, then its 3 followers together; "leaders": the 3 leaders to
    completion, then the 9 followers together.  Each warm admission's hit
    is recorded, and when a request's prefill completes, its slot's rows of
    the system prompt (all 32 layers, k_q / k_s / v_q / v_s; cached rows on
    a warm admission, its own on a cold one) are compared with
    ``expected``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    _, prompts, budgets = prefix_trace(cfg.vocab_size)
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=PREFIX_MAX_LEN,
                                  chunk=PREFIX_CHUNK, rt=Runtime("fused_int8"), **lane)
    group, hits, rows_ok = {}, {}, {}
    admit, emit = cb._admit_chunked, cb._emit_first

    def admit_rec(req):
        admit(req)
        if req.prefill_pos:
            hits[req.rid] = req.prefill_pos

    def emit_check(req, logits):
        emit(req, logits)
        if req.rid not in rows_ok:
            want = expected[group[req.rid]]
            rows_ok[req.rid] = all(
                torch.equal(lay[k][req.slot, :PREFIX_SYSTEM], w[k])
                for lay, w in zip(cb.state["layers"], want) for k in w)
    cb._admit_chunked, cb._emit_first = admit_rec, emit_check
    waves = ([[4 * g], [4 * g + 1, 4 * g + 2, 4 * g + 3]] for g in range(3)) \
        if order == "groups" else iter([[[0, 4, 8], [i for i in range(12) if i % 4]]])
    torch.cuda.synchronize()
    cb.reset_clock()
    reset_launch_counts()                      # the path's run starts here
    t0 = time.perf_counter()
    reqs = {}
    for pair in waves:
        for wave in pair:
            for i in wave:
                r = cb.submit(prompts[i], budgets[i])
                reqs[i], group[r.rid] = r, i // 4
            cb.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()                   # ... and ends here
    want = want_launches(cfg, cb.stats["decode_steps"], [len(p) for p in prompts],
                         "decode_attn", prefills=cb.prefill_pieces)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    ordered = [reqs[i] for i in range(12)]
    rec = dict(serve_record(ordered, wall, cfg), stats=dict(cb.stats), launches=counts)
    for r, per in zip(ordered, rec["requests"]):
        per.update(group=group[r.rid], hit=hits.get(r.rid, 0),
                   prefill_s=r.first_token_time - r.admit_time,
                   rows_equal=rows_ok.get(r.rid))
    if cb._pcache is not None:
        rec["cache"] = dict(cb._pcache.stats)
    if cb._swap is not None:
        rec["swap_copies"] = list(cb.swap_copies)
    outs = [list(r.output) for r in ordered]
    del cb
    torch.cuda.empty_cache()
    return rec, outs


def warm_margin(torch, cfg, params, qparams, prompt: list, n_hit: int, prefix: list,
                toks: tuple) -> dict:
    """:func:`decode_margin` for a warm admission: the system rows from a
    one-shot prefill, a warm carry from them, the rest of the prompt in
    64-token chunks, a finalize past the cached rows, then ``prefix`` fed
    back one decode step at a time."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime

    rt = Runtime("fused_int8")
    ml = len(prompt) + len(prefix) + 1
    _, st = M.prefill(params, cfg, {"inputs": torch.tensor([prompt[:n_hit]], device="cuda")},
                      ml, rt)
    carry = M.warm_prefill_carry(cfg, st, 0, n_hit, T.carry_len(ml), prompt[:n_hit])
    for i in range(n_hit, len(prompt), PREFIX_CHUNK):
        n = min(PREFIX_CHUNK, len(prompt) - i)
        chunk = torch.zeros((1, PREFIX_CHUNK), dtype=torch.int64, device="cuda")
        chunk[0, :n] = torch.tensor(prompt[i:i + n])
        lg, carry = M.prefill_chunk(params, cfg, carry, chunk, n, rt)
    T.write_slot(st, 0, M.finalize_prefill_carry(cfg, carry, ml, n_hit), n_hit)
    for tok in prefix:
        lg, st = M.decode_step(qparams, cfg, st, torch.tensor([tok], dtype=torch.int32,
                                                               device="cuda"), rt)
    row = lg[0].float()
    a, b = (float(row[t]) for t in toks)
    return {"logits": [a, b], "argmax": int(row.argmax()), "row": row}


def warm_divergences(torch, cfg, params, rec: dict, outs: list, off: list) -> list:
    """Each request whose tokens part from the cache-off trace: both lanes'
    logits at the first differing token from single-request reruns (the
    cache-off lane's cold, :func:`decode_margin`; the warm lane's from its
    hit, :func:`warm_margin`).  A part is explained when both reruns pick
    their lane's token, the cache-off lane's best two lie closer than the
    two lanes' logit rows lie apart, and those lie within 10% of the logit
    scale; a cold admission must not part at all."""
    from repro_torch.serve.quantize import quantize_tree

    _, prompts, _ = prefix_trace(cfg.vocab_size)
    qparams = None
    res = []
    for i, (a, b, per) in enumerate(zip(outs, off, rec["requests"])):
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        m = {"request": i, "token": d, "tokens": [a[d], b[d]], "hit": per["hit"]}
        if per["hit"]:
            qparams = qparams if qparams is not None else quantize_tree(params)
            cold = decode_margin(torch, cfg, params, qparams, prompts[i], b[:d], (b[d], a[d]))
            warm = warm_margin(torch, cfg, params, qparams, prompts[i], per["hit"], a[:d],
                               (b[d], a[d]))
            m.update(off_top2_gap=cold["top2_gap"], logit_scale=cold["logit_scale"],
                     lanes_max_abs_diff=float((cold["row"] - warm["row"]).abs().max()),
                     off_reproduced=cold["argmax"] == b[d],
                     warm_reproduced=warm["argmax"] == a[d])
            m["explained"] = (m["off_reproduced"] and m["warm_reproduced"]
                              and m["off_top2_gap"] < m["lanes_max_abs_diff"]
                              <= 0.1 * m["logit_scale"])
        else:
            m["explained"] = False
        res.append(m)
        print(f"   request {i} (hit {per['hit']}) parts from the cache-off trace at token "
              f"{d} ({a[d]} vs {b[d]}): {m}")
    del qparams
    return res


def swap_trace(torch, cfg, params, plain: list) -> dict:
    """The phase-4 trace under ``priority:preempt`` with ``kv_swap``
    (4 slots, ``max_len`` 256, atomic prefill): requests 0-3 at priority 0
    until they decode, then 4-7 at priority 1, which preempt them; every
    victim's rows swap out and return verbatim, so the trace must equal the
    plain trace 8 of 8, every request prefilled once."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    prompts, budgets = serve_trace(cfg.vocab_size)
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                  rt=Runtime("fused_int8"), policy="priority:preempt",
                                  kv_swap=True, cold_rows=8 * 256)
    torch.cuda.synchronize()
    cb.reset_clock()
    reset_launch_counts()                      # the path's run starts here
    t0 = time.perf_counter()
    reqs = [cb.submit(p, b, priority=0) for p, b in zip(prompts[:4], budgets[:4])]
    for _ in range(2):
        cb.step()
    reqs += [cb.submit(p, b, priority=1) for p, b in zip(prompts[4:], budgets[4:])]
    cb.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()                   # ... and ends here
    st, pieces = cb.stats, cb.prefill_pieces
    want = want_launches(cfg, st["decode_steps"], [len(p) for p in prompts], "decode_attn",
                         prefills=pieces)
    once = sum(T.prefill_pieces(cfg, cb._bucket(len(p))) for p in prompts)
    outs = [list(r.output) for r in reqs]
    same = sum(a == b for a, b in zip(outs, plain))
    rec = dict(serve_record(reqs, wall, cfg), stats=dict(st), launches=counts,
               same_as_plain=same, swap_copies=list(cb.swap_copies),
               row_bytes=cb._swap.row_bytes)
    for d, n, s in cb.swap_copies:
        print(f"   {d}: {n} bytes in {s * 1e3:.3f} ms ({n / s / 1e9:.2f} GB/s)")
    print(f"   swap trace: {same} of {len(plain)} requests equal the plain trace; "
          f"{st['preemptions']} preemptions, {st['preempt_swaps']} swapped, "
          f"{st['preempt_recomputes']} recomputed; {st['swap_out_bytes']} bytes out, "
          f"{st['swap_in_bytes']} in; modeled NAND cycles out {st['swap_out_cycles']}, in "
          f"{st['swap_in_cycles']}; launches {counts}")
    del cb
    torch.cuda.empty_cache()
    if counts != want:
        raise AssertionError(f"swap trace: launch counts {counts} != {want}")
    if (same != len(plain) or st["preempt_swaps"] < 1 or st["preempt_recomputes"]
            or st["swap_in_bytes"] != st["swap_out_bytes"] or pieces != once):
        raise AssertionError(f"swap trace: {same} of {len(plain)} equal, stats {st}, "
                             f"prefill pieces {pieces} != {once}")
    return rec


def phase_prefix(torch, ctx) -> dict:
    """llama3-8b at full width on 4 slots: how ``quantize_kv``'s division
    runs on the card; the prefix trace without the cache, with it (each
    group's leader, then its followers: 9 warm admissions of about 384
    tokens, ``prefill_tokens_saved`` their sum, each warm slot's system rows
    byte-identical to the leaf's in all 32 layers (and every slot's to a
    one-shot prefill of its system prompt), every token that parts
    from the cache-off trace explained by a near-tie), and with the cache
    small and the cold tier on (the 3 leaders, then the 9 followers: a
    demoted leaf promoted at least once, the same row and token gates);
    then the swap trace.  Warm and cold TTFT, the tokens saved and every
    block copy's time are recorded."""
    from repro_torch.configs import registry

    cfg = registry.get("llama3-8b")
    params = ctx["params"]
    out = {"quantize_round_trip": quantize_round_trip(torch)}
    systems, prompts, _ = prefix_trace(cfg.vocab_size)
    expected = system_rows(torch, cfg, params, systems)
    runs = {"cache_off": ({}, "groups"), "cache": ({"prefix_cache": True}, "groups"),
            "tiers": ({"prefix_cache": True, "prefix_cache_rows": PREFIX_TIER_ROWS,
                       "kv_swap": True}, "leaders")}
    outs = {}
    for label, (lane, order) in runs.items():
        rec, outs[label] = serve_prefix(torch, cfg, params, lane, order, expected)
        out[label] = rec
        per = rec["requests"]
        warm = [p for p in per if p["hit"]]
        cold = [p for p in per if not p["hit"]]
        rec["warm_ttft_s"] = [p["ttft_s"] for p in warm]
        rec["cold_ttft_s"] = [p["ttft_s"] for p in cold]
        print(f"   {label}: served {rec['tokens_served']} tokens in {rec['wall_s']:.2f} s; "
              f"{len(warm)} warm admissions (hits {[p['hit'] for p in warm]}), "
              f"{rec['stats'].get('prefill_tokens_saved', 0)} prompt tokens saved; TTFT "
              f"warm {[round(p['ttft_s'] * 1e3, 1) for p in warm]} ms, cold "
              f"{[round(p['ttft_s'] * 1e3, 1) for p in cold]} ms; admission to first token "
              f"warm {[round(p['prefill_s'] * 1e3, 1) for p in warm]} ms, cold "
              f"{[round(p['prefill_s'] * 1e3, 1) for p in cold]} ms; "
              f"cache {rec.get('cache')}; launches {rec['launches']}")
        for d, n, s in rec.get("swap_copies", []):
            print(f"   {label} {d}: {n} bytes in {s * 1e3:.3f} ms")
        bad_rows = [i for i, p in enumerate(per) if p["rows_equal"] is not True]
        if bad_rows:
            raise AssertionError(f"{label}: the slots' system rows differ from a one-shot "
                                 f"prefill's in requests {bad_rows}")
        if sum(p["hit"] for p in warm) != rec["stats"].get("prefill_tokens_saved", 0):
            raise AssertionError(f"{label}: hits {[p['hit'] for p in warm]} do not sum to "
                                 f"prefill_tokens_saved")
        if label == "cache_off":
            continue
        if label == "cache" and (len(warm) != 9 or any(
                not PREFIX_SYSTEM <= p["hit"] <= PREFIX_SYSTEM + 4 for p in warm)):
            raise AssertionError(f"cache: {len(warm)} warm admissions, hits "
                                 f"{[p['hit'] for p in warm]}")
        if label == "tiers" and (rec["cache"]["promotions"] < 1
                                 or rec["cache"]["demotions"] < 1 or not warm):
            raise AssertionError(f"tiers: no demoted leaf promoted: {rec['cache']}")
        rec["same_as_cache_off"] = sum(a == b for a, b in zip(outs[label], outs["cache_off"]))
        rec["divergences"] = warm_divergences(torch, cfg, params, rec, outs[label],
                                              outs["cache_off"])
        far = [m["request"] for m in rec["divergences"] if not m["explained"]]
        print(f"   {label}: {rec['same_as_cache_off']} of 12 requests equal the cache-off "
              f"trace; unexplained parts: {far}")
        if far:
            raise AssertionError(f"{label}: requests {far} part from the cache-off trace "
                                 "without a near-tie")
    both = [i for i, (p, q) in enumerate(zip(out["cache"]["requests"],
                                             out["tiers"]["requests"]))
            if p["hit"] and p["hit"] == q["hit"]]
    out["tiers"]["same_as_cache_where_hits_equal"] = [
        outs["tiers"][i] == outs["cache"][i] for i in both]
    if not all(out["tiers"]["same_as_cache_where_hits_equal"]):
        raise AssertionError("tiers: a request with the same hit parts from the cache run")
    del expected
    torch.cuda.empty_cache()
    out["swap"] = swap_trace(torch, cfg, params, ctx["plain_outputs"])
    return out


# ---------------------------------------------------------------------------
# phase server: the engine as a live service (A.10's rest)
# ---------------------------------------------------------------------------
SERVER_FAIL_AT = (5, 9, 30)      # injected device errors (they fire on decode steps)
SERVER_SLOT_LOSS = ((12, 2),)    # (step, slot): a plane lost mid-trace


def stream_trace(cb, prompts: list, budgets: list, waves: list, cancel: int | None = None,
                 deadline: tuple | None = None) -> tuple:
    """Serve the trace through ``AsyncServer`` over ``cb``: ``waves`` is a
    list of (request indices, priority), each wave submitted at once, and
    the next once every request of the one before has a token (or ended);
    request ``cancel`` disconnects after its second token; ``deadline`` is
    (request index, seconds).  The event loop only reads host lists; every
    engine step runs on the server's worker thread.  Returns the streams,
    each stream's tokens, whether it raised ``RequestTimedOut``, and the
    wall time."""
    import asyncio
    from repro_torch.serve.server import AsyncServer, RequestTimedOut

    async def consume(i, stream):
        toks = []
        try:
            async for tok in stream:
                toks.append(tok)
                if i == cancel and len(toks) == 2:
                    stream.cancel()
        except RequestTimedOut:
            return toks, True
        return toks, False

    async def run():
        streams, tasks = {}, {}
        async with AsyncServer(cb) as srv:
            for k, (idx, prio) in enumerate(waves):
                while k and not all(streams[i].request.output or streams[i].request.done
                                    for i in waves[k - 1][0]):
                    await asyncio.sleep(0.001)

                def kw(i):
                    extra = {"deadline_s": deadline[1]} if deadline and deadline[0] == i else {}
                    return {"priority": prio, **extra}
                got = await asyncio.gather(*(srv.submit(prompts[i], budgets[i], **kw(i))
                                             for i in idx))
                for i, s in zip(idx, got):
                    streams[i] = s
                    tasks[i] = asyncio.create_task(consume(i, s))
            done = {i: await t for i, t in tasks.items()}
        return streams, done

    t0 = time.perf_counter()
    streams, done = asyncio.run(run())
    wall = time.perf_counter() - t0
    n = len(prompts)
    return ([streams[i] for i in range(n)], [done[i][0] for i in range(n)],
            [done[i][1] for i in range(n)], wall)


def ledger_balanced(cb) -> bool:
    """Every slot free or quarantined, no carry, no work left."""
    sched = cb.scheduler
    return (len(sched.free_slots) + len(sched.quarantined) == cb.n_slots
            and not cb._carries and not cb._warm_rows and not sched.has_work())


def server_faults(torch, cfg, params, plain: list, faults) -> dict:
    """The swap trace (``priority:preempt``, ``kv_swap``; requests 0-3 at
    priority 0, then 4-7 at priority 1 once 0-3 decode) streamed through the
    server with ``faults``: every stream must equal the plain trace, each
    injected failure must be one retry and one pool rebuild, and the
    rebuilds must keep the pool's tensors (their addresses) and the captured
    steps (nothing captured again)."""
    from repro_torch.models import graphs as G
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    prompts, budgets = serve_trace(cfg.vocab_size)
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                  rt=Runtime("fused_int8"), policy="priority:preempt",
                                  kv_swap=True, cold_rows=8 * 256, faults=faults)
    bufs = G.state_tensors(cb.state) + cb._static_inputs()
    ptrs = [t.data_ptr() for t in bufs]
    graphs = {k: g.graph for k, g in cb._steps.graphs.items()}
    captures, rebuild_s = [], []
    real_capture, real_rebuild = G.StepGraph._capture, cb._rebuild_pool

    def timed_rebuild():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_rebuild()
        torch.cuda.synchronize()
        rebuild_s.append(time.perf_counter() - t0)
    G.StepGraph._capture = lambda *a: captures.append(a)
    cb._rebuild_pool = timed_rebuild
    try:
        streams, outs, _, wall = stream_trace(cb, prompts, budgets,
                                              [(range(4), 0), (range(4, 8), 1)])
    finally:
        G.StepGraph._capture = real_capture
    st, inj = dict(cb.stats), dict(faults.injected)
    same = sum(a == b and list(s.request.output) == b
               for a, b, s in zip(outs, plain, streams))
    rec = {"wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall, "same_as_plain": same,
           "stats": st, "injected": inj, "rebuild_s": rebuild_s,
           "quarantined": sorted(cb.scheduler.quarantined),
           "ptrs_unchanged": [t.data_ptr() for t in bufs] == ptrs,
           "graphs_unchanged": {k: g.graph for k, g in cb._steps.graphs.items()} == graphs,
           "captures": len(captures), "ledger_balanced": ledger_balanced(cb)}
    del cb, bufs, graphs
    torch.cuda.empty_cache()
    return rec


def phase_server(torch, ctx) -> dict:
    """llama3-8b at full width under ``fused_int8`` on 4 slots, the phase-4
    trace run as a live service through ``AsyncServer``: ``drain()`` and the
    streamed trace on one engine (8 of 8 streams equal the plain trace, with
    exact B1 / B2 / RMSNorm launches), a disconnect after a stream's second
    token (a prefix of its plain stream, CANCELLED, its slot taken by a
    queued request, the ledger balanced, the other 7 unchanged), a deadline
    shorter than a request's plain service time (TIMEOUT, a prefix,
    ``RequestTimedOut`` in its stream); then the swap trace with injected
    step failures and a lost slot, and with NAND bit flips at BER 2e-4
    (every stream equal to the plain trace, one retry and one in-place
    rebuild an injected failure, no recapture); and the serve CLI's
    ``--serve`` mode in a subprocess."""
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.faults import FaultInjector

    cfg = registry.get("llama3-8b")
    params, plain = ctx["params"], ctx["plain_outputs"]
    prompts, budgets = serve_trace(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                  rt=Runtime("fused_int8"))
    out: dict = {}
    # drain() on the trace, then the same trace streamed, on one engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [cb.submit(p, b) for p, b in zip(prompts, budgets)]
    cb.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["drain"] = {"wall_s": wall, "tokens_per_s": sum(budgets) / wall,
                    "steps": cb.stats["steps"],
                    "latency_s": [r.finish_time - r.arrival_time for r in reqs]}
    if [list(r.output) for r in reqs] != plain:
        raise AssertionError("drain(): the trace parts from the plain trace")
    steps0, decode0 = cb.stats["steps"], cb.stats["decode_steps"]
    reset_launch_counts()                      # the server path's run starts here
    streams, outs, _, wall = stream_trace(cb, prompts, budgets, [(range(8), 0)])
    counts = launch_counts()                   # ... and ends here
    want = want_launches(cfg, cb.stats["decode_steps"] - decode0, lens, "decode_attn",
                         prefills=prefill_calls(cb, [s.request for s in streams]))
    same = sum(a == b for a, b in zip(outs, plain))
    steps = cb.stats["steps"] - steps0
    out["stream"] = {"wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
                     "steps": steps, "launches": counts, "same_as_plain": same,
                     "hop_ms_per_step": (wall / steps - out["drain"]["wall_s"]
                                         / out["drain"]["steps"]) * 1e3}
    print(f"   drain(): {sum(budgets)} tokens in {out['drain']['wall_s']:.3f} s "
          f"({out['drain']['tokens_per_s']:.1f} tokens/s, {out['drain']['steps']} steps); "
          f"streamed: {sum(map(len, outs))} tokens in {wall:.3f} s "
          f"({out['stream']['tokens_per_s']:.1f} tokens/s, {steps} steps, "
          f"{out['stream']['hop_ms_per_step']:.2f} ms a step over drain()); {same} of 8 "
          f"streams equal the plain trace; launches {counts}")
    if same != 8 or counts != want:
        raise AssertionError(f"streamed: {same} of 8 equal; launches {counts} != {want}")

    # a disconnect after request 0's second token
    admitted = []
    real_admit = cb.scheduler.admit

    def logged_admit(now):
        got = real_admit(now)
        admitted.extend((r.rid, r.slot) for r in got)
        return got
    cb.scheduler.admit = logged_admit
    streams, outs, _, wall = stream_trace(cb, prompts, budgets, [(range(8), 0)], cancel=0)
    cb.scheduler.admit = real_admit
    gone = streams[0].request
    slot0 = next(slot for rid, slot in admitted if rid == gone.rid)
    by_rid = {s.request.rid: s.request for s in streams}
    taken = [rid for rid, slot in admitted if slot == slot0 and rid != gone.rid
             and by_rid[rid].admit_time >= gone.finish_time]
    others = sum(list(s.request.output) == p for s, p in zip(streams[1:], plain[1:]))
    out["cancel"] = {"tokens": len(gone.output), "state": gone.state.value,
                     "slot_taken_by": taken, "others_same": others,
                     "ledger_balanced": ledger_balanced(cb)}
    print(f"   disconnect: request 0 {gone.state.value} after {len(gone.output)} tokens "
          f"(streamed {len(outs[0])}); slot {slot0} then taken by {taken}; "
          f"{others} of 7 others equal; ledger balanced {out['cancel']['ledger_balanced']}")
    if (gone.state.value != "cancelled" or not 2 <= len(gone.output) < budgets[0]
            or list(gone.output) != plain[0][:len(gone.output)] or not taken
            or others != 7 or not out["cancel"]["ledger_balanced"]):
        raise AssertionError(f"disconnect: {out['cancel']}")

    # a deadline at half a first-wave request's drain() latency
    lat = out["drain"]["latency_s"]
    late = max(range(4), key=lambda i: lat[i])
    streams, outs, raised, wall = stream_trace(cb, prompts, budgets, [(range(8), 0)],
                                               deadline=(late, lat[late] / 2))
    r = streams[late].request
    others = sum(list(s.request.output) == p
                 for i, (s, p) in enumerate(zip(streams, plain)) if i != late)
    out["deadline"] = {"request": late, "deadline_s": lat[late] / 2, "tokens": len(r.output),
                       "state": r.state.value, "raised": raised[late], "others_same": others,
                       "timeouts": cb.stats["timeouts"], "ledger_balanced": ledger_balanced(cb)}
    print(f"   deadline: request {late} ({lat[late] / 2:.3f} s, half its drain() latency) "
          f"{r.state.value} after {len(r.output)} of {budgets[late]} tokens, "
          f"RequestTimedOut {raised[late]}; {others} of 7 others equal")
    if (r.state.value != "timeout" or not raised[late]
            or not 1 <= len(r.output) < budgets[late]
            or list(r.output) != plain[late][:len(r.output)] or others != 7
            or not out["deadline"]["ledger_balanced"]):
        raise AssertionError(f"deadline: {out['deadline']}")
    del cb, streams
    torch.cuda.empty_cache()

    # the swap trace under injected faults, through the server
    for label, faults in (
            ("step_failures", FaultInjector(seed=0, step_fail_at=SERVER_FAIL_AT,
                                            slot_loss_at=SERVER_SLOT_LOSS)),
            ("bit_flips", FaultInjector(seed=0, ber=2e-4))):
        rec = out[label] = server_faults(torch, cfg, params, plain, faults)
        st, inj = rec["stats"], rec["injected"]
        print(f"   {label}: {rec['same_as_plain']} of 8 streams equal the plain trace in "
              f"{rec['wall_s']:.3f} s; injected {inj}; step_failures {st['step_failures']}, "
              f"retries {st['step_retries']}, rebuilds {st['pool_rebuilds']} "
              f"({[round(s * 1e3, 3) for s in rec['rebuild_s']]} ms each), slot losses "
              f"{st['slot_losses']}, quarantined {rec['quarantined']}, cold re-reads "
              f"{st['cold_rereads']}, recomputes {st['recovery_recomputes']}; swaps "
              f"{st['preempt_swaps']}, ECC checks {st['ecc_checks']}, corrected bits "
              f"{st['ecc_corrected_bits']}, uncorrectable {st['uncorrectable_blocks']}; "
              f"addresses kept {rec['ptrs_unchanged']}, graphs kept "
              f"{rec['graphs_unchanged']}, captures {rec['captures']}")
        bad = (rec["same_as_plain"] != 8 or not rec["ptrs_unchanged"]
               or not rec["graphs_unchanged"] or rec["captures"] or not rec["ledger_balanced"]
               or st["pool_rebuilds"] != inj["step_failures"]
               or st["step_retries"] != inj["step_failures"])
        if label == "step_failures":
            bad |= (inj["step_failures"] < 1 or st["slot_losses"] != 1
                    or st["quarantined_slots"] != 1 or len(rec["rebuild_s"]) < 1)
        else:
            bad |= (st["ecc_corrected_bits"] < 1 or st["uncorrectable_blocks"]
                    or st["swap_ins"] < 1)
        if bad:
            raise AssertionError(f"{label}: {rec}")

    # the serve CLI, as a user starts it
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "llama3-8b", "--reduced", "--serve", "--requests", "3",
                          "--slots", "2"], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(root / "src")})
    out["cli"] = {"rc": cli.returncode, "seconds": time.perf_counter() - t0,
                  "stdout": cli.stdout[-2000:], "stderr": cli.stderr[-2000:]}
    print(f"   CLI --serve: exit {cli.returncode} in {out['cli']['seconds']:.1f} s; "
          f"last line {cli.stdout.strip().splitlines()[-1:]}")
    if cli.returncode != 0 or "SERVE_SHUTDOWN_CLEAN" not in cli.stdout:
        raise AssertionError(f"CLI --serve: {out['cli']}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the SSM slice (mamba2-2.7b, B6)
# ---------------------------------------------------------------------------
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE = 80, 64, 128     # mamba2-2.7b at full width
SSD_GROUPS = 1                                       # mamba2-2.7b: one B/C group
# (N, Q): a whole chunk, a prompt, a token, an odd chunk
SSD_SHAPES = ((4, 128), (1, 37), (2, 1), (2, 33))


def ssd_inputs(torch, g, N: int, Q: int, H: int = SSD_HEADS) -> tuple:
    """B6's operands at full width (``H`` heads of ``SSD_HEAD_DIM``), drawn
    as the reference's kernel test draws them (``tests/test_kernels_ssm.py``),
    with B and C per group as the model's kernel route passes them."""
    dh, S, G = SSD_HEAD_DIM, SSD_STATE, SSD_GROUPS

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return (normal(N, Q, H, dh), normal(N, Q, G, S) * 0.5, normal(N, Q, G, S) * 0.5,
            torch.nn.functional.softplus(normal(N, Q, H)), -torch.exp(normal(H) * 0.3),
            torch.ones(H, device="cuda"), normal(N, H, dh, S) * 0.1)


def ssd_work(N: int, Q: int, G: int, H: int = SSD_HEADS) -> tuple[int, int, int]:
    """Bytes B6 must move (each input read once, each output written once,
    B and C per group of G) and its operations on these inputs: the four
    products (the scores C.B once per group over the causal triangle
    k <= q; per head the scores times x*dt over the same triangle, C*exp(cs)
    times h_in, and the chunk state from B*decay and x*dt) and the
    elementwise f32 terms (the decay scale over the triangle, C*exp(cs),
    B*decay, x*dt, the skip D*x and the sums), at ``H`` heads."""
    dh, S = SSD_HEAD_DIM, SSD_STATE
    n_bytes = 4 * (2 * N * Q * H * dh + 2 * N * Q * G * S + N * Q * H + 2 * H
                   + 2 * N * H * dh * S + N * H)
    tri = Q * (Q + 1) // 2
    products = N * (G * tri * 2 * S + H * (tri * 2 * dh + 2 * Q * S * 2 * dh))
    elementwise = N * H * (tri + 2 * Q * S + 4 * Q * dh)
    return n_bytes, products, elementwise


def ssd_bound(N: int, Q: int, H: int = SSD_HEADS) -> tuple[float, str]:
    """B6's bound as it is called: B and C per group, the products at the
    TF32 tensor rate three times over (3xTF32: hi*hi, hi*lo, lo*hi), the
    elementwise terms at the f32 rate."""
    n_bytes, products, elementwise = ssd_work(N, Q, SSD_GROUPS, H)
    return bound_ms(n_bytes, [(3 * products, TF32_FLOPS_PER_S),
                              (elementwise, FP32_FLOPS_PER_S)])


def ssd_bound_per_head(N: int, Q: int, H: int = SSD_HEADS) -> tuple[float, str]:
    """The per-head count, kept beside it for comparison with the kernel's
    first design: B and C read for each head and every operation at the
    f32 rate outside the tensor cores."""
    n_bytes, products, elementwise = ssd_work(N, Q, H, H)
    return bound_ms(n_bytes, [(products + elementwise, FP32_FLOPS_PER_S)])


def ssd_kernel_checks(torch, ssd, H: int = SSD_HEADS, shapes: tuple = SSD_SHAPES) -> dict:
    """B6 against its plain version at N 4 / Q 128, N 1 / Q 37, N 2 / Q 1
    and N 2 / Q 33 (or ``shapes``; ``H`` heads of 64 in one group, mamba2's
    80 by default, state 128): y and the chunk state within rtol 2e-4
    / atol 2e-5, the decay within rtol 1e-5; device time (graph replay),
    eager time, the plain version's time and the bound at each shape.  The
    record is the first shape's, with every shape's under ``shapes``."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for N, Q in shapes:
        args = ssd_inputs(torch, g, N, Q, H)
        got = ssd.ssd_chunk_cuda(*args)
        want = ssd.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        for name, a, b, (rtol, atol) in zip(("y", "s_out", "decay"), got, want,
                                            ((2e-4, 2e-5), (2e-4, 2e-5), (1e-5, 0.0))):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"B6 N={N} Q={Q}: non-finite {name}")
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=lambda m, n=name: f"B6 N={N} Q={Q} {n}: {m}")
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        n_bytes, products, elementwise = ssd_work(N, Q, SSD_GROUPS, H)
        sets = copies(torch, lambda: ssd_inputs(torch, g, N, Q, H), n_bytes)
        n = len(sets)
        tk = timed(torch, lambda i: ssd.ssd_chunk_cuda(*sets[i % n]), 20)
        tp = timed(torch, lambda i: ssd.ssd_chunk_plain(*sets[i % n]), 5)
        b, b_head = ssd_bound(N, Q, H), ssd_bound_per_head(N, Q, H)
        out[f"N{N}_Q{Q}"] = {"N": N, "Q": Q, "H": H, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                             "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
                             "bound_ms": b[0], "bound_by": b[1], "bytes": n_bytes,
                             "product_flops": products, "elementwise_flops": elementwise,
                             "bound_ms_per_head": b_head[0], "bound_by_per_head": b_head[1],
                             "max_abs_err": max(errs), "max_abs_err_y_state_decay": errs}
        print(f"   B6 N={N} Q={Q:3d} H={H} dh={SSD_HEAD_DIM} S={SSD_STATE}: "
              f"{tk['device_ms'] * 1e3:.1f} us device / {tk['eager_ms'] * 1e3:.1f} eager "
              f"(bound {b[0] * 1e3:.2f} by {b[1]}: {n_bytes / 1e6:.1f} MB, "
              f"{products / 1e9:.3f} GFLOP of products as 3xTF32, {elementwise / 1e9:.4f} "
              f"GFLOP f32; per-head bound {b_head[0] * 1e3:.2f} by {b_head[1]}; plain "
              f"{tp['device_ms'] * 1e3:.1f}); max |err| y {errs[0]:.3g}, state "
              f"{errs[1]:.3g}, decay {errs[2]:.3g}")
        del sets
    head = out["N{}_Q{}".format(*shapes[0])]
    # no single PyTorch call computes the masked-decay chunk (scores, decay
    # mask, state and decay together), so there is no library yardstick
    return dict(head, library_ms=None, shapes=out)


def rms_norm_checks(torch, rn) -> dict:
    """The RMSNorm kernel: within rtol 1e-6 of the plain version and
    row-invariant bit for bit (M 4 and 20 against 124) at d 2560, 4096 and
    5120; times at the decode steps' shapes [4, 2560], [4, 4096] and
    [4, 5120] (mamba2's, llama's, mamba2's inner width) beside the plain
    version's and ``torch.nn.functional.rms_norm``'s (a yardstick only)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(8)
    out = {"shapes": {}}
    for d in (2560, 4096, 5120):
        x = torch.randn((124, d), generator=g, device="cuda")
        scale = torch.randn((d,), generator=g, device="cuda")
        full = rn.rms_norm_cuda(x, scale)
        torch.testing.assert_close(full, rn.rms_norm_plain(x, scale), rtol=1e-6, atol=0.0)
        for m in (4, 20):
            parts = torch.cat([rn.rms_norm_cuda(x[i:i + m], scale) for i in range(0, 124, m)])
            if not torch.equal(parts, full):
                raise AssertionError(f"rms_norm d={d}: rows at M={m} differ from M=124")
    for d in (2560, 4096, 5120):
        M = 4
        x = torch.randn((M, d), generator=g, device="cuda")
        scale = torch.randn((d,), generator=g, device="cuda")
        err = float((rn.rms_norm_cuda(x, scale) - rn.rms_norm_plain(x, scale)).abs().max())
        # warm inputs: on the decode path the previous op has just written x
        tk = timed(torch, lambda i: rn.rms_norm_cuda(x, scale), 200)
        tp = timed(torch, lambda i: rn.rms_norm_plain(x, scale), 200)
        lib = (graph_ms(torch, lambda i: F.rms_norm(x, (d,), scale, 1e-5), 200)
               if hasattr(F, "rms_norm") else None)
        b = bound_ms(4 * (2 * M * d + d), [(4 * M * d, FP32_FLOPS_PER_S)])
        out["shapes"][d] = {"M": M, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                            "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
                            "library_ms": lib, "bound_ms": b[0], "bound_by": b[1],
                            "max_abs_err": err}
        print(f"   rms_norm [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
              f"{tk['eager_ms'] * 1e3:.2f} eager (bound {b[0] * 1e3:.3f}, plain "
              f"{tp['device_ms'] * 1e3:.2f} / {tp['eager_ms'] * 1e3:.2f} eager, "
              f"F.rms_norm {'n/a' if lib is None else f'{lib * 1e3:.2f}'}); max |err| {err:.3g}; "
              f"row-invariant at M 4, 20, 124 for d 2560, 4096, 5120")
    return dict(out["shapes"][5120], shapes=out["shapes"], row_invariant=True,
                quant=rms_norm_quant_checks(torch, rn))


# every width at which an RMSNorm's output feeds quantized linears on the
# served paths: the RMSNorm families' d_model, MLA's q_lora rank and the
# SSM blocks' inner widths (mamba2-2.7b's 5120, jamba's 16384)
SERVED_RMS_WIDTHS = (1536, 2560, 3072, 4096, 5120, 6144, 7168, 8192, 16384, 18432)
QUANT_ROWS = 124


def rms_norm_quant_checks(torch, rn) -> dict:
    """The RMSNorm fused with the activation quantizer (``rms_norm_quant``)
    at every width of :data:`SERVED_RMS_WIDTHS` (a zero row among random
    ones): its output bit-equal to the RMSNorm kernel's and its codes and
    scales to ``quantize_activation`` of that output, at 1, 4 and 20 rows a
    call, each call's rows equal to the 124-row call's (row-invariant), one
    kernel node when captured and the same bits on two replays (all
    gated); timed at [4, 4096] and [4, 5120] beside the RMSNorm kernel
    alone, the unfused pair (the kernel, then ``quantize_activation``)
    captured as a CUDA graph, the yardstick, and the plain version (no one
    library call computes the three outputs)."""
    from repro_torch.core import quant
    g = torch.Generator(device="cuda").manual_seed(27)
    out = {"widths": {}, "shapes": {}}
    for d in SERVED_RMS_WIDTHS:
        x = torch.randn((QUANT_ROWS, d), generator=g, device="cuda") * 2
        x[7] = 0                                   # the scale's floor
        scale = torch.randn((d,), generator=g, device="cuda")
        whole = rn.rms_norm_quant_cuda(x, scale)
        h = rn.rms_norm_cuda(x, scale)
        same = [torch.equal(a, b) for a, b in zip(whole, (h, *quant.quantize_activation(h)))]
        rows = {m: all(torch.equal(torch.cat([rn.rms_norm_quant_cuda(x[i:i + m], scale)[j]
                                              for i in range(0, QUANT_ROWS, m)]), whole[j])
                       for j in range(3)) for m in (1, 4, 20)}
        x4 = x[:4].contiguous()
        replays, nodes = replay_bits(torch, lambda i: rn.rms_norm_quant_cuda(x4, scale),
                                     tuple(t[:4] for t in whole))
        out["widths"][d] = {"equal_to_pair": same, "row_invariant": rows,
                            "replays_equal": replays, "graph_nodes": nodes}
        if not (all(same) and all(rows.values()) and replays and nodes == [0]):
            raise AssertionError(f"rms_norm_quant d={d}: equal to the kernel and the quantizer "
                                 f"{same}, rows across calls {rows}, replays {replays}, "
                                 f"device operations {nodes}")
    print(f"   rms_norm_quant: h, codes and scales equal to rms_norm_cuda then "
          f"quantize_activation at d {SERVED_RMS_WIDTHS}, row-invariant at 1, 4, 20 and "
          f"{QUANT_ROWS} rows a call, one kernel node a call, replays equal")
    for d in (4096, 5120):
        M = 4
        x = torch.randn((M, d), generator=g, device="cuda")
        scale = torch.randn((d,), generator=g, device="cuda")
        err = float((rn.rms_norm_quant_cuda(x, scale)[0] - rn.rms_norm_plain(x, scale))
                    .abs().max())
        tk = timed(torch, lambda i: rn.rms_norm_quant_cuda(x, scale), 200)
        tn = graph_ms(torch, lambda i: rn.rms_norm_cuda(x, scale), 200)
        tu = graph_ms(torch, lambda i: quant.quantize_activation(rn.rms_norm_cuda(x, scale)), 200)
        tp = graph_ms(torch, lambda i: rn.rms_norm_quant_plain(x, scale), 200)
        b = bound_ms(4 * (2 * M * d + d + M) + M * d, [(6 * M * d, FP32_FLOPS_PER_S)])
        out["shapes"][d] = {"M": M, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                            "rms_norm_ms": tn, "unfused_ms": tu, "plain_ms": tp,
                            "library_ms": None, "bound_ms": b[0], "bound_by": b[1],
                            "max_abs_err": err}
        print(f"   rms_norm_quant [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
              f"{tk['eager_ms'] * 1e3:.2f} eager (bound {b[0] * 1e3:.3f}; rms_norm alone "
              f"{tn * 1e3:.2f}, rms_norm + quantize_activation {tu * 1e3:.2f}, plain "
              f"{tp * 1e3:.2f}); max |err| of h {err:.3g}")
    return dict(out["shapes"][4096], shapes=out["shapes"], widths=out["widths"])


def ssd_forward_check(torch, cfg) -> dict:
    """One full-width mamba2 layer over T = 200 tokens (two chunks, the
    second padded): B6's path (``use_kernel``) against the model's chunked
    tensor path on the card, output within the reference's tolerance for
    this pair (rtol 3e-3, atol 3e-4) and the final state within its
    full-sequence tolerance (rtol 2e-3, atol 2e-4)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import ssm as SSM

    gen = torch.Generator(device="cuda").manual_seed(9)
    p = SSM.ssm_init(gen, cfg)
    x = torch.randn((1, 200, cfg.d_model), generator=gen, device="cuda")
    reset_launch_counts()
    yk, sk = SSM.ssm_forward(p, cfg, x, return_state=True, use_kernel=True)
    launches = launch_counts()["ssd_chunk"]
    yp, sp = SSM.ssm_forward(p, cfg, x, return_state=True, use_kernel=False)
    torch.cuda.synchronize()
    if launches != 2:
        raise AssertionError(f"ssd_forward at T=200 launched B6 {launches} times, not 2")
    torch.testing.assert_close(yk, yp, rtol=3e-3, atol=3e-4)
    torch.testing.assert_close(sk["h"], sp["h"], rtol=2e-3, atol=2e-4)
    out = {"T": 200, "launches": launches, "out_max_abs": float((yk - yp).abs().max()),
           "out_scale": float(yp.abs().max()),
           "h_max_abs": float((sk["h"] - sp["h"]).abs().max()),
           "h_scale": float(sp["h"].abs().max())}
    print(f"   ssm_forward T=200 (2 chunks), B6 path vs chunked tensor path: out max |diff| "
          f"{out['out_max_abs']:.3g} of {out['out_scale']:.3g}, final state "
          f"{out['h_max_abs']:.3g} of {out['h_scale']:.3g}")
    return out


def reduced_ssm(torch, cfg) -> dict:
    """The reduced mamba2 under ``fused_int8`` on the card (B6, B1, the
    norm kernel) against the same model on the CPU (plain versions):
    prefill over 150 tokens (two chunks) and one decode step, within 2% of
    the logit scale, argmax equal."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    rcfg = cfg.reduced()
    p_cpu = M.init_params(rcfg, seed=0, device="cpu")
    q_cpu = quantize_tree(p_cpu)
    prompts = torch.randint(0, rcfg.vocab_size, (2, 150),
                            generator=torch.Generator().manual_seed(3))
    rt = Runtime("fused_int8")
    res = {}
    for dev in ("cpu", "cuda"):
        p, q = convert.to_device(p_cpu, dev), convert.to_device(q_cpu, dev)
        lg0, st = M.prefill(p, rcfg, {"inputs": prompts.to(dev)}, 256, rt)
        lg1, _ = M.decode_step(q, rcfg, st, torch.argmax(lg0, -1).to(torch.int32), rt)
        res[dev] = (lg0.cpu(), lg1.cpu())
    out = {}
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["cpu"][i], res["cuda"][i]
        d, sc = float((a - b).abs().max()), float(a.abs().max())
        if not torch.equal(a.argmax(-1), b.argmax(-1)) or d > 2e-2 * sc:
            raise AssertionError(f"reduced mamba2 {what}: card vs cpu max diff {d} (scale {sc})")
        out[f"{what}_max_abs"], out[f"{what}_logit_scale"] = d, sc
    print(f"   reduced mamba2, card (kernels) vs CPU (plain): prefill max |diff| "
          f"{out['prefill_max_abs']:.3g} of {out['prefill_logit_scale']:.3g}, decode "
          f"{out['decode_max_abs']:.3g} of {out['decode_logit_scale']:.3g}, argmax equal")
    return out


def b6_on_trace_prefills(torch, cfg, params) -> dict:
    """B6 on the ragged trace's own inputs: each prompt prefilled alone under
    ``fused_int8``, as the continuous engine admits it (exact length, one B6
    launch per layer and 128-token chunk), with every B6 call repeated
    through the plain version on the same operands: y and the chunk state
    within rtol 2e-4 / atol 2e-5, the decay within rtol 1e-5, at the Q the
    trace gives.  ``tol_used`` is the worst |kernel - plain| / (atol + rtol
    * |plain|) of each output (at most 1 passes)."""
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    prompts, _ = serve_trace(cfg.vocab_size)
    kernel, calls = ssd.ssd_chunk_cuda, []
    tols = ((2e-4, 2e-5), (2e-4, 2e-5), (1e-5, 0.0))

    def checked(*args):
        got = kernel(*args)
        want = ssd.ssd_chunk_plain(*args)
        used = []
        for a, b, (rtol, atol) in zip(got, want, tols):
            diff = (a - b).abs()
            used.append(float(torch.where(diff > 0, diff / (atol + rtol * b.abs()),
                                          torch.zeros_like(diff)).max()))
        calls.append({"Q": args[0].shape[1], "tol_used": used,
                      "max_abs_err": [float((a - b).abs().max()) for a, b in zip(got, want)]})
        return got
    ssd.ssd_chunk_cuda = checked
    try:
        for p in prompts:
            M.prefill(params, cfg, {"inputs": torch.tensor([p], device="cuda")}, len(p) + 1,
                      Runtime("fused_int8"))
    finally:
        ssd.ssd_chunk_cuda = kernel
    out = {"calls": len(calls), "Q": sorted({c["Q"] for c in calls}),
           "tol_used_y_state_decay": [max(c["tol_used"][i] for c in calls) for i in range(3)],
           "max_abs_err_y_state_decay": [max(c["max_abs_err"][i] for c in calls)
                                         for i in range(3)]}
    print(f"   B6 against the plain version on the trace's prefills ({out['calls']} calls, "
          f"Q {out['Q']}): share of the tolerance used, y / state / decay "
          f"{[f'{u:.3g}' for u in out['tol_used_y_state_decay']]}, max |err| "
          f"{[f'{e:.3g}' for e in out['max_abs_err_y_state_decay']]}")
    if max(out["tol_used_y_state_decay"]) > 1:
        raise AssertionError(f"B6 leaves its tolerance on the trace's prefills: {out}")
    return out


def ssd_amplification(torch, cfg, params, steps: int = 6) -> dict:
    """How far the full-width model carries a difference far inside B6's
    tolerance to the logits: each trace prompt prefilled under
    ``fused_int8`` with B6, with the plain version in its place on the card
    (the ``ref_int8`` lane's SSD; its int8 GEMM equals B1 bit for bit), and
    with the plain version's y and state scaled by 1 + 2^-20 (about 1e-6,
    200x inside rtol 2e-4), then ``steps`` decode steps (W8A8, no B6) fed
    the plain variant's greedy tokens: at the prefill and after each step,
    the largest difference of the logits from the plain variant's, beside
    the logit scale."""
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    prompts, _ = serve_trace(cfg.vocab_size)
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    kernel, eps = ssd.ssd_chunk_cuda, 2.0 ** -20

    def nudged(*args):
        y, s_out, decay = ssd.ssd_chunk_plain(*args)
        return y * (1 + eps), s_out * (1 + eps), decay
    rows, tokens = {}, []
    for name, fn in (("plain", ssd.ssd_chunk_plain), ("kernel", kernel), ("nudged", nudged)):
        ssd.ssd_chunk_cuda = fn
        try:
            rows[name] = []
            for i, p in enumerate(prompts):
                lg, st = M.prefill(params, cfg, {"inputs": torch.tensor([p], device="cuda")},
                                   len(p) + steps + 1, rt)
                seq = [lg[0].float()]
                if name == "plain":
                    tokens.append([])
                for t in range(steps):
                    if name == "plain":
                        tokens[i].append(int(seq[-1].argmax()))
                    tok = torch.tensor([tokens[i][t]], dtype=torch.int32, device="cuda")
                    lg, st = M.decode_step(qparams, cfg, st, tok, rt)
                    seq.append(lg[0].float())
                rows[name].append(seq)
        finally:
            ssd.ssd_chunk_cuda = kernel
    del qparams
    out = {f"{name}_vs_plain_max_abs": [
        max(float((a[t] - b[t]).abs().max()) for a, b in zip(rows[name], rows["plain"]))
        for t in range(steps + 1)] for name in ("kernel", "nudged")}
    out["logit_scale"] = max(float(r[0].abs().max()) for r in rows["plain"])
    print(f"   logits against the plain SSD's (8 trace prompts, scale {out['logit_scale']:.3g}), "
          f"at the prefill and after each of {steps} decode steps: B6 "
          f"{[f'{d:.3g}' for d in out['kernel_vs_plain_max_abs']]}; plain scaled by 1 + 2^-20 "
          f"{[f'{d:.3g}' for d in out['nudged_vs_plain_max_abs']]}")
    return out


def divergence_margins(torch, cfg, params, outputs: dict) -> list:
    """For each request where the ``ref_int8`` lane parts from ``fused_int8``,
    both lanes' logits at the first differing token from single-request
    reruns at the served steps' shapes (:func:`decode_margin`, the request
    in each of ``SERVE_SLOTS`` slots of ``SERVE_ROWS`` rows): each lane's gap between the two
    candidates, the fused lane's gap between its best two, and how far the
    two lanes' logit rows lie apart there."""
    from repro_torch.serve.quantize import quantize_tree

    prompts, _ = serve_trace(cfg.vocab_size)
    qparams = quantize_tree(params)
    res = []
    for rid, (a, b) in enumerate(zip(outputs["fused_int8"], outputs["ref_int8"])):
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        lanes = {k: decode_margin(torch, cfg, params, qparams, prompts[rid], a[:d],
                                  (a[d], b[d]), k, SERVE_SLOTS, SERVE_ROWS)
                 for k in ("fused_int8", "ref_int8")}
        f, r = lanes["fused_int8"], lanes["ref_int8"]
        rec = {"rid": rid, "token": d, "tokens": [a[d], b[d]],
               "fused_gap": f["logits"][0] - f["logits"][1],
               "ref_gap": r["logits"][0] - r["logits"][1],
               "fused_top2_gap": f["top2_gap"], "logit_scale": f["logit_scale"],
               "lanes_max_abs_diff": float((f["row"] - r["row"]).abs().max()),
               "fused_reproduced": f["argmax"] == a[d], "ref_reproduced": r["argmax"] == b[d],
               "reproduced": f["argmax"] == a[d] and r["argmax"] == b[d]}
        res.append(rec)
        print(f"   req {rid} parts at token {d} ({a[d]} vs {b[d]}): gap fused "
              f"{rec['fused_gap']:.4g}, ref {rec['ref_gap']:.4g} (logit scale "
              f"{rec['logit_scale']:.3g}); lanes' rows apart by {rec['lanes_max_abs_diff']:.3g};"
              f" reruns pick the lanes' tokens: fused {rec['fused_reproduced']}, ref "
              f"{rec['ref_reproduced']}")
    del qparams
    return res


NEAR_TIE_SHARE = 0.1        # how far a near-tie's two rows may lie apart, of the logit scale


def near_tie_failures(margins: list, forced: bool = False) -> list:
    """The parting requests that the near-tie rule leaves unexplained.  The
    rule: the fused lane's row picks its token, and a witness row lies
    within ``NEAR_TIE_SHARE`` of the logit scale of it, with the fused
    row's gap between the two tokens within that distance.  The witness is
    the other lane's row at the parting token (:func:`divergence_margins`,
    :func:`whisper_margins`).  With ``forced`` (a MoE stack's records,
    :func:`moe_margins`) the witness is ``ref_int8`` run on the fused
    lane's own inputs, each lane's served row must pick its token at the
    same engine step, and the served rows are held to the rule only at the
    first parting step: a request that parts later may part through the
    other slots' rows (capacity)."""
    def near(gap, dist, scale):
        return abs(gap) <= dist <= NEAR_TIE_SHARE * scale
    first = min((m["step"] for m in margins), default=None) if forced else None
    return [m["rid"] for m in margins
            if not m["fused_reproduced"]
            or (forced and not (m["ref_reproduced"] and m["step"] == m["ref_step"]))
            or ((not forced or m["step"] == first)
                and not near(m["fused_gap"], m["lanes_max_abs_diff"], m["logit_scale"]))
            or (forced and not near(m["forced_fused_gap"], m["forced_max_abs_diff"],
                                    m["logit_scale"]))]


def serve_mamba2(torch, ctx, cfg) -> dict:
    """mamba2-2.7b at full width (random f32 weights, seed 0): ``Engine``
    with 4 prompts of 64 tokens and 16 greedy steps, one decode step's
    profile, then the ragged 8-request trace through
    ``ContinuousBatchingEngine`` under ``fused_int8`` (the path whose
    launch counts the ``kernels`` line reports for B6 and the norm) and
    under ``ref_int8``; exact launch counts on every run; then B6 held
    against the plain version on the trace's own prefills, and both lanes'
    logits where ``ref_int8`` parts from ``fused_int8``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantize_tree

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime("fused_int8")
    eng = Engine(cfg=cfg, params=params, rt=rt, max_len=128)
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    eng.generate({"inputs": prompts}, steps=1)                # warm-up
    steps = 16
    reset_launch_counts()
    toks, tm = eng.generate({"inputs": prompts}, steps=steps)
    counts = launch_counts()
    want = want_launches(cfg, steps, [prompts.shape[1]], None)
    if counts != want:
        raise AssertionError(f"Engine launch counts {counts} != {want}")
    if tuple(toks.shape) != (4, steps) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    out["engine"] = {"prefill_s": tm["prefill_s"], "tpot_s": tm["tpot_s"],
                     "decode_s": tm["decode_s"], "launches": counts,
                     "tokens_row0": toks[0].tolist()}
    print(f"   Engine: init {out['init_s']:.1f} s, prefill {tm['prefill_s'] * 1e3:.1f} ms, "
          f"TPOT {tm['tpot_s'] * 1e3:.2f} ms, launches {counts}")
    logits0, state = M.prefill(params, cfg, {"inputs": prompts}, 128, rt)
    if tuple(logits0.shape) != (4, cfg.vocab_size) or not bool(torch.isfinite(logits0).all()):
        raise AssertionError(f"prefill logits {tuple(logits0.shape)} not finite")
    tok = torch.argmax(logits0, -1).to(torch.int32)
    try:        # a measurement, not a check: a profiler fault is recorded
        out["decode_profile"] = profile_step(
            torch, lambda: M.decode_step(eng.qparams, cfg, clone_state(state), tok, rt))
    except Exception as e:  # noqa: BLE001
        out["decode_profile"] = {"error": f"{type(e).__name__}: {e}"}
        print(f"   profile failed: {out['decode_profile']['error']}")
    del eng, state
    torch.cuda.empty_cache()
    # the captured decode step (graphs) against eager, every SSM state bit-equal
    pool = ragged_pool(torch, cfg, params, 256, 256)
    out["graph_decode"], steps, _ = replay_vs_eager(torch, cfg, quantize_tree(params),
                                                    pool, "decode", fresh=True)
    del pool, steps
    torch.cuda.empty_cache()

    outputs = {}
    for backend in ("fused_int8", "ref_int8"):
        cb, reqs, wall, counts = serve(torch, cfg, params, {}, None, backend)
        rec = dict(serve_record(reqs, wall, cfg), launches=counts, stats=dict(cb.stats))
        outputs[backend] = [list(r.output) for r in reqs]
        if backend == "fused_int8":
            ctx["ssd_chunk_launches"] = counts["ssd_chunk"]
            ctx["rms_norm_launches"] = counts["rms_norm"]
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            for r in rec["requests"]:
                print(f"   req {r['rid']}: prompt {r['prompt']:3d} -> {r['tokens']:2d} tokens, "
                      f"TTFT {r['ttft_s'] * 1e3:7.1f} ms, TPOT {r['tpot_s'] * 1e3:6.1f} ms")
        else:
            same = [a == b for a, b in zip(outputs["fused_int8"], outputs["ref_int8"])]
            rec["same_as_fused_int8"] = sum(same)
            rec["first_divergence"] = [
                next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                for a, b in zip(outputs["fused_int8"], outputs["ref_int8"])]
        print(f"   {backend}: served {rec['tokens_served']} tokens in {wall:.2f} s "
              f"({rec['tokens_per_s']:.1f} tokens/s), {cb.stats['decode_steps']} decode steps, "
              f"launches {counts}"
              + (f"; requests equal to fused_int8's: {rec['same_as_fused_int8']} of "
                 f"{len(reqs)} (first divergence {rec['first_divergence']})"
                 if backend == "ref_int8" else
                 f"; peak memory {rec['max_memory_allocated'] / 1e9:.2f} GB"))
        out[backend] = rec
        del cb, reqs
        torch.cuda.empty_cache()
    out["b6_on_trace_prefills"] = b6_on_trace_prefills(torch, cfg, params)
    out["ssd_amplification"] = ssd_amplification(torch, cfg, params)
    out["divergence_margins"] = divergence_margins(torch, cfg, params, outputs)
    del params
    return out


def phase_ssm(torch, ctx, build: dict | None) -> dict:
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssd_chunk as ssd

    ctx.pop("params", None)                   # llama3-8b's f32 weights
    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get("mamba2-2.7b")
    ptxas = (build or {}).get("ptxas", {})
    return {"ptxas": {k: ptxas.get(k) for k in ("ssd_chunk", "rms_norm")},
            "ssd_chunk": ssd_kernel_checks(torch, ssd),
            "rms_norm": rms_norm_checks(torch, rn),
            "ssd_forward": ssd_forward_check(torch, cfg),
            "reduced": reduced_ssm(torch, cfg),
            "full_width": serve_mamba2(torch, ctx, cfg)}


# ---------------------------------------------------------------------------
# phase families: the paper's OPT-30B (16 of its 48 layers), granite-3-8b
# and phi3-mini-3.8b (8 layers each), chameleon-34b, nemotron-4-340b and
# grok-1-314b (2 of its 64 layers), at full width
# ---------------------------------------------------------------------------
OPT_LAYERS = 16      # of OPT-30B's 48: 118 GB of f32 weights do not fit one card
OPT_ATTN = (4, 56, 1, 128)         # 4 slots, 56 heads of 128, MHA (rep 1)
PHI3_ATTN = (4, 32, 1, 96)         # 4 slots, 32 heads of 96, MHA
# granite-3-8b (of 40) and phi3-mini-3.8b (of 32): a layer adds nothing a
# first one does not exercise, and each layer costs the script time (the
# serve runs, the near-tie reruns, a fresh-process profile)
SHORT_LAYERS = 8
# chameleon-34b: 48 layers of 0.69 G parameters, 2.77 GB each in f32 (133 GB
# in all): 16 layers hold 44.3 GB of f32 weights, as OPT-30B's 16 do
CHAMELEON_LAYERS = 16
CHAMELEON_ATTN = (4, 8, 8, 128)    # 4 slots, 8 groups of 8 heads of 128
# nemotron-4-340b: a layer is 3.45 G parameters (13.8 GB in f32, 3.45 GB in
# int8), its untied embedding and head 18.9 GB each: 2 layers and both take
# 65.4 GB of f32 and 6.9 GB of int8 weights; 3 would not fit
NEMOTRON_LAYERS = 2
NEMOTRON_ATTN = (4, 8, 12, 192)    # 4 slots, 8 groups of 12 heads of 192
# grok-1-314b: a layer is 4.92 G parameters (19.7 GB in f32, 4.92 GB in
# int8: 8 SwiGLU experts of 6144 x 32768), its untied embedding and head
# 3.22 GB each: 2 layers hold about 55.6 GB with both copies; 3 would not fit
GROK_LAYERS = 2
GROK_ATTN = (4, 8, 6, 128)         # 4 slots, 8 groups of 6 heads of 128
# the 8 experts' row counts in a decode step at 4 slots (top-2 of 8: cap 2,
# 8 choices) and in a spec_k = 4 verify window (20 rows: cap 10, 40
# choices), each with experts of 0, 1 and C rows
GROUPED_COUNTS = {2: (2, 1, 0, 2, 1, 0, 1, 1), 10: (10, 3, 0, 1, 10, 5, 7, 4)}
FAMILY_B2 = (512, (1, 200, 377, 512))
# B3 (spec_k 4) and B4 (spec_tree 6) windows in their lanes' pools of
# 512 + T - 1 rows, the last cursor a slot at 511
FAMILY_VERIFY = (("verify_attn", 5, 512, (3, 150, 377, 511)),
                 ("verify_tree_attn", 7, 512, (3, 150, 377, 511)))
LN_ROWS = 140        # 1, 4, 20 and 28 rows a call divide it


def layer_shapes(cfg) -> dict:
    """{(K, N): count} of one attention layer's W8A8 linears: wq, wk, wv,
    wo, w_up, w_down and, under SwiGLU, w_gate (llama3-8b's are
    ``LINEAR_SHAPES``); a MoE layer's attention linears only (its experts:
    :func:`grouped_b1`)."""
    d, hd = cfg.d_model, cfg.head_dim
    kns = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d)]
    if not cfg.n_experts:
        kns += [(d, cfg.d_ff), (cfg.d_ff, d)] + ([(d, cfg.d_ff)] if cfg.mlp_type == "swiglu"
                                                 else [])
    shapes: dict = {}
    for kn in kns:
        shapes[kn] = shapes.get(kn, 0) + 1
    return shapes


def layer_norm_checks(torch, lnk) -> dict:
    """The LayerNorm kernel: within rtol 1e-6 of the plain version (atol
    1e-6 of the output's scale: an output near zero is the difference of
    two rounded terms) and row-invariant bit for bit (each row the same
    bits at 1, 4, 20 and 28 rows a call as at 140) at OPT-30B's d 7168 and
    opt-125m's 768; times at the decode steps' shapes [4, 7168] (OPT-30B)
    and [4, 384] (whisper-tiny) and at the training shapes [1024, 768]
    (opt-125m) and [1024, 4096] (with and without the saved statistics),
    each beside the plain version's and ``torch.nn.functional.layer_norm``'s
    (a yardstick only); then :func:`layer_norm_quant_checks`."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(10)

    def inputs(M, d):
        return (torch.randn((M, d), generator=g, device="cuda") * 3 + 0.5,
                torch.randn((d,), generator=g, device="cuda"),
                torch.randn((d,), generator=g, device="cuda"))
    out = {"row_invariant": {}, "shapes": {}}
    for d in (768, 7168):
        x, scale, bias = inputs(LN_ROWS, d)
        full = lnk.layer_norm_cuda(x, scale, bias)
        want = lnk.layer_norm_plain(x, scale, bias)
        torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        rows = {}
        for m in (1, 4, 20, 28):
            parts = torch.cat([lnk.layer_norm_cuda(x[i:i + m], scale, bias)
                               for i in range(0, LN_ROWS, m)])
            rows[m] = torch.equal(parts, full)
        out["row_invariant"][d] = rows
        if not all(rows.values()):
            raise AssertionError(f"layer_norm d={d}: rows differ from M={LN_ROWS}: {rows}")
    print(f"   layer_norm: within rtol 1e-6 of the plain version and row-invariant at M 1, 4, "
          f"20, 28, {LN_ROWS} for d 768, 7168")
    for M, d in ((4, 7168), (4, 384), (1024, 768), (1024, 4096)):
        x, scale, bias = inputs(M, d)
        err = float((lnk.layer_norm_cuda(x, scale, bias)
                     - lnk.layer_norm_plain(x, scale, bias)).abs().max())
        # warm inputs: on the decode path the previous op has just written x
        tk = timed(torch, lambda i: lnk.layer_norm_cuda(x, scale, bias), 200)
        ts = graph_ms(torch, lambda i: lnk.layer_norm_cuda(x, scale, bias, with_stats=True), 200)
        tp = timed(torch, lambda i: lnk.layer_norm_plain(x, scale, bias), 200)
        lib = graph_ms(torch, lambda i: F.layer_norm(x, (d,), scale, bias, 1e-5), 200)
        b = bound_ms(4 * (2 * M * d + 2 * d), [(8 * M * d, FP32_FLOPS_PER_S)])
        out["shapes"][f"{M}x{d}"] = {
            "M": M, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
            "with_stats_ms": ts, "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
            "library_ms": lib, "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err}
        print(f"   layer_norm [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
              f"{tk['eager_ms'] * 1e3:.2f} eager, with stats {ts * 1e3:.2f} (bound "
              f"{b[0] * 1e3:.3f}, plain {tp['device_ms'] * 1e3:.2f} / "
              f"{tp['eager_ms'] * 1e3:.2f} eager, F.layer_norm {lib * 1e3:.2f}); "
              f"max |err| {err:.3g}")
    out.update(out["shapes"]["4x7168"])
    out["quant"] = layer_norm_quant_checks(torch, lnk)
    return out


# every width the fused LayerNorm is gated at: whisper-tiny's 384,
# opt-125m's 768, opt-6.7b's 4096, OPT-30B's 7168, and widths that take
# each of the forward's other register budgets or re-read the row
QUANT_LN_WIDTHS = (96, 384, 768, 1000, 4096, 7168, 18432, 24576)
LN_REPLAYS = 8


def layer_norm_quant_checks(torch, lnk) -> dict:
    """The LayerNorm fused with the activation quantizer
    (``layer_norm_quant``) at every width of :data:`QUANT_LN_WIDTHS` (a
    zero row and a constant row among random ones): its output bit-equal to
    the LayerNorm kernel's and its codes and scales to
    ``quantize_activation`` of that output, at 1, 4, 20 and 28 rows a call,
    each call's rows equal to the 140-row call's (row-invariant), one
    kernel node when captured and the same bits on
    :data:`LN_REPLAYS` replays (all gated); timed at [4, 7168] and [4, 384]
    beside the LayerNorm kernel alone, the unfused pair (the kernel, then
    ``quantize_activation``) captured as a CUDA graph, the yardstick, and
    the plain version (no one library call computes the three outputs)."""
    from repro_torch.core import quant
    g = torch.Generator(device="cuda").manual_seed(28)
    out = {"widths": {}, "shapes": {}}
    for d in QUANT_LN_WIDTHS:
        x = torch.randn((LN_ROWS, d), generator=g, device="cuda") * 3 + 0.5
        x[7] = 0                                   # the scale's floor (h is the bias)
        x[9] = 1.7                                 # a constant row
        scale = torch.randn((d,), generator=g, device="cuda")
        bias = torch.randn((d,), generator=g, device="cuda")
        whole = lnk.layer_norm_quant_cuda(x, scale, bias)
        h = lnk.layer_norm_cuda(x, scale, bias)
        same = [torch.equal(a, b) for a, b in zip(whole, (h, *quant.quantize_activation(h)))]
        rows = {m: all(torch.equal(torch.cat([lnk.layer_norm_quant_cuda(x[i:i + m], scale,
                                                                         bias)[j]
                                              for i in range(0, LN_ROWS, m)]), whole[j])
                       for j in range(3)) for m in (1, 4, 20, 28)}
        x4 = x[:4].contiguous()
        replays, nodes = replay_bits(torch, lambda i: lnk.layer_norm_quant_cuda(x4, scale, bias),
                                     tuple(t[:4] for t in whole), LN_REPLAYS)
        out["widths"][d] = {"equal_to_pair": same, "row_invariant": rows,
                            "replays_equal": replays, "graph_nodes": nodes}
        if not (all(same) and all(rows.values()) and replays and nodes == [0]):
            raise AssertionError(f"layer_norm_quant d={d}: equal to the kernel and the "
                                 f"quantizer {same}, rows across calls {rows}, replays "
                                 f"{replays}, device operations {nodes}")
    print(f"   layer_norm_quant: h, codes and scales equal to layer_norm_cuda then "
          f"quantize_activation at d {QUANT_LN_WIDTHS}, row-invariant at 1, 4, 20 and 28 "
          f"rows a call against {LN_ROWS}, one kernel node a call, {LN_REPLAYS} replays equal")
    for d in (7168, 384):
        M = 4
        x = torch.randn((M, d), generator=g, device="cuda") * 3 + 0.5
        scale = torch.randn((d,), generator=g, device="cuda")
        bias = torch.randn((d,), generator=g, device="cuda")
        err = float((lnk.layer_norm_quant_cuda(x, scale, bias)[0]
                     - lnk.layer_norm_plain(x, scale, bias)).abs().max())
        tk = timed(torch, lambda i: lnk.layer_norm_quant_cuda(x, scale, bias), 200)
        tn = graph_ms(torch, lambda i: lnk.layer_norm_cuda(x, scale, bias), 200)
        tu = graph_ms(torch, lambda i: quant.quantize_activation(
            lnk.layer_norm_cuda(x, scale, bias)), 200)
        tp = graph_ms(torch, lambda i: lnk.layer_norm_quant_plain(x, scale, bias), 200)
        b = bound_ms(4 * (2 * M * d + 2 * d + M) + M * d, [(12 * M * d, FP32_FLOPS_PER_S)])
        out["shapes"][d] = {"M": M, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                            "layer_norm_ms": tn, "unfused_ms": tu, "plain_ms": tp,
                            "library_ms": None, "bound_ms": b[0], "bound_by": b[1],
                            "max_abs_err": err}
        print(f"   layer_norm_quant [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
              f"{tk['eager_ms'] * 1e3:.2f} eager (bound {b[0] * 1e3:.3f}; layer_norm alone "
              f"{tn * 1e3:.2f}, layer_norm + quantize_activation {tu * 1e3:.2f}, plain "
              f"{tp * 1e3:.2f}); max |err| of h {err:.3g}")
    return dict(out["shapes"][7168], shapes=out["shapes"], widths=out["widths"])


def family_kernels(torch, mods, cfg, attn: tuple) -> dict:
    """The kernels at one family's full-width shapes: B1 and B5 over one
    layer's linears at M 4 (bit-equal to their plain versions, beside
    ``torch._int_mm``), and B2 (S 512), B3 (T 5) and B4 (T 7) at its
    (B, G, rep, D) against their plain versions with B3's rows equal to B2
    and B4 on a chain equal to B3 (all gated); times and bounds."""
    from repro_torch.serve import drafter

    mm, pim, da, va, vt, quant = (mods[k] for k in ("mm", "pim", "da", "va", "vt", "quant"))
    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = layer_shapes(cfg)
    print(f"   {cfg.name}: one layer's linears {shapes}; attention (B, G, rep, D) {attn}")
    out = {"b1": b1_per_layer(torch, mm, g, 4, shapes),
           "b5": b5_per_layer(torch, mm, pim, quant, g, 4, shapes),
           "b2": b2_case(torch, da, quant, *FAMILY_B2, attn)}
    for name, T, max_len, pos in FAMILY_VERIFY:
        out[name] = verify_case(torch, da, va, vt, quant, drafter, name, T, max_len, pos, attn)
    return out


def expert_stacks(cfg) -> list:
    """(K, N) of a MoE layer's expert stacks: w_up (and w_gate under
    SwiGLU) d -> ff, w_down ff -> d."""
    d, ff = cfg.d_model, cfg.moe_d_ff
    return [(d, ff)] * (2 if cfg.mlp_type == "swiglu" else 1) + [(ff, d)]


def grouped_bound(C: int, counts: tuple, K: int, N: int, live: int) -> tuple:
    """The grouped entry's bound with the weights of ``live`` experts read:
    those bytes, x, the scales read and the output written, over the memory
    rate; the int8 operations of the rows held, over the int8 rate."""
    E = len(counts)
    n_bytes = live * K * N + E * C * K + 4 * E * C + 4 * live * N + 4 * E * C * N + 4 * E
    return bound_ms(n_bytes, [(2 * sum(counts) * K * N, INT8_OPS_PER_S)])


def grouped_b1(torch, mm, cfg, counts_by_c: dict | None = None) -> dict:
    """The grouped B1 at a MoE layer's expert stacks (``expert_stacks``,
    ``cfg.n_experts`` experts) for C rows an expert at the row counts of
    ``GROUPED_COUNTS`` (experts with 0, 1 and C rows): bit-equal to its
    plain version and to B1 (``int8_matmul_cuda``) on each expert's slice,
    the rows past a count zero, one kernel a call and the same bits on two
    replays of a captured call (gated); its device time a layer (every
    stack), the plain version's, the library's (``torch._int_mm`` on each
    expert that holds a row, x zero-padded to 32 rows, summed: the faster
    weight layout), two bounds: the weight bytes it reads (the experts
    that hold a row) and every expert's, and the kernel's own plan (its
    grid and split from its C interface, ``launch_plan``).  ``counts_by_c``
    (``{C: row counts}``) replaces ``GROUPED_COUNTS``."""
    from repro_torch.kernels import int8_matmul_grouped as gmm

    g = torch.Generator(device="cuda").manual_seed(13)
    E = cfg.n_experts
    out = {}
    for C, counts in (counts_by_c or GROUPED_COUNTS).items():
        cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
        live = [e for e, c in enumerate(counts) if c]
        rec = {"C": C, "counts": list(counts) if E <= 16 else
               {"experts_with_C_rows": sum(c == C for c in counts),
                "experts_with_rows": len(live), "rows": sum(counts)}, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "bound_all_experts_ms": 0.0, "max_abs_err": 0.0,
               "stacks": []}
        by = {"bytes": 0.0, "operations": 0.0}
        for K, N in expert_stacks(cfg):
            w_q = torch.randint(-127, 128, (E, K, N), generator=g, device="cuda",
                                dtype=torch.int8)
            w_s = torch.rand((E, N), generator=g, device="cuda") + 0.01
            x_q = torch.randint(-127, 128, (E, C, K), generator=g, device="cuda",
                                dtype=torch.int8)
            x_s = torch.rand((E, C, 1), generator=g, device="cuda") + 0.01
            args = (x_q, x_s, w_q, w_s, cnt)
            got = gmm.int8_matmul_grouped_cuda(*args)
            plain = gmm.int8_matmul_grouped_plain(*args)
            per = all(torch.equal(got[e, :c], mm.int8_matmul_cuda(
                x_q[e, :c].contiguous(), x_s[e, :c].contiguous(), w_q[e], w_s[e],
                with_acc=False)[0]) for e, c in enumerate(counts) if c)
            zero = all(not got[e, c:].any() for e, c in enumerate(counts))
            if not (torch.equal(got, plain) and per and zero):
                raise AssertionError(f"grouped B1 at C={C} K={K} N={N}: plain "
                                     f"{torch.equal(got, plain)}, per-expert B1 {per}, "
                                     f"zero rows {zero}")
            same, nodes = replay_bits(torch, lambda i: (gmm.int8_matmul_grouped_cuda(*args),),
                                      (got,))
            if not same or nodes != [0]:
                raise AssertionError(f"grouped B1 at C={C} K={K} N={N}: replays equal {same}, "
                                     f"device operations {nodes} (not one kernel)")
            rec["max_abs_err"] = max(rec["max_abs_err"], float((got - plain).abs().max()))
            t = graph_ms(torch, lambda i: gmm.int8_matmul_grouped_cuda(*args), 20)
            t_plain = graph_ms(torch, lambda i: gmm.int8_matmul_grouped_plain(*args), 2)
            xs = [torch.cat([x_q[e], x_q.new_zeros((32 - C, K))]) if C <= 16 else x_q[e]
                  for e in live]
            layouts = {}
            for layout in ("row-major", "column-major"):
                ws = [w_q[e] if layout == "row-major" else w_q[e].t().contiguous().t()
                      for e in live]

                def lib(i, ws=ws):
                    for x, w in zip(xs, ws):
                        torch._int_mm(x, w)
                try:
                    layouts[layout] = graph_ms(torch, lib, 10)
                except RuntimeError as e:
                    layouts[layout] = None
                    layouts[layout + " refused"] = str(e).splitlines()[0][:120]
                del ws
            ok = [v for k, v in layouts.items() if k in ("row-major", "column-major")
                  and v is not None]
            t_lib = min(ok) if ok else None
            b = grouped_bound(C, counts, K, N, len(live))
            b_all = grouped_bound(C, counts, K, N, E)
            by[b[1]] += b[0]
            rec["ms"] += t
            rec["plain_ms"] += t_plain
            rec["library_ms"] = (None if t_lib is None or rec["library_ms"] is None
                                 else rec["library_ms"] + t_lib)
            rec["bound_ms"] += b[0]
            rec["bound_all_experts_ms"] += b_all[0]
            rec["stacks"].append({"K": K, "N": N, "ms": t, "plain_ms": t_plain,
                                  "library_ms": t_lib, "library_layouts_ms": layouts,
                                  "bound_ms": b[0], "bound_all_experts_ms": b_all[0],
                                  "plan": gmm.launch_plan(counts, C, K, N, 132)._asdict()})
            lib_us = "n/a" if t_lib is None else f"{t_lib * 1e3:.1f}"
            plan = rec["stacks"][-1]["plan"]
            print(f"   grouped B1 E={E} C={C} K={K:5d} N={N:5d} counts {rec['counts']}: "
                  f"{t * 1e3:.1f} us (bound {b[0] * 1e3:.1f} for the {len(live)} experts "
                  f"with a row, {b_all[0] * 1e3:.1f} for all {E}; plain {t_plain * 1e3:.1f}), "
                  f"per-expert torch._int_mm {lib_us} us {layouts}; bit-equal to the plain "
                  f"version and to B1 on each expert; {plan['ctas']} CTAs, "
                  f"{plan['waves']} full waves, {plan['stages_per_cta']} of "
                  f"{plan['stages']} stages a CTA at most, {plan['cut_tiles']} cut tiles")
            del args, got, plain, w_q, x_q, xs
            torch.cuda.empty_cache()
        rec["bound_by"] = max(by, key=by.get)
        lib = rec["library_ms"]
        print(f"   grouped B1 C={C}, a layer's {len(expert_stacks(cfg))} stacks: "
              f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; all "
              f"experts {rec['bound_all_experts_ms']:.4f}), plain {rec['plain_ms']:.3f} ms, "
              f"library {'n/a' if lib is None else f'{lib:.4f}'} ms")
        out[C] = rec
    return out


def moe_margins(torch, cfg, params, outputs: dict, quantized: bool = False) -> list:
    """Where ``ref_int8`` parts from ``fused_int8`` on a MoE stack: both
    lanes served again, each parting request's logits row recorded at its
    first differing token from the served step itself (a single-request
    rerun would route other rows with it, and a MoE's row depends on the
    rows it is routed with), with the engine step that emitted it; and a
    second witness on the fused lane's own inputs: its decode state and
    every slot's token at that step, through one ``ref_int8`` decode step
    (teacher-forced, launches not counted).  Each record: the two
    candidates' gap in each lane, the served rows' distance, the logit
    scale, whether each served row picks its lane's token, the step; and
    the teacher-forced row's token, its distance from the fused row and
    the fused row's gap between the two tokens.  A request whose first
    token parts (its prefill's logits: under an int8 tree, or with B6 in
    an SSM layer, prefill differs across the lanes) is recorded from each
    lane's prefill of its prompt alone, as the engine admits it
    (engine step 0; both lanes then have the same inputs, so the
    ``ref_int8`` prefill is also its witness)."""
    from repro_torch.kernels import launch_counts, set_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.scheduler import RequestState

    first = {rid: next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
             for rid, (a, b) in enumerate(zip(outputs["fused_int8"], outputs["ref_int8"]))
             if a != b}
    rows, steps, forced = {}, {}, {}
    prompts, _ = serve_trace(cfg.vocab_size)
    for rid in [r for r, d in first.items() if d == 0]:
        n = len(prompts[rid])
        width = n if T.has_ssm(cfg) else min(SERVE_ROWS, -(-n // 16) * 16)
        toks = torch.zeros((1, width), dtype=torch.int64, device="cuda")
        toks[0, :n] = torch.tensor(prompts[rid], device="cuda")
        batch = {"inputs": toks}
        if not T.has_ssm(cfg):
            batch["lengths"] = torch.tensor([n], dtype=torch.int32, device="cuda")
        counts = launch_counts()
        for backend in ("fused_int8", "ref_int8"):
            lg, _ = M.prefill(params, cfg, batch, SERVE_ROWS, Runtime(backend))
            rows.setdefault(backend, {})[rid] = lg[0].float().cpu()
            steps.setdefault(backend, {})[rid] = 0           # no engine step yet
        forced[rid] = rows["ref_int8"][rid]
        set_launch_counts(counts)
    for backend in ("fused_int8", "ref_int8"):
        got, at = rows.setdefault(backend, {}), steps.setdefault(backend, {})

        def setup(cb, got=got, at=at, witness=backend == "fused_int8"):
            served = cb._steps
            real = served.decode

            def decode():
                want = [(slot, req.rid) for slot, req in cb.scheduler.active.items()
                        if first.get(req.rid, 0) > 0 and req.state is RequestState.DECODING
                        and len(req.output) == first[req.rid]]
                inputs = ((clone_state(served.state), served.tok.clone())
                          if witness and want else None)
                logits, argmax = real()
                for slot, rid in want:
                    got[rid] = logits[slot].float().cpu()
                    at[rid] = cb.stats["steps"]
                if inputs is not None:
                    counts = launch_counts()
                    lg, _ = T.decode_step(served.params, cfg, *inputs, Runtime("ref_int8"))
                    for slot, rid in want:
                        forced[rid] = lg[slot].float().cpu()
                    set_launch_counts(counts)
                    del lg, inputs
                return logits, argmax
            served.decode = decode
        cb, reqs, _, _ = serve(torch, cfg, params, {},
                               "decode_attn" if backend == "fused_int8" else None, backend,
                               setup=setup, quantized=quantized)
        if [list(r.output) for r in reqs] != outputs[backend]:
            raise AssertionError(f"{cfg.name} {backend}: the recording run parts from the "
                                 "first run")
        del cb._steps.decode            # the hook's cycle would hold the engine's weights
        del cb, reqs
        torch.cuda.empty_cache()
    res = []
    for rid, d in sorted(first.items()):
        a, b = outputs["fused_int8"][rid][d], outputs["ref_int8"][rid][d]
        f, r, t = rows["fused_int8"][rid], rows["ref_int8"][rid], forced[rid]
        tf = int(t.argmax())
        rec = {"rid": rid, "token": d, "tokens": [a, b], "step": steps["fused_int8"][rid],
               "ref_step": steps["ref_int8"][rid],
               "fused_gap": float(f[a] - f[b]), "ref_gap": float(r[a] - r[b]),
               "fused_top2_gap": float(torch.topk(f, 2).values.diff().abs()[0]),
               "logit_scale": float(f.abs().max()),
               "lanes_max_abs_diff": float((f - r).abs().max()),
               "fused_reproduced": int(f.argmax()) == a, "ref_reproduced": int(r.argmax()) == b,
               "forced_token": tf, "forced_max_abs_diff": float((f - t).abs().max()),
               "forced_fused_gap": float(f[a] - f[tf])}
        res.append(rec)
        print(f"   req {rid} parts at token {d} ({a} vs {b}), step {rec['step']}: gap fused "
              f"{rec['fused_gap']:.4g}, ref {rec['ref_gap']:.4g} (logit scale "
              f"{rec['logit_scale']:.3g}); lanes' rows apart by {rec['lanes_max_abs_diff']:.3g}; "
              f"served rows pick the lanes' tokens: fused {rec['fused_reproduced']}, ref "
              f"{rec['ref_reproduced']}; ref_int8 on the fused lane's inputs picks {tf} "
              f"(fused gap to it {rec['forced_fused_gap']:.4g}), rows apart by "
              f"{rec['forced_max_abs_diff']:.3g}")
    return res

def same_streams(outs: dict, want: list) -> dict:
    """Per lane, the requests whose tokens equal ``want``'s, and where each
    other one first parts from it."""
    return {k: {"same": sum(a == b for a, b in zip(v, want)),
                "first_divergence": [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                                          None) for a, b in zip(v, want)]}
            for k, v in outs.items()}


ALL_LANES = ("spec_k", "spec_tree", "multi_step_4", "chunk_32_fifo")


def serve_family(torch, ctx, cfg, lanes: tuple = (), exact: bool = False,
                 embed_prompt: bool = False) -> dict:
    """One family at full width (random f32 weights, seed 0) on the card:
    the phase-4 trace under ``fused_int8``, ``pim_bitserial`` and
    ``ref_int8``, every run with exact launch counts.  ``pim_bitserial``
    must equal ``ref_int8`` token for token (B5's sums are the plain int32
    sums and both run the plain attention).  With ``exact`` (OPT-30B)
    ``fused_int8`` must equal them too.  Without, a request where
    ``fused_int8`` (B2) parts from ``ref_int8`` (the plain attention) is
    held to :func:`divergence_margins`: a single-request rerun of the fused
    lane picks the fused lane's token (every stage of that lane but the
    ``lm_head`` is row- and pool-invariant), the two candidates' gap there
    is smaller than how far the two lanes' logit rows lie apart, and those
    lie within 10% of the logit scale.  B2 sums its softmax in another
    order than the plain attention; a last-bit difference flips an int8
    activation code now and then, and the flips compound over a deep stack
    of random weights (phase ``engine`` holds llama's one step to 10%).
    Both reruns run at the served steps' shapes (the plain attention's P.V
    sums in an order set by the pool's size); whether the ``ref_int8`` rerun
    picks its lane's token is recorded, not gated.  With ``lanes`` (of ``ALL_LANES``) also ``Engine`` (4
    prompts of 64 tokens, or of 64 embeddings where ``embed_prompt``; 16
    steps, exact launch counts), the verify window's K/V against
    sequential decode's (gated equal in every layer), and the lanes named:
    ``spec_k = 4``, ``spec_tree = 6, spec_branch = 2``, ``multi_step = 4``
    and ``chunk = 32``, each gated 8 of 8 equal to the plain
    ``fused_int8`` trace; then the captured decode step against eager over
    8 steps (gated bit-equal, exact launch counts, a profiled replay's
    kernels equal to its credits), whose profile gives the replayed step's
    wall, device-busy time and idle share at 4 slots.  The peak of device
    memory over the whole family (initialisation included) is recorded
    beside the card's total.

    A MoE stack (grok-1-314b) routes each call's rows together with a
    capacity, so a slot's tokens depend on the other slots': each served
    run records the calls, the dropped choices (gated above 0 under
    ``fused_int8``) and the experts that got a row (``moe.count_routing``),
    the captured steps' calls apart from the prefill calls; where
    ``fused_int8`` parts from ``ref_int8`` the lanes' rows are held to
    near-ties by :func:`moe_margins` and :func:`near_tie_failures` with
    ``forced``; the verify window is not held to sequential decode (it routes T times the rows at another capacity, so
    the K/V from the second layer on part by design), and ``multi_step =
    4`` is gated 8 of 8 on a lockstep trace (the phase-4 prompts, every
    budget 16: a fused block never runs with an idle slot) against the
    plain lane on it; on the phase-4 trace a fused block feeds an idle
    slot its own argmax where the plain step feeds it its last token, which
    can move a live slot's choices (the reference's lanes part the same
    way: ``tests/test_torch_moe.py``), so that run is recorded, not gated."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantize_tree

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    secs, t_part = {}, time.perf_counter()

    def part(name):                     # seconds of each part, for the script's budget
        nonlocal t_part
        secs[name], t_part = time.perf_counter() - t_part, time.perf_counter()

    out = {"n_layers": cfg.n_layers, "init_s": time.perf_counter() - t0, "serve_s": secs,
           "f32_weight_bytes": sum(t.numel() * 4 for lp in params["layers"]
                                   for k in ("attn", "mlp", "moe") if k in lp
                                   for t in lp[k].values() if isinstance(t, torch.Tensor)),
           "f32_embed_head_bytes": sum(params[k]["w"].numel() * 4 for k in ("embed", "lm_head")
                                       if k in params)}
    # a MoE stack's routing on each served run (calls, dropped choices,
    # experts that got a row), the captured steps' calls (decode, or a
    # verify window) apart from the eager prefill calls: a graph adds to
    # the counter set when the engine captured it, prefill to the one set
    # at its call
    routing = cfg.n_experts > 0
    count_steps, zero_routing, routing_record = (
        routing_counters(torch) if routing else (lambda: None, lambda cb: None, None))
    outs = {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        count_steps()
        cb, reqs, wall, counts = serve(torch, cfg, params, {},
                                       "decode_attn" if backend == "fused_int8" else None,
                                       backend, setup=zero_routing)
        outs[backend] = [list(r.output) for r in reqs]
        out[backend] = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats),
                            launches=counts, max_memory_allocated=torch.cuda.max_memory_allocated())
        if routing:
            out[backend]["routing"] = routing_record()
        print(f"   {cfg.name} {backend}: served {out[backend]['tokens_served']} tokens in "
              f"{wall:.2f} s ({out[backend]['tokens_per_s']:.1f} tokens/s), "
              f"{cb.stats['decode_steps']} decode steps, launches {counts}, peak "
              f"{out[backend]['max_memory_allocated'] / 1e9:.1f} GB"
              + (f", routing {out[backend]['routing']}" if routing else ""))
        del cb, reqs
        torch.cuda.empty_cache()
    if routing and sum(v["dropped_choices"]
                                   for v in out["fused_int8"]["routing"].values()) < 1:
        raise AssertionError(f"{cfg.name}: no choice was dropped on the trace, so capacity "
                             "went untested")
    part("backends")
    plain = outs["fused_int8"]
    out["backends_vs_fused_int8"] = same_streams(outs, plain)
    out["pim_eq_ref_int8_requests"] = sum(
        a == b for a, b in zip(outs["pim_bitserial"], outs["ref_int8"]))
    print(f"   {cfg.name}: requests equal to fused_int8's "
          f"{ {k: v['same'] for k, v in out['backends_vs_fused_int8'].items()} } of "
          f"{len(plain)}; pim_bitserial equal to ref_int8 in "
          f"{out['pim_eq_ref_int8_requests']}")
    if out["pim_eq_ref_int8_requests"] != len(plain):
        raise AssertionError(f"{cfg.name}: pim_bitserial and ref_int8 part")
    if out["backends_vs_fused_int8"]["ref_int8"]["same"] != len(plain):
        if cfg.n_experts:
            moe.count_routing(None)
            margins = moe_margins(torch, cfg, params, outs)
        else:
            margins = divergence_margins(torch, cfg, params, outs)
        out["divergence_margins"] = margins
        far = near_tie_failures(margins, forced=bool(cfg.n_experts))
        if exact or far:
            raise AssertionError(f"{cfg.name}: fused_int8 parts from ref_int8 "
                                 f"{out['backends_vs_fused_int8']['ref_int8']}; "
                                 f"unexplained: {far}")
    part("margins")
    if lanes:
        eng = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=128)
        g = torch.Generator(device="cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
        # the stubbed front end's embeddings, at the token table's scale
        inputs = (torch.randn((4, 64, cfg.d_model), generator=g, device="cuda") * 0.02
                  if embed_prompt else prompts)
        eng.generate({"inputs": inputs}, steps=1)                 # warm-up
        reset_launch_counts()
        toks, tm = eng.generate({"inputs": inputs}, steps=16)
        counts = launch_counts()
        want = want_launches(cfg, 16, [64], "decode_attn",
                             prefills=T.prefill_pieces(cfg, 64))
        if counts != want or tuple(toks.shape) != (4, 16):
            raise AssertionError(f"{cfg.name} Engine: launch counts {counts} != {want}")
        if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"{cfg.name} Engine: token out of range")
        out["engine"] = {"prefill_s": tm["prefill_s"], "tpot_s": tm["tpot_s"],
                         "launches": counts, "prompt": list(inputs.shape)}
        print(f"   {cfg.name} Engine from a {list(inputs.shape)} "
              f"{'embedding' if embed_prompt else 'token'} prompt: prefill "
              f"{tm['prefill_s'] * 1e3:.1f} ms, TPOT {tm['tpot_s'] * 1e3:.2f} ms, "
              f"launches {counts}")
        qparams = eng.qparams
        del eng
        if not cfg.n_experts:
            _, state = M.prefill(params, cfg, {"inputs": prompts}, 128, Runtime("fused_int8"))
            win = torch.randint(0, cfg.vocab_size, (4, 5), generator=g, device="cuda",
                                dtype=torch.int32)
            out["full_width_parity"] = full_width_parity(torch, params, cfg, qparams, state,
                                                         win)
            del state
        del qparams
        torch.cuda.empty_cache()
        lane_runs = {"spec_k": ({"spec_k": 4}, "verify_attn"),
                     "spec_tree": ({"spec_tree": 6, "spec_branch": 2}, "verify_tree_attn"),
                     "multi_step_4": ({"multi_step": 4}, "decode_attn"),
                     "chunk_32_fifo": ({"chunk": 32}, "decode_attn")}
        lane_outs = {}
        for label in lanes:
            lane, attn = lane_runs[label]
            count_steps()
            cb, reqs, wall, counts = serve(torch, cfg, params, lane, attn, setup=zero_routing)
            lane_outs[label] = [list(r.output) for r in reqs]
            st = cb.stats
            rec = dict(serve_record(reqs, wall, cfg), stats=dict(st), launches=counts)
            if "spec" in label:
                rec["acceptance_rate"] = cb.acceptance_rate
                rec["tokens_per_verify_step"] = ((rec["tokens_served"] - len(reqs))
                                                 / st["verify_steps"])
            if routing:
                rec["routing"] = routing_record()
            out[label] = rec
            print(f"   {cfg.name} {label}: served {rec['tokens_served']} tokens in {wall:.2f} s, "
                  f"{st['decode_steps']} steps ({st['verify_steps']} verify, "
                  f"{st['multi_blocks']} fused blocks, {st['chunks']} chunks), launches {counts}")
            del cb, reqs
            torch.cuda.empty_cache()
        out["lanes_vs_plain"] = same_streams(lane_outs, plain)
        print(f"   {cfg.name}: requests equal to the plain trace "
              f"{ {k: v['same'] for k, v in out['lanes_vs_plain'].items()} } of {len(plain)}")
        gated = {k: v for k, v in out["lanes_vs_plain"].items()
                 if not (cfg.n_experts and k == "multi_step_4")}
        if cfg.n_experts and "multi_step_4" in lanes:
            prompts_l, budgets_l = serve_trace(cfg.vocab_size)
            lock = (prompts_l, [16] * len(budgets_l))
            lock_outs = {}
            for label, lane in (("plain", {}), ("multi_step_4", {"multi_step": 4})):
                count_steps()
                cb, reqs, wall, counts = serve(torch, cfg, params, lane, "decode_attn",
                                               trace=lock, setup=zero_routing)
                lock_outs[label] = [list(r.output) for r in reqs]
                out[f"lockstep_{label}"] = dict(serve_record(reqs, wall, cfg),
                                                stats=dict(cb.stats), launches=counts,
                                                routing=routing_record())
                del cb, reqs
                torch.cuda.empty_cache()
            if out["lockstep_multi_step_4"]["stats"]["multi_blocks"] < 1:
                raise AssertionError(f"{cfg.name}: the lockstep trace fused no block")
            gated["multi_step_4_lockstep"] = same_streams(
                {"multi_step_4": lock_outs["multi_step_4"]}, lock_outs["plain"])["multi_step_4"]
            out["lanes_vs_plain"]["multi_step_4_lockstep"] = gated["multi_step_4_lockstep"]
            print(f"   {cfg.name}: on the lockstep trace (every budget 16) multi_step = 4 "
                  f"equals the plain lane in {gated['multi_step_4_lockstep']['same']} of "
                  f"{len(plain)} ({out['lockstep_multi_step_4']['stats']['multi_blocks']} "
                  f"fused blocks); on the phase-4 trace in "
                  f"{out['lanes_vs_plain']['multi_step_4']['same']} (recorded)")
        if any(v["same"] != len(plain) for v in gated.values()):
            raise AssertionError(f"{cfg.name}: a lane parts from the plain trace: {gated}")
    part("lanes")
    moe.count_routing(None)              # the captured step's graph adds nothing
    # the captured decode step: the float weights go first, and the int8
    # ones and the pool before a fresh-process profile (the last resort of
    # replay_vs_eager), so that the child has the card's memory
    pool = ragged_pool(torch, cfg, params, 256, 256)
    hold = [quantize_tree(params), pool]
    del params, pool
    torch.cuda.empty_cache()
    out["graph_decode"], steps, _ = replay_vs_eager(torch, cfg, *hold, "decode",
                                                    release=hold.clear, fresh=True)
    prof = out["graph_decode"]["profile"]
    print(f"   {cfg.name}: replayed decode step at 4 slots: wall {prof['wall_us'] / 1e3:.2f} ms, "
          f"device busy {prof['device_busy_us'] / 1e3:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    del hold, steps
    torch.cuda.empty_cache()
    part("graph")
    total = torch.cuda.get_device_properties(0).total_memory
    out["memory"] = {"device_total_bytes": total,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                     "free_at_peak_bytes": total - torch.cuda.max_memory_reserved()}
    print(f"   {cfg.name}: peak device memory {out['memory']['peak_reserved_bytes'] / 1e9:.2f} "
          f"GB reserved ({out['memory']['peak_allocated_bytes'] / 1e9:.2f} allocated) of "
          f"{total / 1e9:.2f} GB: {out['memory']['free_at_peak_bytes'] / 1e9:.2f} GB free")
    return out


def qk_norm_rows(torch, rn, cfg) -> dict:
    """QK-norm's rows through the RMSNorm kernel (``[B*T*H, head_dim]``):
    the query rows of ``cfg.n_heads`` heads and the key rows of
    ``cfg.n_kv_heads``, each token's rows the same bits whether the call
    holds 1, 4, 20 or 28 tokens' rows (one slot, a decode step at 4 slots,
    the ``spec_k`` and ``spec_tree`` windows) or 140 (gated); the kernel
    within rtol 1e-6 of its plain version."""
    g = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for what, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads)):
        x = torch.randn((LN_ROWS, heads, cfg.head_dim), generator=g, device="cuda")
        scale = torch.randn((cfg.head_dim,), generator=g, device="cuda")
        full = rn.rms_norm_cuda(x, scale)
        torch.testing.assert_close(full, rn.rms_norm_plain(x, scale), rtol=1e-6, atol=0.0)
        rows = {m: torch.equal(torch.cat([rn.rms_norm_cuda(x[i:i + m], scale)
                                          for i in range(0, LN_ROWS, m)]), full)
                for m in (1, 4, 20, 28)}
        out[what] = {"heads": heads, "row_invariant": rows}
        if not all(rows.values()):
            raise AssertionError(f"QK-norm {what} rows differ across calls: {rows}")
    print(f"   QK-norm rows [tokens * heads, {cfg.head_dim}] through rms_norm: row-invariant "
          f"at 1, 4, 20, 28 and {LN_ROWS} tokens a call ({cfg.n_heads} query heads, "
          f"{cfg.n_kv_heads} key heads)")
    return out


# deepseek-v3-671b at full width with 4 of its 61 layers: its 3 dense layers
# (MLA, SwiGLU of 18432) and 1 MoE layer (256 SwiGLU experts of 2048, top-8,
# one shared expert), plus the MTP head's MoE layer.  A MoE layer's experts
# are 11.27 G parameters (45.1 GB in f32), so the f32 tree of these layers
# (about 107 GB) does not fit one card; the int8 tree it serves (about 32.6
# GB) does, drawn and quantized a part at a time (:func:`int8_params`)
DEEPSEEK_LAYERS = 4
DEEPSEEK_E = 256
# the grouped entry's row counts at E 256: a decode step at 4 slots (32
# choices, cap 1) and a spec_k = 4 window (160 choices, cap 2), each with
# experts of 0, 1 and C rows; which experts hold them is drawn from seed 17
DEEPSEEK_ROWS = {1: (28, 0), 2: (50, 60)}     # C: (experts with C rows, with 1 row)


def deepseek_counts() -> dict:
    import numpy as np
    rng = np.random.default_rng(17)
    out = {}
    for C, (full, one) in DEEPSEEK_ROWS.items():
        counts = np.zeros(DEEPSEEK_E, np.int64)
        pick = rng.permutation(DEEPSEEK_E)
        counts[pick[:full]] = C
        counts[pick[full:full + one]] = 1
        out[C] = tuple(int(c) for c in counts)
    return out


def int8_params(torch, cfg, seed: int = 0) -> dict:
    """A model's served int8 tree drawn a part at a time on the card (seed
    ``seed``): each layer's attention (or an SSM layer's Mamba2 block) and
    dense FFN drawn in f32 and
    quantized (``quantize_tree``) before the next part is drawn, a MoE
    layer's expert stacks one expert at a time (``quantize_weight`` over an
    expert's [in, out] weight, what ``_quantize_3d`` does for each expert,
    scale for each (expert, out)); norms, the router, the embedding, the
    ``lm_head`` and ``mtp_proj`` stay f32, as ``quantize_tree`` leaves
    them.  Scales as the port's initialisers draw (1 / sqrt(in), the
    embedding 0.02); the draws differ from ``init_params``'."""
    from repro_torch.core import quant
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.serve.quantize import quantize_tree

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = cfg.d_model

    def experts() -> dict:
        E, ff = cfg.n_experts, cfg.moe_d_ff
        p = {"router": torch.randn((d, E), generator=gen, device="cuda").mul_(d ** -0.5)}
        stacks = {"w_up": (d, ff), "w_gate": (d, ff), "w_down": (ff, d)}
        for name, (K, N) in stacks.items():
            p[name + "_q"] = torch.empty((E, K, N), dtype=torch.int8, device="cuda")
            p[name + "_s"] = torch.empty((E, N), dtype=torch.float32, device="cuda")
        for e in range(E):
            for name, (K, N) in stacks.items():
                w = torch.randn((K, N), generator=gen, device="cuda").mul_(K ** -0.5)
                q, sc = quant.quantize_weight(w, axis=0)
                p[name + "_q"][e].copy_(q)
                p[name + "_s"][e].copy_(sc)
                del w, q, sc
        if cfg.n_shared_experts:
            p["shared"] = quantize_tree(L.mlp_init(gen, d, ff * cfg.n_shared_experts,
                                                   cfg.mlp_type))
        return p

    def layer(i: int) -> dict:
        p = {"ln1": L.norm_init(d, device="cuda")}
        if cfg.layer_kind(i) == "ssm":
            p["ssm"] = quantize_tree(SSM.ssm_init(gen, cfg))
        else:
            p["attn"] = quantize_tree(A.attn_init(gen, cfg))
        p["ln2"] = L.norm_init(d, device="cuda")
        if cfg.is_moe_layer(i):
            p["moe"] = experts()
        else:
            p["mlp"] = quantize_tree(L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_type))
        return p

    params = {"embed": L.embed_init(gen, cfg.vocab_size, d),
              "ln_f": L.norm_init(d, device="cuda"),
              "lm_head": L.dense_init(gen, d, cfg.vocab_size),
              "layers": [layer(i) for i in range(cfg.n_layers)]}
    if cfg.mtp:
        params["mtp_proj"] = L.dense_init(gen, 2 * d, d)
        params["mtp_layer"] = layer(cfg.n_layers - 1)
    torch.cuda.synchronize()
    return params


def mla_shapes(cfg) -> dict:
    """{(K, N): count} of an MLA layer's W8A8 linears (wq_a, wq_b, wkv_a,
    wkv_b: prefill only, decode dequantizes it; wo) and of a dense layer's
    SwiGLU FFN."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    kns = [(d, cfg.q_lora_rank), (cfg.q_lora_rank, H * (dn + dr)), (d, r + dr),
           (r, H * (dn + dv)), (H * dv, d), (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    shapes: dict = {}
    for kn in kns:
        shapes[kn] = shapes.get(kn, 0) + 1
    return shapes


def rms_norm_widths(torch, rn, widths: tuple) -> dict:
    """The RMSNorm kernel at the given widths: within rtol 1e-6 of its plain
    version and row-invariant bit for bit (1, 4, 20 and 28 rows a call
    against 140), timed at [4, d] beside the plain version and
    ``F.rms_norm``, with its bound."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(18)
    out = {}
    for d in widths:
        x = torch.randn((LN_ROWS, d), generator=g, device="cuda")
        scale = torch.randn((d,), generator=g, device="cuda")
        full = rn.rms_norm_cuda(x, scale)
        torch.testing.assert_close(full, rn.rms_norm_plain(x, scale), rtol=1e-6, atol=0.0)
        rows = {m: torch.equal(torch.cat([rn.rms_norm_cuda(x[i:i + m], scale)
                                          for i in range(0, LN_ROWS, m)]), full)
                for m in (1, 4, 20, 28)}
        if not all(rows.values()):
            raise AssertionError(f"rms_norm d={d}: rows differ across calls {rows}")
        x4 = x[:4].contiguous()
        err = float((rn.rms_norm_cuda(x4, scale) - rn.rms_norm_plain(x4, scale)).abs().max())
        tk = timed(torch, lambda i: rn.rms_norm_cuda(x4, scale), 200)
        tp = graph_ms(torch, lambda i: rn.rms_norm_plain(x4, scale), 200)
        lib = (graph_ms(torch, lambda i: F.rms_norm(x4, (d,), scale, 1e-5), 200)
               if hasattr(F, "rms_norm") else None)
        b = bound_ms(4 * (2 * 4 * d + d), [(4 * 4 * d, FP32_FLOPS_PER_S)])
        out[d] = {"M": 4, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                  "plain_ms": tp, "library_ms": lib, "bound_ms": b[0], "bound_by": b[1],
                  "max_abs_err": err, "row_invariant": rows}
        print(f"   rms_norm [4, {d}]: {tk['device_ms'] * 1e3:.2f} us (bound {b[0] * 1e3:.3f}, "
              f"plain {tp * 1e3:.2f}, F.rms_norm {'n/a' if lib is None else f'{lib * 1e3:.2f}'}); "
              f"row-invariant at 1, 4, 20, 28 and {LN_ROWS} rows a call")
    return out


def combine_top8(torch, cfg, qparams) -> dict:
    """The fixed-order combine at top-8 of 256 on the card (gated): on the
    same weighted expert rows the card's sums equal the CPU's bit for bit,
    and the full-width MoE layer (routing, grouped B1, combine, shared
    expert) repeats its bits on the same rows at 4 and 20 rows a call."""
    from repro_torch.models import moe
    p = next(lp["moe"] for lp in qparams["layers"] if "moe" in lp)
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for N in (4, 20):
        x = torch.randn((N, cfg.d_model), generator=g, device="cuda")
        r = moe.route(p, x, cfg)
        ye = torch.randn(tuple(r.toks.shape) + (cfg.d_model,), generator=g, device="cuda")
        same_cpu = torch.equal(moe.combine(ye, r.order).cpu(),
                               moe.combine(ye.cpu(), r.order.cpu()))
        a, _ = moe.moe_local(p, x, cfg)
        b, _ = moe.moe_local(p, x, cfg)
        out[N] = {"card_eq_cpu": same_cpu, "repeats": torch.equal(a, b),
                  "dropped_choices": int(r.dropped), "experts_with_rows": int((r.counts > 0).sum()),
                  "cap": int(r.toks.shape[1])}
        if not (same_cpu and out[N]["repeats"]):
            raise AssertionError(f"top-8 combine at N={N}: {out[N]}")
    print(f"   top-8 combine at E {cfg.n_experts}: card sums equal the CPU's bit for bit and "
          f"the MoE layer repeats its bits: {out}")
    return out


def mla_step_parts(torch, cfg, qparams) -> dict:
    """Device ms (graph replay) of the parts of a deepseek decode step at 4
    slots under ``fused_int8``, each on its own: one MLA layer's attention
    (``mla_decode`` at 4 cursors in a pool of 256 rows: 4 B1 launches and
    the plain latent-space ops), ``wkv_b``'s dequantization alone (16.8 M
    elements a layer a step), the dense FFN (3 B1), the MoE layer
    (``moe_local``: routing, 3 grouped B1, the fixed-order combine, the
    shared expert), the shared expert alone (its plain int8 path: float64
    products), and the f32 ``lm_head``."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(20)
    d, B, S = cfg.d_model, 4, 256
    x = torch.randn((B, 1, d), generator=g, device="cuda")
    dim = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    c_q = torch.randint(-127, 128, (B, S, dim), generator=g, device="cuda", dtype=torch.int8)
    c_s = torch.rand((B, S, 1), generator=g, device="cuda") * 0.02
    pos = torch.tensor([37, 64, 91, 130], dtype=torch.int32, device="cuda")
    dense = next(lp for lp in qparams["layers"] if "mlp" in lp)
    moe_p = next(lp["moe"] for lp in qparams["layers"] if "moe" in lp)
    parts = {
        "mla_decode": lambda i: A.mla_decode(dense["attn"], cfg, x, pos, c_q, c_s, "fused_int8"),
        "wkv_b_dequantize": lambda i: A._absorbed(dense["attn"], cfg),
        "dense_ffn": lambda i: L.apply_mlp(dense["mlp"], x, cfg.mlp_type, "fused_int8"),
        "moe_layer": lambda i: moe.moe_apply(moe_p, x, cfg),
        "shared_expert": lambda i: L.apply_mlp(moe_p["shared"], x, cfg.mlp_type),
        "lm_head": lambda i: L.apply_linear(L._lin(qparams["lm_head"], "w"), x[:, 0],
                                            "fused_int8")}
    out = {k: graph_ms(torch, fn, 20) for k, fn in parts.items()}
    print(f"   {cfg.name} decode step parts at 4 slots, device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


# a layer's attention output, card vs CPU, of its scale (the CPU tests' layer tolerance)
LAYER_CPU_SHARE = 1e-3


def mla_bf16(torch, cfg, qparams) -> dict:
    """Phase ``plan``'s deepseek part: one MLA layer's attention as
    :func:`mla_step_parts` times it (``mla_decode`` under ``fused_int8`` at
    4 cursors in a pool of 256 rows) with its SLC intermediates
    (``Runtime.dmvm_dtype``) at bf16 and at f32: device ms of each (graph
    replay, in this run), the bf16 output's gap from f32, and B1's 4
    launches a call (gated: finite, the dtype takes effect, 4 B1 launches,
    no other hand kernel).  The card's output at each dtype is held
    against the same call on the CPU from the same inputs (B1's plain
    version; the path ``tests/test_torch_dmvm.py`` holds against JAX):
    within ``LAYER_CPU_SHARE`` of its scale, as those tests hold a layer, and
    at bf16 nearer the CPU's bf16 output than the card's f32 one."""
    from repro_torch import convert
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import attention as A

    g = torch.Generator(device="cuda").manual_seed(20)
    d, B, S = cfg.d_model, 4, 256
    x = torch.randn((B, 1, d), generator=g, device="cuda")
    dim = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    c_q = torch.randint(-127, 128, (B, S, dim), generator=g, device="cuda", dtype=torch.int8)
    c_s = torch.rand((B, S, 1), generator=g, device="cuda") * 0.02
    pos = torch.tensor([37, 64, 91, 130], dtype=torch.int32, device="cuda")
    attn = next(lp for lp in qparams["layers"] if "mlp" in lp)["attn"]
    outs, ms = {}, {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        def fn(i, dt=dt):
            return A.mla_decode(attn, cfg, x, pos, c_q, c_s, "fused_int8", inter_dtype=dt)
        reset_launch_counts()
        outs[name] = fn(0)[0]
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        if counts.get("int8_matmul") != 4 or set(counts) - {"int8_matmul", "rms_norm",
                                                            "rms_norm_quant"}:
            raise AssertionError(f"mla_decode at {name} launched {counts}")
        ms[name] = graph_ms(torch, fn, 20)
    gap = float((outs["bf16"] - outs["f32"]).abs().max())
    scale = float(outs["f32"].abs().max())
    if not torch.isfinite(outs["bf16"]).all() or gap == 0.0:
        raise AssertionError(f"MLA at bf16: finite {bool(torch.isfinite(outs['bf16']).all())}, "
                             f"gap from f32 {gap}")
    attn_cpu = convert.to_device(attn, "cpu")
    vs_cpu = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        want = A.mla_decode(attn_cpu, cfg, x.cpu(), pos.cpu(), c_q.cpu(), c_s.cpu(),
                            "fused_int8", inter_dtype=dt)[0]
        vs_cpu[name] = float((outs[name].cpu() - want).abs().max())
        if vs_cpu[name] > LAYER_CPU_SHARE * float(want.abs().max()):
            raise AssertionError(f"MLA at {name}: card vs CPU {vs_cpu[name]} (scale "
                                 f"{float(want.abs().max())})")
    if not vs_cpu["bf16"] < gap:
        raise AssertionError(f"MLA at bf16: card vs CPU {vs_cpu['bf16']} not below the gap "
                             f"from f32 {gap}")
    print(f"   {cfg.name} plan: an MLA layer's attention at 4 slots, device ms f32 "
          f"{ms['f32']:.4f}, bf16 {ms['bf16']:.4f}; bf16 output within {gap:.3g} of f32's "
          f"(scale {scale:.3g}); card vs CPU at bf16 {vs_cpu['bf16']:.3g}, at f32 "
          f"{vs_cpu['f32']:.3g}; 4 B1 launches a call")
    return {"mla_decode_ms": ms, "bf16_gap": gap, "scale": scale, "vs_cpu": vs_cpu,
            "launches_a_call": counts}


def reduced_mla_lanes(torch, cfg) -> dict:
    """The reduced model served by the continuous engine on the card under
    the three quantized backends and, under ``fused_int8``, the MTP lanes
    (``spec_k = 3``; ``spec_tree = 3, spec_branch = 2``): every stream
    gated equal to the CPU's plain ``fused_int8`` stream (at 4 experts and
    top-2 the capacity is N: nothing drops, so the lanes are lossless)."""
    return reduced_streams(torch, cfg, dict(
        BACKEND_LANES, spec_k_3_mtp={"spec_k": 3, "drafter": "mtp"},
        spec_tree_3_mtp={"spec_tree": 3, "spec_branch": 2, "drafter": "mtp"}))


def serve_deepseek(torch, ctx, cfg) -> dict:
    """deepseek-v3-671b at full width (``DEEPSEEK_LAYERS`` layers and the MTP
    head) on its int8 tree (:func:`int8_params`; prefill runs int8 too): the
    phase-4 trace under ``fused_int8``, ``pim_bitserial`` and ``ref_int8``
    with exact launch counts (B1 or B5 for every linear, prefill's too, the
    grouped B1 for every expert stack, RMSNorm), the dropped choices under
    ``fused_int8`` gated above 0 (cap 1 at a 4-slot decode step) and the
    three lanes gated token-identical (MLA's attention is the same plain ops
    in each, and B1 and B5 give the plain integers); where they part, the
    lanes are held to :func:`moe_margins` instead, and the record names the
    stage.  The MTP lanes ``spec_k = 4`` and ``spec_tree = 6, spec_branch =
    2`` are each served twice (gated equal to each other, every request at
    its budget, verify steps run, exact launch counts with the drafts'
    cells), not against the plain trace (a verify window routes T times
    the rows at another capacity), with their drafted and accepted counts
    and the drafts' device time (CUDA events around each eager draft
    call).  Then the top-8 combine (:func:`combine_top8`), the decode
    step's parts timed apart (:func:`mla_step_parts`) and the captured
    verify (T 5) and decode steps against eager over 8 steps, the decode
    step's replay profiled in a fresh process (the verify step's here,
    there if a profile here misses records).  Peak device memory is
    recorded beside the card's total."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantized_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = int8_params(torch, cfg)
    secs, t_part = {"init": time.perf_counter() - t0}, time.perf_counter()

    def part(name):
        nonlocal t_part
        secs[name], t_part = time.perf_counter() - t_part, time.perf_counter()
    out = {"n_layers": cfg.n_layers, "serve_s": secs,
           "int8_tree_bytes": quantized_bytes(qparams),
           "after_draw_allocated_bytes": torch.cuda.memory_allocated()}
    print(f"   {cfg.name}: int8 tree of {cfg.n_layers} layers and the MTP head drawn in "
          f"{secs['init']:.1f} s, {out['int8_tree_bytes'] / 1e9:.2f} GB")
    count_steps, zero_routing, routing_record = routing_counters(torch)
    outs = {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        count_steps()
        cb, reqs, wall, counts = serve(torch, cfg, qparams, {}, None, backend,
                                       setup=zero_routing, quantized=True)
        outs[backend] = [list(r.output) for r in reqs]
        out[backend] = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats),
                            launches=counts, routing=routing_record())
        print(f"   {cfg.name} {backend}: served {out[backend]['tokens_served']} tokens in "
              f"{wall:.2f} s, {cb.stats['decode_steps']} decode steps, launches {counts}, "
              f"routing {out[backend]['routing']}")
        del cb, reqs
        torch.cuda.empty_cache()
    moe.count_routing(None)
    if out["fused_int8"]["routing"]["steps"]["dropped_choices"] < 1:
        raise AssertionError(f"{cfg.name}: no choice was dropped at a decode step")
    part("backends")
    plain = outs["fused_int8"]
    out["backends_vs_fused_int8"] = same_streams(outs, plain)
    same = {k: v["same"] for k, v in out["backends_vs_fused_int8"].items()}
    print(f"   {cfg.name}: requests equal to fused_int8's {same} of {len(plain)}")
    if same["pim_bitserial"] != len(plain) or same["ref_int8"] != len(plain):
        margins = moe_margins(torch, cfg, qparams, outs, quantized=True)
        out["divergence_margins"] = margins
        raise AssertionError(f"{cfg.name}: the backends part ({same}); margins {margins}")
    part("margins")
    lane_outs = {}
    for label, lane in (("spec_k_4_mtp", {"spec_k": 4, "drafter": "mtp"}),
                        ("spec_tree_6_mtp", {"spec_tree": 6, "spec_branch": 2,
                                             "drafter": "mtp"})):
        runs = []
        for _ in range(2):
            events = []

            def timing(cb, events=events):
                d = cb._drafter
                for name in ("draft_batch", "draft_tree_batch"):
                    real = getattr(d, name)

                    def fn(*a, real=real):
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                        res = real(*a)
                        ev[1].record()
                        events.append(ev)
                        return res
                    setattr(d, name, fn)
            cb, reqs, wall, counts = serve(torch, cfg, qparams, lane, None, setup=timing,
                                           quantized=True)
            st = dict(cb.stats)
            runs.append([list(r.output) for r in reqs])
            draft_ms = [a.elapsed_time(b) for a, b in events]
            rec = dict(serve_record(reqs, wall, cfg), stats=st, launches=counts,
                       acceptance_rate=cb.acceptance_rate, draft_calls=len(draft_ms),
                       draft_device_ms=sum(draft_ms),
                       draft_ms_per_call=sum(draft_ms) / max(1, len(draft_ms)))
            if st["verify_steps"] < 1:
                raise AssertionError(f"{cfg.name} {label}: no verify step ran")
            del cb, reqs
            torch.cuda.empty_cache()
        out[label] = rec
        lane_outs[label] = runs[0]
        out[label]["runs_equal"] = runs[0] == runs[1]
        print(f"   {cfg.name} {label}: served {rec['tokens_served']} tokens in {rec['wall_s']:.2f} "
              f"s, {st['verify_steps']} verify steps, drafted {st['spec_drafted']}, accepted "
              f"{st['spec_accepted']}; {rec['draft_calls']} draft calls, "
              f"{rec['draft_ms_per_call']:.2f} ms each on the device; two runs equal "
              f"{out[label]['runs_equal']}; launches {counts}")
        if runs[0] != runs[1]:
            raise AssertionError(f"{cfg.name} {label}: two runs part")
    out["mtp_lanes_vs_plain"] = same_streams(lane_outs, plain)
    part("mtp_lanes")
    out["combine_top8"] = combine_top8(torch, cfg, qparams)
    out["step_parts_ms"] = mla_step_parts(torch, cfg, qparams)
    out["plan"] = mla_bf16(torch, cfg, qparams)
    pool = ragged_pool(torch, cfg, qparams, 256, 256)
    out["plan"]["graph_decode_bf16"], _, _ = replay_vs_eager(
        torch, cfg, qparams, pool, "decode",
        rt=Runtime("fused_int8", dmvm_dtype=torch.bfloat16), profile=False)
    ctx["plan_deepseek"] = out["plan"]
    out["graph_verify"], _, _ = replay_vs_eager(torch, cfg, qparams, pool, "verify", 5)
    hold = [qparams, pool]
    del qparams, pool
    out["graph_decode"], _, _ = replay_vs_eager(torch, cfg, *hold, "decode",
                                                release=hold.clear, fresh=True)
    prof = out["graph_decode"]["profile"]
    print(f"   {cfg.name}: replayed decode step at 4 slots: wall {prof['wall_us'] / 1e3:.2f} ms, "
          f"device busy {prof['device_busy_us'] / 1e3:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_kernels']} device events")
    del hold
    torch.cuda.empty_cache()
    part("graphs")
    total = torch.cuda.get_device_properties(0).total_memory
    out["memory"] = {"device_total_bytes": total,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    print(f"   {cfg.name}: peak device memory {out['memory']['peak_reserved_bytes'] / 1e9:.2f} GB "
          f"reserved ({out['memory']['peak_allocated_bytes'] / 1e9:.2f} allocated) of "
          f"{total / 1e9:.2f} GB")
    return out


def deepseek_family(torch, ctx, mods: dict) -> dict:
    """deepseek-v3-671b: its kernels at its shapes (B1 and B5 over the MLA
    linears and the dense FFN at M 4; the grouped B1 at E 256 for C 1 and
    C 2; RMSNorm at 1536, 512 and 7168), the reduced model on the card
    against the CPU (logits, and the served streams with the MTP lanes),
    then :func:`serve_deepseek` at full width."""
    import dataclasses

    from repro_torch.configs import registry

    full = registry.get("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(14)
    shapes = mla_shapes(cfg)
    print(f"   {cfg.name}: an MLA layer's and a dense FFN's linears {shapes}")
    rec = {"kernels": {"b1": b1_per_layer(torch, mods["mm"], g, 4, shapes),
                       "b5": b5_per_layer(torch, mods["mm"], mods["pim"], mods["quant"], g, 4,
                                          shapes),
                       "rms_norm": rms_norm_widths(torch, mods["rn"], (1536, 512, 7168))},
           "grouped_b1": grouped_b1(torch, mods["mm"], cfg, deepseek_counts())}
    rec.update(reduced_vs_cpu(torch, full))
    rec["reduced_lanes"] = reduced_mla_lanes(torch, full)
    rec.update(serve_deepseek(torch, ctx, cfg))
    # the grouped entry's byte floor at the experts the trace's decode steps
    # routed rows to (a layer's stacks)
    live = rec["fused_int8"]["routing"]["steps"]["experts_with_rows_per_call"]
    rec["grouped_b1"]["bound_on_trace_ms"] = sum(
        live * K * N for K, N in expert_stacks(cfg)) / HBM_BYTES_PER_S * 1e3
    print(f"   {cfg.name}: {live:.2f} of {cfg.n_experts} experts hold a row a decode call on the "
          f"trace: the expert stacks' byte floor {rec['grouped_b1']['bound_on_trace_ms']:.4f} ms "
          f"a layer")
    return rec


# jamba-1.5-large-398b at full width with 8 of its 72 layers: one period of
# its interleave (Mamba2 SSD layers at 0-3 and 5-7, GQA attention at 4; MoE
# at the odd layers, dense SwiGLU at the even ones), the least depth that
# holds every layer kind (the reference's groups need whole periods).  8
# layers and the vocab are 45.14 G parameters: the f32 tree (about 180 GB)
# does not fit one card, the int8 tree (about 48.4 GB; two periods about
# 92 GB) does, drawn a part at a time (:func:`int8_params`)
JAMBA_LAYERS = 8
JAMBA_ATTN = (4, 8, 8, 128)        # 4 slots, 8 groups of 8 heads of 128
JAMBA_HEADS = 256                  # SSM heads of 64 (d_inner 16384), state 128
# B6 on the trace's prefills: prompts of up to 200 tokens, one chunk or two
JAMBA_SSD_SHAPES = ((2, 128), (1, 37))
# the grouped entry's row counts at E 16: a decode step at 4 slots (8
# choices, cap 1) and a prefill call of 52 rows (104 choices, cap 13),
# each with experts of 0, 1 and C rows
JAMBA_ROWS = {1: (1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1),
              13: (13, 0, 1, 13, 7, 13, 0, 2, 13, 13, 5, 0, 13, 9, 1, 13)}


def jamba_shapes(cfg) -> dict:
    """{(K, N): count} of the W8A8 linears of an attention layer (wq, wk, wv,
    wo), an SSM layer (w_z, w_x, out_proj; w_B, w_C and w_dt stay float)
    and a dense SwiGLU FFN (w_up, w_gate, w_down)."""
    d, hd, di, ff = cfg.d_model, cfg.head_dim, cfg.d_inner, cfg.d_ff
    kns = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d), (d, di), (d, di), (di, d), (d, ff), (d, ff), (ff, d)]
    shapes: dict = {}
    for kn in kns:
        shapes[kn] = shapes.get(kn, 0) + 1
    return shapes


def routing_counters(torch) -> tuple:
    """int64 [3] routing counters (``moe.count_routing``) for the captured
    steps and the eager prefill calls of a served run, and the functions a
    serve run calls around them: ``count_steps`` before the engine captures
    its steps, ``zero_routing(engine)`` once it has, and ``record()``."""
    from repro_torch.models import moe

    routing = {k: torch.zeros((3,), dtype=torch.int64, device="cuda")
               for k in ("steps", "prefill")}

    def count_steps():
        moe.count_routing(routing["steps"])

    def zero_routing(cb):
        for t in routing.values():
            t.zero_()
        moe.count_routing(routing["prefill"])

    def record():
        rec = {}
        for k, t in routing.items():
            calls, dropped, live = t.tolist()
            rec[k] = {"calls": calls, "dropped_choices": dropped,
                      "experts_with_rows_per_call": live / max(1, calls)}
        return rec
    return count_steps, zero_routing, record


def reduced_streams(torch, cfg, lanes: dict) -> dict:
    """The reduced model served by the continuous engine on the card under
    each of ``lanes`` (label: engine arguments, ``backend`` among them),
    every stream gated equal to the CPU's plain ``fused_int8`` stream."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    rcfg = cfg.reduced()
    p_cpu = M.init_params(rcfg, seed=0, device="cpu")
    p_gpu = convert.to_device(p_cpu, "cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, rcfg.vocab_size, int(rng.integers(4, 40))).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]

    def run(params, device, backend="fused_int8", **lane):
        eng = ContinuousBatchingEngine(rcfg, params, n_slots=4, max_len=64,
                                       rt=Runtime(backend), device=device, **lane)
        return eng.generate_all(prompts, budgets), eng.stats
    want, _ = run(p_cpu, "cpu")
    out = {}
    for label, kw in lanes.items():
        got, st = run(p_gpu, "cuda", **kw)
        out[label] = {"equal_to_cpu": got == want, "verify_steps": st["verify_steps"],
                      "spec_accepted": st["spec_accepted"], "spec_drafted": st["spec_drafted"]}
        if got != want or ("drafter" in kw and st["verify_steps"] < 1):
            raise AssertionError(f"reduced {rcfg.name} {label} on the card: {out[label]}")
    print(f"   reduced {rcfg.name}: the card's streams under {list(lanes)} equal the CPU's: "
          f"{out}")
    return out


BACKEND_LANES = {"fused_int8": {}, "pim_bitserial": {"backend": "pim_bitserial"},
                 "ref_int8": {"backend": "ref_int8"}}


def serve_jamba(torch, ctx, cfg) -> dict:
    """jamba-1.5-large-398b at full width (``JAMBA_LAYERS`` layers) on its
    int8 tree (:func:`int8_params`; prefill runs int8 too, one piece a
    prompt at exact length): the phase-4 trace under ``fused_int8``,
    ``pim_bitserial`` and ``ref_int8`` with exact launch counts (B1 or B5
    for every linear, prefill's too, the grouped B1 for every expert stack,
    B6 for each SSM layer's prefill chunks under ``fused_int8``, B2 for the
    attention layer's decode, RMSNorm), the dropped choices at the decode
    steps under ``fused_int8`` gated above 0 (cap 1 at 4 slots) and
    ``pim_bitserial`` gated token-identical to ``ref_int8``.  Where
    ``fused_int8`` parts from ``ref_int8`` (B6 in its prefill is within
    tolerance of the plain SSD, not bit-equal, and B2 of the plain
    attention), the lanes are held to near-ties (:func:`moe_margins`,
    :func:`near_tie_failures`): at each parting step ``ref_int8`` on the
    fused lane's own inputs, and at the first one the served rows (a
    first token's rows: the two lanes' prefills, B6 against the plain
    SSD).  Then B6 against its plain version on the trace's own
    prefills (H 256), ``Engine`` (4 prompts of 64 tokens, 16 steps, exact
    launch counts) and the captured decode step against eager over 8
    steps, its replay profiled in a fresh process.  Peak device memory is
    recorded beside the card's total."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantized_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = int8_params(torch, cfg)
    secs, t_part = {"init": time.perf_counter() - t0}, time.perf_counter()

    def part(name):
        nonlocal t_part
        secs[name], t_part = time.perf_counter() - t_part, time.perf_counter()
    out = {"n_layers": cfg.n_layers, "serve_s": secs,
           "int8_tree_bytes": quantized_bytes(qparams),
           "after_draw_allocated_bytes": torch.cuda.memory_allocated()}
    print(f"   {cfg.name}: int8 tree of {cfg.n_layers} layers drawn in {secs['init']:.1f} s, "
          f"{out['int8_tree_bytes'] / 1e9:.2f} GB")
    count_steps, zero_routing, routing_record = routing_counters(torch)
    outs = {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        count_steps()
        cb, reqs, wall, counts = serve(torch, cfg, qparams, {},
                                       "decode_attn" if backend == "fused_int8" else None,
                                       backend, setup=zero_routing, quantized=True)
        outs[backend] = [list(r.output) for r in reqs]
        out[backend] = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats),
                            launches=counts, routing=routing_record(),
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"   {cfg.name} {backend}: served {out[backend]['tokens_served']} tokens in "
              f"{wall:.2f} s ({out[backend]['tokens_per_s']:.1f} tokens/s), "
              f"{cb.stats['decode_steps']} decode steps, launches {counts}, routing "
              f"{out[backend]['routing']}")
        del cb, reqs
        torch.cuda.empty_cache()
    moe.count_routing(None)
    if out["fused_int8"]["routing"]["steps"]["dropped_choices"] < 1:
        raise AssertionError(f"{cfg.name}: no choice was dropped at a decode step")
    part("backends")
    plain = outs["fused_int8"]
    out["backends_vs_fused_int8"] = same_streams(outs, plain)
    same = {k: v["same"] for k, v in out["backends_vs_fused_int8"].items()}
    out["pim_eq_ref_int8_requests"] = sum(a == b for a, b in zip(outs["pim_bitserial"],
                                                                 outs["ref_int8"]))
    print(f"   {cfg.name}: requests equal to fused_int8's {same} of {len(plain)}; "
          f"pim_bitserial equal to ref_int8 in {out['pim_eq_ref_int8_requests']}")
    if out["pim_eq_ref_int8_requests"] != len(plain):
        raise AssertionError(f"{cfg.name}: pim_bitserial and ref_int8 part")
    if same["ref_int8"] != len(plain):
        margins = moe_margins(torch, cfg, qparams, outs, quantized=True)
        out["divergence_margins"] = margins
        far = near_tie_failures(margins, forced=True)
        if far:
            raise AssertionError(f"{cfg.name}: fused_int8 parts from ref_int8 off a near-tie "
                                 f"for requests {far}")
    part("margins")
    out["b6_on_trace_prefills"] = b6_on_trace_prefills(torch, cfg, qparams)
    eng = Engine(cfg=cfg, params=qparams, rt=Runtime("fused_int8"), max_len=128,
                 quantize=False)
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    eng.generate({"inputs": prompts}, steps=1)                 # warm-up
    count_steps()
    reset_launch_counts()
    toks, tm = eng.generate({"inputs": prompts}, steps=16)
    counts = launch_counts()
    moe.count_routing(None)
    want = want_launches(cfg, 16, [64], "decode_attn", prefills=T.prefill_pieces(cfg, 64),
                         int8_prefill=True)
    if counts != want or tuple(toks.shape) != (4, 16):
        raise AssertionError(f"{cfg.name} Engine: launch counts {counts} != {want}")
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"{cfg.name} Engine: token out of range")
    out["engine"] = {"prefill_s": tm["prefill_s"], "tpot_s": tm["tpot_s"], "launches": counts,
                     "prompt": list(prompts.shape)}
    print(f"   {cfg.name} Engine from a [4, 64] prompt: prefill {tm['prefill_s'] * 1e3:.1f} ms, "
          f"TPOT {tm['tpot_s'] * 1e3:.2f} ms, launches {counts}")
    del eng
    torch.cuda.empty_cache()
    part("engine")
    pool = ragged_pool(torch, cfg, qparams, 256, 256)
    hold = [qparams, pool]
    del qparams, pool
    out["memory"] = {"device_total_bytes": torch.cuda.get_device_properties(0).total_memory,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    out["graph_decode"], _, _ = replay_vs_eager(torch, cfg, *hold, "decode",
                                                release=hold.clear, fresh=True)
    prof = out["graph_decode"]["profile"]
    print(f"   {cfg.name}: replayed decode step at 4 slots: wall {prof['wall_us'] / 1e3:.2f} ms, "
          f"device busy {prof['device_busy_us'] / 1e3:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_kernels']} device events")
    del hold
    torch.cuda.empty_cache()
    part("graph")
    mem = out["memory"]
    print(f"   {cfg.name}: peak device memory {mem['peak_reserved_bytes'] / 1e9:.2f} GB reserved "
          f"({mem['peak_allocated_bytes'] / 1e9:.2f} allocated) of "
          f"{mem['device_total_bytes'] / 1e9:.2f} GB")
    return out


def jamba_family(torch, ctx, mods: dict) -> dict:
    """jamba-1.5-large-398b: its kernels at its shapes before the tree is
    drawn (B1 and B5 over an attention layer's, an SSM layer's and a dense
    FFN's linears at M 4; B2 at rep 8, D 128; the grouped B1 at E 16 for C
    1 and C 13; B6 at 256 heads of 64, state 128; RMSNorm at 8192 and at
    the SSM's gated 16384), the reduced model on the card against the CPU
    (logits, and the served streams under the three backends), then
    :func:`serve_jamba` at full width."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import ssd_chunk as ssd

    full = registry.get("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    if cfg.ssm_heads != JAMBA_HEADS or cfg.ssm_head_dim != SSD_HEAD_DIM:
        raise AssertionError(f"{cfg.name}: SSM heads {cfg.ssm_heads} of {cfg.ssm_head_dim}")
    g = torch.Generator(device="cuda").manual_seed(15)
    shapes = jamba_shapes(cfg)
    print(f"   {cfg.name}: an attention layer's, an SSM layer's and a dense FFN's linears "
          f"{shapes}; attention (B, G, rep, D) {JAMBA_ATTN}")
    rec = {"kernels": {"b1": b1_per_layer(torch, mods["mm"], g, 4, shapes),
                       "b5": b5_per_layer(torch, mods["mm"], mods["pim"], mods["quant"], g, 4,
                                          shapes),
                       "b2": b2_case(torch, mods["da"], mods["quant"], *FAMILY_B2, JAMBA_ATTN),
                       "ssd_chunk": ssd_kernel_checks(torch, ssd, JAMBA_HEADS,
                                                      JAMBA_SSD_SHAPES),
                       "rms_norm": rms_norm_widths(torch, mods["rn"],
                                                   (cfg.d_model, cfg.d_inner))},
           "grouped_b1": grouped_b1(torch, mods["mm"], cfg, JAMBA_ROWS)}
    rec.update(reduced_vs_cpu(torch, full))
    rec["reduced_lanes"] = reduced_streams(torch, full, BACKEND_LANES)
    rec.update(serve_jamba(torch, ctx, cfg))
    live = rec["fused_int8"]["routing"]["steps"]["experts_with_rows_per_call"]
    rec["grouped_b1"]["bound_on_trace_ms"] = sum(
        live * K * N for K, N in expert_stacks(cfg)) / HBM_BYTES_PER_S * 1e3
    print(f"   {cfg.name}: {live:.2f} of {cfg.n_experts} experts hold a row a decode call on the "
          f"trace: the expert stacks' byte floor {rec['grouped_b1']['bound_on_trace_ms']:.4f} ms "
          f"a layer")
    prof = rec["graph_decode"]["profile"]
    print(f"   {cfg.name} on {ctx.get('card')}: int8 tree {rec['int8_tree_bytes'] / 1e9:.2f} GB, "
          f"peak allocated {rec['memory']['peak_allocated_bytes'] / 1e9:.2f} GB, {live:.2f} of "
          f"{cfg.n_experts} experts with a row a decode call, phase-4 trace "
          f"{rec['fused_int8']['tokens_per_s']:.1f} / {rec['pim_bitserial']['tokens_per_s']:.1f} "
          f"/ {rec['ref_int8']['tokens_per_s']:.1f} tokens a second (fused_int8 / pim_bitserial "
          f"/ ref_int8), replayed decode step wall {prof['wall_us'] / 1e3:.2f} ms, busy "
          f"{prof['device_busy_us'] / 1e3:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['device_kernels']} device events")
    return rec


# whisper-tiny, uncut: 4 encoder and 4 decoder layers, d 384, MHA of 6 heads
# of 64, gelu, LayerNorm, sinusoidal positions, 1,500 encoder frames from
# the stubbed front end, tied vocab 51865 (39 M parameters)
WHISPER_ATTN = (4, 6, 1, 64)       # 4 slots, 6 heads of 64, MHA (rep 1)
WHISPER_PROMPT, WHISPER_STEPS = 16, 32


def whisper_shapes(cfg) -> dict:
    """{(K, N): count} of a decoder layer's W8A8 linears a decode step: its
    self-attention's wq, wk, wv and wo, its cross-attention's wq and wo
    (the cross K/V are cached at prefill) and its gelu MLP's w_up and
    w_down."""
    d, hd = cfg.d_model, cfg.head_dim
    return {(d, cfg.n_heads * hd): 6, (d, cfg.d_ff): 1, (cfg.d_ff, d): 1}


def whisper_margins(torch, cfg, params, qparams, batch: dict, outs: dict) -> list:
    """Where ``fused_int8`` parts from ``ref_int8`` on ``Engine.generate``:
    both lanes' decode steps run eagerly from the same (float) prefill,
    each fed the ``ref_int8`` stream, so each row's inputs are its served
    inputs in both lanes up to the token where it parts; there, the fused
    row's gap between the two tokens, whether it picks the fused token, how
    far the two rows lie apart and the logit scale."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    fused, ref = outs["fused_int8"], outs["ref_int8"]
    first = {i: int((fused[i] != ref[i]).nonzero()[0]) for i in range(fused.shape[0])
             if not torch.equal(fused[i], ref[i])}
    _, state = M.prefill(params, cfg, batch, 128, Runtime("fused_int8"))
    states = {b: clone_state(state) for b in ("fused_int8", "ref_int8")}
    res = []
    for t in range(max(first.values())):
        f, r = (M.decode_step(qparams, cfg, states[b], ref[:, t].contiguous(), Runtime(b))[0]
                .float() for b in ("fused_int8", "ref_int8"))
        for i, d in first.items():
            if d == t + 1:
                a, b = int(fused[i, d]), int(ref[i, d])
                res.append({"rid": i, "token": d, "tokens": [a, b],
                            "fused_gap": float(f[i, a] - f[i, b]),
                            "fused_reproduced": int(f[i].argmax()) == a,
                            "lanes_max_abs_diff": float((f[i] - r[i]).abs().max()),
                            "logit_scale": float(f[i].abs().max())})
    return res


def serve_whisper(torch, ctx, cfg) -> dict:
    """whisper-tiny at full width, nothing cut (random f32 weights, seed 0):
    ``Engine.generate`` from seeded frames [4, 1500, 384] and 16-token
    prompts for 32 greedy steps under ``fused_int8``, ``pim_bitserial`` and
    ``ref_int8``, exact launch counts on each (prefill float: the encoder's
    and decoder's LayerNorms; decode: B1 or B5 for 8 linears a layer, B2
    for the self-attention under ``fused_int8``, the cross-attention on the
    plain int8 path under every backend, as the reference's), the tokens
    in range, ``pim_bitserial`` gated token-identical to ``ref_int8``, and
    where ``fused_int8`` parts, :func:`whisper_margins` gated to near-ties
    (:func:`near_tie_failures`); then the captured decode step on a pool of
    4 slots at ragged cursors (each slot its own frames) against eager over
    8 steps."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantize_tree

    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"frames": torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=g,
                                   device="cuda"),
             "tokens": torch.randint(0, cfg.vocab_size, (4, WHISPER_PROMPT), generator=g,
                                     device="cuda")}
    out, outs = {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
                 "frames": list(batch["frames"].shape)}, {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        eng = Engine(cfg=cfg, params=params, rt=Runtime(backend), max_len=128)
        eng.generate(batch, steps=1)                          # warm-up: capture
        reset_launch_counts()
        toks, tm = eng.generate(batch, steps=WHISPER_STEPS)
        counts = launch_counts()
        want = want_launches(cfg, WHISPER_STEPS, [WHISPER_PROMPT],
                             "decode_attn" if backend == "fused_int8" else None, backend)
        if counts != want or tuple(toks.shape) != (4, WHISPER_STEPS):
            raise AssertionError(f"{cfg.name} {backend}: launch counts {counts} != {want}")
        if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"{cfg.name} {backend}: token out of range")
        outs[backend] = toks
        out[backend] = {"prefill_s": tm["prefill_s"], "tpot_s": tm["tpot_s"],
                        "decode_s": tm["decode_s"],
                        "tokens_per_s": toks.numel() / tm["decode_s"], "launches": counts,
                        "tokens_row0": toks[0].tolist()}
        print(f"   {cfg.name} {backend}: Engine from frames {list(batch['frames'].shape)} and "
              f"[4, {WHISPER_PROMPT}] tokens: prefill {tm['prefill_s'] * 1e3:.1f} ms, TPOT "
              f"{tm['tpot_s'] * 1e3:.2f} ms ({out[backend]['tokens_per_s']:.1f} tokens/s), "
              f"launches {counts}")
        del eng
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    same = {b: int((outs[b] == outs["fused_int8"]).all(dim=1).sum()) for b in outs}
    out["rows_equal_to_fused_int8"] = same
    print(f"   {cfg.name}: rows equal to fused_int8's {same} of 4")
    if not torch.equal(outs["pim_bitserial"], outs["ref_int8"]):
        raise AssertionError(f"{cfg.name}: pim_bitserial and ref_int8 part")
    qparams = quantize_tree(params)
    if same["ref_int8"] != 4:
        margins = whisper_margins(torch, cfg, params, qparams, batch, outs)
        out["divergence_margins"] = margins
        far = near_tie_failures(margins)
        print(f"   {cfg.name}: where fused_int8 parts: {margins}")
        if far or len(margins) != 4 - same["ref_int8"]:
            raise AssertionError(f"{cfg.name}: fused_int8 parts from ref_int8 off a near-tie "
                                 f"in rows {far} ({margins})")
    pool = ragged_pool(torch, cfg, params, 256, 256)
    out["graph_decode"], _, _ = replay_vs_eager(torch, cfg, qparams, pool, "decode")
    prof = out["graph_decode"]["profile"]
    print(f"   {cfg.name}: replayed decode step at 4 slots: wall {prof['wall_us'] / 1e3:.2f} ms, "
          f"device busy {prof['device_busy_us'] / 1e3:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_kernels']} device events")
    del params, qparams, pool
    torch.cuda.empty_cache()
    return out


def reduced_engine_streams(torch, cfg) -> dict:
    """The reduced encoder-decoder's ``Engine.generate`` (frames [2, S_enc,
    d] and 6 tokens, 8 greedy steps) under the three backends on the card,
    each gated token-identical to the CPU's ``fused_int8`` stream."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine

    rcfg = cfg.reduced()
    p_cpu = M.init_params(rcfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {"frames": torch.randn((2, rcfg.encoder_seq, rcfg.d_model), generator=gen),
             "tokens": torch.randint(0, rcfg.vocab_size, (2, 6), generator=gen)}
    want, _ = Engine(cfg=rcfg, params=p_cpu, rt=Runtime("fused_int8"), max_len=64,
                     device="cpu").generate(batch, 8)
    p_gpu = convert.to_device(p_cpu, "cuda")
    out = {}
    for backend in BACKEND_LANES:
        got, _ = Engine(cfg=rcfg, params=p_gpu, rt=Runtime(backend), max_len=64,
                        device="cuda").generate(batch, 8)
        out[backend] = bool(torch.equal(got.cpu(), want))
    print(f"   reduced {rcfg.name}: the card's Engine streams equal the CPU's {out}")
    if not all(out.values()):
        raise AssertionError(f"reduced {rcfg.name}: the card's streams part from the CPU's "
                             f"{out}")
    return out


def whisper_family(torch, ctx, mods: dict) -> dict:
    """whisper-tiny: B1 and B5 over a decoder layer's linears at M 4, B2 at
    rep 1, D 64, the reduced model on the card against the CPU, then
    :func:`serve_whisper` at full width."""
    from repro_torch.configs import registry

    cfg = registry.get("whisper-tiny")
    g = torch.Generator(device="cuda").manual_seed(16)
    shapes = whisper_shapes(cfg)
    print(f"   {cfg.name}: a decoder layer's linears {shapes}; attention (B, G, rep, D) "
          f"{WHISPER_ATTN}")
    rec = {"kernels": {"b1": b1_per_layer(torch, mods["mm"], g, 4, shapes),
                       "b5": b5_per_layer(torch, mods["mm"], mods["pim"], mods["quant"], g, 4,
                                          shapes),
                       "b2": b2_case(torch, mods["da"], mods["quant"], *FAMILY_B2,
                                     WHISPER_ATTN)}}
    rec.update(reduced_vs_cpu(torch, cfg))
    rec["reduced_streams"] = reduced_engine_streams(torch, cfg)
    rec.update(serve_whisper(torch, ctx, cfg))
    prof = rec["graph_decode"]["profile"]
    print(f"   {cfg.name} on {ctx.get('card')}: peak allocated "
          f"{rec['max_memory_allocated'] / 1e9:.2f} GB, Engine TPOT "
          f"{rec['fused_int8']['tpot_s'] * 1e3:.2f} / {rec['pim_bitserial']['tpot_s'] * 1e3:.2f} / "
          f"{rec['ref_int8']['tpot_s'] * 1e3:.2f} ms at 4 rows (fused_int8 / pim_bitserial / "
          f"ref_int8), replayed decode step wall {prof['wall_us'] / 1e3:.2f} ms, busy "
          f"{prof['device_busy_us'] / 1e3:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['device_kernels']} device events")
    return rec


def phase_families(torch, ctx, mods: dict) -> dict:
    """OPT-30B at full width with 16 of its 48 layers (free of llama's and
    mamba2's weights): its kernels at its shapes, the LayerNorm kernel, the
    reduced model on the card against the CPU, and its serve runs
    (:func:`serve_family` with every lane); then granite-3-8b and
    phi3-mini-3.8b at full width with ``SHORT_LAYERS`` layers each, each with its kernels at its
    shapes (phi3's attention at D 96), its reduced config against the CPU,
    and its serve runs under the three backends with its captured decode
    step; then chameleon-34b at full width with 16 of its 48 layers (its
    kernels, QK-norm's rows, the reduced model from embeddings, the three
    backends, ``Engine`` from an embedding prompt, the spec lanes, the
    captured decode step), nemotron-4-340b at full width with 2 of its 96
    layers (its kernels, B2-B4 at D 192 also across pools, the reduced
    model, the three backends, the captured decode step) and grok-1-314b at
    full width with 2 of its 64 layers (about 55.6 GB of f32 and int8
    weights; 3 layers would hold about 80 GB): its attention kernels at
    rep 6, B1's grouped entry at its expert stacks, the reduced model at 4
    and at 8 experts, the three backends, ``Engine``, ``multi_step = 4``
    and the captured decode step), deepseek-v3-671b with 4 of its 61 layers
    and the MTP head (:func:`deepseek_family`), jamba-1.5-large-398b with 8
    of its 72 layers (:func:`jamba_family`) and whisper-tiny uncut
    (:func:`whisper_family`), each family's weights freed before the
    next."""
    import dataclasses
    import gc

    from repro_torch.configs import registry

    ctx.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    opt = dataclasses.replace(registry.get("opt-30b"), n_layers=OPT_LAYERS)
    out = {"layer_norm": layer_norm_checks(torch, mods["lnk"])}
    t0 = time.perf_counter()
    rec = {"kernels": family_kernels(torch, mods, opt, OPT_ATTN)}
    rec.update(reduced_vs_cpu(torch, registry.get("opt-30b")))
    rec.update(serve_family(torch, ctx, opt, lanes=ALL_LANES, exact=True))
    ctx["layer_norm_launches"] = rec["fused_int8"]["launches"]["layer_norm"]
    ctx["layer_norm_quant_launches"] = rec["fused_int8"]["launches"]["layer_norm_quant"]
    rec["family_s"] = time.perf_counter() - t0
    out["opt-30b"] = rec
    # granite-3-8b's attention has llama3-8b's shape: 8 groups of 4 heads of 128
    for arch, attn in (("granite-3-8b", LLAMA_ATTN), ("phi3-mini-3.8b", PHI3_ATTN)):
        cfg = dataclasses.replace(registry.get(arch), n_layers=SHORT_LAYERS)
        t0 = time.perf_counter()
        rec = {"kernels": family_kernels(torch, mods, cfg, attn)}
        rec.update(reduced_vs_cpu(torch, cfg))
        rec.update(serve_family(torch, ctx, cfg))
        rec["family_s"] = time.perf_counter() - t0
        out[arch] = rec
        gc.collect()
        torch.cuda.empty_cache()
    cham = dataclasses.replace(registry.get("chameleon-34b"), n_layers=CHAMELEON_LAYERS)
    t0 = time.perf_counter()
    rec = {"kernels": family_kernels(torch, mods, cham, CHAMELEON_ATTN),
           "qk_norm_rows": qk_norm_rows(torch, mods["rn"], cham)}
    rec.update(reduced_vs_cpu(torch, registry.get("chameleon-34b"), embeddings=True))
    rec.update(serve_family(torch, ctx, cham, lanes=("spec_k", "spec_tree"),
                            embed_prompt=True))
    rec["family_s"] = time.perf_counter() - t0
    out["chameleon-34b"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    nem = dataclasses.replace(registry.get("nemotron-4-340b"), n_layers=NEMOTRON_LAYERS)
    t0 = time.perf_counter()
    rec = {"kernels": family_kernels(torch, mods, nem, NEMOTRON_ATTN)}
    rec["kernels"]["cross_pool"] = cross_pool(torch, mods["da"], mods["va"], mods["vt"],
                                              mods["quant"], NEMOTRON_ATTN, CROSS_POOL[:1])
    rec.update(reduced_vs_cpu(torch, registry.get("nemotron-4-340b")))
    rec.update(serve_family(torch, ctx, nem))
    rec["family_s"] = time.perf_counter() - t0
    out["nemotron-4-340b"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    grok_cfg = registry.get("grok-1-314b")
    grok = dataclasses.replace(grok_cfg, n_layers=GROK_LAYERS)
    t0 = time.perf_counter()
    rec = {"kernels": family_kernels(torch, mods, grok, GROK_ATTN)}
    rec["kernels"]["cross_pool"] = cross_pool(torch, mods["da"], mods["va"], mods["vt"],
                                              mods["quant"], GROK_ATTN, CROSS_POOL[:1])
    rec["grouped_b1"] = grouped_b1(torch, mods["mm"], grok)
    rec.update(reduced_vs_cpu(torch, grok_cfg))
    e8 = reduced_vs_cpu(torch, grok_cfg,
                        rcfg=dataclasses.replace(grok_cfg.reduced(), n_experts=8))
    rec.update({f"e8_{k}": v for k, v in e8.items()})
    rec.update(serve_family(torch, ctx, grok, lanes=("multi_step_4",)))
    ctx["grouped_launches"] = rec["fused_int8"]["launches"]["int8_matmul_grouped"]
    # the grouped entry's byte floor at the experts the trace's decode steps
    # routed rows to (a layer's stacks; the prefill calls run float experts)
    live = rec["fused_int8"]["routing"]["steps"]["experts_with_rows_per_call"]
    rec["grouped_b1"]["bound_on_trace_ms"] = sum(
        live * K * N for K, N in expert_stacks(grok)) / HBM_BYTES_PER_S * 1e3
    print(f"   grok-1-314b: {live:.2f} of {grok.n_experts} experts hold a row a decode call "
          f"on the trace: the expert stacks' byte floor "
          f"{rec['grouped_b1']['bound_on_trace_ms']:.4f} ms a layer")
    rec["family_s"] = time.perf_counter() - t0
    out["grok-1-314b"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    for arch, family in (("deepseek-v3-671b", deepseek_family),
                         ("jamba-1.5-large-398b", jamba_family),
                         ("whisper-tiny", whisper_family)):
        t0 = time.perf_counter()
        rec = family(torch, ctx, mods)
        rec["family_s"] = time.perf_counter() - t0
        out[arch] = rec
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase train: the training path (llama3-8b at full width, opt-125m uncut)
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 8              # of llama3-8b's 32: 2.80 B parameters, 11.2 GB of f32
TRAIN_BATCH, TRAIN_SEQ = 8, 128      # the training CLI's defaults
TRAIN_STEPS = 4               # AdamW steps on one repeated batch, per moment type
TRAIN_LR = 3e-4
GRAD_TOL = 1e-3               # of a leaf's largest gradient: norm kernels against plain norms
NORM_BWD_ROWS = TRAIN_BATCH * TRAIN_SEQ
OPT125_STEPS = 20
OPT125_FAIL_AT = (7, 13)
OPT125_CKPT_EVERY = 5


def norm_bwd_bound(M: int, d: int, layer_norm: bool) -> tuple[float, str]:
    """The backward's least time: x and g read and dx written once, the
    scale read and its (and the bias's) gradient written once; about 8
    (RMSNorm) or 11 (LayerNorm) f32 operations an element."""
    n_params = 3 if layer_norm else 2
    return bound_ms(4 * (3 * M * d + n_params * d),
                    [((11 if layer_norm else 8) * M * d, FP32_FLOPS_PER_S)])


def kernel_breakdown(torch, fn, iters: int = 20) -> dict:
    """Each device kernel's mean µs a call of ``fn`` over ``iters`` profiled
    calls (torch.profiler's device events, by kernel name)."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.name[:60]] = out.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / iters
    return out


def norm_backward_checks(torch, rn, lnk) -> dict:
    """Both norms' backward kernels against autograd of their plain
    versions at llama3-8b's [1024, 4096] and opt-125m's [1024, 768] (a
    train step's B*T rows), within 1e-5 of the gradient's scale (dx is a
    difference of terms of that size; the column sums run in another order
    than autograd's), the same bits on a second call (no float atomics);
    each as the training path runs it, handed the forward's statistics
    (the RMSNorm's ``rstd``, the LayerNorm's mean and ``rstd``), with the
    same bits as without them (the kernel then recomputes them in the
    forward's order), one device kernel a call (the captured call's graph
    holds one kernel node) and the same bits on two replays of it (all
    gated); times of both at [1024, 4096] and [1024, 768] beside the plain
    version's (autograd through it) and the
    library's (``torch.ops.aten._fused_rms_norm_backward`` /
    ``native_layer_norm_backward``, a yardstick only), all captured as CUDA
    graphs and replayed, with the byte bound."""
    aten = torch.ops.aten
    g = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for name, d in (("rms_norm_backward", 4096), ("rms_norm_backward", 768),
                    ("layer_norm_backward", 768), ("layer_norm_backward", 4096)):
        M = NORM_BWD_ROWS
        x = torch.randn((M, d), generator=g, device="cuda") * 3 + 0.5
        scale = torch.randn((d,), generator=g, device="cuda")
        bias = torch.randn((d,), generator=g, device="cuda")
        dy = torch.randn((M, d), generator=g, device="cuda")
        ln = name == "layer_norm_backward"
        if ln:
            _, mean_k, rstd_k = lnk.layer_norm_cuda(x, scale, bias, with_stats=True)

            def kern(i):
                return lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean_k, rstd=rstd_k)

            def own_stats():
                return lnk.layer_norm_backward_cuda(x, scale, dy)

            def plain(i):
                return lnk.layer_norm_backward_plain(x, scale, bias, dy)
            _, mean, rstd = aten.native_layer_norm(x, [d], scale, bias, 1e-5)

            def lib(i):
                return aten.native_layer_norm_backward(dy, x, [d], mean, rstd, scale, bias,
                                                       [True, True, True])
        else:
            _, rstd_k = rn.rms_norm_cuda(x, scale, with_rstd=True)

            def kern(i):
                return rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd_k)

            def own_stats():
                return rn.rms_norm_backward_cuda(x, scale, dy)

            def plain(i):
                return rn.rms_norm_backward_plain(x, scale, dy)
            lib = None
            if hasattr(aten, "_fused_rms_norm_backward") and hasattr(aten, "_fused_rms_norm"):
                rstd = aten._fused_rms_norm(x, [d], scale, 1e-5)[1]

                def lib(i):
                    return aten._fused_rms_norm_backward(dy, x, [d], rstd, scale, [True, True])
        got, want = kern(0), plain(0)
        errs = []
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
            errs.append(float((a - b).abs().max()))
        if not all(torch.equal(a, b) for a, b in zip(got, kern(1))):
            raise AssertionError(f"{name} [{M}, {d}]: a second call gave other bits")
        rec = {"M": M, "d": d, "max_abs_err": max(errs)}
        rec["replays_equal"], rec["graph_nodes"] = replay_bits(torch, kern, got)
        if not (all(torch.equal(a, b) for a, b in zip(got, own_stats())) and rec["replays_equal"]
                and rec["graph_nodes"] == [0]):
            raise AssertionError(f"{name} [{M}, {d}]: other bits without the saved stats or "
                                 f"on a replay ({rec['replays_equal']}), or device operations "
                                 f"{rec['graph_nodes']} (not one kernel)")
        tk, tp = timed(torch, kern, 50), timed(torch, plain, 50)
        lib_ms = None
        if lib is not None:
            try:        # a yardstick only: an aten signature of another version
                lib_ms = graph_ms(torch, lib, 50)
            except (RuntimeError, TypeError) as e:
                print(f"   {name}: the library call did not run here: {e}")
        b = norm_bwd_bound(M, d, ln)
        rec["device_kernels_us"] = kernel_breakdown(torch, kern)
        rec.update({"ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                    "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
                    "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1]})
        print(f"   {name} [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
              f"{tk['eager_ms'] * 1e3:.2f} eager (bound {b[0] * 1e3:.2f}, plain "
              f"{tp['device_ms'] * 1e3:.2f} / {tp['eager_ms'] * 1e3:.2f} eager, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f}'}); max |err| "
              f"{max(errs):.3g}; repeats its bits; device kernels "
              f"{ {k: round(v, 2) for k, v in rec['device_kernels_us'].items()} } us")
        if d == (4096 if not ln else 768):
            out[name] = rec
        out.setdefault("shapes", []).append(rec)
    return out


def captured(torch, fn):
    """``fn(0)`` captured in a CUDA graph kept for inspection, after a call
    on a side stream: (graph, the call's outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        got = fn(0)
    return graph, got


def replay_bits(torch, fn, want, replays: int = 2) -> tuple[bool, list[int]]:
    """``fn(0)`` captured in a CUDA graph: whether each of ``replays``
    replays gives the tensors ``want``, and the graph's node types (one
    call's device operations)."""
    from repro_torch.models.graphs import node_types
    graph, got = captured(torch, fn)
    types = node_types(graph)
    same = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b) for a, b in zip(got, want)))
    del graph
    return all(same), types


def plain_norms(rn, lnk):
    """A context in which ``apply_norm`` runs the plain versions on CUDA
    tensors too (autograd through them), for the gradient gate."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = rn.rms_norm, lnk.layer_norm
        rn.rms_norm = lambda x, scale, eps=1e-5: rn.rms_norm_plain(x, scale, eps)
        lnk.layer_norm = lambda x, scale, bias, eps=1e-5: lnk.layer_norm_plain(x, scale,
                                                                                bias, eps)
        try:
            yield
        finally:
            rn.rms_norm, lnk.layer_norm = saved
    return ctx()


def train_steps(torch, cfg, batch, quantized: bool, card: str,
                profiled: bool = False) -> dict:
    """``TRAIN_STEPS`` AdamW steps (f32 or int8 moments) from the seeded
    weights on one repeated batch: each step's loss and wall time (host
    clock, the loss read back), tokens a second, peak device memory and
    6 N tokens over the step time (N the model's parameters)."""
    from repro_torch import kernels as KN
    from repro_torch.convert import tree_leaves
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step

    params = M.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = AdamW(lr=TRAIN_LR, warmup_steps=2, total_steps=100, weight_decay=0.0,
                quantized_state=quantized)
    state = opt.init(params)
    step = make_train_step(cfg, Runtime(), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KN.reset_launch_counts()
    losses, wall = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    counts = KN.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = (profile_step(torch, lambda: step(params, state, batch), "llama3-8b train")
            if profiled else None)
    del params, state, m
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(wall[1:])[len(wall[1:]) // 2]          # median past the first
    rec = {"moments": "int8" if quantized else "f32", "losses": losses, "step_ms": wall,
           "steady_step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
           "model_tflop_per_s": 6 * n_params * tokens / steady * 1e-9,
           "peak_gb": peak / 1e9, "n_params": n_params, "launches": counts,
           "profile": prof}
    print(f"   llama3-8b x{cfg.n_layers} AdamW ({rec['moments']} moments), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {[round(x, 4) for x in losses]}; step "
          f"{[round(w, 1) for w in wall]} ms (steady {steady:.1f} ms), "
          f"{rec['tokens_per_s']:.0f} tok/s, 6 N tokens / step {rec['model_tflop_per_s']:.2f} "
          f"TFLOP/s, peak {rec['peak_gb']:.2f} GB ({card})")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{rec['moments']} moments: the loss did not fall: {losses}")
    return rec


def llama_gradient_gate(torch, cfg, batch, rn, lnk) -> dict:
    """One step's gradient at full width through the norm kernels against
    the same step through the plain norms, on the same weights and batch:
    every leaf within ``GRAD_TOL`` of its largest magnitude, every norm
    scale's gradient present and nonzero, and one backward launch a norm."""
    from repro_torch import kernels as KN
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim.adamw import _paths
    from repro_torch.train.train_step import value_and_grad

    params = M.init_params(cfg, seed=0, device="cuda")
    KN.reset_launch_counts()
    t0 = time.perf_counter()
    loss_k, gk = value_and_grad(params, cfg, batch, Runtime())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = KN.launch_counts()
    with plain_norms(rn, lnk):
        loss_p, gp = value_and_grad(params, cfg, batch, Runtime())
    norms = 2 * cfg.n_layers + 1
    if counts["rms_norm"] != norms or counts["rms_norm_backward"] != norms:
        raise AssertionError(f"norm launches {counts} for {norms} norms")
    worst, zero_scales = 0.0, []
    leaves_p = dict(_paths(gp))
    for path, a in _paths(gk):
        b = leaves_p[path]
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, err)
        if err > GRAD_TOL or not torch.isfinite(a).all():
            raise AssertionError(f"gradient of {path}: {err:.3g} of its scale apart")
        if "scale" in path and torch.count_nonzero(a) == 0:
            zero_scales.append(path)
    if zero_scales:
        raise AssertionError(f"norm scales with a zero gradient: {zero_scales}")
    rec = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
           "worst_leaf_err": worst, "leaves": len(leaves_p), "norm_scales": sum(
               "scale" in p for p in leaves_p), "fwd_bwd_s": wall, "launches": counts}
    print(f"   llama3-8b x{cfg.n_layers} gradient: loss {float(loss_k):.6f} (kernels) / "
          f"{float(loss_p):.6f} (plain norms); {len(leaves_p)} leaves within {worst:.3g} of "
          f"their scale (gate {GRAD_TOL}), {rec['norm_scales']} norm scales all nonzero; "
          f"{norms} forward and {norms} backward norm launches; fwd+bwd {wall:.2f} s")
    return rec


def opt125m_resilience_child() -> dict:
    """opt-125m uncut (LayerNorm, the tied head), run in a process of its own
    with ``torch.use_deterministic_algorithms(True)`` (and the
    ``CUBLAS_WORKSPACE_CONFIG`` it needs, set before the process started):
    ``ResilientRunner`` with checkpoints every ``OPT125_CKPT_EVERY`` steps
    and failures injected at ``OPT125_FAIL_AT`` for ``OPT125_STEPS`` steps,
    int8 moments, against a clean run: the final weights equal bit for bit
    and every logged step's loss equal."""
    import tempfile

    import torch
    from repro_torch import kernels as KN
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import tree_leaves
    from repro_torch.data.pipeline import SyntheticTokens, put_batch
    from repro_torch.device import set_float32_precision
    from repro_torch.ft.failures import FailureInjector, ResilientRunner
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step

    torch.use_deterministic_algorithms(True)
    set_float32_precision()
    cfg = registry.get("opt-125m")
    data = SyntheticTokens(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0)
    opt = AdamW(lr=TRAIN_LR, warmup_steps=2, total_steps=OPT125_STEPS, quantized_state=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fail_at in (("clean", ()), ("failed", OPT125_FAIL_AT)):
            params = M.init_params(cfg, seed=0, device="cuda")
            runner = ResilientRunner(step_fn=make_train_step(cfg, Runtime(), opt),
                                     ckpt_dir=f"{tmp}/{label}", ckpt_every=OPT125_CKPT_EVERY,
                                     injector=FailureInjector(fail_at=fail_at))
            KN.reset_launch_counts()
            t0 = time.perf_counter()
            params, _, log = runner.run(params, opt.init(params), data, OPT125_STEPS)
            torch.cuda.synchronize()
            runs[label] = {"params": tree_leaves(params), "log": log,
                           "wall_s": time.perf_counter() - t0,
                           "launches": KN.launch_counts(), "seen": sorted(runner.injector.seen)}
    deterministic = torch.are_deterministic_algorithms_enabled()
    # where a step's time goes, then the same step without deterministic algorithms
    params = M.init_params(cfg, seed=0, device="cuda")
    state, step = opt.init(params), make_train_step(cfg, Runtime(), opt)
    batch = put_batch(data.batch_at(0), "cuda")
    prof = profile_step(torch, lambda: step(params, state, batch), "opt-125m train")
    torch.use_deterministic_algorithms(False)
    free_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        float(step(params, state, batch)[2]["loss"])
        free_ms.append((time.perf_counter() - t0) * 1e3)
    clean = {m["step"]: m["loss"] for m in runs["clean"]["log"]}
    failed = runs["failed"]
    equal_params = all(torch.equal(a, b) for a, b in zip(runs["clean"]["params"],
                                                         failed["params"]))
    equal_losses = all(m["loss"] == clean[m["step"]] for m in failed["log"])
    steps = len(runs["clean"]["log"])
    return {"deterministic_algorithms": deterministic,
            "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "equal_params": equal_params, "equal_losses": equal_losses,
            "losses": [m["loss"] for m in runs["clean"]["log"]],
            "failed_steps_logged": [m["step"] for m in failed["log"]],
            "injected": failed["seen"],
            "clean_wall_s": runs["clean"]["wall_s"], "failed_wall_s": failed["wall_s"],
            "clean_step_ms": [m["dt"] * 1e3 for m in runs["clean"]["log"]],
            "launches_clean": runs["clean"]["launches"],
            "layer_norm_backward_per_step": runs["clean"]["launches"]["layer_norm_backward"]
            / steps, "profile": prof, "nondeterministic_step_ms": free_ms}


def opt125m_resilience(torch) -> dict:
    """:func:`opt125m_resilience_child` in a fresh process (deterministic
    algorithms need ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts)."""
    code = ("import json, sys; sys.path[:0] = ['src', '.']; import chip_smoke as S; "
            "print('CHILD ' + json.dumps(S.opt125m_resilience_child()))")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                           env=env, capture_output=True, text=True, timeout=900)
    line = next((x for x in child.stdout.splitlines() if x.startswith("CHILD ")), None)
    if child.returncode != 0 or line is None:
        raise AssertionError(f"opt-125m resilience run failed (exit {child.returncode}): "
                             f"{child.stderr[-3000:]}")
    print("\n".join(x for x in child.stdout.splitlines() if not x.startswith("CHILD ")))
    rec = json.loads(line[6:])
    steady = sorted(rec["clean_step_ms"][1:])[len(rec["clean_step_ms"][1:]) // 2]
    rec["steady_step_ms"] = steady
    print(f"   opt-125m: {OPT125_STEPS} steps, failures at {rec['injected']}, checkpoints "
          f"every {OPT125_CKPT_EVERY}: final weights equal {rec['equal_params']}, losses "
          f"equal {rec['equal_losses']} (deterministic algorithms "
          f"{rec['deterministic_algorithms']}); losses {rec['losses'][0]:.4f} -> "
          f"{rec['losses'][-1]:.4f}; steady step {steady:.1f} ms; runs {rec['clean_wall_s']:.1f}"
          f" / {rec['failed_wall_s']:.1f} s; {rec['layer_norm_backward_per_step']:.0f} "
          f"LayerNorm backward launches a step; without deterministic algorithms "
          f"{[round(x, 1) for x in rec['nondeterministic_step_ms']]} ms a step")
    if not (rec["equal_params"] and rec["equal_losses"]) or rec["injected"] != list(
            OPT125_FAIL_AT):
        raise AssertionError("opt-125m: the resilient run does not equal the clean run")
    return rec


def phase_train(torch, ctx, rn, lnk) -> dict:
    """The training path on the card: both norms' backward kernels against
    autograd of their plain versions (:func:`norm_backward_checks`);
    llama3-8b at full width with ``TRAIN_LAYERS`` layers in f32: one step's
    gradient through the norm kernels against the plain norms
    (:func:`llama_gradient_gate`) and ``TRAIN_STEPS`` AdamW steps under f32
    and int8 moments, the loss gated to fall (their backward launches are
    what the ``kernels`` line reports for the RMSNorm backward); and
    opt-125m uncut through ``ResilientRunner`` with injected failures,
    gated equal to a clean run (its launches are the LayerNorm
    backward's)."""
    import dataclasses
    import gc

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens, put_batch

    gc.collect()
    torch.cuda.empty_cache()
    out = norm_backward_checks(torch, rn, lnk)
    cfg = dataclasses.replace(registry.get("llama3-8b"), n_layers=TRAIN_LAYERS)
    batch = put_batch(SyntheticTokens(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                                       "train"), seed=0).batch_at(0), "cuda")
    out["gradient"] = llama_gradient_gate(torch, cfg, batch, rn, lnk)
    gc.collect()
    torch.cuda.empty_cache()
    launches = 0
    for quantized in (False, True):
        rec = train_steps(torch, cfg, batch, quantized, ctx["card"], profiled=not quantized)
        out["int8" if quantized else "f32"] = rec
        launches += rec["launches"]["rms_norm_backward"]
        gc.collect()
        torch.cuda.empty_cache()
    ctx["rms_norm_backward_launches"] = launches
    out["opt-125m"] = opt125m_resilience(torch)
    ctx["layer_norm_backward_launches"] = out["opt-125m"]["launches_clean"]["layer_norm_backward"]
    return out


# a full-width step's logits, card vs CPU, of the logit scale: 32 random
# layers carry an activation code flipped at a rounding boundary (an f32
# ulp apart) to a few percent of the scale (0.160 of 4.78 at bf16 in a
# reading), so the step is held loosely and the layer tightly
# (:func:`gqa_bf16_vs_cpu`)
STEP_CPU_SHARE = 0.1


def gqa_bf16_vs_cpu(torch, cfg, attn) -> dict:
    """One llama3-8b layer's attention (``gqa_decode`` under ``ref_int8``
    at 4 cursors in a pool of 256 rows: the plain int8 attention, which
    takes ``dmvm_dtype``) on the card at bf16 and f32, each held against
    the same call on the CPU from the same inputs (the path
    ``tests/test_torch_dmvm.py`` holds against JAX): within
    ``LAYER_CPU_SHARE`` of its scale, and at bf16 nearer the CPU's bf16
    output than the card's f32 one."""
    from repro_torch import convert
    from repro_torch.core import quant
    from repro_torch.models import attention as A

    g = torch.Generator(device="cuda").manual_seed(23)
    B, S = len(RAGGED_LENS), 256
    x = torch.randn((B, 1, cfg.d_model), generator=g, device="cuda")
    kv = [quant.quantize_kv(torch.randn((B, S, cfg.n_kv_heads, cfg.head_dim), generator=g,
                                        device="cuda")) for _ in range(2)]
    cache = [kv[0][0], kv[0][1], kv[1][0], kv[1][1]]
    pos = torch.tensor(RAGGED_LENS, dtype=torch.int32, device="cuda")
    attn_cpu = convert.to_device(attn, "cpu")
    outs = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        for dev, p in (("cuda", attn), ("cpu", attn_cpu)):
            c = [t.to(dev, copy=True) for t in cache]
            outs[name, dev] = A.gqa_decode(p, cfg, x.to(dev), pos.to(dev), *c, "ref_int8",
                                           inter_dtype=dt)[0].cpu()
    gap = float((outs["bf16", "cuda"] - outs["f32", "cuda"]).abs().max())
    out = {"bf16_gap": gap, "scale": float(outs["f32", "cpu"].abs().max())}
    for name in ("f32", "bf16"):
        want = outs[name, "cpu"]
        out[f"{name}_vs_cpu"] = float((outs[name, "cuda"] - want).abs().max())
        if out[f"{name}_vs_cpu"] > LAYER_CPU_SHARE * float(want.abs().max()):
            raise AssertionError(f"llama3-8b attention at {name}: card vs CPU {out}")
    if gap == 0.0 or not out["bf16_vs_cpu"] < gap:
        raise AssertionError(f"llama3-8b attention at bf16: {out}")
    print(f"   llama3-8b plan: a layer's attention under ref_int8, card vs CPU at bf16 "
          f"{out['bf16_vs_cpu']:.3g}, at f32 {out['f32_vs_cpu']:.3g}; bf16 within {gap:.3g} "
          f"of f32 (scale {out['scale']:.3g})")
    return out


def plan_llama(torch) -> dict:
    """llama3-8b at full width (int8 tree, 4 slots at ragged cursors in a
    pool of 256 rows): one decode step from one state under ``fused_int8``
    at bf16 and at f32 (B1 and B2 take no dtype: gated bit-equal, logits
    and state, with exact launches); under ``ref_int8`` the bf16 step
    captured as a CUDA graph and replayed over ``GRAPH_STEPS`` steps
    bit-equal to eager (:func:`replay_vs_eager`), and one bf16 step's logit
    gap from the f32 step's (recorded; gated finite and nonzero).  The
    bf16 and f32 steps' logits are held against the same steps on the CPU
    from the same state and tokens (the tree copied there; the path
    ``tests/test_torch_dmvm.py`` holds against JAX), within
    ``STEP_CPU_SHARE`` of the logit scale, and one layer's attention
    tightly (:func:`gqa_bf16_vs_cpu`)."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    cfg = registry.get("llama3-8b")
    params = M.init_params(cfg, seed=0, device="cuda")
    qparams = quantize_tree(params)
    del params
    torch.cuda.empty_cache()
    state = ragged_pool(torch, cfg, qparams, 256, 256)
    g = torch.Generator(device="cuda").manual_seed(22)
    tok = torch.randint(0, cfg.vocab_size, (len(RAGGED_LENS),), generator=g, device="cuda",
                        dtype=torch.int32)
    bf16 = torch.bfloat16
    runs = {}
    for name, rt in (("f32", Runtime("fused_int8")),
                     ("bf16", Runtime("fused_int8", dmvm_dtype=bf16))):
        st = clone_state(state)
        reset_launch_counts()
        lg, _ = M.decode_step(qparams, cfg, st, tok, rt)
        torch.cuda.synchronize()
        runs[name] = (lg, st, launch_counts())
    want = want_launches(cfg, 1, [], "decode_attn", prefills=0)
    if any(r[2] != want for r in runs.values()):
        raise AssertionError(f"fused_int8 decode launches {[r[2] for r in runs.values()]} "
                             f"!= {want}")
    if not torch.equal(runs["f32"][0], runs["bf16"][0]) or same_state(torch, runs["f32"][1],
                                                                      runs["bf16"][1]):
        raise AssertionError("fused_int8 decode step differs between bf16 and f32")
    out = {"fused_int8_bf16_eq_f32": True, "launches": want}
    print("   llama3-8b plan: fused_int8 decode step bit-equal at bf16 and f32 (logits and "
          "state)")
    del runs
    out["graph_ref_int8_bf16"], _, _ = replay_vs_eager(
        torch, cfg, qparams, state, "decode", rt=Runtime("ref_int8", dmvm_dtype=bf16),
        profile=False)
    l32 = M.decode_step(qparams, cfg, clone_state(state), tok, Runtime("ref_int8"))[0]
    l16 = M.decode_step(qparams, cfg, clone_state(state), tok,
                        Runtime("ref_int8", dmvm_dtype=bf16))[0]
    gap, scale = float((l16 - l32).abs().max()), float(l32.abs().max())
    argmax_eq = int((l16.argmax(-1) == l32.argmax(-1)).sum())
    if not torch.isfinite(l16).all() or gap == 0.0:
        raise AssertionError(f"ref_int8 at bf16: gap from f32 {gap}")
    out["ref_int8_bf16_vs_f32"] = {"max_abs": gap, "logit_scale": scale,
                                   "argmax_equal": argmax_eq, "slots": len(RAGGED_LENS)}
    print(f"   llama3-8b plan: ref_int8 bf16 step's logits within {gap:.4g} of f32's (scale "
          f"{scale:.4g}), argmax equal in {argmax_eq} of {len(RAGGED_LENS)} slots")
    out["attention_vs_cpu"] = gqa_bf16_vs_cpu(torch, cfg, qparams["layers"][0]["attn"])
    t0 = time.perf_counter()
    q_cpu = convert.to_device(qparams, "cpu")
    rec = {"logit_scale": scale}
    for name, lg, dt in (("bf16", l16, bf16), ("f32", l32, None)):
        want = M.decode_step(q_cpu, cfg, convert.to_device(clone_state(state), "cpu"), tok.cpu(),
                             Runtime("ref_int8", dmvm_dtype=dt))[0]
        rec[f"{name}_max_abs"] = float((lg.cpu() - want).abs().max())
        rec[f"{name}_argmax_equal"] = int((lg.argmax(-1).cpu() == want.argmax(-1)).sum())
    rec["cpu_s"] = time.perf_counter() - t0
    out["ref_int8_step_vs_cpu"] = rec
    print(f"   llama3-8b plan: ref_int8 step, card vs CPU: bf16 max |diff| "
          f"{rec['bf16_max_abs']:.4g}, f32 {rec['f32_max_abs']:.4g} of {scale:.4g}; argmax "
          f"equal in {rec['bf16_argmax_equal']} / {rec['f32_argmax_equal']} of "
          f"{len(RAGGED_LENS)} slots (the CPU's two steps {rec['cpu_s']:.1f} s)")
    if max(rec["bf16_max_abs"], rec["f32_max_abs"]) > STEP_CPU_SHARE * scale:
        raise AssertionError(f"ref_int8 step, card vs CPU: {rec}")
    del qparams, q_cpu, state, l32, l16, want
    torch.cuda.empty_cache()
    return out


def kv_api_vs_cpu(torch) -> dict:
    """The per-layer cache API on the card and on the CPU from the same
    floats: ``append_layer`` at [B] positions (one clamped at the pool's
    end), two ``append_layer_chunk`` calls, ``append_latent`` at deepseek's
    latent width; every leaf (``layer_view`` of both layers, the latent
    codes and scales) gated bit-equal."""
    from repro_torch.core import kvcache as KV

    g = torch.Generator().manual_seed(21)
    B, S, H, D = 3, 64, 8, 128
    k, v = (torch.randn((B, 5, H, D), generator=g) * 3 for _ in range(2))
    lat = torch.randn((B, 2, 576), generator=g)
    pos = torch.tensor([0, 17, 63], dtype=torch.int32)
    leaves = {}
    for dev in ("cpu", "cuda"):
        c = KV.init_cache(2, B, S, H, D, device=dev)
        KV.append_layer(c, 1, k.to(dev), v.to(dev), pos.to(dev))
        KV.append_layer_chunk(c, 0, k[:, :2].to(dev), v[:, :2].to(dev), 3)
        KV.append_layer_chunk(c, 0, k[:, 2:].to(dev), v[:, 2:].to(dev), 5)
        lc = KV.init_latent_cache(2, B, S, lat.shape[-1], device=dev)
        KV.append_latent(lc, 1, lat.to(dev), pos.to(dev))
        leaves[dev] = [t.cpu() for t in (*KV.layer_view(c, 0), *KV.layer_view(c, 1),
                                         lc.c_q, lc.c_s)]
    bad = [i for i, (a, b) in enumerate(zip(leaves["cpu"], leaves["cuda"]))
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"per-layer cache API: leaves {bad} differ from the CPU's")
    print(f"   per-layer cache API: {len(leaves['cpu'])} leaves bit-equal to the CPU's")
    return {"leaves": len(leaves["cpu"]), "bit_equal": True}


def dryrun_cells(torch) -> dict:
    """``python -m repro_torch.launch.dryrun`` in processes of their own,
    the two at once: ``--quick`` and llama3-8b's four full-size cells
    (``--arch llama3-8b``), counted again (``--force``).  Gated: exit 0,
    every record ``ok`` or skipped for ``applicable``'s own reason (a cell
    that applies but was not counted fails), counted flops > 0 and
    ``model_flops`` equal to this host's, and on each ``ok`` decode cell a
    peak measured over a real step that launched B1 (and B2 where the stack
    attends)."""
    from repro_torch.configs.shapes import applicable
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    runs = (("quick", ["--quick"],
             [(a, s) for a in D.QUICK_ARCHS for s in D.QUICK_SHAPES], True),
            ("llama3-8b", ["--arch", "llama3-8b"],
             [("llama3-8b", s) for s in D.SHAPES], False))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                               "--force"], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _, args, _, _ in runs]
    results = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    for (name, _, cells, quick), (_, err, rc) in zip(runs, results):
        if rc != 0:
            raise AssertionError(f"dryrun {name}: exit {rc}: {err[-2000:]}")
        recs = []
        for arch, sname in cells:
            rec = json.loads(D.out_path(arch, sname, quick=quick).read_text())
            cfg = D.cell_config(arch, quick)
            shape = (D.QUICK_SHAPES if quick else D.SHAPES)[sname]
            if rec["model_flops"] != M.model_flops(cfg, shape):
                raise AssertionError(f"{arch} {sname}: model_flops {rec['model_flops']}")
            if rec["status"] == "skipped":
                why = applicable(cfg, shape)[1]
                if not why or rec.get("reason") != why:
                    raise AssertionError(f"{arch} {sname}: skipped, but not for applicable's "
                                         f"reason: {rec.get('reason')}")
            elif rec["status"] != "ok" or not rec["cost"]["flops"] > 0:
                raise AssertionError(f"{arch} {sname}: {rec['status']}, {rec.get('cost')}")
            elif rec["kind"] == "decode":
                mem = rec["memory"]
                ran = mem.get("peak_launches", {})
                if (not mem.get("peak_bytes") or not ran.get("int8_matmul")
                        or (cfg.family != "ssm" and not ran.get("decode_attn"))):
                    raise AssertionError(f"{arch} {sname}: peak run {mem}")
            recs.append({k: rec.get(k) for k in ("arch", "shape", "status", "reason",
                                                 "model_flops", "cost", "memory", "reduced",
                                                 "count_s")})
        out[name] = {"records": recs}
        print(f"   dryrun {name}: {len(recs)} records (both runs at once: {secs:.1f} s): "
              + ", ".join(f"{r['arch']}/{r['shape']} {r['status']}"
                          + (f" {r['cost']['flops']:.4g} flops" if r['status'] == 'ok' else '')
                          for r in recs), flush=True)
    return out


def phase_plan(torch, ctx) -> dict:
    """Phase ``plan``: ``Runtime.dmvm_dtype`` on the card
    (:func:`plan_llama`; deepseek's part runs in phase ``families``, where
    its tree lives: :func:`mla_bf16` and its bf16 captured decode step, and
    is gated here to have run), the per-layer cache API against the CPU
    (:func:`kv_api_vs_cpu`), the dry run (:func:`dryrun_cells`) and
    ``examples/quickstart_torch.py`` on the card."""
    t0 = time.perf_counter()
    out = {"llama3-8b": plan_llama(torch)}
    if "plan_deepseek" not in ctx:
        raise AssertionError("plan: deepseek's bf16 MLA step did not run (phase families)")
    out["deepseek-v3-671b"] = ctx["plan_deepseek"]
    out["kv_api"] = kv_api_vs_cpu(torch)
    out["dryrun"] = dryrun_cells(torch)
    root = Path(__file__).resolve().parent
    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, "examples/quickstart_torch.py"], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0 or "generated 16 tokens for 4 requests" not in res.stdout:
        raise AssertionError(f"quickstart_torch.py: exit {res.returncode}: {res.stderr[-2000:]}")
    out["quickstart"] = {"seconds": time.perf_counter() - t1, "stdout": res.stdout}
    print("   quickstart_torch.py on the card: " + " | ".join(
        ln for ln in res.stdout.splitlines() if "TPOT" in ln))
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.core import quant
        from repro_torch.device import set_float32_precision
        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attn as da
        from repro_torch.kernels import int8_matmul as mm
        from repro_torch.kernels import layer_norm as lnk
        from repro_torch.kernels import pim_mvm as pim
        from repro_torch.kernels import rms_norm as rn
        from repro_torch.kernels import verify_attn as va
        from repro_torch.kernels import verify_tree_attn as vt
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card or 'nvidia-smi failed'}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {kind} x {count}", flush=True)

    s = Smoke(torch)
    ctx: dict = {"card": card}
    if not card:
        s.failures.append("nvidia-smi did not report the card")
    s.phase("build", lambda: phase_build(torch, _build))
    if not s.failures:
        s.phase("linears", lambda: phase_linears(torch, mm, pim, quant))
        s.phase("attention", lambda: phase_attention(torch, da, quant))
        s.phase("engine", lambda: phase_engine(torch, ctx))
        if "params" in ctx:
            s.phase("serve", lambda: phase_serve(torch, ctx))
            s.phase("graphs", lambda: phase_graphs(torch, ctx))
            s.phase("verify", lambda: phase_verify(torch, ctx, da, va, vt, quant))
            s.phase("prefix", lambda: phase_prefix(torch, ctx))
            s.phase("server", lambda: phase_server(torch, ctx))
        else:
            s.failures.append("serve: skipped, the engine phase made no params")
        s.phase("ssm", lambda: phase_ssm(torch, ctx, s.record.get("build")))
        mods = {"mm": mm, "pim": pim, "da": da, "va": va, "vt": vt, "quant": quant, "lnk": lnk,
                "rn": rn}
        s.phase("families", lambda: phase_families(torch, ctx, mods))
        s.phase("train", lambda: phase_train(torch, ctx, rn, lnk))
        s.phase("plan", lambda: phase_plan(torch, ctx))

    kernels = []
    lin, att = s.record.get("linears", {}), s.record.get("attention", {})
    ver = s.record.get("verify", {}).get("kernels", {})
    ssm = s.record.get("ssm", {})
    main = ctx.get("main_launches", {})
    grok = s.record.get("families", {}).get("grok-1-314b", {})
    train = s.record.get("train", {})
    for name, src, replaces, rec, launches in (
            ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
             "src/repro/kernels/int8_matmul/kernel.py:45", lin.get("int8_matmul"),
             main.get("int8_matmul")),
            ("int8_matmul_grouped", "src/repro_torch/csrc/int8_matmul_grouped.cu",
             "src/repro/models/moe.py:61 _int8_expert_mm (XLA einsum; no Pallas kernel)",
             grok.get("grouped_b1", {}).get(2), ctx.get("grouped_launches")),
            ("decode_attn", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn/kernel.py:130", att or None,
             main.get("decode_attn")),
            ("pim_mvm", "src/repro_torch/csrc/pim_mvm.cu",
             "src/repro/kernels/pim_mvm/kernel.py:62", lin.get("pim_mvm"),
             ctx.get("pim_launches")),
            ("verify_attn", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn/kernel.py:143", ver.get("verify_attn"),
             ctx.get("verify_attn_launches")),
            ("verify_tree_attn", "src/repro_torch/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn/kernel.py:217", ver.get("verify_tree_attn"),
             ctx.get("verify_tree_attn_launches")),
            ("ssd_chunk", "src/repro_torch/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssm_scan/kernel.py:61", ssm.get("ssd_chunk"),
             ctx.get("ssd_chunk_launches")),
            ("rms_norm", "src/repro_torch/csrc/rms_norm.cu",
             "src/repro/models/layers.py apply_norm (jnp; no Pallas kernel)",
             ssm.get("rms_norm"), ctx.get("rms_norm_launches")),
            ("rms_norm_quant", "src/repro_torch/csrc/rms_norm.cu",
             "src/repro/models/layers.py apply_norm with src/repro/core/quant.py "
             "quantize_activation (jnp; no Pallas kernel)",
             ssm.get("rms_norm", {}).get("quant"), main.get("rms_norm_quant")),
            ("layer_norm", "src/repro_torch/csrc/layer_norm.cu",
             "src/repro/models/layers.py apply_norm, LayerNorm branch (jnp; no Pallas kernel)",
             s.record.get("families", {}).get("layer_norm"), ctx.get("layer_norm_launches")),
            ("layer_norm_quant", "src/repro_torch/csrc/layer_norm.cu",
             "src/repro/models/layers.py apply_norm, LayerNorm branch, with "
             "src/repro/core/quant.py quantize_activation (jnp; no Pallas kernel)",
             s.record.get("families", {}).get("layer_norm", {}).get("quant"),
             ctx.get("layer_norm_quant_launches")),
            ("rms_norm_backward", "src/repro_torch/csrc/rms_norm.cu",
             "src/repro/models/layers.py apply_norm's gradient (XLA autodiff of jnp; "
             "no Pallas kernel)", train.get("rms_norm_backward"),
             ctx.get("rms_norm_backward_launches")),
            ("layer_norm_backward", "src/repro_torch/csrc/layer_norm.cu",
             "src/repro/models/layers.py apply_norm's gradient, LayerNorm branch (XLA "
             "autodiff of jnp; no Pallas kernel)", train.get("layer_norm_backward"),
             ctx.get("layer_norm_backward_launches"))):
        if rec is None or not launches:
            s.failures.append(f"{name}: no measurement or no launch on its path")
            continue
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    seconds = time.perf_counter() - t_start
    s.record.update({"card": card, "kind": kind, "count": count, "seconds": seconds,
                     "failures": s.failures, "kernels": kernels})
    print(f"chip_smoke: {seconds:.1f} s", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(s.record, indent=1, default=str))
    if s.failures:
        print("FAILED:\n  " + "\n  ".join(s.failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
