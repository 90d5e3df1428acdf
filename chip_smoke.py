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
6. ``ssm``: mamba2-2.7b (64 layers, d 2560, 80 SSM heads of 64, state 128,
   vocab 50280) after llama3-8b's parameters are freed.  B6 (``ssd_chunk``)
   against its plain version at full width (Q 128, 37, 1 and 33; B and C
   per group, as the model passes them) with its time,
   bound and ``ptxas`` line, and the RMSNorm kernel's; ``ssd_forward`` over
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
   row-invariant at 1, 4, 20 and 28 rows a call; its time beside
   ``F.layer_norm``), the reduced config on the card against the CPU, the
   phase-4 trace under ``fused_int8``, ``pim_bitserial`` and ``ref_int8``
   (gated token-identical), ``Engine``, ``spec_k = 4`` and ``spec_tree = 6,
   spec_branch = 2`` with the verify window's K/V gated equal to
   sequential decode's in every layer, ``multi_step = 4`` and ``chunk = 32``
   (each lane gated 8 of 8 equal to the plain trace; its ``fused_int8``
   run's LayerNorm launches are what the ``kernels`` line reports), and its
   captured decode step gated bit-equal to eager over 8 steps with its
   replayed wall, device-busy time and idle share; then granite-3-8b and
   phi3-mini-3.8b at full width and depth, each with B1 / B5 / B2-B4 at
   its shapes (phi3's attention at G 32, rep 1, D 96), its reduced config
   on the card against the CPU, served under ``fused_int8``,
   ``pim_bitserial`` and ``ref_int8`` (``pim_bitserial`` gated
   token-identical to ``ref_int8``; where ``fused_int8`` parts from them, a
   single-request rerun must reproduce the fused lane's token at a gap
   smaller than the two lanes' logit rows lie apart, within 10% of the
   logit scale), and its captured decode step against eager.

Every path runs a row-invariant norm kernel for every norm on the card
(``rms_norm``, or ``layer_norm`` for OPT); each serve run's launch counts
include it.

The script prints its seconds; its last three lines are the
``kernels`` JSON, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  The full record goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
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
        print(f"   {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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
    instantiation of the attention body (B2 0, B3 1, B4 2), read from
    ``ptxas -v``; empty when the library was already built."""
    import re
    rows, mask = [], None
    for ln in log.splitlines():
        m = re.search(r"attn_kernelILi(\d)E", ln)
        if m and "Compiling entry" in ln:
            mask = int(m.group(1))
            rows.append({"mask": mask})
            continue
        if mask is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            rows[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m:
            rows[-1].update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    for r in sorted(rows, key=lambda r: r["mask"]):
        print(f"   decode_attn body, mask {r['mask']}: {r.get('registers')} registers, "
              f"{r.get('spill_bytes')} bytes spilled, {r.get('smem_bytes')} bytes shared "
              f"memory a CTA (static), 128 threads, clusters of 8 CTAs")
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
DEVICE_KERNELS = {"int8_matmul": "int8_mm_cluster", "pim_mvm": "pim_mvm_cluster",
                  "decode_attn": "attn_kernel", "verify_attn": "attn_kernel",
                  "verify_tree_attn": "attn_kernel", "ssd_chunk": "ssd_chunk_kernel",
                  "rms_norm": "rms_norm_kernel", "layer_norm": "layer_norm_kernel"}


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
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            for name in hand:
                if name in e.name:
                    hand[name] += 1
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
           "device_events_by_kind": kinds, "hand_kernels": hand,
           "top_kernels": [{"name": n, "count": c, "us": u} for n, (c, u) in
                           sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
           "top_host_ops": [{"name": a.key, "count": a.count,
                             "self_cpu_us": a.self_cpu_time_total} for a in host]}
    print(f"   one {what} step: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {out['idle_share']:.3f}, "
          f"{out['device_kernels']} device events {kinds}")
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


def reduced_vs_cpu(torch, cfg) -> dict:
    """A small input against a reference: the reduced model under
    ``fused_int8`` on the card (kernels) and on the CPU (plain versions),
    prefill plus one decode step from the same weights and prompts, within
    2% of the logit scale, argmax equal."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    rcfg = cfg.reduced()
    rp_cpu = M.init_params(rcfg, seed=0, device="cpu")
    rp_gpu = convert.to_device(rp_cpu, "cuda")
    rq_cpu = quantize_tree(rp_cpu)
    rq_gpu = convert.to_device(rq_cpu, "cuda")
    rprompts = torch.randint(0, rcfg.vocab_size, (2, 24),
                             generator=torch.Generator().manual_seed(3))
    rt = Runtime("fused_int8")
    res, out = {}, {}
    for dev, p, q in (("cpu", rp_cpu, rq_cpu), ("cuda", rp_gpu, rq_gpu)):
        lg0, st = M.prefill(p, rcfg, {"inputs": rprompts.to(dev)}, 64, rt)
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
    print(f"   reduced {cfg.name}, card (kernels) vs CPU (plain): prefill max |diff| "
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


def linears_per_layer(cfg) -> int:
    """W8A8 linears of one layer's step: a mamba2 layer's w_z, w_x and
    out_proj; an attention layer's wq, wk, wv, wo and its MLP's w_up and
    w_down, with w_gate under SwiGLU."""
    if cfg.family == "ssm":
        return 3
    return 4 + (3 if cfg.mlp_type == "swiglu" else 2)


def want_launches(cfg, steps: int, prompt_lens: list[int], attn: str | None,
                  backend: str = "fused_int8", prefills: int | None = None) -> dict:
    """Exact kernel launches of ``steps`` decode (or verify) steps plus one
    prefill per prompt (or ``prefills`` prefill calls: the chunks of a
    chunked admission, an admission again after a preemption): each norm one
    launch of the configuration's norm kernel (two a layer, one for
    ``ln_f``); under ``fused_int8`` an attention layer's step one B1 launch
    a linear (7 for llama's SwiGLU, 6 for OPT's gelu) and one of ``attn``,
    a mamba2 layer's step 3 B1 launches (w_z, w_x, out_proj), and a mamba2
    prefill one B6 launch per layer and 128-token chunk (float weights: no
    B1 in prefill); under ``pim_bitserial`` the same linears launch B5
    instead, and attention runs its plain version."""
    L = cfg.n_layers
    prefills = len(prompt_lens) if prefills is None else prefills
    want = {"int8_matmul": 0, "pim_mvm": 0, "decode_attn": 0, "verify_attn": 0,
            "verify_tree_attn": 0, "ssd_chunk": 0, "rms_norm": 0, "layer_norm": 0}
    want[norm_kernel(cfg)] = (2 * L + 1) * (steps + prefills)
    if backend == "pim_bitserial":
        want["pim_mvm"] = linears_per_layer(cfg) * L * steps
    if backend == "fused_int8":
        want["int8_matmul"] = linears_per_layer(cfg) * L * steps
        if cfg.family == "ssm":
            want["ssd_chunk"] = L * sum(math.ceil(n / 128) for n in prompt_lens)
        else:
            want[attn] = L * steps
    return want


def prefill_calls(cb, reqs) -> int:
    """Prefill calls of a served trace, each one RMSNorm launch a norm: an
    attention stack prefills in pieces of ``PREFILL_PIECE`` rows, once an
    admission and again after each preemption (a chunked admission runs the
    pieces its chunks touch, which the engine counts); an SSM stack once an
    admission."""
    from repro_torch.models import transformer as T
    if cb.chunk:
        return cb.stats["prefill_pieces"]
    return sum((1 + r.n_preemptions) * T.prefill_pieces(cb.cfg, cb._bucket(r.prompt_len))
               for r in reqs)


def serve(torch, cfg, params, lane: dict, attn: str | None,
          backend: str = "fused_int8", request=None) -> tuple:
    """Serve the trace on 4 slots (``max_len`` 256) under ``backend`` with
    the given lane arguments (``request(i)``: request i's extra ``submit``
    arguments), the launch counts reset just before and read just after;
    they must equal :func:`want_launches`.  Every step on the card replays
    a CUDA graph, captured when the engine is built; prefill is eager."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                  rt=Runtime(backend), **lane)
    prompts, budgets = serve_trace(cfg.vocab_size)
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
                         prefill_calls(cb, reqs))
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


def cross_pool(torch, da, va, vt, quant) -> dict:
    """B3's rows and B4's on a chain (T 5, the ``spec_k`` window) in a pool
    of max_len + T - 1 rows against B2 in a pool of max_len rows holding the
    same live K/V, bit for bit (gated), at cursors whose rows cross chunk
    boundaries."""
    g = torch.Generator(device="cuda").manual_seed(6)
    T, out = 5, {}
    for max_len, pos in CROSS_POOL:
        q_q, q_s = window_q(torch, va, g, T)
        cache = kv_pool(torch, quant, g, max_len + T - 1)
        small = tuple(c[:, :max_len].contiguous() for c in cache)
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lengths = (pos_t[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                                 device="cuda")).contiguous()
        b3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
        b4 = vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos_t, chain_anc(torch, ATTN_B, T))
        rows = []
        for t in range(T):
            b2 = da.decode_attn_cuda(q_q[:, :, t].contiguous(), q_s[:, :, t].contiguous(),
                                     *small, lengths[:, t].contiguous())
            rows.append([torch.equal(b3[:, :, t], b2), torch.equal(b4[:, :, t], b2)])
        out[max_len] = {"pos": list(pos), "rows_b3_b4_eq_b2": rows}
        print(f"   across pools (B3 / B4 chain at S {max_len + T - 1}, B2 at S {max_len}), "
              f"cursors {list(pos)}: rows equal {rows}")
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


def row_invariance(torch, cfg, params, B: int, T: int) -> dict:
    """The float stages that a verify step runs over B*T rows and a decode
    step over B, each run on the same random rows once as the verify step
    calls it and T times as the decode step does: how many outputs differ,
    and by how much.  The norm (the configuration's norm kernel, RMSNorm or
    LayerNorm) must differ in none."""
    from repro_torch.core import quant
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
    if out[norm]["differing"]:
        raise AssertionError(f"apply_norm is not row-invariant: {out[norm]}")
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
    out = {"row_invariance": row_invariance(torch, cfg, params, B, T),
           "window_vs_decode": window_vs_decode(torch, M, cfg, q, state, toks, rt)[0]}
    print(f"   full width, verify_step vs sequential decode_step: "
          f"{describe_window(out['window_vs_decode'])}")
    if out["window_vs_decode"]["first_layer_differing"] is not None:
        raise AssertionError("the verify window's K/V entries differ from sequential "
                             "decode's under the row-invariant norm")
    return out


def decode_margin(torch, cfg, params, qparams, prompt: list, prefix: list,
                  toks: tuple, backend: str = "fused_int8") -> dict:
    """The logits that chose output token ``len(prefix)`` of a request in a
    lane, from a single-request rerun of it under ``backend`` (the engine's
    prefill, bucketed to 16 and masked to the prompt, or at exact length for
    an SSM, then ``prefix`` fed back one decode step at a time; every stage
    but the ``lm_head`` and an SSM's float projections is row-invariant, so
    these are the lane's logits up to its last bits): the two candidate
    tokens' logits, their gap, the gap between the best two, and the row."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    rt = Runtime(backend)
    if cfg.family == "ssm":
        padded, batch = prompt, {}
    else:
        padded = prompt + [0] * (-len(prompt) % 16)
        batch = {"lengths": torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")}
    lg, st = M.prefill(params, cfg, dict(batch, inputs=torch.tensor([padded], device="cuda")),
                       len(padded) + len(prefix) + 1, rt)
    for tok in prefix:
        lg, st = M.decode_step(qparams, cfg, st, torch.tensor([tok], dtype=torch.int32,
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


def ragged_pool(torch, cfg, params, rows: int, max_len: int, seed: int = 4) -> dict:
    """A pool of ``len(RAGGED_LENS)`` slots and ``rows`` rows, each slot
    prefilled (full width, ``fused_int8``) with its own random prompt."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime

    state = M.init_decode_state(cfg, len(RAGGED_LENS), rows, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    for slot, n in enumerate(RAGGED_LENS):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda")
        _, one = M.prefill(params, cfg, {"inputs": toks}, max_len, Runtime("fused_int8"))
        T.write_slot(state, slot, one)
    return state


def same_state(torch, a: dict, b: dict) -> list[str]:
    """Names of the state tensors that differ (``L<i>.<leaf>``, ``pos``)."""
    bad = [f"L{i}.{k}" for i, (la, lb) in enumerate(zip(a["layers"], b["layers"]))
           for k in la if not torch.equal(la[k], lb[k])]
    return bad + ([] if torch.equal(a["pos"], b["pos"]) else ["pos"])


def replay_vs_eager(torch, cfg, qparams, state: dict, kind: str, width: int = 0) -> dict:
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
    credited with."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import graphs as G
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime

    rt = Runtime("fused_int8")
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
    per = want_launches(cfg, width if kind == "multi" else 1, [], attn, prefills=0)
    want = {k: v for k, v in want_launches(cfg, 1, [], attn, prefills=0).items() if v}
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
    # the profiler may miss device records, never add one, and a replay runs
    # the same nodes every time: one profiled replay whose hand-kernel events
    # equal the credits shows the graph runs the kernels it is credited
    # with.  Late in this long process a profile of mamba2's replay missed
    # 5 of its 4,615 records in every try, while a fresh process missed
    # none, so the last resort is a fresh process's profile of the same step
    credited, rec["profile_tries"] = device_launches(per), []
    for _ in range(PROFILE_TRIES):
        rec["profile"] = profile_step(torch, call, f"replayed {kind}")
        ran = rec["profile"]["hand_kernels"]
        rec["profile_tries"].append(ran)
        if any(ran[k] > credited[k] for k in ran):
            raise AssertionError(f"{kind}: the profiled replay ran {ran} hand-kernel "
                                 f"events, more than the credited {credited}")
        if ran == credited:
            break
    else:
        torch.cuda.empty_cache()        # the child needs the card's memory
        ran = profile_in_child(cfg, kind, width)
        rec["profile_tries"].append({"fresh_process": ran})
        if ran != credited:
            raise AssertionError(f"{kind}: {PROFILE_TRIES} profiled replays and one in a "
                                 f"fresh process ran {rec['profile_tries']} hand-kernel "
                                 f"events, credited {credited}")
    print(f"   {kind}: the profiled replay ran the credited kernels {ran} "
          f"(profile {len(rec['profile_tries'])} of at most {PROFILE_TRIES + 1})")
    return rec, steps, replay


def replay_profile_child(arch: str, kind: str, width: int, n_layers: int) -> dict:
    """The hand-kernel events of one profiled replay of ``kind`` at
    ``width`` (as in :func:`replay_vs_eager`) of ``arch`` at full width and
    ``n_layers`` layers on a fresh 4-slot pool at ragged cursors; run by
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
                        f"replayed {kind} (fresh process)")["hand_kernels"]


def profile_in_child(cfg, kind: str, width: int) -> dict:
    """:func:`replay_profile_child` in a fresh Python process (waited for,
    killed at its time limit); a child that fails fails the caller."""
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
    print(f"   {kind}: a fresh process's profiled replay ran {line[6:]}")
    return json.loads(line[6:])


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
# phase 6: the SSM slice (mamba2-2.7b, B6)
# ---------------------------------------------------------------------------
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE = 80, 64, 128     # mamba2-2.7b at full width
SSD_GROUPS = 1                                       # mamba2-2.7b: one B/C group
# (N, Q): a whole chunk, a prompt, a token, an odd chunk
SSD_SHAPES = ((4, 128), (1, 37), (2, 1), (2, 33))


def ssd_inputs(torch, g, N: int, Q: int) -> tuple:
    """B6's operands at full width, drawn as the reference's kernel test
    draws them (``tests/test_kernels_ssm.py``), with B and C per group as
    the model's kernel route passes them."""
    H, dh, S, G = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_GROUPS

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return (normal(N, Q, H, dh), normal(N, Q, G, S) * 0.5, normal(N, Q, G, S) * 0.5,
            torch.nn.functional.softplus(normal(N, Q, H)), -torch.exp(normal(H) * 0.3),
            torch.ones(H, device="cuda"), normal(N, H, dh, S) * 0.1)


def ssd_work(N: int, Q: int, G: int) -> tuple[int, int, int]:
    """Bytes B6 must move (each input read once, each output written once,
    B and C per group of G) and its operations on these inputs: the four
    products (the scores C.B once per group over the causal triangle
    k <= q; per head the scores times x*dt over the same triangle, C*exp(cs)
    times h_in, and the chunk state from B*decay and x*dt) and the
    elementwise f32 terms (the decay scale over the triangle, C*exp(cs),
    B*decay, x*dt, the skip D*x and the sums)."""
    H, dh, S = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE
    n_bytes = 4 * (2 * N * Q * H * dh + 2 * N * Q * G * S + N * Q * H + 2 * H
                   + 2 * N * H * dh * S + N * H)
    tri = Q * (Q + 1) // 2
    products = N * (G * tri * 2 * S + H * (tri * 2 * dh + 2 * Q * S * 2 * dh))
    elementwise = N * H * (tri + 2 * Q * S + 4 * Q * dh)
    return n_bytes, products, elementwise


def ssd_bound(N: int, Q: int) -> tuple[float, str]:
    """B6's bound as it is called: B and C per group, the products at the
    TF32 tensor rate three times over (3xTF32: hi*hi, hi*lo, lo*hi), the
    elementwise terms at the f32 rate."""
    n_bytes, products, elementwise = ssd_work(N, Q, SSD_GROUPS)
    return bound_ms(n_bytes, [(3 * products, TF32_FLOPS_PER_S),
                              (elementwise, FP32_FLOPS_PER_S)])


def ssd_bound_per_head(N: int, Q: int) -> tuple[float, str]:
    """The per-head count, kept beside it for comparison with the kernel's
    first design: B and C read for each head and every operation at the
    f32 rate outside the tensor cores."""
    n_bytes, products, elementwise = ssd_work(N, Q, SSD_HEADS)
    return bound_ms(n_bytes, [(products + elementwise, FP32_FLOPS_PER_S)])


def ssd_kernel_checks(torch, ssd) -> dict:
    """B6 against its plain version at N 4 / Q 128, N 1 / Q 37, N 2 / Q 1
    and N 2 / Q 33 (80 heads of 64 in one group, state 128): y and the
    chunk state within rtol 2e-4
    / atol 2e-5, the decay within rtol 1e-5; device time (graph replay),
    eager time, the plain version's time and the bound at each shape."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for N, Q in SSD_SHAPES:
        args = ssd_inputs(torch, g, N, Q)
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
        n_bytes, products, elementwise = ssd_work(N, Q, SSD_GROUPS)
        sets = copies(torch, lambda: ssd_inputs(torch, g, N, Q), n_bytes)
        n = len(sets)
        tk = timed(torch, lambda i: ssd.ssd_chunk_cuda(*sets[i % n]), 20)
        tp = timed(torch, lambda i: ssd.ssd_chunk_plain(*sets[i % n]), 5)
        b, b_head = ssd_bound(N, Q), ssd_bound_per_head(N, Q)
        out[f"N{N}_Q{Q}"] = {"N": N, "Q": Q, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                             "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
                             "bound_ms": b[0], "bound_by": b[1], "bytes": n_bytes,
                             "product_flops": products, "elementwise_flops": elementwise,
                             "bound_ms_per_head": b_head[0], "bound_by_per_head": b_head[1],
                             "max_abs_err": max(errs), "max_abs_err_y_state_decay": errs}
        print(f"   B6 N={N} Q={Q:3d} H={SSD_HEADS} dh={SSD_HEAD_DIM} S={SSD_STATE}: "
              f"{tk['device_ms'] * 1e3:.1f} us device / {tk['eager_ms'] * 1e3:.1f} eager "
              f"(bound {b[0] * 1e3:.2f} by {b[1]}: {n_bytes / 1e6:.1f} MB, "
              f"{products / 1e9:.3f} GFLOP of products as 3xTF32, {elementwise / 1e9:.4f} "
              f"GFLOP f32; per-head bound {b_head[0] * 1e3:.2f} by {b_head[1]}; plain "
              f"{tp['device_ms'] * 1e3:.1f}); max |err| y {errs[0]:.3g}, state "
              f"{errs[1]:.3g}, decay {errs[2]:.3g}")
        del sets
    head = out["N4_Q128"]
    # no single PyTorch call computes the masked-decay chunk (scores, decay
    # mask, state and decay together), so there is no library yardstick
    return dict(head, library_ms=None, shapes=out)


def rms_norm_checks(torch, rn) -> dict:
    """The RMSNorm kernel: within rtol 1e-6 of the plain version and
    row-invariant bit for bit (M 4 and 20 against 124) at d 2560, 4096 and
    5120; times at the mamba2 decode step's shapes [4, 2560] and [4, 5120]
    beside the plain version's and ``torch.nn.functional.rms_norm``'s (a
    yardstick only)."""
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
    for d in (2560, 5120):
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
    return dict(out["shapes"][5120], shapes=out["shapes"], row_invariant=True)


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
    reruns (:func:`decode_margin`): each lane's gap between the two
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
                                  (a[d], b[d]), k) for k in ("fused_int8", "ref_int8")}
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
                                                    pool, "decode")
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
# and phi3-mini-3.8b at full width
# ---------------------------------------------------------------------------
OPT_LAYERS = 16      # of OPT-30B's 48: 118 GB of f32 weights do not fit one card
OPT_ATTN = (4, 56, 1, 128)         # 4 slots, 56 heads of 128, MHA (rep 1)
PHI3_ATTN = (4, 32, 1, 96)         # 4 slots, 32 heads of 96, MHA
FAMILY_B2 = (512, (1, 200, 377, 512))
# B3 (spec_k 4) and B4 (spec_tree 6) windows in their lanes' pools of
# 512 + T - 1 rows, the last cursor a slot at 511
FAMILY_VERIFY = (("verify_attn", 5, 512, (3, 150, 377, 511)),
                 ("verify_tree_attn", 7, 512, (3, 150, 377, 511)))
LN_ROWS = 140        # 1, 4, 20 and 28 rows a call divide it


def layer_shapes(cfg) -> dict:
    """{(K, N): count} of one attention layer's W8A8 linears: wq, wk, wv,
    wo, w_up, w_down and, under SwiGLU, w_gate (llama3-8b's are
    ``LINEAR_SHAPES``)."""
    d, hd = cfg.d_model, cfg.head_dim
    kns = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d), (d, cfg.d_ff), (cfg.d_ff, d)]
    if cfg.mlp_type == "swiglu":
        kns.append((d, cfg.d_ff))
    shapes: dict = {}
    for kn in kns:
        shapes[kn] = shapes.get(kn, 0) + 1
    return shapes


def layer_norm_checks(torch, lnk) -> dict:
    """The LayerNorm kernel: within rtol 1e-6 of the plain version (atol
    1e-6 of the output's scale: an output near zero is the difference of
    two rounded terms) and row-invariant bit for bit (each row the same
    bits at 1, 4, 20 and 28 rows a call as at 140) at OPT-30B's d 7168 and
    opt-125m's 768; time at the OPT-30B decode step's shape [4, 7168] beside
    the plain version's and ``torch.nn.functional.layer_norm``'s (a
    yardstick only)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(10)

    def inputs(M, d):
        return (torch.randn((M, d), generator=g, device="cuda") * 3 + 0.5,
                torch.randn((d,), generator=g, device="cuda"),
                torch.randn((d,), generator=g, device="cuda"))
    out = {"row_invariant": {}}
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
    M, d = 4, 7168
    x, scale, bias = inputs(M, d)
    err = float((lnk.layer_norm_cuda(x, scale, bias)
                 - lnk.layer_norm_plain(x, scale, bias)).abs().max())
    # warm inputs: on the decode path the previous op has just written x
    tk = timed(torch, lambda i: lnk.layer_norm_cuda(x, scale, bias), 200)
    tp = timed(torch, lambda i: lnk.layer_norm_plain(x, scale, bias), 200)
    lib = graph_ms(torch, lambda i: F.layer_norm(x, (d,), scale, bias, 1e-5), 200)
    b = bound_ms(4 * (2 * M * d + 2 * d), [(8 * M * d, FP32_FLOPS_PER_S)])
    out.update({"M": M, "d": d, "ms": tk["device_ms"], "eager_ms": tk["eager_ms"],
                "plain_ms": tp["device_ms"], "plain_eager_ms": tp["eager_ms"],
                "library_ms": lib, "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err})
    print(f"   layer_norm [{M}, {d}]: {tk['device_ms'] * 1e3:.2f} us device / "
          f"{tk['eager_ms'] * 1e3:.2f} eager (bound {b[0] * 1e3:.3f}, plain "
          f"{tp['device_ms'] * 1e3:.2f} / {tp['eager_ms'] * 1e3:.2f} eager, F.layer_norm "
          f"{lib * 1e3:.2f}); max |err| {err:.3g}; row-invariant at M 1, 4, 20, 28, "
          f"{LN_ROWS} for d 768, 7168")
    return out


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


def same_streams(outs: dict, want: list) -> dict:
    """Per lane, the requests whose tokens equal ``want``'s, and where each
    other one first parts from it."""
    return {k: {"same": sum(a == b for a, b in zip(v, want)),
                "first_divergence": [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                                          None) for a, b in zip(v, want)]}
            for k, v in outs.items()}


def serve_family(torch, ctx, cfg, lanes: bool) -> dict:
    """One family at full width (random f32 weights, seed 0) on the card:
    the phase-4 trace under ``fused_int8``, ``pim_bitserial`` and
    ``ref_int8``, every run with exact launch counts.  ``pim_bitserial``
    must equal ``ref_int8`` token for token (B5's sums are the plain int32
    sums and both run the plain attention).  With ``lanes`` (OPT-30B)
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
    The ``ref_int8`` rerun is recorded, not gated: the plain attention's
    P.V sums in an order set by the pool's size, which the rerun's smaller
    pool changes.  With ``lanes`` also ``Engine`` (4 prompts of 64
    tokens, 16 steps), ``spec_k = 4`` and ``spec_tree = 6, spec_branch =
    2`` (each gated 8 of 8 equal to the plain lane), the verify window's
    K/V against sequential decode's (gated equal in every layer), and
    ``multi_step = 4`` and ``chunk = 32`` (gated token-identical to the
    plain trace); then the captured decode step against eager over 8 steps
    (gated bit-equal, exact launch counts, a profiled replay's kernels equal
    to its credits), whose profile gives the replayed step's wall,
    device-busy time and idle share at 4 slots."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.quantize import quantize_tree

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"n_layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
           "f32_weight_bytes": sum(t.numel() * 4 for lp in params["layers"]
                                   for t in (lp["attn"] | lp["mlp"]).values())}
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    for backend in ("fused_int8", "pim_bitserial", "ref_int8"):
        cb, reqs, wall, counts = serve(torch, cfg, params, {},
                                       "decode_attn" if backend == "fused_int8" else None,
                                       backend)
        outs[backend] = [list(r.output) for r in reqs]
        out[backend] = dict(serve_record(reqs, wall, cfg), stats=dict(cb.stats),
                            launches=counts, max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"   {cfg.name} {backend}: served {out[backend]['tokens_served']} tokens in "
              f"{wall:.2f} s ({out[backend]['tokens_per_s']:.1f} tokens/s), "
              f"{cb.stats['decode_steps']} decode steps, launches {counts}, peak "
              f"{out[backend]['max_memory_allocated'] / 1e9:.1f} GB")
        del cb, reqs
        torch.cuda.empty_cache()
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
        margins = divergence_margins(torch, cfg, params, outs)
        out["divergence_margins"] = margins
        far = [m["rid"] for m in margins if not m["fused_reproduced"]
               or abs(m["fused_gap"]) > m["lanes_max_abs_diff"]
               or m["lanes_max_abs_diff"] > 0.1 * m["logit_scale"]]
        if lanes or far:
            raise AssertionError(f"{cfg.name}: fused_int8 parts from ref_int8 "
                                 f"{out['backends_vs_fused_int8']['ref_int8']}; "
                                 f"unexplained: {far}")
    if lanes:
        eng = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=128)
        g = torch.Generator(device="cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
        eng.generate({"inputs": prompts}, steps=1)                # warm-up
        reset_launch_counts()
        toks, tm = eng.generate({"inputs": prompts}, steps=16)
        counts = launch_counts()
        want = want_launches(cfg, 16, [64], "decode_attn",
                             prefills=T.prefill_pieces(cfg, 64))
        if counts != want or tuple(toks.shape) != (4, 16):
            raise AssertionError(f"{cfg.name} Engine: launch counts {counts} != {want}")
        out["engine"] = {"prefill_s": tm["prefill_s"], "tpot_s": tm["tpot_s"],
                         "launches": counts}
        print(f"   {cfg.name} Engine: prefill {tm['prefill_s'] * 1e3:.1f} ms, TPOT "
              f"{tm['tpot_s'] * 1e3:.2f} ms, launches {counts}")
        qparams = eng.qparams
        del eng
        _, state = M.prefill(params, cfg, {"inputs": prompts}, 128, Runtime("fused_int8"))
        win = torch.randint(0, cfg.vocab_size, (4, 5), generator=g, device="cuda",
                            dtype=torch.int32)
        out["full_width_parity"] = full_width_parity(torch, params, cfg, qparams, state, win)
        del state, qparams
        torch.cuda.empty_cache()
        lane_runs = {"spec_k": ({"spec_k": 4}, "verify_attn"),
                     "spec_tree": ({"spec_tree": 6, "spec_branch": 2}, "verify_tree_attn"),
                     "multi_step_4": ({"multi_step": 4}, "decode_attn"),
                     "chunk_32_fifo": ({"chunk": 32}, "decode_attn")}
        lane_outs = {}
        for label, (lane, attn) in lane_runs.items():
            cb, reqs, wall, counts = serve(torch, cfg, params, lane, attn)
            lane_outs[label] = [list(r.output) for r in reqs]
            st = cb.stats
            rec = dict(serve_record(reqs, wall, cfg), stats=dict(st), launches=counts)
            if "spec" in label:
                rec["acceptance_rate"] = cb.acceptance_rate
                rec["tokens_per_verify_step"] = ((rec["tokens_served"] - len(reqs))
                                                 / st["verify_steps"])
            out[label] = rec
            print(f"   {cfg.name} {label}: served {rec['tokens_served']} tokens in {wall:.2f} s, "
                  f"{st['decode_steps']} steps ({st['verify_steps']} verify, "
                  f"{st['multi_blocks']} fused blocks, {st['chunks']} chunks), launches {counts}")
            del cb, reqs
            torch.cuda.empty_cache()
        out["lanes_vs_plain"] = same_streams(lane_outs, plain)
        print(f"   {cfg.name}: requests equal to the plain trace "
              f"{ {k: v['same'] for k, v in out['lanes_vs_plain'].items()} } of {len(plain)}")
        if any(v["same"] != len(plain) for v in out["lanes_vs_plain"].values()):
            raise AssertionError(f"{cfg.name}: a lane parts from the plain trace: "
                                 f"{out['lanes_vs_plain']}")
    # the captured decode step: the float weights go first, so that a
    # fresh-process profile (the last resort of replay_vs_eager) has room
    pool = ragged_pool(torch, cfg, params, 256, 256)
    qparams = quantize_tree(params)
    del params
    torch.cuda.empty_cache()
    out["graph_decode"], steps, _ = replay_vs_eager(torch, cfg, qparams, pool, "decode")
    prof = out["graph_decode"]["profile"]
    print(f"   {cfg.name}: replayed decode step at 4 slots: wall {prof['wall_us'] / 1e3:.2f} ms, "
          f"device busy {prof['device_busy_us'] / 1e3:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    del pool, steps, qparams
    torch.cuda.empty_cache()
    return out


def phase_families(torch, ctx, mods: dict) -> dict:
    """OPT-30B at full width with 16 of its 48 layers (free of llama's and
    mamba2's weights): its kernels at its shapes, the LayerNorm kernel, the
    reduced model on the card against the CPU, and its serve runs
    (:func:`serve_family` with every lane); then granite-3-8b and
    phi3-mini-3.8b at full width and depth, each with its kernels at its
    shapes (phi3's attention at D 96), its reduced config against the CPU,
    and its serve runs under the three backends with its captured decode
    step."""
    import dataclasses
    import gc

    from repro_torch.configs import registry

    ctx.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    opt = dataclasses.replace(registry.get("opt-30b"), n_layers=OPT_LAYERS)
    out = {"layer_norm": layer_norm_checks(torch, mods["lnk"])}
    rec = {"kernels": family_kernels(torch, mods, opt, OPT_ATTN)}
    rec.update(reduced_vs_cpu(torch, registry.get("opt-30b")))
    rec.update(serve_family(torch, ctx, opt, lanes=True))
    ctx["layer_norm_launches"] = rec["fused_int8"]["launches"]["layer_norm"]
    out["opt-30b"] = rec
    # granite-3-8b's attention has llama3-8b's shape: 8 groups of 4 heads of 128
    for arch, attn in (("granite-3-8b", LLAMA_ATTN), ("phi3-mini-3.8b", PHI3_ATTN)):
        cfg = registry.get(arch)
        rec = {"kernels": family_kernels(torch, mods, cfg, attn)}
        rec.update(reduced_vs_cpu(torch, cfg))
        rec.update(serve_family(torch, ctx, cfg, lanes=False))
        out[arch] = rec
        gc.collect()
        torch.cuda.empty_cache()
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
    ctx: dict = {}
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
        else:
            s.failures.append("serve: skipped, the engine phase made no params")
        s.phase("ssm", lambda: phase_ssm(torch, ctx, s.record.get("build")))
        mods = {"mm": mm, "pim": pim, "da": da, "va": va, "vt": vt, "quant": quant, "lnk": lnk}
        s.phase("families", lambda: phase_families(torch, ctx, mods))

    kernels = []
    lin, att = s.record.get("linears", {}), s.record.get("attention", {})
    ver = s.record.get("verify", {}).get("kernels", {})
    ssm = s.record.get("ssm", {})
    main = ctx.get("main_launches", {})
    for name, src, replaces, rec, launches in (
            ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
             "src/repro/kernels/int8_matmul/kernel.py:45", lin.get("int8_matmul"),
             main.get("int8_matmul")),
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
            ("layer_norm", "src/repro_torch/csrc/layer_norm.cu",
             "src/repro/models/layers.py apply_norm, LayerNorm branch (jnp; no Pallas kernel)",
             s.record.get("families", {}).get("layer_norm"), ctx.get("layer_norm_launches"))):
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
