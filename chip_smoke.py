#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases (any failure makes the script exit non-zero):

1. card and build: the card's name and power limit, and ``nvcc -Xptxas -v``
   (registers, shared memory, spills) for every kernel in ``csrc/``, all
   compiled at once;
2. kernel parity and timing at full llama3-8b width: each kernel against its
   plain PyTorch version on the card (B1/B5 bit-exact, B2 within
   rtol=3e-5, atol=3e-6), B5's int32 sums against B1's, CUDA-event times
   beside the plain version's, a library call's where one computes the same
   function, and the bound (the larger of bytes / 3.35 TB/s and operations
   / the type's peak);
3. ``Engine`` at full width (llama3-8b, random f32 weights from a seeded
   ``torch.Generator``) under ``fused_int8``: 4 prompts of 64 tokens, 16
   greedy steps, with the launch counts that show B1 and B2 ran; one decode
   step from one state under ``fused_int8``, ``pim_bitserial`` (B5) and
   ``ref_int8`` (plain); and the reduced config on the card against the
   same model on the CPU (plain versions);
4. ``ContinuousBatchingEngine`` at full width: 8 ragged requests on 4 slots,
   greedy FIFO — the main path, whose launch counts the ``kernels`` line
   reports (B5's come from its ``pim_bitserial`` step).

The last three lines are the ``kernels`` JSON, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  The full record goes to
``--out``.
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
    return out


LINEAR_SHAPES = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}


def phase_linears(torch, mm, pim, quant) -> dict:
    """B1 and B5 at M = 4 over one layer's linears (wq, wo: 4096x4096;
    wk, wv: 4096x1024; w_up, w_gate: 4096x14336; w_down: 14336x4096)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    M = 4
    res = {"shapes": [], "int8_matmul": {}, "pim_mvm": {}}
    for (K, N), count in LINEAR_SHAPES.items():
        def make():
            return (torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8),
                    torch.rand((M, 1), generator=g, device="cuda") * 0.01 + 1e-3,
                    torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8),
                    torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3)
        x_q, x_s, w_q, w_s = make()
        out_k, acc_k = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
        out_p, acc_p = mm.int8_matmul_plain(x_q, x_s, w_q, w_s)
        w_hi, w_lo = quant.pack_qlc(w_q)
        out5, acc5 = pim.pim_mvm_cuda(x_q, x_s, w_hi, w_lo, w_s)
        out5p, acc5p = pim.pim_mvm_plain(x_q, x_s, w_hi, w_lo, w_s)
        torch.cuda.synchronize()
        checks = {"b1_acc_eq_plain": torch.equal(acc_k, acc_p),
                  "b1_out_eq_plain": torch.equal(out_k, out_p),
                  "b5_acc_eq_b1": torch.equal(acc5, acc_k),
                  "b5_acc_eq_plain": torch.equal(acc5p, acc_k),
                  "b5_out_eq_b1": torch.equal(out5, out_k)}
        err1 = float((out_k - out_p).abs().max())
        err5 = float((out5 - out5p).abs().max())
        if not all(checks.values()):
            raise AssertionError(f"K={K} N={N}: {checks}")

        sets = copies(torch, make, K * N)
        packed = [quant.pack_qlc(s[2]) for s in sets]
        n = len(sets)

        def b5(fn):
            return lambda i: fn(sets[i % n][0], sets[i % n][1], *packed[i % n], sets[i % n][3])
        t_b1 = timed(torch, lambda i: mm.int8_matmul_cuda(*sets[i % n]), 50)
        t_b1p = timed(torch, lambda i: mm.int8_matmul_plain(*sets[i % n]), 5)
        t_b5 = timed(torch, b5(pim.pim_mvm_cuda), 10)
        t_b5p = timed(torch, b5(pim.pim_mvm_plain), 3)
        try:        # the library int8 GEMM, timed as a yardstick only
            t_lib = timed(torch, lambda i: torch._int_mm(sets[i % n][0], sets[i % n][2]), 50)
        except RuntimeError as e:
            t_lib = None
            lib_note = str(e).splitlines()[0][:120]
        else:
            lib_note = "torch._int_mm (int32 product, no epilogue)"
        io = M * K + 4 * M + 4 * N + 4 * M * N
        b1_bound = bound_ms(io + K * N, [(2 * M * K * N, INT8_OPS_PER_S)])
        b5_bound = bound_ms(io + 2 * K * N, [(32 * M * K * N, INT8_OPS_PER_S)])
        row = {"K": K, "N": N, "count_per_layer": count, "checks": checks,
               "b1_bound_by": b1_bound[1], "b5_bound_by": b5_bound[1],
               "b1_ms": t_b1["device_ms"], "b1_plain_ms": t_b1p["device_ms"],
               "b1_bound_ms": b1_bound[0], "b1_eager_ms": t_b1["eager_ms"],
               "b5_ms": t_b5["device_ms"], "b5_plain_ms": t_b5p["device_ms"],
               "b5_bound_ms": b5_bound[0], "b5_eager_ms": t_b5["eager_ms"],
               "library_ms": t_lib and t_lib["device_ms"], "library": lib_note,
               "b1_max_abs_err": err1, "b5_max_abs_err": err5}
        res["shapes"].append(row)
        lib_us = "n/a" if t_lib is None else f"{t_lib['device_ms'] * 1e3:.1f}"
        print(f"   M={M} K={K:5d} N={N:5d} (us, device / eager): B1 "
              f"{row['b1_ms'] * 1e3:.1f} / {row['b1_eager_ms'] * 1e3:.1f} (bound "
              f"{b1_bound[0] * 1e3:.1f}, plain {row['b1_plain_ms'] * 1e3:.1f}, "
              f"library {lib_us})  B5 {row['b5_ms'] * 1e3:.1f} / "
              f"{row['b5_eager_ms'] * 1e3:.1f} (bound {b5_bound[0] * 1e3:.1f}, plain "
              f"{row['b5_plain_ms'] * 1e3:.1f})  {checks}")
        del sets, packed
    for key, prefix in (("int8_matmul", "b1"), ("pim_mvm", "b5")):
        rows = res["shapes"]
        lib = [r["library_ms"] for r in rows]
        res[key] = {
            "ms": sum(r[f"{prefix}_ms"] * r["count_per_layer"] for r in rows),
            "plain_ms": sum(r[f"{prefix}_plain_ms"] * r["count_per_layer"] for r in rows),
            "bound_ms": sum(r[f"{prefix}_bound_ms"] * r["count_per_layer"] for r in rows),
            "library_ms": (None if key == "pim_mvm" or None in lib else
                           sum(r["library_ms"] * r["count_per_layer"] for r in rows)),
            "max_abs_err": max(r[f"{prefix}_max_abs_err"] for r in rows),
            "bound_by": max(rows, key=lambda r: r[f"{prefix}_bound_ms"] * r["count_per_layer"])[
                f"{prefix}_bound_by"]}
    return res


def phase_attention(torch, da, quant) -> dict:
    """B2 at B = 4, G = 8, rep = 4, D = 128, S = 512, ragged lengths."""
    g = torch.Generator(device="cuda").manual_seed(2)
    B, G, rep, D, S = 4, 8, 4, 128, 512
    lengths = torch.tensor([1, 200, 377, S], dtype=torch.int32, device="cuda")

    def make():
        q = torch.randn((B, G * rep, D), generator=g, device="cuda")
        q_q, q_s = quant.quantize_kv(q)
        k_q, k_s = quant.quantize_kv(torch.randn((B, S, G, D), generator=g, device="cuda"))
        v_q, v_s = quant.quantize_kv(torch.randn((B, S, G, D), generator=g, device="cuda"))
        return (q_q.reshape(B, G, rep, D), q_s.reshape(B, G, rep, 1),
                k_q, k_s[..., 0].contiguous(), v_q, v_s[..., 0].contiguous(), lengths)
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


def profile_step(torch, fn) -> dict:
    """Where one full-width decode step's time goes: its wall time (host
    clock, ended by a synchronize), the device's busy time (the sum of the
    kernels' own durations under ``torch.profiler``), the idle share, and
    the kernels and host ops that take the most."""
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
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    busy = sum(v[1] for v in kernels.values())
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    out = {"wall_us": wall_us, "device_busy_us": busy,
           "idle_share": max(0.0, 1 - busy / wall_us),
           "top_kernels": [{"name": n, "count": c, "us": u} for n, (c, u) in
                           sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
           "top_host_ops": [{"name": a.key, "count": a.count,
                             "self_cpu_us": a.self_cpu_time_total} for a in host]}
    print(f"   one decode step: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {out['idle_share']:.3f}")
    for k in out["top_kernels"]:
        print(f"     kernel {k['name']:60s} x{k['count']:4d} {k['us']:9.1f} us")
    for h in out["top_host_ops"]:
        print(f"     host   {h['name'][:60]:60s} x{h['count']:4d} {h['self_cpu_us']:9.1f} us")
    return out


def clone_state(state: dict) -> dict:
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
            "pos": state["pos"].clone()}


def phase_engine(torch, ctx) -> dict:
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
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
    want = {"int8_matmul": 7 * cfg.n_layers * steps,
            "decode_attn": cfg.n_layers * steps, "pim_mvm": 0}
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
    if step["pim_bitserial"][1] != {"int8_matmul": 0, "decode_attn": 0,
                                    "pim_mvm": 7 * cfg.n_layers}:
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
    del eng, state, step, lf, lp, lr
    torch.cuda.empty_cache()

    # small input against a reference: the reduced model on the card
    # (kernels) and on the CPU (plain versions), prefill plus one decode step
    # from the same weights and prompts
    rcfg = cfg.reduced()
    rp_cpu = M.init_params(rcfg, seed=0, device="cpu")
    rp_gpu = convert.to_device(rp_cpu, "cuda")
    rq_cpu = quantize_tree(rp_cpu)
    rq_gpu = convert.to_device(rq_cpu, "cuda")
    rprompts = torch.randint(0, rcfg.vocab_size, (2, 24),
                             generator=torch.Generator().manual_seed(3))
    rt = Runtime("fused_int8")
    res = {}
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
    print(f"   reduced llama3-8b, card (kernels) vs CPU (plain): prefill max |diff| "
          f"{out['reduced_prefill_max_abs']:.3g}, decode {out['reduced_decode_max_abs']:.3g}, "
          f"argmax equal")
    return out


def phase_serve(torch, ctx) -> dict:
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cfg = registry.get("llama3-8b")
    cb = ContinuousBatchingEngine(cfg, ctx["params"], n_slots=4, max_len=256,
                                  rt=Runtime("fused_int8"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 201))).tolist()
               for _ in range(8)]
    budgets = [int(rng.integers(8, 33)) for _ in range(8)]
    torch.cuda.synchronize()
    cb.reset_clock()
    reset_launch_counts()                      # the main path's run starts here
    t0 = time.perf_counter()
    reqs = [cb.submit(p, b) for p, b in zip(prompts, budgets)]
    cb.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()                   # ... and ends here
    ctx["main_launches"] = counts
    steps = cb.stats["decode_steps"]
    want = {"int8_matmul": 7 * cfg.n_layers * steps,
            "decode_attn": cfg.n_layers * steps, "pim_mvm": 0}
    if counts != want or steps < 1:
        raise AssertionError(f"launch counts {counts} != {want}")
    per = []
    for r in reqs:
        if r.error is not None or len(r.output) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: error {r.error}, {len(r.output)} tokens")
        if min(r.output) < 0 or max(r.output) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid}: token out of range")
        per.append({"rid": r.rid, "prompt": r.prompt_len, "tokens": len(r.output),
                    "ttft_s": r.first_token_time - r.arrival_time,
                    "latency_s": r.finish_time - r.arrival_time})
        print(f"   req {r.rid}: prompt {r.prompt_len:3d} -> {len(r.output):2d} tokens, "
              f"TTFT {per[-1]['ttft_s'] * 1e3:7.1f} ms, latency {per[-1]['latency_s']:.3f} s")
    served = sum(p["tokens"] for p in per)
    print(f"   served {served} tokens in {wall:.2f} s; stats {cb.stats}; launches {counts}")
    return {"wall_s": wall, "tokens_served": served, "requests": per,
            "stats": dict(cb.stats), "launches": counts}


def main() -> int:
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
        from repro_torch.kernels import pim_mvm as pim
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
        else:
            s.failures.append("serve: skipped, the engine phase made no params")

    kernels = []
    lin, att = s.record.get("linears", {}), s.record.get("attention", {})
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
             ctx.get("pim_launches"))):
        if rec is None or not launches:
            s.failures.append(f"{name}: no measurement or no launch on its path")
            continue
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    s.record.update({"card": card, "kind": kind, "count": count,
                     "failures": s.failures, "kernels": kernels})
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
