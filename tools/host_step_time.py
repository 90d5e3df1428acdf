"""Host and device time of the port's serve steps on the card, eager against
replayed from a CUDA graph, to compare two trees of the repo in one run.

    python3 tools/host_step_time.py --src <tree>/src --label <name> --out <file.json>

``--src`` picks the tree whose ``repro_torch`` is imported; its kernels are
built there first.  With random weights (seed 0), after a 4 x 64-token
prefill, under ``fused_int8``, at full width, it times one step of each of
llama3-8b decode, ``spec_k`` verify (4 slots x 5 tokens), ``spec_tree``
verify (4 slots x 7 tree nodes) and mamba2-2.7b decode, and a fused block of
4 greedy decode steps with the argmax fed back (eager: 4 steps and 4
argmaxes; replayed: ``ServeSteps.multi``, 4 replays of the decode graph).
``--archs`` names other models instead, each as ``arch`` or ``arch:layers``
(its first ``layers`` layers), timed on decode steps only (an
encoder-decoder's prefill takes seeded frames [4, S_enc, d] and 16 tokens),
e.g. ``--archs opt-30b:16,whisper-tiny --no-trace`` for the LayerNorm
families:

* eager: the model function called op by op;
* replayed: the engine's captured step (``models/graphs.py``), for a tree
  that has it (a tree without it reports eager only).

Each reports the host time until the call returns (dispatch) and the wall
time to the end of a synchronize, the median over ``--steps`` steps after
two warm-up steps, and for one more step the device-busy time (the sum of
the kernels' durations under ``torch.profiler``) and the idle share
(1 - busy / median wall).  The B1 call's host time a call over 2,000
back-to-back calls is kept beside them.  Last, the phase-4 trace of
``chip_smoke.py`` is served at full width (tokens a second, TTFT and
latency of each request) with ``multi_step`` 1, and 4 where the tree has
the fused lane.  The card's name and power limit are printed.
Host times vary between machines and within a call: run parent, change,
change, parent in one call and compare within it.
"""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TREE_PARENTS = [-1, -1, 0, 0, 1, 2]      # a 6-node draft tree: T 7


def time_steps(torch, step, n: int) -> dict:
    """Median host (until ``step`` returns) and wall (to the end of a
    synchronize) milliseconds of ``n`` calls of ``step`` after two, and one
    more call's device-busy time and idle share."""
    host, wall = [], []
    for i in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 2:
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
    out = {"host_ms": statistics.median(host), "wall_ms": statistics.median(wall),
           "host_ms_each": host, "wall_ms_each": wall}
    out.update(device_busy(torch, step))
    if "busy_ms" in out:        # against the median wall: the profiler slows the host
        out["idle_share"] = max(0.0, 1 - out["busy_ms"] / out["wall_ms"])
    return out


def device_busy(torch, step) -> dict:
    """Device-busy milliseconds of one call of ``step`` (the sum of its
    device events' durations), that call's wall under the profiler, and its
    device events and fill kernels (``torch.full`` and the like) counted."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except Exception as e:  # noqa: BLE001 - a measurement: its fault is recorded
        return {"busy_error": f"{type(e).__name__}: {e}"}
    dev = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return {"busy_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            "profiled_wall_ms": wall, "device_events": len(dev),
            "fill_kernels": sum("FillFunctor" in e.name for e in dev)}


def b1_call(torch, quant, mm) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    x_q, x_s = quant.quantize_activation(torch.randn((4, 4096), generator=g, device="cuda"))
    lin = quant.make_quantized_linear(torch.randn((4096, 1024), generator=g, device="cuda"))
    for _ in range(20):
        mm.int8_matmul(x_q, x_s, lin)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        mm.int8_matmul(x_q, x_s, lin)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"host_us": (t1 - t0) / n * 1e6, "wall_us": (t2 - t0) / n * 1e6}


def model_steps(torch, arch: str, n: int, kinds: tuple[str, ...],
                layers: int | None = None) -> dict:
    """Eager and (where the tree captures them) replayed times of each step
    kind in ``kinds`` (``decode``, ``verify``, ``tree``, ``block``) of
    ``arch`` (its first ``layers`` layers where given)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.drafter import tree_depths_ancestors
    from repro_torch.serve.quantize import quantize_tree
    try:
        from repro_torch.models import graphs as G
    except ImportError:                       # a tree from before the graphs
        G = None

    cfg = registry.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = M.init_params(cfg, seed=0, device="cuda")
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    depth, anc = (torch.tensor(x, dtype=torch.int32, device="cuda").repeat(4, 1)
                  for x in tree_depths_ancestors(TREE_PARENTS))
    width = {"decode": 1, "verify": 5, "tree": 7, "block": 4}
    out = {}
    for kind in kinds:
        rows = 64 + width[kind] * 3 * (n + 4)        # eager, replayed, the profiles
        batch = {"inputs": prompts}
        if cfg.family == "encdec":
            batch = {"frames": torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=g,
                                           device="cuda"), "tokens": prompts[:, :16]}
        logits, state = M.prefill(params, cfg, batch, rows, rt)
        cur = {"state": state, "tok": torch.argmax(logits, -1).to(torch.int32)}
        window = torch.randint(0, cfg.vocab_size, (4, width[kind]), generator=g,
                               device="cuda", dtype=torch.int32)
        kw = {"depth": depth, "anc": anc} if kind == "tree" else {}

        def eager():
            if kind in ("verify", "tree"):
                _, _, cur["state"] = M.verify_step(qparams, cfg, cur["state"], window,
                                                   rt, **kw)
                return
            for _ in range(width[kind]):
                lg, cur["state"] = M.decode_step(qparams, cfg, cur["state"], cur["tok"], rt)
                cur["tok"] = torch.argmax(lg, -1).to(torch.int32)
        rec = {"eager": time_steps(torch, eager, n)}
        if G is not None:
            steps = G.ServeSteps(qparams, cfg, rt, cur["state"],
                                 decode=kind in ("decode", "block"),
                                 verify=(5,) if kind == "verify" else (),
                                 tree=(7,) if kind == "tree" else ())
            if kind in ("verify", "tree"):
                steps.window[width[kind]].copy_(window)
                if kind == "tree":
                    steps.depth[7].copy_(depth)
                    steps.anc[7].copy_(anc)
            steps.tok.copy_(cur["tok"])

            def replayed():
                if kind == "decode":
                    steps.tok.copy_(steps.decode()[1])
                elif kind == "block":
                    steps.multi(4)
                else:
                    getattr(steps, kind)(width[kind])
            rec["replayed"] = time_steps(torch, replayed, n)
            del steps
        out[kind] = rec
        del cur, state, logits
        torch.cuda.empty_cache()
    del params, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_trace(torch, multi_step: int) -> dict:
    """``chip_smoke.py``'s phase-4 trace (8 ragged requests, prompts 16-200,
    budgets 8-32, seed 3) on 4 slots through ``ContinuousBatchingEngine``
    under ``fused_int8`` at llama3-8b's full width: tokens a second, and each
    request's TTFT and latency (queue wait included)."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import ContinuousBatchingEngine

    cfg = registry.get("llama3-8b")
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 201))).tolist()
               for _ in range(8)]
    budgets = [int(rng.integers(8, 33)) for _ in range(8)]
    kw = {"multi_step": multi_step} if multi_step > 1 else {}
    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=256,
                                   rt=Runtime("fused_int8"), **kw)
    eng.generate_all(prompts[:2], [2, 2])            # warm-up: first calls, allocator
    torch.cuda.synchronize()
    eng.reset_clock()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = sum(len(r.output) for r in reqs)
    out = {"multi_step": multi_step, "wall_s": wall, "tokens": served,
           "tokens_per_s": served / wall,
           "ttft_ms": [(r.first_token_time - r.arrival_time) * 1e3 for r in reqs],
           "latency_ms": [(r.finish_time - r.arrival_time) * 1e3 for r in reqs],
           "decode_steps": eng.stats["decode_steps"],
           "multi_blocks": eng.stats.get("multi_blocks", 0)}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--archs", default="",
                    help="comma-separated arch or arch:layers, decode steps only "
                         "(default: llama3-8b's four step kinds and mamba2-2.7b decode)")
    ap.add_argument("--no-trace", action="store_true", help="skip the served trace")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("host_step_time: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import quant
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import _build
    from repro_torch.kernels import int8_matmul as mm

    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    t0 = time.perf_counter()
    _build.build()
    res = {"label": args.label, "src": args.src, "card": card,
           "build_s": time.perf_counter() - t0, "b1_call": b1_call(torch, quant, mm)}
    if args.archs:
        models = []
        for spec in args.archs.split(","):
            arch, _, layers = spec.partition(":")
            res[spec] = model_steps(torch, arch, args.steps, ("decode",),
                                    int(layers) if layers else None)
            models.append(spec)
    else:
        res["llama3-8b"] = model_steps(torch, "llama3-8b", args.steps,
                                       ("decode", "verify", "tree", "block"))
        res["mamba2-2.7b"] = model_steps(torch, "mamba2-2.7b", args.steps, ("decode",))
        models = ["llama3-8b", "mamba2-2.7b"]
    try:                                  # a tree from before the fused lane refuses it
        import repro_torch.models.graphs  # noqa: F401
        blocks = (1, 4)
    except ImportError:
        blocks = (1,)
    res["trace"] = [] if args.no_trace else [serve_trace(torch, m) for m in blocks]
    print(f"{args.label} ({card}): B1 call host {res['b1_call']['host_us']:.2f} us "
          f"(wall {res['b1_call']['wall_us']:.2f})")
    for arch in models:
        for kind, rec in res[arch].items():
            for how, r in rec.items():
                busy = (f", device busy {r['busy_ms']:.2f} ms, idle share "
                        f"{r['idle_share']:.3f}, {r['device_events']} device events, "
                        f"{r['fill_kernels']} fills" if "busy_ms" in r else "")
                print(f"{args.label}: {arch} {kind} {how}: host {r['host_ms']:.2f} ms, "
                      f"wall {r['wall_ms']:.2f} ms (median of {args.steps}){busy}")
    for t in res["trace"]:
        print(f"{args.label}: trace, multi_step {t['multi_step']}: {t['tokens']} tokens in "
              f"{t['wall_s']:.3f} s ({t['tokens_per_s']:.1f} tokens/s), TTFT ms "
              f"{[round(x, 1) for x in t['ttft_ms']]}, latency ms "
              f"{[round(x, 1) for x in t['latency_ms']]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
