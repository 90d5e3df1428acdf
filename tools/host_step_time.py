"""Host time of the port's hot path on the card, to compare two trees of the
repo in one run: the model-facing B1 call (M 4, K 4096, N 1024), and one
full-width step each of llama3-8b decode, llama3-8b verify (4 slots x 5
tokens, as the ``spec_k = 4`` lane runs it) and mamba2-2.7b decode, with
random weights (seed 0) after a 4 x 64-token prefill, under ``fused_int8``.

    python3 tools/host_step_time.py --src <tree>/src --label <name> --out <file.json>

``--src`` picks the tree whose ``repro_torch`` is imported; its kernels are
built there first.  Each step reports the host time until the call returns
(dispatch) and the wall time to the end of a synchronize, the median over
``--steps`` steps after two warm-up steps; the B1 call the host time a call
over 2,000 back-to-back calls.  The card's name and power limit are
printed beside them.  Host times vary between machines and calls: run
parent, change, change, parent in one call and compare within it.
"""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def time_steps(torch, step, n: int) -> dict:
    """Median host (until ``step`` returns) and wall (to the end of a
    synchronize) milliseconds of ``n`` calls of ``step`` after two."""
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
    return {"host_ms": statistics.median(host), "wall_ms": statistics.median(wall),
            "host_ms_each": host, "wall_ms_each": wall}


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


def model_steps(torch, arch: str, n: int, verify: bool) -> dict:
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree

    cfg = registry.get(arch)
    params = M.init_params(cfg, seed=0, device="cuda")
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    out = {}

    logits, state = M.prefill(params, cfg, {"inputs": prompts}, 64 + n + 4, rt)
    cur = {"state": state, "tok": torch.argmax(logits, -1).to(torch.int32)}

    def decode():
        lg, cur["state"] = M.decode_step(qparams, cfg, cur["state"], cur["tok"], rt)
        cur["tok"] = torch.argmax(lg, -1).to(torch.int32)
    out["decode"] = time_steps(torch, decode, n)
    del cur, state, logits
    if verify:
        T = 5
        logits, state = M.prefill(params, cfg, {"inputs": prompts}, 64 + T * (n + 2) + 1, rt)
        window = torch.randint(0, cfg.vocab_size, (4, T), generator=g, device="cuda",
                               dtype=torch.int32)
        cur = {"state": state}

        def verify_step():
            _, _, cur["state"] = M.verify_step(qparams, cfg, cur["state"], window, rt)
        out["verify"] = time_steps(torch, verify_step, n)
        del cur, state, logits
    del params, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=20)
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
    res["llama3-8b"] = model_steps(torch, "llama3-8b", args.steps, verify=True)
    res["mamba2-2.7b"] = model_steps(torch, "mamba2-2.7b", args.steps, verify=False)
    print(f"{args.label} ({card}): B1 call host {res['b1_call']['host_us']:.2f} us "
          f"(wall {res['b1_call']['wall_us']:.2f})")
    for arch in ("llama3-8b", "mamba2-2.7b"):
        for what, r in res[arch].items():
            print(f"{args.label}: {arch} {what} step host {r['host_ms']:.2f} ms, "
                  f"wall {r['wall_ms']:.2f} ms (median of {args.steps})")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
