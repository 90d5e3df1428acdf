"""One-shot prefill time of long prompts on the card, to compare two trees
of the repo in one run.

    python3 tools/prefill_time.py --src <tree>/src --label <name> --out <file.json>

``--src`` picks the tree whose ``repro_torch`` is imported; its kernels are
built there first.  With random weights (seed 0), at llama3-8b's full
width, under ``fused_int8``, it prefills one prompt of each of 2,048 and
4,096 tokens into a state of 4,096 rows (an engine's ``max_len``), the
prefill part of such a request's TTFT.  Each reports the host time until
``prefill`` returns (dispatch) and the wall time to the end of a
synchronize, the median over ``--steps`` calls after two; then, once every
length is timed (a profile slows the host's later dispatch), one more
call's device-busy time and idle share (``host_step_time.py``'s
``device_busy``).  The card's name and power limit are printed.  Run parent,
change, change, parent in one call and compare within it.
"""
import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from host_step_time import device_busy

LENGTHS = (2048, 4096)
MAX_LEN = 4096


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefill_time: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import registry
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models.transformer import Runtime

    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    _build.build()
    cfg = registry.get("llama3-8b")
    params = M.init_params(cfg, seed=0, device="cuda")
    rt = Runtime("fused_int8")
    g = torch.Generator(device="cuda").manual_seed(2)
    res = {"label": args.label, "src": args.src, "card": card, "max_len": MAX_LEN}
    calls = {}
    for n in LENGTHS:
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda")
        calls[n] = lambda prompt=prompt: M.prefill(params, cfg, {"inputs": prompt},
                                                   MAX_LEN, rt)
        host, wall = [], []
        for i in range(args.steps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[n]()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                host.append((t1 - t0) * 1e3)
                wall.append((t2 - t0) * 1e3)
        res[str(n)] = {"host_ms": statistics.median(host), "wall_ms": statistics.median(wall),
                       "host_ms_each": host, "wall_ms_each": wall}
        gc.collect()
        torch.cuda.empty_cache()
    for n in LENGTHS:
        r = res[str(n)]
        r.update(device_busy(torch, calls[n]))
        busy = ""
        if "busy_ms" in r:
            r["idle_share"] = max(0.0, 1 - r["busy_ms"] / r["wall_ms"])
            busy = f", device busy {r['busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}"
        print(f"{args.label} ({card}): prefill of {n} tokens (max_len {MAX_LEN}): host "
              f"{r['host_ms']:.2f} ms, wall {r['wall_ms']:.2f} ms (median of "
              f"{args.steps}){busy or ', ' + r.get('busy_error', '')}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
