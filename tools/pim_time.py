"""Device time of B5 (the bit-serial PIM MVM) on the card, to compare two
trees of the repo in one run: the kernel alone and the model-facing call
(``pim_mvm(x_q, x_s, lin)``, what a ``pim_bitserial`` step pays, packing
included where the tree packs) over one llama3-8b layer's 7 linears at M 1,
4, 20 and 28, each first held bit-equal to B1; B1 over the same layer at
M 4; and where one full-width llama3-8b decode step's time goes (4 slots
after a 4 x 64-token prefill, random weights from seed 0) under
``pim_bitserial`` and under ``fused_int8`` (``chip_smoke.profile_step``).
Times are CUDA-graph replays over input sets that keep the 50 MB L2 cold
(``chip_smoke.copies``).

    python3 tools/pim_time.py --src <tree>/src --label <name> --out <file.json>

``--src`` picks the tree whose ``repro_torch`` is imported; its kernels are
built there first.  A tree whose ``pim_mvm_cuda`` takes the two nibble
planes (``w_hi``, ``w_lo``) gets them packed once before its kernel is
timed.  The card's name and power limit are printed beside the times.
Compare trees only within one call, in the order parent, change, change,
parent.
"""
import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B5_M = (1, 4, 20, 28)


def layer_times(torch, cs, quant, mm, pim, M: int, planes: bool) -> dict:
    """Per-shape and per-layer device ms of the B5 kernel, the model-facing
    B5 call and (at M 4) B1, over one llama3-8b layer's linears at M rows."""
    g = torch.Generator(device="cuda").manual_seed(1)
    tot = {"kernel_ms": 0.0, "call_ms": 0.0, "b1_ms": 0.0 if M == 4 else None, "shapes": []}
    for (K, N), count in cs.LINEAR_SHAPES.items():
        sets = cs.copies(torch, lambda: cs.linear_inputs(torch, g, M, K, N, w_low=-128), K * N)
        n = len(sets)
        ws = [quant.pack_qlc(s[2]) if planes else (s[2],) for s in sets]
        lins = [quant.QuantizedLinear(w_q=s[2], w_scale=s[3], smooth=None) for s in sets]
        out5, acc5 = pim.pim_mvm_cuda(sets[0][0], sets[0][1], *ws[0], sets[0][3])
        out1, acc1 = mm.int8_matmul_cuda(*sets[0])
        call = pim.pim_mvm(sets[0][0], sets[0][1], lins[0])
        torch.cuda.synchronize()
        if not (torch.equal(acc5, acc1) and torch.equal(out5, out1) and torch.equal(call, out1)):
            raise AssertionError(f"B5 differs from B1 at M={M} K={K} N={N}")
        row = {"K": K, "N": N, "count_per_layer": count,
               "kernel_ms": cs.graph_ms(torch, lambda i: pim.pim_mvm_cuda(
                   sets[i % n][0], sets[i % n][1], *ws[i % n], sets[i % n][3]), 20),
               "call_ms": cs.graph_ms(torch, lambda i: pim.pim_mvm(
                   sets[i % n][0], sets[i % n][1], lins[i % n]), 20)}
        if M == 4:
            row["b1_ms"] = cs.graph_ms(
                torch, lambda i: mm.int8_matmul_cuda(*sets[i % n], with_acc=False), 50)
            tot["b1_ms"] += row["b1_ms"] * count
        tot["kernel_ms"] += row["kernel_ms"] * count
        tot["call_ms"] += row["call_ms"] * count
        tot["shapes"].append(row)
        del sets, ws, lins
    return tot


def step_profiles(torch, cs) -> dict:
    """``chip_smoke.profile_step`` of one full-width llama3-8b decode step
    under ``pim_bitserial`` and under ``fused_int8``, from one state."""
    from repro_torch.configs import registry
    from repro_torch.models import model as Mdl
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import Engine

    cfg = registry.get("llama3-8b")
    params = Mdl.init_params(cfg, seed=0, device="cuda")
    eng = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=128)
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=g, device="cuda")
    logits0, state = Mdl.prefill(params, cfg, {"inputs": prompts}, 128, Runtime("fused_int8"))
    tok = torch.argmax(logits0, -1).to(torch.int32)
    out = {}
    for backend in ("pim_bitserial", "fused_int8"):
        out[backend] = cs.profile_step(
            torch, lambda: Mdl.decode_step(eng.qparams, cfg, cs.clone_state(state), tok,
                                           Runtime(backend)), f"{backend} decode")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pim_time: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import _build
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import pim_mvm as pim

    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    _build.build(["pim_mvm", "int8_matmul"])
    planes = "w_hi" in inspect.signature(pim.pim_mvm_cuda).parameters
    res = {"label": args.label, "src": args.src, "card": card, "two_planes": planes,
           "layer": {M: layer_times(torch, cs, quant, mm, pim, M, planes) for M in B5_M}}
    for M, r in res["layer"].items():
        b1 = "" if r["b1_ms"] is None else f", B1 {r['b1_ms']:.4f}"
        print(f"{args.label} ({card}): M {M} a layer: B5 kernel {r['kernel_ms']:.4f} ms, "
              f"model-facing call {r['call_ms']:.4f} ms{b1}", flush=True)
    res["steps"] = step_profiles(torch, cs)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
