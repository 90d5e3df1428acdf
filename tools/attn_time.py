"""Device time a launch of the attention kernels B2, B3 and B4 on the card,
to compare two trees of the repo in one run: B2 at S 512 and 4,096
(``chip_smoke.B2_SHAPES``), B3 / B4 at the windows of
``chip_smoke.VERIFY_CASES``, and B2 / B3 at the shapes of the step
profiles in ``chip_smoke.py`` (a 128-row pool after a 64-token prefill:
every slot at length 65, or a 5-token window at cursor 64), each first
held against its plain version and its bit-exact invariants, then timed
by CUDA-graph replay over input sets that keep the 50 MB L2 cold
(``chip_smoke.b2_case`` / ``verify_case``).

    python3 tools/attn_time.py --src <tree>/src --label <name> --out <file.json>

``--src`` picks the tree whose ``repro_torch`` is imported; its kernels are
built there first.  The card's name and power limit are printed beside the
times.  Compare trees only within one call, in the order parent, change,
change, parent.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP_B2 = (128, (65, 65, 65, 65))
STEP_B3 = ("verify_attn_step", 5, 124, (64, 64, 64, 64))   # pool of 124 + 4 rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_time: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import verify_attn as va
    from repro_torch.kernels import verify_tree_attn as vt
    from repro_torch.serve import drafter

    set_float32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    _build.build(["decode_attn"])
    res = {"label": args.label, "src": args.src, "card": card, "cases": {}}
    for S, lengths in cs.B2_SHAPES:
        res["cases"][f"decode_attn_S{S}"] = cs.b2_case(torch, da, quant, S, lengths)
    res["cases"]["decode_attn_step"] = cs.b2_case(torch, da, quant, *STEP_B2)
    for name, T, max_len, pos in (*cs.VERIFY_CASES, STEP_B3):
        res["cases"][name] = cs.verify_case(torch, da, va, vt, quant, drafter, name, T,
                                            max_len, pos)
    for name, r in res["cases"].items():
        print(f"{args.label} ({card}): {name} {r['ms'] * 1e3:.2f} us a launch (bound "
              f"{r['bound_ms'] * 1e3:.2f}, plain {r['plain_ms'] * 1e3:.1f})")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
