"""Quickstart on the PyTorch port: the paper's pipeline end to end on a
small model, the port's counterpart of ``examples/quickstart.py``.

1. Build a small OPT model (the paper's benchmark family).
2. "Deploy" it to the flash-PIM path: W8A8 quantize the static weights
   (QLC region); norms and softmax stay in float (controller ops).
3. Prefill a batch of prompts (the "GPU summarization stage").
4. Generate tokens through the quantized decode path (the PIM stage),
   with K/V appended to the int8 "SLC" cache every step.
5. Ask the analytical device model what the same workload costs on the
   actual 3D NAND flash PIM device (TPOT, Fig. 5/14).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core import pimsim
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = registry.get("opt-125m").reduced()
print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")

params = M.init_params(cfg, seed=0, device=args.device)
engine = Engine(cfg=cfg, params=params, max_len=96, quantize=True, device=args.device)

prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
tokens, times = engine.generate({"inputs": prompts}, steps=16)

where = torch.cuda.get_device_name(engine.device) if engine.device.type == "cuda" else "CPU"
print(f"generated {tokens.shape[1]} tokens for {tokens.shape[0]} requests")
print(f"prefill {times['prefill_s']*1e3:.1f} ms | "
      f"TPOT {times['tpot_s']*1e3:.2f} ms ({where}, functional only)")

print("\n--- what the real flash-PIM device would do (analytical) ---")
for name in ("opt-6.7b", "opt-30b"):
    m = pimsim.OPT_MODELS[name]
    bd = pimsim.flash_tpot(m)
    gpu = pimsim.gpu_tpot(m, "rtx4090")
    print(f"{name}: flash TPOT {bd.total*1e3:.2f} ms "
          f"(vs 4xRTX4090 {gpu*1e3:.2f} ms -> {gpu/bd.total:.1f}x speedup)")
