"""End-to-end serving driver on the PyTorch port, the counterpart of
``examples/serve_pim.py``: batched requests through the full offload
pipeline, comparing the float decode path against the paper's W8A8 PIM
decode path (accuracy and bytes moved), for several architectures, then a
ragged request stream through the continuous-batching engine.

Run:  PYTHONPATH=src python examples/serve_pim_torch.py [--steps 12]
      [--batch 4] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.kvcache import cache_bytes
from repro_torch.models import model as M
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.quantize import quantized_bytes

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=12)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

for arch in ("llama3-8b", "mamba2-2.7b", "deepseek-v3-671b"):
    cfg = registry.get(arch).reduced()
    params = M.init_params(cfg, seed=0, device=args.device)
    gen = torch.Generator().manual_seed(1)
    batch = {"inputs": (torch.randn((args.batch, 24, cfg.d_model), generator=gen)
                        if cfg.input_mode == "embeddings" else
                        torch.randint(0, cfg.vocab_size, (args.batch, 24), generator=gen))}
    e_q = Engine(cfg=cfg, params=params, max_len=64, quantize=True, device=args.device)
    e_f = Engine(cfg=cfg, params=params, max_len=64, quantize=False, device=args.device)
    tq, tmq = e_q.generate(batch, steps=args.steps)
    tf, tmf = e_f.generate(batch, steps=args.steps)
    agree = float((tq == tf).float().mean())
    wq = quantized_bytes(e_q.qparams)
    wf = quantized_bytes(params)
    state = M.init_decode_state(cfg, args.batch, 64, device=args.device)
    print(f"{arch:>22}: token agreement {agree:5.0%} | "
          f"weights {wf/1e6:6.1f}MB -> {wq/1e6:6.1f}MB "
          f"({wf/wq:.1f}x denser 'QLC') | "
          f"SLC cache {cache_bytes(state)/1e6:.1f}MB | "
          f"TPOT q={tmq['tpot_s']*1e3:.1f}ms f={tmf['tpot_s']*1e3:.1f}ms")

# ---------------------------------------------------------------------------
# continuous batching: ragged prompts, queueing, slot reuse, backfill
# ---------------------------------------------------------------------------
print("\ncontinuous batching (llama3-8b reduced, 2 slots, 6 ragged requests):")
cfg = registry.get("llama3-8b").reduced()
params = M.init_params(cfg, seed=0, device=args.device)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist()
           for _ in range(6)]
budgets = [int(rng.integers(4, args.steps + 1)) for _ in range(6)]
eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64, device=args.device)
outs = eng.generate_all(prompts, budgets)
for i, (p, o) in enumerate(zip(prompts, outs)):
    print(f"  req {i}: prompt {len(p):2d} tok -> generated {len(o):2d} tok "
          f"{o[:6]}{'...' if len(o) > 6 else ''}")
st = eng.state
print(f"  pooled SLC state: {cache_bytes(st)/1e6:.1f}MB across "
      f"{eng.n_slots} slots (invariant under slot churn)")
