"""Train a small model with the PyTorch port's fault-tolerant runner
(checkpoint/restart + straggler watchdog + deterministic data replay): the
port's counterpart of ``examples/train_small.py``.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 200] [--device cpu]
(opt-125m reduced, two microbatches a step, one injected node failure; the
loss must fall.)
"""
import argparse
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import set_float32_precision
from repro_torch.ft.failures import FailureInjector, ResilientRunner
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

set_float32_precision()
cfg = registry.get("opt-125m").reduced()
shape = ShapeConfig("train_small", args.seq, args.batch, "train")
data = SyntheticTokens(cfg, shape, seed=0)
params = M.init_params(cfg, seed=0, device=args.device)
opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=args.steps, weight_decay=0.01)
step = make_train_step(cfg, Runtime(), opt, microbatches=2)
fail_at = min(60, args.steps // 2)

with tempfile.TemporaryDirectory() as ckpt_dir:
    runner = ResilientRunner(
        step_fn=step, ckpt_dir=ckpt_dir, ckpt_every=25,
        injector=FailureInjector(fail_at=(fail_at,)))   # simulated node failure
    params, opt_state, log = runner.run(params, opt.init(params), data, args.steps)

print(f"first loss {log[0]['loss']:.3f} -> last loss {log[-1]['loss']:.3f}")
print(f"recovered from {len(runner.injector.seen)} injected failure(s); "
      f"straggler events: {len(runner.watchdog.events)}")
if not log[-1]["loss"] < log[0]["loss"]:
    raise SystemExit("the loss did not fall")
print("OK")
