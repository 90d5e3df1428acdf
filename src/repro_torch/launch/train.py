"""Training entry point.

PyTorch-port counterpart of ``repro.launch.train``, with its flags and
``--device`` (the card by default; ``--device cpu`` runs the kernels'
plain versions):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 100 \\
        [--reduced] [--batch 8] [--seq 128] [--ckpt-dir DIR] [--device cpu]

Weights are random, from ``init_params(cfg, seed=0)``; the data is the
seeded synthetic stream (``data/pipeline.py``).  The run goes through
:class:`ResilientRunner` (checkpoints every ``--ckpt-every`` steps,
``--resume`` restarts from the latest one).  The checkpoint directory
defaults to ``repro_torch_ckpt`` under the system's temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import set_float32_precision
from repro_torch.ft.failures import ResilientRunner
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    set_float32_precision()
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = SyntheticTokens(cfg, shape, seed=0)
    params = M.init_params(cfg, seed=0, device=args.device)
    opt = AdamW(lr=args.lr, warmup_steps=max(2, args.steps // 20), total_steps=args.steps)
    opt_state = opt.init(params)
    step = make_train_step(cfg, Runtime(), opt, microbatches=args.microbatches)

    start = 0
    if args.resume:
        from repro_torch.ckpt import checkpoint as C
        if C.latest_step(args.ckpt_dir) is not None:
            state, extra = C.restore(args.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = extra["data_step"]
            print(f"resumed from step {start}")

    runner = ResilientRunner(step_fn=step, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    t0 = time.time()
    params, opt_state, log = runner.run(params, opt_state, data, args.steps, start_step=start)
    dt = time.time() - t0
    for m in log[:3] + log[-3:]:
        print(f"step {m['step']}: loss={m['loss']:.4f} ({m['dt'] * 1e3:.0f} ms)")
    toks = (args.steps - start) * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks / dt:.0f} tok/s, "
          f"stragglers={len(runner.watchdog.events)}")


if __name__ == "__main__":
    main()
