"""Failure handling and straggler mitigation for the training loop and the
serve loop.

PyTorch-port counterpart of ``repro.ft.failures``.  A training step either
(a) raises (a device failure or preemption surfaced as an exception), (b)
silently stalls (a straggler), or (c) corrupts state (a non-finite loss).
:class:`ResilientRunner` handles all three:

  * retry-with-restore: on an exception or a non-finite loss, reload the
    latest committed checkpoint and replay the data stream
    deterministically (``SyntheticTokens.batch_at``), so the recovered run
    ends on the parameters of an unfailed one;
  * straggler watchdog: a step slower than ``factor`` times the running mean
    of step times is logged and counted (the serve engine observes every
    ``step()`` the same way, ``stats["slow_steps"]``), the signal a
    deployment uses to trigger a backup executor or a hot-spare swap;
  * :class:`FailureInjector` raises :class:`StepFailure` at chosen steps,
    for tests.

The int8 error-feedback gradient compression is ``ft/compress.py``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

from repro_torch.ckpt import checkpoint as C


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault injection for tests: fail once at each given step."""
    fail_at: tuple[int, ...] = ()
    seen: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise StepFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Exponential moving average of step times; ``observe`` flags a step
    slower than ``factor`` times the average before it."""
    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.2
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.events.append((step, dt, self.ema))
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


@dataclasses.dataclass
class ResilientRunner:
    """Drives ``step_fn`` with checkpoint/restart, the watchdog and retries."""
    step_fn: Callable                    # (params, opt_state, batch) -> (p, o, metrics)
    ckpt_dir: str
    ckpt_every: int = 10
    max_retries: int = 3
    injector: FailureInjector | None = None
    watchdog: StragglerWatchdog = dataclasses.field(default_factory=StragglerWatchdog)

    def run(self, params, opt_state, data_iter, n_steps: int,
            start_step: int = 0, async_ckpt: bool = True):
        """Steps ``start_step .. n_steps - 1`` -> (params, opt_state, log of
        ``{"step", "loss", "dt"}``).  A step's loss is read on the host (the
        step's wall time ``dt`` includes the wait for the device)."""
        ckpt = C.AsyncCheckpointer(self.ckpt_dir)
        step = start_step
        retries = 0
        metrics_log = []
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                batch = data_iter.batch_at(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise StepFailure(f"non-finite loss at step {step}")
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                metrics_log.append({"step": step, "loss": loss, "dt": dt})
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    state = {"params": params, "opt": opt_state}
                    if async_ckpt:
                        ckpt.save(step, state, {"data_step": step})
                    else:
                        C.save(self.ckpt_dir, step, state, {"data_step": step})
            except StepFailure:
                retries += 1
                if retries > self.max_retries:
                    raise
                ckpt.wait()
                last = C.latest_step(self.ckpt_dir)
                if last is not None:
                    state = {"params": params, "opt": opt_state}
                    state, extra = C.restore(self.ckpt_dir, state)
                    params, opt_state = state["params"], state["opt"]
                    step = extra["data_step"]      # deterministic data replay
                else:                              # restart from the initial state
                    step = start_step
        ckpt.wait()
        return params, opt_state, metrics_log
