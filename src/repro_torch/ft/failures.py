"""Straggler detection for the serve loop.

PyTorch-port counterpart of ``repro.ft.failures``' :class:`StragglerWatchdog`
(the training loop's checkpoint-and-retry runner and its failure injector
belong to the training path, ROADMAP A.12).  The engine observes every
``step()``'s wall time: a step slower than ``factor`` times the running
mean is counted as a straggler (``stats["slow_steps"]``), the signal a
deployment uses to trigger a backup executor or a hot-spare swap.
"""
from __future__ import annotations

import dataclasses


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
