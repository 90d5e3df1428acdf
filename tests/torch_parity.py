"""JAX engine runs for the port's parity tests, each computed once, and
the float K/V that the reference's int8 cache quantizer sees.

A JAX ``ContinuousBatchingEngine`` compiles its steps as closures of its
own, so every engine compiles them again.  Engines of one ``max_len`` and
``chunk`` here share the first one's compiled steps (and its top-k cache):
they close over nothing else, so the shared steps are the same functions.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import quant as JQ
from repro.models.transformer import Runtime as JRuntime
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro_torch.core.quant import quantize_kv

JITTED = ("_prefill", "_carry_init", "_chunk_fn", "_finalize_write", "_decode", "_write",
          "_read_slot", "_gather", "_warm_carry", "_topk_fns")


class JaxRuns:
    """JAX engines over ``cfg`` and ``params`` under ``backend`` with the
    keyword arguments ``base``, and their runs, each computed once."""

    def __init__(self, cfg, params, base: dict, backend: str = "fused_int8"):
        self.cfg, self.params, self.base = cfg, params, base
        self.rt = JRuntime(backend=backend)
        self.fns: dict = {}
        self.runs: dict = {}

    def engine(self, **kw) -> JCB:
        eng = JCB(self.cfg, self.params, rt=self.rt, **{**self.base, **kw})
        for name in JITTED:
            if hasattr(eng, name):
                setattr(eng, name, self.fns.setdefault((eng.max_len, eng.chunk, name),
                                                       getattr(eng, name)))
        return eng

    def run(self, key, drive, **kw):
        """``(drive(engine), engine)`` for ``key``, the engine built with
        ``kw`` on the first call."""
        if key not in self.runs:
            eng = self.engine(**kw)
            self.runs[key] = (drive(eng), eng)
        return self.runs[key]


@contextlib.contextmanager
def reference_kv_quantizations(*modules):
    """Every ``(x, q, scale)`` of the reference's ``quantize_kv`` while the
    block runs, as numpy arrays.  The function is wrapped in ``repro.core.quant``
    and in each of ``modules`` that imported it by name; the traced operands
    of a scan or jit body reach the host through ``jax.debug.callback``.  A
    function JAX traced before the block keeps its unwrapped trace."""
    seen: list = []
    real = JQ.quantize_kv

    def record(x, q, s):
        seen.append((np.array(x), np.array(q), np.array(s)))

    def wrapped(x):
        q, s = real(x)
        jax.debug.callback(record, x, q, s)
        return q, s

    saved = [(m, m.quantize_kv) for m in (JQ, *modules)]
    for m, _ in saved:
        m.quantize_kv = wrapped
    try:
        yield seen
    finally:
        for m, f in saved:
            m.quantize_kv = f


def check_kv_quantizations(seen: list) -> None:
    """The port's ``quantize_kv`` on each recorded float K/V gives every code
    and scale of the reference's ``quantize_kv`` called on it, bit for bit.
    Traced by XLA on the CPU, the reference divides by 127 as a multiply by
    its reciprocal, so the recorded scales may sit one ulp from IEEE
    division; wherever a recorded scale equals the port's, so do its codes."""
    assert seen
    for x, q, sc in seen:
        tq, ts = (a.numpy() for a in quantize_kv(torch.from_numpy(x)))
        eq, es = (np.asarray(a) for a in JQ.quantize_kv(jnp.asarray(x)))
        np.testing.assert_array_equal(tq, eq)
        np.testing.assert_array_equal(ts, es)
        np.testing.assert_array_max_ulp(sc, ts, maxulp=1)
        same = np.broadcast_to(sc == ts, tq.shape)
        np.testing.assert_array_equal(tq[same], q[same])
