"""JAX engine runs for the port's parity tests, each computed once.

A JAX ``ContinuousBatchingEngine`` compiles its steps as closures of its
own, so every engine compiles them again.  Engines of one ``max_len`` and
``chunk`` here share the first one's compiled steps (and its top-k cache):
they close over nothing else, so the shared steps are the same functions.
"""
from repro.models.transformer import Runtime as JRuntime
from repro.serve.engine import ContinuousBatchingEngine as JCB

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
