"""Serve steps over static buffers, captured as CUDA graphs on the card.

PyTorch counterpart of the reference engine's compiled steps.  There each
serve step is one ``jax.jit`` that donates the decode state, so the pool
updates in place and the host dispatches a step once.  Here each step is
captured once as a CUDA graph over fixed tensors, the decode state (which
every step updates in place, see ``models/transformer.py``) and the static
input buffers a :class:`ServeSteps` owns, and then replayed.  The host
copies a step's inputs into the buffers (``copy_``) before a replay and
reads the step's outputs after it.  Admissions, commits and cursor rewinds
run eagerly between replays and write the same state tensors in place.

Capture: eager warm-up calls on a side stream come first, because the first
call of a kernel loads its library and sets function attributes, which a
capture must not record.  The state is snapshotted before the warm-up and
written back after it.  The kernel wrappers' launch counters move during the
capture, which launches nothing: the graph keeps what its capture added,
takes it back off, and credits it on every replay, so the counters read as
if the step had run eagerly.  A capture that fails raises; nothing on the
card falls back to eager dispatch.  On CPU tensors, which only a caller that
asks for the CPU gets, the same functions run eagerly on the same buffers.

All graphs of one :class:`ServeSteps` share one memory pool, so a graph's
outputs hold only until the next replay of any of them: read them first.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import kernels as KN
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Runtime


def state_tensors(state: dict) -> list[torch.Tensor]:
    """Every tensor of a decode state: each layer's leaves, then ``pos``."""
    return [t for layer in state["layers"] for t in layer.values()] + [state["pos"]]


class StepGraph:
    """One step ``fn`` (no arguments: it reads static buffers and updates
    ``state`` in place, and returns its outputs).  On the card it is
    captured at construction and :meth:`__call__` replays it; on the CPU
    :meth:`__call__` runs ``fn``."""

    def __init__(self, fn: Callable[[], Any], state: dict, pool=None):
        self.fn = fn
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: Any = None
        self.launches: dict[str, int] = {}
        dev = state["pos"].device
        if dev.type == "cuda":
            self._capture(state, dev, pool)

    def _capture(self, state: dict, dev: torch.device, pool) -> None:
        saved = [t.clone() for t in state_tensors(state)]
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn()                  # warm-up: libraries load, attributes set
        main.wait_stream(side)
        for t, s in zip(state_tensors(state), saved):
            t.copy_(s)
        del saved
        before = KN.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = self.fn()
        after = KN.launch_counts()
        KN.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.graph, self.out = graph, out
        self.fn = None                 # the replay needs only the graph

    def __call__(self) -> Any:
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        KN.credit_launches(self.launches)
        return self.out


class ServeSteps:
    """The static input buffers and the captured steps over one decode
    state of ``n`` slots (``state["pos"]`` is [n]):

    * ``tok`` [n] int32: the decode and fused steps' input tokens;
    * ``window[T]`` [n, T] int32 for each verify window size, and
      ``depth[T]`` / ``anc[T]`` for each tree window size.

    Steps (each returns outputs that hold until the next replay):

    * :meth:`decode`: ``decode_step`` -> (logits [n, V], argmax [n] int32);
    * :meth:`verify` (``T`` in ``verify``) and :meth:`tree` (``T`` in
      ``tree``): ``verify_step`` -> (logits [n, T, V], argmax [n, T]);
    * :meth:`multi`: ``multi_decode_step`` as m replays of the decode step
      -> tokens [n, m] int32.
    """

    def __init__(self, params: Any, cfg: ModelConfig, rt: Runtime, state: dict,
                 *, decode: bool = True, verify: tuple[int, ...] = (),
                 tree: tuple[int, ...] = ()):
        self.params, self.cfg, self.rt, self.state = params, cfg, rt, state
        n = state["pos"].shape[0]
        dev = state["pos"].device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        self.tok = zeros(n)
        self.window = {t: zeros(n, t) for t in (*verify, *tree)}
        self.depth = {t: zeros(n, t) for t in tree}
        self.anc = {t: zeros(n, t) for t in tree}
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.graphs: dict[tuple, StepGraph] = {}
        if decode:
            self._add(("decode",), self._decode)
        for t in verify:
            self._add(("verify", t), lambda t=t: self._verify(t))
        for t in tree:
            self._add(("tree", t), lambda t=t: self._verify(t, tree=True))

    def _add(self, key: tuple, fn: Callable[[], Any]) -> None:
        self.graphs[key] = StepGraph(fn, self.state, self.pool)

    def _decode(self):
        logits, _ = T.decode_step(self.params, self.cfg, self.state, self.tok,
                                  self.rt)
        return logits, torch.argmax(logits, -1).to(torch.int32)

    def _verify(self, t: int, tree: bool = False):
        kw = {"depth": self.depth[t], "anc": self.anc[t]} if tree else {}
        logits, _, _ = T.verify_step(self.params, self.cfg, self.state,
                                     self.window[t], self.rt, **kw)
        return logits, torch.argmax(logits, -1).to(torch.int32)

    def decode(self):
        return self.graphs[("decode",)]()

    def verify(self, t: int):
        return self.graphs[("verify", t)]()

    def tree(self, t: int):
        return self.graphs[("tree", t)]()

    def multi(self, m: int) -> torch.Tensor:
        """The fused block: ``m`` decode steps from the tokens in ``tok``,
        each step's argmax copied into ``tok`` on the device for the next
        (ties to the lowest id, as :func:`transformer.multi_decode_step`
        breaks them).  Returns the [n, m] int32 tokens; ``tok`` ends on the
        block's last column."""
        blk = torch.empty((self.tok.shape[0], m), dtype=torch.int32,
                          device=self.tok.device)
        for i in range(m):
            _, argmax = self.decode()
            blk[:, i] = argmax
            self.tok.copy_(argmax)
        return blk
