"""Deterministic synthetic token pipeline with resume/skip-ahead.

PyTorch-port counterpart of ``repro.data.pipeline``.  Batches are a pure
function of (seed, step), drawn from numpy's Philox exactly as the
reference draws them, so they equal the reference's batches bit for bit
and a restarted job regenerates exactly the stream it would have seen (the
data-side half of fault-tolerant resume).  Batches stay numpy arrays until
:func:`put_batch` moves them to a device, on a mesh each rank its block of
every input (the global batch is still drawn whole, so the blocks are the
reference's batch's, bit for bit).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import resolve


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    step: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        B, T = self.shape.global_batch, self.shape.seq_len
        V = self.cfg.vocab_size
        if self.cfg.family == "encdec":
            frames = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model), dtype=np.float32)
            toks = rng.integers(0, V, size=(B, T + 1), dtype=np.int32)
            return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.input_mode == "embeddings":
            inputs = rng.standard_normal((B, T, self.cfg.d_model), dtype=np.float32)
            labels = rng.integers(0, V, size=(B, T), dtype=np.int32)
            return {"inputs": inputs, "labels": labels}
        toks = rng.integers(0, V, size=(B, T + 1), dtype=np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def skip_to(self, step: int) -> "SyntheticTokens":
        self.step = step
        return self


def put_batch(batch: dict, device: str | torch.device = "cuda", specs: dict | None = None,
              mesh=None) -> dict:
    """A batch's arrays as tensors on ``device`` (dtypes kept; a tensor
    already there is passed through).  With ``specs`` (each input's spec,
    ``dist/sharding.py`` ``input_shardings``) and ``mesh`` each rank keeps
    its block of every input, cut from the whole array before it moves."""
    dev = resolve(device)
    out = {}
    for k, v in batch.items():
        if specs is not None:
            v = _block(v, specs[k], mesh)
        out[k] = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                                 device=dev)
    return out


def _block(v, spec: tuple, mesh):
    """The rank's block of ``v`` (an array or a tensor) under ``spec``."""
    from repro_torch.dist import sharding as SH
    sl = tuple(SH.block(v.shape[d], mesh, axes) for d, axes in enumerate(SH.live(spec, mesh)))
    return v[sl]
