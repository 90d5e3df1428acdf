"""The port's training path against the JAX reference on the CPU.

Weights are the port's seeded init, converted to the reference's layout
(``convert.to_numpy``) for the reference; batches come from
the synthetic pipeline (the port's batches equal the reference's bit for
bit, ``tests/test_torch_ckpt_ft.py``), and the port's ``train_loss`` and
every leaf's gradient (``torch.autograd.grad``, mapped back to the
reference's stacked layout by ``convert.to_numpy``) are held to
``jax.value_and_grad`` of the reference's ``train_loss`` at ``.reduced()``
for seven families: llama3-8b, opt-125m (LayerNorm, the tied head),
grok-1-314b (MoE aux loss), deepseek-v3-671b (MLA, the MTP term),
mamba2-2.7b, jamba-1.5-large-398b (hybrid) and whisper-tiny
(encoder-decoder).  Tolerance: the loss within rtol 1e-6, each leaf's
gradient within 2e-5 of that leaf's largest magnitude (f32 sums in other
orders; the worst seen is about 3e-6).

The reference's SSM training gradient is NaN from about 6 tokens on: its
chunked SSD masks ``exp(cs_q - cs_k)`` after the exponential, whose upper
triangle overflows at the init's decays, and ``where``'s gradient
multiplies that inf by zero (ROADMAP queue C).  The port computes the same
NaNs in the same entries: at 16 tokens mamba2's gradients are held NaN for
NaN and within the tolerance elsewhere; at 4 tokens, where the reference's
gradients are finite, mamba2's and jamba's are held whole.

Also here: ``remat`` gives the same gradients bit for bit, the train step's
loss falls on the tiny llama (``TestTrainStepLossDecreases``), microbatched
equals full (granite-3-8b), ``model_flops`` equals the reference's, and the
training CLI runs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.shapes import ShapeConfig as JShape
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.models import model as JM
from repro.models.transformer import Runtime as JRuntime
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, put_batch
from repro_torch.models import model as TM
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import AdamW
from repro_torch.train.train_step import make_train_step, value_and_grad
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
GRAD_ATOL = 2e-5          # of each leaf's largest gradient magnitude


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _setup(arch: str, seq: int, batch: int = 2):
    """Both configs, the port's seeded weights and the same weights in the
    reference's layout, and a batch of the reference's pipeline."""
    jcfg, tcfg = JR.get(arch).reduced(), TR.get(arch).reduced()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, tcfg))
    data = JTokens(jcfg, JShape("t", seq, batch, "train"), seed=3).batch_at(0)
    return jcfg, tcfg, jparams, params, data


def _reference(jcfg, jparams, data):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, jcfg, b, JRuntime())))(jparams, data)
    return float(loss), _flat(grads)


def _port(tcfg, params, data, rt=Runtime()):
    loss, grads = value_and_grad(params, tcfg, put_batch(data, "cpu"), rt)
    return float(loss), _flat(convert.to_numpy(grads, tcfg))


@pytest.mark.parametrize("arch,seq", [
    ("llama3-8b", 16), ("opt-125m", 16), ("grok-1-314b", 16), ("deepseek-v3-671b", 16),
    ("mamba2-2.7b", 16), ("mamba2-2.7b", 4), ("jamba-1.5-large-398b", 4),
    ("whisper-tiny", 16)])
def test_loss_and_every_gradient_match_reference(arch, seq):
    jcfg, tcfg, jparams, params, data = _setup(arch, seq)
    jl, jg = _reference(jcfg, jparams, data)
    tl, tg = _port(tcfg, params, data)
    assert set(tg) == set(jg)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    nan_leaves = 0
    for k, want in jg.items():
        got = tg[k]
        assert got.shape == want.shape, k
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=k)
        nan_leaves += bool(nan.any())
        fin = want[~nan]
        if fin.size:
            np.testing.assert_allclose(got[~nan], fin, rtol=0,
                                       atol=GRAD_ATOL * max(float(np.abs(fin).max()), 1e-30),
                                       err_msg=k)
    # the reference's SSD gradient overflows past a few tokens (module docstring)
    assert (nan_leaves > 0) == (jcfg.family == "ssm" and seq > 4)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny"])
def test_remat_gives_the_same_gradients(arch):
    _, tcfg, _, params, data = _setup(arch, 16)
    plain = _port(tcfg, params, data)
    remat = _port(tcfg, params, data, Runtime(remat=True))
    assert plain[0] == remat[0]
    for k, v in plain[1].items():
        np.testing.assert_array_equal(remat[1][k], v, err_msg=k)


def test_embedding_inputs_give_the_table_a_zero_gradient():
    """chameleon-34b takes embeddings: its table gets a zero gradient, as
    ``jax.grad`` gives an unused leaf."""
    _, tcfg, _, params, data = _setup("chameleon-34b", 8)
    loss, grads = value_and_grad(params, tcfg, put_batch(data, "cpu"), Runtime())
    assert torch.isfinite(loss)
    assert torch.count_nonzero(grads["embed"]["w"]) == 0
    assert torch.count_nonzero(grads["lm_head"]["w"]) > 0


def test_model_flops_match_reference():
    for arch in ("llama3-8b", "deepseek-v3-671b", "whisper-tiny"):
        for name, shape in SHAPES.items():
            js = JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
            assert TM.model_flops(TR.get(arch), shape) == JM.model_flops(JR.get(arch), js)


# ---------------------------------------------------------------------------
# mirrors of tests/test_optim_ckpt_ft.py::TestTrainStepLossDecreases
# ---------------------------------------------------------------------------
def test_tiny_llama_loss_goes_down():
    cfg = TR.get("llama3-8b").reduced()
    data = SyntheticTokens(cfg, ShapeConfig("tiny", 32, 4, "train"), seed=3)
    params = TM.init_params(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=100, weight_decay=0.0)
    ostate = opt.init(params)
    step = make_train_step(cfg, Runtime(), opt)
    losses = []
    for i in range(12):
        params, ostate, m = step(params, ostate, data.batch_at(i % 2))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatched_matches_full():
    cfg = TR.get("granite-3-8b").reduced()
    data = SyntheticTokens(cfg, ShapeConfig("tiny", 16, 4, "train"), seed=1)
    params = TM.init_params(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=100)
    b = data.batch_at(0)
    p1, p2 = (convert.tree_map(params, torch.clone) for _ in range(2))
    p1, _, m1 = make_train_step(cfg, Runtime(), opt, microbatches=1)(p1, opt.init(p1), b)
    p2, _, m2 = make_train_step(cfg, Runtime(), opt, microbatches=2)(p2, opt.init(p2), b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    d = max(float((a - b_).abs().max())
            for a, b_ in zip(convert.tree_leaves(p1), convert.tree_leaves(p2)))
    assert d < 2e-3


def test_train_cli_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "llama3-8b", "--reduced", "--steps", "4", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: 4 steps" in res.stdout and "tok/s" in res.stdout


def test_remat_field_defaults_off():
    assert Runtime().remat is False
    assert dataclasses.replace(Runtime(), remat=True).remat is True
