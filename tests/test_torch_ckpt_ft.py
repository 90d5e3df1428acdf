"""The port's optimizer, checkpoints, fault tolerance, gradient compression
and data pipeline against the JAX reference on the CPU.

Mirrors ``tests/test_optim_ckpt_ft.py`` (``TestAdamW``,
``TestCheckpoint``, ``TestResilience``, ``TestGradCompression``,
``TestDataPipeline``) and holds the port to the reference on the same
numpy inputs:

* ``_q8`` / ``_dq8`` codes and scales bit for bit, including a leaf whose
  last axis is no multiple of 128 stacked as the reference stacks it (one
  scale over the layers of a stack, ``_q8_stack``);
* two ``AdamW.update`` calls on llama3-8b reduced with the same gradients,
  f32 and int8 moments and ``weight_decay > 0``: parameters, f32 moments
  and int8 scales within 1e-6 of each leaf's scale (the stacked norm
  scales decayed as the reference decays them, ``ln_f`` not; the global
  gradient norm sums its leaves in another order, so the clip scale may
  differ by an ulp), a stack's shared fallback scale one value for all its
  layers, int8 codes equal but for at most 1 in 10,000 that moves by one;
* ``compress`` codes, scales and residuals bit for bit;
* the pipeline's batches (token, embedding and encoder-decoder forms) bit
  for bit.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.shapes import ShapeConfig as JShape
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.ft import compress as JFC
from repro.optim import adamw as JA
from repro_torch import convert
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry as TR
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, put_batch
from repro_torch.ft import compress as FC
from repro_torch.ft.failures import FailureInjector, ResilientRunner, StragglerWatchdog
from repro_torch.models import model as TM
from repro_torch.models.transformer import Runtime
from repro_torch.optim import adamw as TA
from repro_torch.train.train_step import make_train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------------
# int8 moments and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 256), (2, 4, 384), (5, 64), (130,), (7,), ()])
def test_q8_and_dq8_bit_equal_to_reference(shape):
    rng = np.random.default_rng(sum(shape) + len(shape))
    x = np.asarray(rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3, shape),
                   dtype=np.float32)
    jq, js = JA._q8(jnp.asarray(x))
    tq, ts = TA._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    like = torch.from_numpy(x)
    np.testing.assert_array_equal(TA._dq8(tq, ts, like).numpy(),
                                  np.asarray(JA._dq8(jq, js, jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(128, 64), (256,), (64, 128)])
def test_q8_stack_matches_the_reference_stacked_leaf(shape):
    """Four layers' leaves: the reference quantizes them stacked [4, ...];
    a last axis of 64 falls back to one scale for all four."""
    rng = np.random.default_rng(len(shape))
    xs = [(rng.standard_normal(shape) * (i + 1)).astype(np.float32) for i in range(4)]
    jq, js = JA._q8(jnp.asarray(np.stack(xs)))
    got = TA._q8_stack([torch.from_numpy(x) for x in xs])
    np.testing.assert_array_equal(np.stack([q.numpy() for q, _ in got]), np.asarray(jq))
    if shape[-1] % TA.BLOCK:
        assert np.asarray(js).ndim == 0
        assert all(s.ndim == 0 and s.item() == float(js) for _, s in got)
    else:
        np.testing.assert_array_equal(np.stack([s.numpy() for _, s in got]), np.asarray(js))


def _llama_update(quantized: bool, steps: int = 2):
    """``steps`` updates of llama3-8b reduced with the same gradients on
    both sides -> (reference params and state, port params and state)."""
    cfg = TR.get("llama3-8b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
              quantized_state=quantized)
    jopt, topt = JA.AdamW(**kw), TA.AdamW(**kw)
    jstate, tstate = jopt.init(jparams), topt.init(params)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        grads = convert.tree_map(params, lambda p: torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.3))
        jgrads = jax.tree.map(jnp.asarray, convert.to_numpy(grads, cfg))
        jparams, jstate, jn = jopt.update(jgrads, jstate, jparams)
        params, tstate, tn = topt.update(grads, tstate, params, cfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    return cfg, (jparams, jstate), (params, tstate)


def _moments(state, cfg):
    return {name: _flat(convert.to_numpy(tree, cfg)) for name, tree in
            (("m", state.m), ("v", state.v))}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_adamw_update_matches_reference(quantized):
    cfg, (jp, js), (tp, ts) = _llama_update(quantized)
    want, got = _flat(jp), _flat(convert.to_numpy(tp, cfg))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6 * float(np.abs(v).max()),
                                   err_msg=k)
    assert int(ts.count) == int(js.count) == 2
    jm, tm = {"m": _flat(js.m), "v": _flat(js.v)}, _moments(ts, cfg)
    for name in ("m", "v"):
        for k, v in jm[name].items():
            g = tm[name][k]
            if k.endswith("/q"):
                assert np.mean(g != v) <= 1e-4 and np.abs(g.astype(int) - v).max() <= 1, k
                continue
            if k.endswith("/s") and v.ndim == 0:       # one scale over the stack
                assert g.shape == (cfg.n_layers,) and np.all(g == g[0]), k
            np.testing.assert_allclose(g, np.broadcast_to(v, g.shape), rtol=0,
                                       atol=1e-6 * float(np.abs(v).max()), err_msg=k)


def test_adamw_decays_stacked_norm_scales_as_the_reference():
    """With zero gradients only the decay moves a leaf: a layer's norm
    scale (stacked [n, d] in the reference) is decayed, ``ln_f`` is not."""
    cfg = TR.get("llama3-8b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    opt = TA.AdamW(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    grads = convert.tree_map(params, torch.zeros_like)
    params, _, _ = opt.update(grads, opt.init(params), params, cfg)
    assert torch.all(params["ln_f"]["scale"] == 1.0)
    assert torch.all(params["layers"][0]["ln1"]["scale"] < 1.0)
    jparams = {"ln_f": {"scale": jnp.ones(4)},
               "groups": (({"ln1": {"scale": jnp.ones((2, 4))}},),)}
    jopt = JA.AdamW(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    jp, _, _ = jopt.update(jax.tree.map(jnp.zeros_like, jparams), jopt.init(jparams), jparams)
    assert bool(jnp.all(jp["ln_f"]["scale"] == 1.0))
    assert bool(jnp.all(jp["groups"][0][0]["ln1"]["scale"] < 1.0))


def test_adamw_converges():
    """Mirror of ``TestAdamW``: the quadratic converges, int8 moments track
    f32, and the reported gradient norm is the one before the clip."""
    def run(opt, steps=200):
        params = {"x": torch.tensor([2.0, -1.5]), "w": torch.ones((4, 4))}
        target = torch.tensor([0.5, 0.5])
        state = opt.init(params)

        def loss(p):
            return torch.sum((p["x"] - target) ** 2) + 0.1 * torch.sum(p["w"] ** 2)
        for _ in range(steps):
            leaves = [params["x"].requires_grad_(True), params["w"].requires_grad_(True)]
            gx, gw = torch.autograd.grad(loss(params), leaves)
            params = {"x": params["x"].detach(), "w": params["w"].detach()}
            params, state, _ = opt.update({"x": gx, "w": gw}, state, params)
        return float(loss(params))
    l32 = run(TA.AdamW(lr=5e-2, weight_decay=0.0, warmup_steps=5, total_steps=10_000))
    assert l32 < 1e-2
    l8 = run(TA.AdamW(lr=5e-2, weight_decay=0.0, warmup_steps=5, quantized_state=True))
    assert abs(l8 - run(TA.AdamW(lr=5e-2, weight_decay=0.0, warmup_steps=5))) < 0.05
    opt = TA.AdamW(clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    _, _, gnorm = opt.update({"x": torch.full((3,), 1e6)}, opt.init(params), params)
    assert float(gnorm) > 1e5


# ---------------------------------------------------------------------------
# checkpoints (mirror of TestCheckpoint)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_bit_exact(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": [torch.ones(5), torch.zeros(2)],
                  "e": TA.AdamWState(count=torch.tensor(3), m={"q": torch.ones(2, dtype=torch.int8),
                                                               "s": torch.tensor(0.5)},
                                     v=torch.full((2,), -1.5))}}
    C.save(tmp_path, 5, tree, {"data_step": 5})
    got, extra = C.restore(tmp_path, tree)
    assert extra["data_step"] == 5
    assert isinstance(got["b"]["e"], TA.AdamWState)
    for x, y in zip(convert.tree_leaves(tree), convert.tree_leaves(got)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    names = sorted(p.name for p in (tmp_path / "step_5").iterdir())
    assert "b__d__#1.npy" in names and "b__e__m__q.npy" in names and "COMMIT" in names
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_5"]


def test_checkpoint_uncommitted_invisible(tmp_path):
    p = C.save(tmp_path, 1, {"a": torch.ones(3)})
    (p / "COMMIT").unlink()
    assert C.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        C.restore(tmp_path, {"a": torch.ones(3)})


def test_checkpoint_async_and_gc(tmp_path):
    ck = C.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.full((3,), float(s))})
    ck.wait()
    assert C.latest_step(tmp_path) == 4
    steps = sorted(int(p.name.split("_")[1]) for p in Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_async_checkpoint_copies_before_an_in_place_step(tmp_path):
    """The tree is copied to host memory before ``save`` returns: an
    in-place update right after (the train step's) does not reach the file."""
    t = torch.zeros(1000)
    ck = C.AsyncCheckpointer(tmp_path)
    ck.save(1, {"t": t})
    t.add_(1.0)
    ck.wait()
    got, _ = C.restore(tmp_path, {"t": t})
    assert torch.count_nonzero(got["t"]) == 0


def test_restore_onto_a_device(tmp_path):
    C.save(tmp_path, 1, {"w": torch.arange(16.0).reshape(4, 4)})
    got, _ = C.restore(tmp_path, {"w": torch.zeros(4, 4)}, device="cpu")
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], torch.arange(16.0).reshape(4, 4))


# ---------------------------------------------------------------------------
# fault tolerance (mirror of TestResilience)
# ---------------------------------------------------------------------------
def _resilient_run(fail_at, tmp, n_steps=20, quantized=False):
    cfg = TR.get("granite-3-8b").reduced()
    data = SyntheticTokens(cfg, ShapeConfig("tiny", 16, 2, "train"), seed=7)
    params = TM.init_params(cfg, seed=0, device="cpu")
    opt = TA.AdamW(lr=1e-3, warmup_steps=1, total_steps=100, quantized_state=quantized)
    runner = ResilientRunner(step_fn=make_train_step(cfg, Runtime(), opt), ckpt_dir=str(tmp),
                             ckpt_every=5, injector=FailureInjector(fail_at=fail_at))
    p, _, log = runner.run(params, opt.init(params), data, n_steps, async_ckpt=False)
    return p, log, runner


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_recovers_and_matches_clean_run(tmp_path, quantized):
    p_clean, log_clean, _ = _resilient_run((), tmp_path / "clean", quantized=quantized)
    p_fail, log_fail, runner = _resilient_run((7, 13), tmp_path / "fail", quantized=quantized)
    assert runner.injector.seen == {7, 13}
    for a, b in zip(convert.tree_leaves(p_clean), convert.tree_leaves(p_fail)):
        assert torch.equal(a, b)
    clean = {m["step"]: m["loss"] for m in log_clean}
    assert [m["step"] for m in log_fail] == [*range(7), *range(5, 13), *range(10, 20)]
    for m in log_fail:
        assert m["loss"] == clean[m["step"]]


def test_non_finite_loss_restores(tmp_path):
    """A step whose loss is not finite counts as a failure: the runner
    restores the last checkpoint and replays."""
    calls = []

    def step(params, state, batch):
        calls.append(int(batch["i"]))
        bad = len(calls) == 4
        return params + 1, state, {"loss": torch.tensor(float("nan") if bad else 1.0)}

    class Data:
        def batch_at(self, i):
            return {"i": i}
    runner = ResilientRunner(step_fn=step, ckpt_dir=str(tmp_path), ckpt_every=2)
    p, _, log = runner.run(torch.zeros(()), torch.zeros(()), Data(), 5, async_ckpt=False)
    assert calls == [0, 1, 2, 3, 2, 3, 4] and [m["step"] for m in log] == [0, 1, 2, 2, 3, 4]
    assert float(p) == 5.0


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0)
    for s, dt in enumerate([1.0, 1.0, 1.0, 5.0, 1.0]):
        wd.observe(s, dt)
    assert len(wd.events) == 1 and wd.events[0][0] == 3


# ---------------------------------------------------------------------------
# gradient compression (mirror of TestGradCompression)
# ---------------------------------------------------------------------------
def test_compress_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    g = (rng.standard_normal(257) * 10).astype(np.float32)
    res = (rng.standard_normal(257) * 0.01).astype(np.float32)
    jq, js, jr = JFC.compress(jnp.asarray(g), jnp.asarray(res))
    tq, ts, tr = FC.compress(torch.from_numpy(g), torch.from_numpy(res))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(FC.decompress(tq, ts).numpy(), np.asarray(JFC.decompress(jq, js)))
    zeros = FC.init_residuals({"a": torch.ones(2, 3), "b": [torch.ones(4)]})
    assert zeros["a"].shape == (2, 3) and torch.count_nonzero(zeros["b"][0]) == 0


def test_error_feedback_converges_exactly_in_expectation():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    res, acc = torch.zeros(256), torch.zeros(256)
    for _ in range(50):
        q, s, res = FC.compress(g, res)
        acc = acc + FC.decompress(q, s)
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=float(s) * 1.1)


def test_quantization_bounded():
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32)) * 10
    q, s, res = FC.compress(g, torch.zeros(64))
    assert float(res.abs().max()) <= float(s) * 0.51


# ---------------------------------------------------------------------------
# data pipeline (mirror of TestDataPipeline)
# ---------------------------------------------------------------------------
def test_deterministic_skip_ahead():
    cfg = TR.get("llama3-8b").reduced()
    shape = ShapeConfig("tiny", 8, 4, "train")
    a = SyntheticTokens(cfg, shape, seed=11)
    b = SyntheticTokens(cfg, shape, seed=11).skip_to(3)
    for _ in range(3):
        next(a)
    ba, bb = next(a), next(b)
    np.testing.assert_array_equal(ba["inputs"], bb["inputs"])
    np.testing.assert_array_equal(ba["labels"], bb["labels"])


@pytest.mark.parametrize("arch", ["llama3-8b", "chameleon-34b", "whisper-tiny"])
def test_batches_bit_equal_to_reference(arch):
    tcfg, jcfg = TR.get(arch).reduced(), JR.get(arch).reduced()
    mine = SyntheticTokens(tcfg, ShapeConfig("t", 12, 3, "train"), seed=5)
    ref = JTokens(jcfg, JShape("t", 12, 3, "train"), seed=5)
    for step in (0, 1, 9):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    t = put_batch(mine.batch_at(0), "cpu")
    assert all(isinstance(v, torch.Tensor) for v in t.values())
    assert dataclasses.asdict(mine.shape) == dataclasses.asdict(ref.shape)
