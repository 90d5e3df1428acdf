"""The port's model layer against the JAX reference on llama3-8b reduced.

Both packages run the same weights (the JAX init, converted through numpy)
on the same numpy inputs.  Integer leaves must be equal; logits within
1e-3 of the logit scale (f32 sums run in another order, and a last-bit
difference can flip one int8 activation code downstream), with the argmax
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import kvcache as JKV
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BACKENDS = ["dense", "ref_int8", "fused_int8", "pim_bitserial"]
JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
MAX_LEN = 48


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.key(0), JCFG)
    qparams = j_quantize_tree(params)
    return {"j": params, "jq": qparams,
            "t": convert.from_numpy(_np(params), device="cpu"),
            "tq": convert.from_numpy(_np(qparams), device="cpu")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _close(j, t, frac=1e-3):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * scale)
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = JR.get("llama3-8b"), TR.get("llama3-8b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()


@pytest.mark.parametrize("tree", ["j", "jq"])
def test_convert_round_trips(weights, tree):
    src = _flat(_np(weights[tree]))
    back = _flat(convert.to_numpy(convert.from_numpy(_np(weights[tree]), device="cpu"), TCFG))
    assert src.keys() == back.keys()
    for k in src:
        assert src[k].dtype == back[k].dtype, k
        np.testing.assert_array_equal(src[k], back[k], err_msg=k)


def test_convert_unstacks_layers_in_order(weights):
    layers = weights["t"]["layers"]
    assert len(layers) == JCFG.n_layers
    stacked = weights["j"]["groups"][0][0]
    for i, layer in enumerate(layers):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(stacked["attn"]["wq"][i]))
        np.testing.assert_array_equal(layer["mlp"]["w_down"].numpy(),
                                      np.asarray(stacked["mlp"]["w_down"][i]))


def test_quantize_tree_matches_reference_exactly(weights):
    want = _flat(convert.to_numpy(weights["tq"], TCFG))
    got = _flat(convert.to_numpy(t_quantize_tree(weights["t"]), TCFG))
    assert want.keys() == got.keys()
    assert "/groups/0/0/attn/wq_q" in got and "/lm_head/w" in got and "/embed/w" in got
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_params_mirrors_reference_structure(weights):
    mine = TM.init_params(TCFG, seed=0, device="cpu")
    ref = weights["t"]
    shapes = {k: v.shape for k, v in _flat(convert.to_numpy(mine, TCFG)).items()}
    assert shapes == {k: v.shape for k, v in _flat(convert.to_numpy(ref, TCFG)).items()}
    # the analytical count leaves out the final norm (ln_f), as in the reference
    assert sum(int(np.prod(s)) for s in shapes.values()) == TCFG.param_count() + TCFG.d_model
    again = TM.init_params(TCFG, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wk"], mine["layers"][1]["attn"]["wk"])


def _prompts(b=2, t=24, seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tree", ["float", "quantized"])
def test_prefill_logits_match(weights, backend, tree):
    toks = _prompts()
    jp, tp = (weights["j"], weights["t"]) if tree == "float" else (weights["jq"], weights["tq"])
    jl, jstate = JM.prefill(jp, JCFG, {"inputs": jnp.asarray(toks)}, MAX_LEN,
                            JT.Runtime(backend=backend))
    tl, tstate = TM.prefill(tp, TCFG, {"inputs": torch.from_numpy(toks)}, MAX_LEN,
                            TT.Runtime(backend=backend))
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    # the int8 cache rows agree but for rare codes on a rounding boundary
    jk = np.asarray(jstate["groups"][0][0]["k_q"])
    tk = np.stack([c["k_q"].numpy() for c in tstate["layers"]])
    assert np.mean(jk == tk) > 0.999


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_ragged_prefill_matches(weights, backend):
    toks = _prompts(3, 32, seed=4)
    lengths = np.array([32, 9, 17], np.int32)
    jl, jstate = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks),
                                                 "lengths": jnp.asarray(lengths)},
                            MAX_LEN, JT.Runtime(backend=backend))
    tl, tstate = TM.prefill(weights["t"], TCFG, {"inputs": torch.from_numpy(toks),
                                                 "lengths": torch.from_numpy(lengths)},
                            MAX_LEN, TT.Runtime(backend=backend))
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), lengths)


def _to_port_state(jstate):
    return convert.from_numpy(_np(jstate), device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_steps_match(weights, backend):
    """Three greedy decode steps from one prefilled state (ragged slot
    positions) under each backend: logits close, argmax equal."""
    toks = _prompts(2, 24, seed=2)
    lengths = np.array([24, 13], np.int32)
    _, jstate = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks),
                                                "lengths": jnp.asarray(lengths)},
                           MAX_LEN, JT.Runtime())
    tstate = _to_port_state(jstate)
    tok = np.array([5, 77], np.int32)
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend=backend)
    for _ in range(3):
        jl, jstate = JM.decode_step(weights["jq"], JCFG, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(weights["tq"], TCFG, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_write_and_read_slot_match_reference_with_clamp():
    rng = np.random.default_rng(6)
    jstate = JM.init_decode_state(JCFG, 3, 16)
    jstate = jax.tree.map(lambda a: jnp.asarray(rng.integers(-100, 100, a.shape).astype(a.dtype)),
                          jstate)
    one = JM.init_decode_state(JCFG, 1, 12)          # shorter row than the pool
    one = jax.tree.map(lambda a: jnp.asarray(rng.integers(-100, 100, a.shape).astype(a.dtype)),
                       one)
    tstate, tone = _to_port_state(jstate), _to_port_state(one)
    for slot in (1, 7):                                 # 7 clamps to the last slot
        jstate = JT.write_slot(jstate, jnp.int32(slot), one)
        tstate = TT.write_slot(tstate, slot, tone)
        want = _flat(_np(_to_port_state(jstate)))
        got = _flat({k: v for k, v in tstate.items()})
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = TT.read_slot(tstate, 1)
    jback = _to_port_state(JT.read_slot(jstate, jnp.int32(1)))
    for k, v in _flat(jback).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)


@pytest.mark.parametrize("pos", [[0, 5], [15, 3], [40, 14]])   # clamps past S - T
@pytest.mark.parametrize("t", [1, 3])
def test_batched_update_clamps_like_reference(pos, t):
    rng = np.random.default_rng(t)
    buf = rng.integers(-9, 9, (2, 16, 2, 4)).astype(np.int8)
    new = rng.integers(-9, 9, (2, t, 2, 4)).astype(np.int8)
    want = JKV.batched_update(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(pos, jnp.int32))
    got = TKV.batched_update(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                             torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start", [0, 5, 14])
def test_chunk_update_clamps_like_reference(start):
    rng = np.random.default_rng(start)
    buf = rng.standard_normal((2, 16, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 4, 2, 4)).astype(np.float32)
    want = JKV.chunk_update(jnp.asarray(buf), jnp.asarray(new), start)
    got = TKV.chunk_update(torch.from_numpy(buf.copy()), torch.from_numpy(new), start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_bytes_match_reference():
    jstate = JM.init_decode_state(JCFG, 2, 32)
    tstate = TM.init_decode_state(TCFG, 2, 32, device="cpu")
    assert TKV.cache_bytes(tstate) == JKV.cache_bytes(jstate)
    jc = JKV.init_cache(2, 3, 8, 2, 16)
    tc = TKV.init_cache(2, 3, 8, 2, 16, device="cpu")
    assert TKV.cache_bytes(tc) == JKV.cache_bytes(jc)
