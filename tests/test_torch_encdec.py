"""The port's encoder-decoder (whisper-tiny reduced) against the JAX
reference.

The reduced config has 2 encoder and 4 decoder layers, d 128, MHA with 4
heads of 32, gelu, LayerNorm, sinusoidal positions, 16 encoder frames and a
tied vocab of 512.  Weights are converted from the JAX init (the
reference's stacked ``enc`` / ``dec`` trees, per-layer lists in the port)
and back.  ``encode``, ``prefill`` (the self-attention and cross K/V
quantized into the int8 cache) and 8 decode steps are held under the four
backends: logits within 1e-3 of the logit scale with the argmax equal, the
int8 codes 99.9% equal and their scales within rtol 1e-5 (the packages'
float K/V differ by ulps; decode starts from JAX's prefilled state).  On
the float self and cross K/V that JAX's own prefill quantizes, the port's
quantizer gives every code and scale of the reference's quantizer, bit for
bit.
``Engine.generate`` serves the same tokens as JAX's (the reference's
``tests/test_system.py`` encoder-decoder case); the continuous engine
refuses the family with the reference's error, and the serve CLI runs the
reference's fixed-batch path.  The Pallas paths run in interpret mode, as
the reference's own tests run them on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import encdec as JE
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as launch
from repro_torch.models import encdec as TE
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_parity import check_kv_quantizations, reference_kv_quantizations
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "whisper-tiny"
BACKENDS = ["dense", "ref_int8", "fused_int8", "pim_bitserial"]
JCFG = JR.get(ARCH).reduced()
TCFG = TR.get(ARCH).reduced()
MAX_LEN = 32
DECODE_STEPS = 8
CACHE = ("k_q", "k_s", "v_q", "v_s", "xk_q", "xk_s", "xv_q", "xv_s")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(j, t, frac=1e-3, argmax=True):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * float(np.abs(j).max()))
    if argmax:
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


def _inputs(batch=2, tokens=6, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, JCFG.encoder_seq, JCFG.d_model)).astype(np.float32)
    toks = rng.integers(0, JCFG.vocab_size, (batch, tokens)).astype(np.int32)
    return frames, toks


def _state_from_jax(js) -> dict:
    """The reference's stacked decode state ([L, B, ...] leaves and a scalar
    ``pos``) as the port's per-layer list and [B] cursor."""
    B = js["k_q"].shape[1]
    layers = [{k: torch.from_numpy(np.array(js[k][i])) for k in CACHE}
              for i in range(js["k_q"].shape[0])]
    return {"layers": layers, "pos": torch.full((B,), int(js["pos"]), dtype=torch.int32)}


def _same_state(js, ts):
    want = _state_from_jax(js)
    np.testing.assert_array_equal(ts["pos"].numpy(), want["pos"].numpy())
    for i, (w, t) in enumerate(zip(want["layers"], ts["layers"])):
        for k in CACHE:
            a, b = t[k].numpy(), w[k].numpy()
            assert a.shape == b.shape, (i, k)
            if k.endswith("_q"):
                assert np.mean(a == b) > 0.999, (i, k)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.key(0), JCFG)
    qparams = j_quantize_tree(params)
    return {"j": params, "jq": qparams,
            "t": convert.from_numpy(_np(params), device="cpu"),
            "tq": convert.from_numpy(_np(qparams), device="cpu")}


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = JR.get(ARCH), TR.get(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    TM.check_supported(t)
    with pytest.raises(NotImplementedError, match="encdec.py"):
        TT.check_supported(t)


@pytest.mark.parametrize("tree", ["j", "jq"])
def test_convert_round_trip_and_quantize(weights, tree):
    """``enc`` / ``dec`` convert to per-layer lists and back, float and
    quantized, leaf for leaf; the port's ``init_params`` draws the
    reference's leaves and shapes, and ``quantize_tree`` of the port's tree
    equals the reference's bit for bit."""
    ref = _np(weights[tree])
    port = convert.from_numpy(ref, device="cpu")
    assert len(port["enc"]) == JCFG.encoder_layers and len(port["dec"]) == JCFG.n_layers
    back = convert.to_numpy(port, TCFG)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    if tree == "j":
        mine = convert.to_numpy(TM.init_params(TCFG, seed=1, device="cpu"), TCFG)
        assert jax.tree.structure(mine) == jax.tree.structure(ref)
        assert [a.shape for a in jax.tree.leaves(mine)] == [a.shape for a in jax.tree.leaves(ref)]
    else:
        got = convert.to_numpy(t_quantize_tree(weights["t"]), TCFG)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)


def test_decode_state_layout(weights):
    """The port's decode state holds the reference's leaves a layer (self
    K/V of ``max_len`` rows, cross K/V of ``encoder_seq`` rows)."""
    js = JE.init_decode_state(JCFG, 3, MAX_LEN)
    ts = TM.init_decode_state(TCFG, 3, MAX_LEN, device="cpu")
    want = _state_from_jax(js)
    for w, t in zip(want["layers"], ts["layers"], strict=True):
        assert {k: (v.shape, v.dtype) for k, v in t.items()} == {
            k: (v.shape, v.dtype) for k, v in w.items()}
    assert ts["pos"].shape == (3,)


# ---------------------------------------------------------------------------
# encode, prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [1, 3])
def test_encode_matches_reference(weights, batch):
    """The encoder (sinusoidal positions, non-causal attention over key
    blocks, float weights as prefill serves them) within 1e-5 of its
    output's scale."""
    frames, _ = _inputs(batch=batch, seed=batch)
    je = JE.encode(weights["j"], JCFG, jnp.asarray(frames), JT.Runtime())
    te = TE.encode(weights["t"], TCFG, torch.from_numpy(frames), TT.Runtime())
    _close(je, te, frac=1e-5, argmax=False)


_RUNS: dict = {}


def _runs(weights, backend: str) -> dict:
    """Both packages' prefill of two prompts of 6 tokens over 16 frames and
    ``DECODE_STEPS`` greedy decode steps (W8A8 weights), the port's from
    JAX's prefilled state, computed once a backend."""
    if backend in _RUNS:
        return _RUNS[backend]
    frames, toks = _inputs()
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    jl, js = JM.prefill(weights["j"], JCFG, {"frames": jnp.asarray(frames),
                                             "tokens": jnp.asarray(toks)}, MAX_LEN, jrt)
    tl, ts = TM.prefill(weights["t"], TCFG, {"frames": torch.from_numpy(frames),
                                             "tokens": torch.from_numpy(toks)}, MAX_LEN, trt)
    out = {"prefill": (np.asarray(jl), tl.clone(), _np(js), ts), "decode": []}
    ts = _state_from_jax(_np(js))
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 4))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(DECODE_STEPS):
        jl, js = jdec(weights["jq"], JCFG, js, jnp.asarray(tok), jrt)
        tl, ts = TM.decode_step(weights["tq"], TCFG, ts, torch.from_numpy(tok), trt)
        out["decode"].append((np.asarray(jl), tl.clone()))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    out["final"] = (_np(js), ts)
    _RUNS[backend] = out
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_matches_reference(weights, backend):
    jl, tl, js, ts = _runs(weights, backend)["prefill"]
    _close(jl, tl)
    _same_state(js, ts)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_steps_match_reference(weights, backend):
    """Self-attention through ``rt.backend`` (B2's plain version under
    ``fused_int8`` here), cross-attention on the plain int8 path under every
    backend, as the reference."""
    run = _runs(weights, backend)
    for jl, tl in run["decode"]:
        _close(jl, tl)
    _same_state(*run["final"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_kv_quantizer_bit_equal_on_reference_floats(weights, backend):
    """The port's ``quantize_kv`` on each float self and cross K/V that
    JAX's prefill writes into the int8 caches: every code and scale equal
    to the reference's ``quantize_kv`` on them, bit for bit
    (:func:`torch_parity.check_kv_quantizations`)."""
    frames, toks = _inputs()
    with reference_kv_quantizations(JE) as seen:
        JM.prefill(weights["j"], JCFG, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(toks)}, MAX_LEN,
                   JT.Runtime(backend=backend))
    assert len(seen) == 4 * JCFG.n_layers
    assert sorted({x.shape[1] for x, _, _ in seen}) == sorted({toks.shape[1], JCFG.encoder_seq})
    check_kv_quantizations(seen)


def test_decode_step_updates_the_state_in_place(weights):
    """Every leaf of the state keeps its tensor (a captured step replays
    over fixed addresses); the cross K/V do not change, the cursor
    advances by one."""
    frames, toks = _inputs()
    _, state = TM.prefill(weights["t"], TCFG, {"frames": torch.from_numpy(frames),
                                               "tokens": torch.from_numpy(toks)}, MAX_LEN,
                          TT.Runtime())
    ptrs = [t.data_ptr() for c in state["layers"] for t in c.values()] + [state["pos"].data_ptr()]
    cross = [c["xk_q"].clone() for c in state["layers"]]
    _, new = TM.decode_step(weights["tq"], TCFG, state, torch.tensor([1, 2], dtype=torch.int32),
                            TT.Runtime())
    assert ptrs == [t.data_ptr() for c in new["layers"] for t in c.values()] + [
        new["pos"].data_ptr()]
    assert all(torch.equal(a, c["xk_q"]) for a, c in zip(cross, new["layers"]))
    assert new["pos"].tolist() == [toks.shape[1] + 1] * 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_engine_generate_token_identical(weights, backend):
    """``Engine.generate`` from ``{"frames", "tokens"}``: 8 greedy steps
    token-identical to JAX's engine (``tests/test_system.py``'s
    encoder-decoder case)."""
    frames, toks = _inputs(seed=2)
    want, _ = JEngine(cfg=JCFG, params=weights["j"], rt=JT.Runtime(backend=backend),
                      max_len=MAX_LEN).generate({"frames": jnp.asarray(frames),
                                                 "tokens": jnp.asarray(toks)}, 8)
    got, tm = Engine(cfg=TCFG, params=weights["t"], rt=TT.Runtime(backend), max_len=MAX_LEN,
                     device="cpu").generate({"frames": frames, "tokens": toks}, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm["tpot_s"] > 0


def test_continuous_engine_refuses_encoder_decoders(weights):
    """The reference's continuous engine refuses the family, and the
    port's with the same error; the decoder-only entry points raise too."""
    with pytest.raises(NotImplementedError, match="decoder-only") as jerr:
        JCB(JCFG, weights["j"], n_slots=2, max_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="decoder-only") as terr:
        ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=MAX_LEN, device="cpu")
    assert str(terr.value) == str(jerr.value)
    state = TM.init_decode_state(TCFG, 1, MAX_LEN, device="cpu")
    for call in (lambda: TM.init_prefill_carry(TCFG, 64, device="cpu"),
                 lambda: TM.multi_decode_step(weights["tq"], TCFG, state,
                                              torch.zeros((1,), dtype=torch.int32), 2,
                                              TT.Runtime()),
                 lambda: TM.verify_step(weights["tq"], TCFG, state,
                                        torch.zeros((1, 2), dtype=torch.int32), TT.Runtime())):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            call()


def test_serve_cli_fixed_batch(capsys):
    """``--arch whisper-tiny`` runs the reference's fixed-batch path (frames
    drawn from the seed); the continuous mode raises as the reference's."""
    launch.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "4",
                 "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=whisper-tiny-smoke batch=2 prompt=4 steps=3" in out and "TPOT" in out
    with pytest.raises(NotImplementedError, match="decoder-only"):
        launch.main(["--arch", ARCH, "--reduced", "--continuous", "--requests", "2",
                     "--slots", "2", "--steps", "3", "--device", "cpu"])
