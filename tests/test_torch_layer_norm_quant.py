"""The LayerNorm fused with the activation quantizer on the CPU.

Under ``fused_int8`` and ``pim_bitserial`` a LayerNorm whose output feeds
quantized linears (OPT's ``ln1`` and ``ln2``, whisper's decoder ``ln1``,
``ln_x`` and ``ln2``) runs ``kernels/layer_norm.py`` ``layer_norm_quant``:
on the card one launch of ``csrc/layer_norm.cu``'s forward body with the
quantizer epilogue, on CPU tensors its plain version, the norm followed by
``quantize_activation``.  The tests hold the plain version to that pair bit
for bit, the norm and the quantizer to the JAX reference on the same
numpy inputs, the routing of ``layers.apply_norm_q``, and reduced OPT-30B
and whisper-tiny decode steps with the pairs to the same steps with a
quantizer a linear (bit for bit) and to JAX's step.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import quant as jq
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import quant as tq
from repro_torch.kernels import layer_norm as lnk
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [(1, 64), (5, 300), (2, 3, 384), (7, 768), (3, 7168)]


def _inputs(shape, seed):
    """x (a zero row, a constant row and rows scaled by 1e-20 and 1e20 among
    random ones), scale and bias, from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0                       # h is the bias
    if flat.shape[0] > 3:
        flat[1] = 1.7
        flat[2] *= np.float32(1e-20)
        flat[3] *= np.float32(1e20)
    d = shape[-1]
    return (x, rng.standard_normal(d).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_is_the_norm_then_the_quantizer(shape):
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(shape, shape[-1]))
    h, codes, scales = lnk.layer_norm_quant_plain(x, scale, bias)
    assert torch.equal(h, lnk.layer_norm_plain(x, scale, bias))
    want_q, want_s = tq.quantize_activation(h)
    assert torch.equal(codes, want_q) and torch.equal(scales, want_s)
    assert codes.dtype == torch.int8 and scales.shape == (*shape[:-1], 1)
    got = lnk.layer_norm_quant(x, scale, bias)
    assert all(torch.equal(a, b) for a, b in zip(got, (h, codes, scales)))


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_against_jax(shape):
    """h within rtol 1e-6 and 1e-6 of the output's scale of the reference's
    LayerNorm (``apply_norm``'s ``"bias"`` branch) on the same inputs, and
    the codes and scales the reference's quantizer gives on the port's h,
    bit for bit.  A constant row c is the one exception to the tolerance:
    its output is the bias plus the mean's rounding error times
    rsqrt(eps) (316), which depends on the order of the sum, so both
    packages' rows are held within 8 ulps of c, so amplified, of the bias."""
    x, scale, bias = _inputs(shape, shape[-1] + 1)
    h, codes, scales = lnk.layer_norm_quant(*(torch.from_numpy(a) for a in (x, scale, bias)))
    want = np.asarray(JL.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                    jnp.asarray(x)))
    got = h.numpy().reshape(-1, shape[-1])
    want = want.reshape(-1, shape[-1])
    const = [i for i, r in enumerate(x.reshape(-1, shape[-1])) if r.min() == r.max() != 0]
    rest = [i for i in range(got.shape[0]) if i not in const]
    np.testing.assert_allclose(got[rest], want[rest], rtol=1e-6,
                               atol=1e-6 * float(np.abs(want[rest]).max()))
    for i in const:
        c = x.reshape(-1, shape[-1])[i, 0]
        room = 8 * np.spacing(c) / np.sqrt(np.float32(1e-5)) * np.abs(scale) + 1e-6
        assert (np.abs(got[i] - bias) <= room).all() and (np.abs(want[i] - bias) <= room).all()
    jc, js = jq.quantize_activation(jnp.asarray(h.numpy()))
    np.testing.assert_array_equal(np.asarray(jc), codes.numpy())
    np.testing.assert_array_equal(np.asarray(js), scales.numpy())


def _readers(kind):
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32))
    q = L.quantize_linear_params({"w": w})
    if kind == "quantized":
        return {"wq_q": q["w_q"], "wq_s": q["w_s"], "wk": w}
    return {"wq_q": q["w_q"], "wq_s": q["w_s"], "wq_smooth": torch.ones(16)}


@pytest.mark.parametrize("backend", ["ref_int8", "fused_int8", "pim_bitserial"])
@pytest.mark.parametrize("readers", ["quantized", "smooth"])
def test_apply_norm_q_routes_a_layer_norm_through_the_fused_entry(backend, readers,
                                                                  monkeypatch):
    """A LayerNorm read by a quantized linear without ``smooth`` under the
    two kernel backends calls ``layer_norm_quant`` once and no unfused
    LayerNorm; a smoothed reader, or ``ref_int8``, calls the unfused
    LayerNorm and no fused entry."""
    calls = {"layer_norm_quant": 0, "layer_norm": 0}
    for name in calls:
        real = getattr(lnk, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(lnk, name, counted)
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((3, 5, 16), 3))
    h, pair = L.apply_norm_q({"scale": scale, "bias": bias}, x, backend, _readers(readers),
                             A.INPUT_LINEARS)
    assert torch.equal(h, lnk.layer_norm_plain(x, scale, bias))
    if backend != "ref_int8" and readers == "quantized":
        assert calls == {"layer_norm_quant": 1, "layer_norm": 0}
        assert all(torch.equal(a, b) for a, b in zip(pair, tq.quantize_activation(h)))
    else:
        assert calls == {"layer_norm_quant": 0, "layer_norm": 1} and pair is None


@contextlib.contextmanager
def _counting():
    """Counts ``quantize_activation``'s calls while the block runs (every
    caller reaches it through the module ``core.quant``)."""
    real, n = tq.quantize_activation, [0]

    def counted(x):
        n[0] += 1
        return real(x)
    tq.quantize_activation = counted
    try:
        yield n
    finally:
        tq.quantize_activation = real


def _clone(state):
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
            "pos": state["pos"].clone()}


def _both_ways(fn, monkeypatch):
    """``fn()`` with the pairs, then with a quantizer a linear: (outputs,
    quantizer calls) each."""
    with _counting() as n:
        with_pairs = fn()
    with monkeypatch.context() as m:
        m.setattr(L, "PAIR_BACKENDS", ())
        with _counting() as n0:
            without = fn()
    return (with_pairs, n[0]), (without, n0[0])


@pytest.fixture(scope="module")
def whisper():
    cfg = TR.get("whisper-tiny").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    batch = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 7), generator=g)}
    return cfg, params, quantize_tree(params), batch


@pytest.mark.parametrize("backend", ["fused_int8", "pim_bitserial"])
def test_whisper_decode_steps_are_the_same_bits_with_the_pairs(whisper, backend, monkeypatch):
    """Reduced whisper-tiny: 4 decode steps from one prefill with the pairs
    (each decoder layer's ``ln1``, ``ln_x`` and ``ln2`` through the fused
    entry) and with a quantizer a linear give the same logits, bit for bit;
    the pairs spare two quantizer calls a layer a step (q, k and v read one
    pair)."""
    cfg, params, qparams, batch = whisper
    rt = TT.Runtime(backend)
    _, state = TM.prefill(params, cfg, batch, 32, rt)

    def steps():
        st, tok, out = _clone(state), torch.tensor([3, 5], dtype=torch.int32), []
        for _ in range(4):
            lg, st = TM.decode_step(qparams, cfg, st, tok, rt)
            out.append(lg)
            tok = torch.argmax(lg, -1).to(torch.int32)
        return torch.stack(out)
    (lg, n), (lg0, n0) = _both_ways(steps, monkeypatch)
    assert torch.equal(lg, lg0)
    assert n0 - n == 4 * 2 * cfg.n_layers and n == 4 * 6 * cfg.n_layers


def test_opt_step_with_the_pairs_stays_close_to_jax():
    """The reference's reduced OPT-30B decode step and the port's with the
    pairs (``layer_norm_quant`` for ``ln1`` and ``ln2``), on the JAX init
    converted through numpy: logits within 1e-3 of the logit scale (f32
    sums run in other orders), argmax equal."""
    jcfg, tcfg = JR.get("opt-30b").reduced(), TR.get("opt-30b").reduced()
    params = JM.init_params(jax.random.key(0), jcfg)
    qparams = j_quantize_tree(params)
    tq_params = convert.from_numpy(jax.tree.map(np.asarray, qparams), device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    _, jstate = JM.prefill(params, jcfg, {"inputs": jnp.asarray(toks)}, 32, JT.Runtime())
    tstate = convert.from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    tok = np.array([5, 77], np.int32)
    jl, _ = JM.decode_step(qparams, jcfg, jstate, jnp.asarray(tok), JT.Runtime("fused_int8"))
    with _counting() as n:
        tl, _ = TM.decode_step(tq_params, tcfg, tstate, torch.from_numpy(tok),
                               TT.Runtime("fused_int8"))
    assert n[0] == 4 * tcfg.n_layers          # ln1, wo, ln2, w_down
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3 * float(np.abs(jl).max()))
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
