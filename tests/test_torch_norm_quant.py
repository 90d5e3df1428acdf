"""A norm's output quantized once for every linear that reads it, on the
CPU.

Under ``fused_int8`` and ``pim_bitserial`` a norm whose output feeds
quantized linears hands them its int8 pair (``layers.apply_norm_q``): an
RMSNorm through the entry fused with the activation quantizer
(``kernels/rms_norm.py`` ``rms_norm_quant``, whose plain version is the
norm followed by ``quantize_activation``), a LayerNorm by quantizing its
output once.  The pair is the quantizer's bits on the norm's output, so a
model step gives the same logits, bit for bit, with one quantizer a norm
output as with one a linear; the tests count the quantizer's calls and
hold the codes against the JAX reference's quantizer.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import quant as jq
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import quant as tq
from repro_torch.kernels import layer_norm as lnk
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.quantize import quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _rows(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0                       # the scale's floor
    if flat.shape[0] > 2:
        flat[1] *= np.float32(1e-20)
        flat[2] *= np.float32(1e20)
    return torch.from_numpy(x)


@pytest.mark.parametrize("shape", [(1, 64), (5, 300), (2, 3, 2560), (7, 4096)])
def test_fused_plain_is_the_norm_then_the_quantizer(shape):
    x = _rows(shape, shape[-1])
    scale = torch.from_numpy(np.random.default_rng(1).standard_normal(shape[-1])
                             .astype(np.float32))
    h, codes, scales = rn.rms_norm_quant_plain(x, scale)
    assert torch.equal(h, rn.rms_norm_plain(x, scale))
    want_q, want_s = tq.quantize_activation(h)
    assert torch.equal(codes, want_q) and torch.equal(scales, want_s)
    assert codes.dtype == torch.int8 and scales.shape == (*shape[:-1], 1)
    # the reference's quantizer on the same rows gives the same codes and scales
    jc, js = jq.quantize_activation(jnp.asarray(h.numpy()))
    np.testing.assert_array_equal(np.asarray(jc), codes.numpy())
    np.testing.assert_array_equal(np.asarray(js), scales.numpy())
    assert [t.shape for t in rn.rms_norm_quant(x, scale)] == [h.shape, codes.shape,
                                                              scales.shape]


def _readers(kind):
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32))
    q = L.quantize_linear_params({"w": w})
    if kind == "quantized":
        return {"wq_q": q["w_q"], "wq_s": q["w_s"], "wk": w}
    if kind == "smooth":
        return {"wq_q": q["w_q"], "wq_s": q["w_s"], "wq_smooth": torch.ones(16)}
    return {"wq": w, "wk": w}


@pytest.mark.parametrize("backend", ["dense", "ref_int8", "fused_int8", "pim_bitserial"])
@pytest.mark.parametrize("readers", ["quantized", "float", "smooth"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_q_hands_the_pair_where_a_quantized_linear_reads(backend, readers, norm):
    """The pair comes only under the two kernel backends and only where a
    reader is quantized without ``smooth``; the float rows are
    ``apply_norm``'s either way and the pair is ``quantize_activation`` of
    them."""
    x = _rows((3, 5, 16), 3)
    p = L.norm_init(16, norm)
    p["scale"] = p["scale"] * 1.5
    h, pair = L.apply_norm_q(p, x, backend, _readers(readers), A.INPUT_LINEARS)
    assert torch.equal(h, L.apply_norm(p, x))
    if backend in ("fused_int8", "pim_bitserial") and readers == "quantized":
        want = tq.quantize_activation(h)
        assert all(torch.equal(a, b) for a, b in zip(pair, want))
    else:
        assert pair is None


def test_linear_takes_the_pair_in_place_of_its_own_quantizer():
    x = _rows((4, 16), 4)
    lin = L._lin(_readers("quantized"), "wq")
    pair = tq.quantize_activation(x)
    with _counting() as n:
        got = L.apply_linear(lin, x, "fused_int8", pair)
    assert n[0] == 0 and torch.equal(got, L.apply_linear(lin, x, "fused_int8"))
    smooth = L._lin(_readers("smooth"), "wq")
    with _counting() as n:       # a smoothed linear quantizes its own scaled rows
        L.apply_linear(smooth, x, "fused_int8", pair)
    assert n[0] == 1


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


def _saved(cfg) -> int:
    """Quantizer calls a pass saves: each norm output read by k quantized
    linears is quantized once instead of k times (attention's q, k, v; MLA's
    wq_a, wkv_a; an SSM block's w_z, w_x; a SwiGLU MLP's gate and up)."""
    n = 0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "ssm":
            n += 1
        else:
            n += 1 if cfg.attn_type == "mla" else 2
        if cfg.d_ff and not cfg.is_moe_layer(i) and cfg.mlp_type == "swiglu":
            n += 1
    return n


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
def models():
    out = {}
    for arch in ("llama3-8b", "mamba2-2.7b", "granite-3-8b", "deepseek-v3-671b", "opt-30b"):
        cfg = TR.get(arch).reduced()
        params = TM.init_params(cfg, seed=0, device="cpu")
        out[arch] = (cfg, params, quantize_tree(params))
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "granite-3-8b",
                                  "deepseek-v3-671b", "opt-30b"])
@pytest.mark.parametrize("backend", ["fused_int8", "pim_bitserial"])
def test_decode_step_is_the_same_bits_with_the_pair_reused(models, arch, backend,
                                                           monkeypatch):
    cfg, params, qparams = models[arch]
    rt = TT.Runtime(backend)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    _, state = TM.prefill(params, cfg, {"inputs": toks}, 32, rt)
    tok = torch.tensor([3, 5], dtype=torch.int32)
    (lg, n), (lg0, n0) = _both_ways(
        lambda: TM.decode_step(qparams, cfg, _clone(state), tok, rt)[0], monkeypatch)
    assert torch.equal(lg, lg0)
    assert n0 - n == _saved(cfg) and n < n0


def test_ref_int8_keeps_a_quantizer_a_linear(models, monkeypatch):
    cfg, params, qparams = models["llama3-8b"]
    rt = TT.Runtime("ref_int8")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(2))
    _, state = TM.prefill(params, cfg, {"inputs": toks}, 32, rt)
    (lg, n), (lg0, n0) = _both_ways(lambda: TM.decode_step(
        qparams, cfg, _clone(state), torch.tensor([3, 5], dtype=torch.int32), rt)[0],
        monkeypatch)
    assert torch.equal(lg, lg0) and n == n0 == 7 * cfg.n_layers


def test_verify_and_int8_prefill_are_the_same_bits_with_the_pair_reused(models, monkeypatch):
    """llama3-8b reduced: a verify window (linear and tree) and a prefill of
    the int8 tree, each with the pairs and with a quantizer a linear."""
    cfg, params, qparams = models["llama3-8b"]
    rt = TT.Runtime("fused_int8")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    _, state = TM.prefill(params, cfg, {"inputs": toks}, 32, rt)
    win = torch.randint(0, cfg.vocab_size, (2, 4), generator=g, dtype=torch.int32)
    depth = torch.tensor([[0, 1, 1, 2]] * 2, dtype=torch.int32)
    anc = torch.tensor([[1, 3, 5, 11]] * 2, dtype=torch.int32)
    for kw in ({}, {"depth": depth, "anc": anc}):
        (got, n), (want, n0) = _both_ways(
            lambda: TT.verify_step(qparams, cfg, _clone(state), win, rt, **kw)[0], monkeypatch)
        assert torch.equal(got, want) and n0 - n == _saved(cfg)
    (got, n), (want, n0) = _both_ways(
        lambda: TM.prefill(qparams, cfg, {"inputs": toks}, 32, rt)[0], monkeypatch)
    assert torch.equal(got, want) and n0 - n == _saved(cfg) * TT.prefill_pieces(cfg, 9)


def test_layer_norm_pair_is_its_output_quantized_once():
    x = _rows((6, 32), 5)
    p = {"scale": torch.linspace(0.5, 2, 32), "bias": torch.linspace(-1, 1, 32)}
    h, pair = L.apply_norm_q(p, x, "fused_int8", _readers("quantized"), A.INPUT_LINEARS)
    assert torch.equal(h, lnk.layer_norm_plain(x, p["scale"], p["bias"]))
    assert all(torch.equal(a, b) for a, b in zip(pair, tq.quantize_activation(h)))


def test_llama_step_with_the_pairs_stays_close_to_jax():
    """The reference's decode step and the port's with the pairs, on the
    JAX init converted through numpy: logits within 1e-3 of the logit scale
    (f32 sums run in other orders), argmax equal, as the port's model tests
    hold every backend."""
    jcfg, tcfg = JR.get("llama3-8b").reduced(), TR.get("llama3-8b").reduced()
    params = JM.init_params(jax.random.key(0), jcfg)
    qparams = j_quantize_tree(params)
    tq_params = convert.from_numpy(jax.tree.map(np.asarray, qparams), device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    _, jstate = JM.prefill(params, jcfg, {"inputs": jnp.asarray(toks)}, 32, JT.Runtime())
    tstate = convert.from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    tok = np.array([5, 77], np.int32)
    jl, _ = JM.decode_step(qparams, jcfg, jstate, jnp.asarray(tok), JT.Runtime("fused_int8"))
    with _counting() as n:
        tl, _ = TM.decode_step(tq_params, tcfg, tstate, torch.from_numpy(tok),
                               TT.Runtime("fused_int8"))
    assert n[0] == 4 * tcfg.n_layers
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3 * float(np.abs(jl).max()))
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


def _rn32(v):
    """The float32 nearest the rational ``v``, ties to even, exactly."""
    from fractions import Fraction
    f = np.float32(float(v))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        key = (abs(Fraction(float(c)) - v), int(np.array(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return np.float32(best[1])


def test_fused_codes_division_is_the_ieee_quotient():
    """The fused kernel's codes (``csrc/rms_norm.cu`` ``code``) divide
    without ``__fdiv_rn``: q0 = h * RN(1 / s), then one fma step with the
    exact residual.  Emulated in exact rational arithmetic, the step gives
    numpy's IEEE quotient bit for bit wherever |h / s| >= 1/4, and the same
    code everywhere, on quotients placed at and around every half-integer
    up to 127 and on random ones, for scales at the floor and above."""
    from fractions import Fraction as Q
    rng = np.random.default_rng(11)
    scales = [np.float32(1e-8) / np.float32(127), np.float32(0.7) / np.float32(127),
              *(np.float32(a) / np.float32(127) for a in rng.uniform(1e-3, 50, 6))]
    for s in scales:
        s = np.float32(s)
        y = np.float32(1) / s                                  # RN(1 / s)
        hs = []
        for k in range(-127, 127):
            h0 = _rn32((Q(k) + Q(1, 2)) * Q(float(s)))
            hs += [h0]
            for _ in range(3):
                hs += [np.nextafter(hs[-1], np.float32(np.inf))]
            hs += [np.nextafter(h0, np.float32(-np.inf))]
        hs += list((rng.uniform(-127, 127, 400) * s).astype(np.float32))
        for h in hs:
            h = np.float32(h)
            ieee = h / s
            q0 = h * y
            r = _rn32(Q(float(h)) - Q(float(s)) * Q(float(q0)))
            q = _rn32(Q(float(q0)) + Q(float(r)) * Q(float(y)))
            if abs(ieee) >= 0.25:
                assert q.tobytes() == ieee.tobytes(), (s, h)
            assert np.clip(np.rint(q), -127, 127) == np.clip(np.rint(ieee), -127, 127)
