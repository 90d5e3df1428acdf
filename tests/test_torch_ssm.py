"""The port's SSM slice (mamba2-2.7b reduced) against the JAX reference.

B6's plain version is held against the reference's oracle (``ref_chunk``)
and its Pallas kernel in interpret mode within the reference's own
tolerance: ``rtol=2e-4, atol=2e-5`` on y and the chunk state, ``rtol=1e-5``
on the chunk decay (the port sums the within-chunk cumsum in f64, the
reference in f32).  The model's SSM block, the prefill and decode logits
(within 1e-3 of the logit scale, argmax equal) and both engines
(token-identical on pinned seeds) run on weights converted from the JAX
init.  The CUDA kernel is held against the plain version in
``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.kernels.ssm_scan import ops as j_ssd_ops, ref as j_ssd_ref
from repro.kernels.ssm_scan.kernel import ssd_chunk_pallas
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree

BACKENDS = ["dense", "ref_int8", "fused_int8", "pim_bitserial"]
JCFG = JR.get("mamba2-2.7b").reduced()
TCFG = TR.get("mamba2-2.7b").reduced()
MAX_LEN = 48


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _close(j, t, frac=1e-3):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * float(np.abs(j).max()))
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.key(0), JCFG)
    qparams = j_quantize_tree(params)
    return {"j": params, "jq": qparams,
            "t": convert.from_numpy(_np(params), device="cpu"),
            "tq": convert.from_numpy(_np(qparams), device="cpu")}


# ---------------------------------------------------------------------------
# B6: the SSD chunk step
# ---------------------------------------------------------------------------
def _chunk_inputs(N, Q, H, dh, S, seed):
    """The reference test's input distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((N, Q, H, dh)).astype(f)
    B = (rng.standard_normal((N, Q, H, S)) * 0.5).astype(f)
    C = (rng.standard_normal((N, Q, H, S)) * 0.5).astype(f)
    dt = np.logaddexp(rng.standard_normal((N, Q, H)), 0).astype(f)
    A = (-np.exp(rng.standard_normal((H,)) * 0.3)).astype(f)
    D = np.ones((H,), f)
    h0 = (rng.standard_normal((N, H, dh, S)) * 0.1).astype(f)
    return x, B, C, dt, A, D, h0


@pytest.mark.parametrize("N,Q,H,dh,S", [
    (1, 16, 4, 32, 16), (2, 64, 8, 64, 32), (3, 33, 2, 16, 8), (2, 1, 3, 8, 4)])
def test_ssd_chunk_plain_matches_ref_and_pallas(N, Q, H, dh, S):
    args = _chunk_inputs(N, Q, H, dh, S, N * Q + H)
    y, s_out, dec = ssd.ssd_chunk(*map(torch.from_numpy, args))
    jy, js, jd = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    for got, want in ((y, jy), (s_out, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jd), rtol=1e-5)
    for n in range(N):
        ry, rs, rd = j_ssd_ref.ref_chunk(*(jnp.asarray(a[n]) for a in args[:4]),
                                         jnp.asarray(args[4]), jnp.asarray(args[5]),
                                         jnp.asarray(args[6][n]))
        np.testing.assert_allclose(y[n].numpy(), np.asarray(ry), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(s_out[n].numpy(), np.asarray(rs), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(dec[n].numpy(), np.asarray(rd), rtol=1e-5)


@pytest.mark.parametrize("N,Q,H,G,dh,S", [(2, 37, 4, 1, 16, 8), (1, 64, 4, 2, 32, 16),
                                          (3, 33, 6, 3, 8, 4)])
def test_ssd_chunk_plain_takes_groups(N, Q, H, G, dh, S):
    """B and C per group [N, Q, G, S]: the plain version expands them to
    heads itself (head h reads group h // (H // G)), so it equals the
    reference's ``ref_chunk`` over the expanded heads."""
    x, B, C, dt, A, D, h0 = _chunk_inputs(N, Q, H, dh, S, 5 * N + Q + G)
    B, C = B[:, :, :G].copy(), C[:, :, :G].copy()
    y, s_out, dec = ssd.ssd_chunk(*map(torch.from_numpy, (x, B, C, dt, A, D, h0)))
    rep = H // G
    Bh, Ch = np.repeat(B, rep, axis=2), np.repeat(C, rep, axis=2)
    for n in range(N):
        ry, rs, rd = j_ssd_ref.ref_chunk(*(jnp.asarray(a[n]) for a in (x, Bh, Ch, dt)),
                                         jnp.asarray(A), jnp.asarray(D), jnp.asarray(h0[n]))
        np.testing.assert_allclose(y[n].numpy(), np.asarray(ry), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(s_out[n].numpy(), np.asarray(rs), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(dec[n].numpy(), np.asarray(rd), rtol=1e-5)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to nearest (ties away from zero) at 10
    mantissa bits, then clear the low 13 bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32: a = a_hi + a_lo, b = b_hi + b_lo, each part a TF32 value;
    lo*hi + hi*lo + hi*hi summed in f32 (a product of two TF32 values is
    exact in f32), the lo*lo term dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("Q", [128, 37, 1])
def test_3xtf32_split_holds_b6_tolerance_at_full_width(Q):
    """The precision design of the B6 kernel, before any chip time: its
    four products in emulated 3xTF32 at mamba2-2.7b's widths (S 128,
    dh 64; four heads of one group) stay within the reference's tolerance
    of the plain version (rtol 2e-4, atol 2e-5), with the kernel's own
    order: the group's scores C.B^T once, each head's masked decay applied
    to them, intra y, exp(cs) times C.h_in, and the state from B scaled
    by its decay weights."""
    H, dh, S = 4, 64, 128
    x, B, C, dt, A, D, h0 = map(torch.from_numpy, _chunk_inputs(1, Q, H, dh, S, Q))
    B, C = B[:, :, :1].contiguous(), C[:, :, :1].contiguous()
    want_y, want_s, _ = ssd.ssd_chunk_plain(x, B, C, dt, A, D, h0)
    b, c = B[0, :, 0], C[0, :, 0]                                     # [Q, S]
    scores = _mm3(c, b.T)                                             # [Q, Q], once
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for h in range(H):
        cs = ssd.chunk_cumsum(dt[0, :, h] * A[h], 0)
        xdt = x[0, :, h] * dt[0, :, h, None]
        L = torch.where(tril, scores * torch.exp(cs[:, None] - cs[None, :]), 0.0)
        inter = torch.exp(cs)[:, None] * _mm3(c, h0[0, h].T)
        y = (_mm3(L, xdt) + inter) + D[h] * x[0, :, h]
        bw = b * torch.exp(cs[-1] - cs)[:, None]
        state = _mm3(xdt.T.contiguous(), bw)                          # [dh, S]
        torch.testing.assert_close(y, want_y[0, :, h], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(state, want_s[0, h], rtol=2e-4, atol=2e-5)


def test_ssd_chunk_masks_by_selection():
    """A strongly decaying head makes exp(cs[q] - cs[k]) overflow above the
    diagonal; the mask selects 0 there, so nothing turns NaN."""
    x, B, C, dt, A, D, h0 = _chunk_inputs(1, 64, 2, 8, 4, 3)
    A[:] = -60.0
    y, s_out, dec = ssd.ssd_chunk_plain(*map(torch.from_numpy, (x, B, C, dt, A, D, h0)))
    assert all(bool(torch.isfinite(t).all()) for t in (y, s_out, dec))


@pytest.mark.parametrize("T,chunk,h0", [(96, 32, False), (40, 16, True), (7, 128, False)])
def test_ssd_forward_matches_reference(T, chunk, h0):
    """Padding to whole chunks, one chunk step per chunk and the inter-chunk
    recurrence, against the reference's ``ops.ssd_forward``."""
    x, B, C, dt, A, D, h = _chunk_inputs(2, T, 4, 32, 16, T + chunk)
    h = h if h0 else None
    want_y, want_h = j_ssd_ops.ssd_forward(*map(jnp.asarray, (x, B, C, dt, A, D)), chunk=chunk,
                                           h0=None if h is None else jnp.asarray(h))
    got_y, got_h = ssd.ssd_forward(*map(torch.from_numpy, (x, B, C, dt, A, D)), chunk=chunk,
                                   h0=None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------
def _block(weights, tree="j"):
    jp = jax.tree.map(lambda a: a[1], weights[tree]["groups"][0][0]["ssm"])
    key = "t" if tree == "j" else "tq"
    return jp, weights[key]["layers"][1]["ssm"]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("T,chunk", [(24, 8), (37, 128)])
def test_ssm_forward_matches_reference(weights, use_kernel, T, chunk):
    jp, tp = _block(weights)
    x = np.random.default_rng(T).standard_normal((2, T, JCFG.d_model)).astype(np.float32)
    want, jst = JS.ssm_forward(jp, JCFG, jnp.asarray(x), chunk=chunk, return_state=True,
                               use_kernel=use_kernel)
    got, tst = TS.ssm_forward(tp, TCFG, torch.from_numpy(x), chunk=chunk, return_state=True,
                              use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for k in ("conv_x", "conv_B", "conv_C", "h"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ssm_decode_matches_reference(weights, backend):
    """Three recurrence steps from a prefilled state, W8A8 weights."""
    jp, _ = _block(weights, "j")
    jq, tq = _block(weights, "jq")
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((2, 12, JCFG.d_model)).astype(np.float32)
    _, jst = JS.ssm_forward(jp, JCFG, jnp.asarray(x0), return_state=True)
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, JCFG.d_model)).astype(np.float32)
        want, jst = JS.ssm_decode(jq, JCFG, jnp.asarray(x), jst, backend)
        got, tst = TS.ssm_decode(tq, TCFG, torch.from_numpy(x), tst, backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# configuration, parameters, state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = JR.get("mamba2-2.7b"), TR.get("mamba2-2.7b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert [j.layer_kind(i) for i in range(j.n_layers)] == ["ssm"] * t.n_layers


@pytest.mark.parametrize("tree", ["j", "jq"])
def test_convert_round_trips_ssm_keys(weights, tree):
    src = _flat(_np(weights[tree]))
    back = _flat(convert.to_numpy(convert.from_numpy(_np(weights[tree]), device="cpu")))
    assert src.keys() == back.keys() and "/lm_head/w" not in back
    for leaf in ("A_log", "D", "dt_bias", "conv_x", "conv_bB", "norm/scale"):
        assert f"/groups/0/0/ssm/{leaf}" in back, leaf
    for k in src:
        assert src[k].dtype == back[k].dtype, k
        np.testing.assert_array_equal(src[k], back[k], err_msg=k)


def test_quantize_tree_matches_reference_exactly(weights):
    want = _flat(convert.to_numpy(weights["tq"]))
    got = _flat(convert.to_numpy(t_quantize_tree(weights["t"])))
    assert want.keys() == got.keys()
    for name in ("w_z", "w_x", "out_proj"):
        assert f"/groups/0/0/ssm/{name}_q" in got and f"/groups/0/0/ssm/{name}_s" in got
    for name in ("w_B", "w_C", "w_dt", "conv_x"):
        assert f"/groups/0/0/ssm/{name}" in got
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_params_mirrors_reference_structure(weights):
    mine = TM.init_params(TCFG, seed=0, device="cpu")
    shapes = {k: v.shape for k, v in _flat(convert.to_numpy(mine)).items()}
    assert shapes == {k: v.shape for k, v in _flat(convert.to_numpy(weights["t"])).items()}
    again = TM.init_params(TCFG, seed=0, device="cpu")
    assert torch.equal(again["layers"][1]["ssm"]["w_x"], mine["layers"][1]["ssm"]["w_x"])
    # log(linspace(1, 16, H)) as the reference draws it, up to the last bit
    np.testing.assert_allclose(mine["layers"][0]["ssm"]["A_log"].numpy(),
                               _flat(weights["j"])["/groups/0/0/ssm/A_log"][0], rtol=1e-6)


def test_decode_state_and_slots_match_reference():
    rng = np.random.default_rng(6)

    def scribble(state):
        return jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)
                                                  if a.dtype == jnp.float32 else
                                                  rng.integers(0, 9, a.shape).astype(a.dtype)),
                            state)
    jstate = scribble(JM.init_decode_state(JCFG, 3, 16))
    one = scribble(JM.init_decode_state(JCFG, 1, 16))
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    empty = TM.init_decode_state(TCFG, 3, 16, device="cpu")
    assert {k: v.shape for k, v in _flat(empty).items()} == {
        k: v.shape for k, v in _flat(tstate).items()}
    for slot in (1, 7):                                 # 7 clamps to the last slot
        jstate = JT.write_slot(jstate, jnp.int32(slot), one)
        tstate = TT.write_slot(tstate, slot, convert.from_numpy(_np(one), device="cpu"))
        want = _flat(convert.from_numpy(_np(jstate), device="cpu"))
        for k, v in _flat(tstate).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    back = convert.from_numpy(_np(JT.read_slot(jstate, jnp.int32(2))), device="cpu")
    for k, v in _flat(TT.read_slot(tstate, 2)).items():
        np.testing.assert_array_equal(v, _flat(back)[k], err_msg=k)


def test_verify_step_and_hybrid_stacks_raise(weights):
    with pytest.raises(NotImplementedError, match="rewindable"):
        TM.verify_step(weights["tq"], TCFG, TM.init_decode_state(TCFG, 1, 8, device="cpu"),
                       torch.zeros((1, 2), dtype=torch.int32), TT.Runtime())
    hybrid = dataclasses.replace(TCFG, family="hybrid", attn_every=4)
    with pytest.raises(NotImplementedError, match="moe.*A.11"):
        TT.check_supported(hybrid)


# ---------------------------------------------------------------------------
# whole model and engines
# ---------------------------------------------------------------------------
def _prompts(b=2, t=24, seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_logits_match(weights, backend):
    """Prefill (the port runs B6's path under ``fused_int8``, the reference
    its tensor path) and three greedy decode steps, W8A8 weights."""
    toks = _prompts()
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    jl, jstate = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks)}, MAX_LEN, jrt)
    tl, tstate = TM.prefill(weights["t"], TCFG, {"inputs": torch.from_numpy(toks)}, MAX_LEN, trt)
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jstate = JM.decode_step(weights["jq"], JCFG, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(weights["tq"], TCFG, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_apply_norm_on_cpu_is_the_plain_formula():
    """On CPU tensors ``apply_norm`` is bit for bit the plain version (and
    the formula it had before the kernel), at every width the paths use."""
    rng = np.random.default_rng(2)
    for d in (128, 256, 2560):
        x = torch.from_numpy(rng.standard_normal((3, 5, d)).astype(np.float32))
        scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
        got = TL.apply_norm({"scale": scale}, x)
        assert torch.equal(got, rn.rms_norm_plain(x, scale))
        old = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-5) * scale
        assert torch.equal(got, old)


def _engine_trace():
    """The mamba2 trace of the reference's continuous-batching equivalence
    test (3 ragged prompts through 2 slots)."""
    prompts = [jax.random.randint(jax.random.key(k), (n,), 0, JCFG.vocab_size).tolist()
               for k, n in ((2, 5), (3, 11), (4, 8))]
    return prompts, [6, 4, 9]


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_continuous_batching_token_identical(weights, backend):
    prompts, budgets = _engine_trace()
    jeng = JCB(JCFG, weights["j"], n_slots=2, max_len=32, rt=JT.Runtime(backend=backend))
    want = jeng.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=32,
                                    rt=TT.Runtime(backend), device="cpu")
    assert teng.generate_all(prompts, budgets) == want
    for key in ("steps", "decode_steps", "prefill_tokens", "max_step_prefill_tokens",
                "max_step_total_tokens", "xfer_bytes", "decode_xfer_bytes"):
        assert teng.stats[key] == jeng.stats[key], key


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_engine_generate_token_identical(weights, backend):
    toks = _prompts(2, 13, seed=3)
    want, _ = JEngine(cfg=JCFG, params=weights["j"], rt=JT.Runtime(backend=backend),
                      max_len=32).generate({"inputs": jnp.asarray(toks)}, 6)
    got, _ = Engine(cfg=TCFG, params=weights["t"], rt=TT.Runtime(backend), max_len=32,
                    device="cpu").generate({"inputs": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs", [{"spec_k": 4}, {"spec_tree": 6}, {"chunk": 4},
                                    {"multi_step": 4}, {"prefix_cache": True}],
                         ids=["spec_k", "spec_tree", "chunk", "multi_step", "prefix_cache"])
def test_lanes_the_state_cannot_take_are_silently_off(weights, kwargs):
    """As in the reference, an SSM stack keeps the exact-length prefill and
    the one-token decode loop, whatever lane the caller asks for, and emits
    the plain engine's tokens."""
    prompts, budgets = _engine_trace()
    plain = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=32, device="cpu")
    want = plain.generate_all(prompts, budgets)
    eng = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=32, device="cpu",
                                   **kwargs)
    assert (eng.spec_k, eng.spec_tree) == (0, 0)
    assert eng.generate_all(prompts, budgets) == want
    assert eng.stats["verify_steps"] == 0
