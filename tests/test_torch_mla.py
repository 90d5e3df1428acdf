"""The port's MLA slice (deepseek-v3-671b: MLA with its int8 latent cache,
dense-then-MoE layers with a shared expert, top-8 routing with the
fixed-order combine, the MTP drafter) against the JAX reference on the CPU.

The model is deepseek-v3-671b ``.reduced()`` (4 layers: 1 dense, then 3
MoE layers of 4 experts, top-2; q_lora 64, kv_lora 32, nope 32, rope 16,
v 32) and its top-8 variants at 16 experts (cap = N: nothing drops) and 64
(cap = ceil(N / 4): choices drop).  The JAX parameters are converted to
the port's.

Tolerances: the latent's int8 codes and scales bit-equal to the
reference's quantizer on the same floats (one quantizer, IEEE division),
and each package's own rows within one code and 1e-5 of a scale of the
other's (the floats they quantize differ by ulps); attention outputs and
logits within 1e-3 of their scale with the argmax equal; ``moe_local``
within 1e-5 of its scale; MTP drafts and the engines' streams
token-identical, with equal stats but the clocks and the transfer
counters (the port keeps the MTP head's hidden carry on the device: see
:func:`_mtp_xfer`).  Each JAX engine run is computed once a module
(``tests/torch_parity.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serve import faults as JF
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as launch
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serve import faults as TF
from repro_torch.serve.drafter import MTPDrafter, make_drafter
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_parity import JaxRuns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v3-671b"
MAX_LEN = 48
BACKENDS = ("dense", "ref_int8", "fused_int8", "pim_bitserial")
CLOCKS = ("device_s", "step_s", "slow_steps")
XFER = ("xfer_bytes", "decode_xfer_bytes")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(E: int | None = None):
    """The reduced config of both packages; with ``E``, top-8 of E experts."""
    out = []
    for R in (JR, TR):
        c = R.get(ARCH).reduced()
        out.append(c if E is None else dataclasses.replace(c, n_experts=E, n_experts_active=8))
    return tuple(out)


def _close(j, t, frac=1e-3, argmax=True):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * float(np.abs(j).max()))
    if argmax:
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


_WEIGHTS: dict = {}


def _weights(E: int | None = None) -> dict:
    """The JAX init (seed 0), quantized, both converted; once a module."""
    if E not in _WEIGHTS:
        params = JM.init_params(jax.random.key(0), _configs(E)[0])
        qparams = j_quantize_tree(params)
        _WEIGHTS[E] = {"j": params, "jq": qparams,
                       "t": convert.from_numpy(_np(params), device="cpu"),
                       "tq": convert.from_numpy(_np(qparams), device="cpu")}
    return _WEIGHTS[E]


def _jax_layers(state):
    """The JAX decode state's per-layer caches in layer order (its dense
    group, then its MoE group)."""
    out = []
    for g in state["groups"]:
        c = g[0]
        out += [{k: np.asarray(v[i]) for k, v in c.items()} for i in range(c["c_q"].shape[0])]
    return out


def _layer_attn(w: dict, tree: str, layer: int = 1):
    j = jax.tree.map(lambda a: a[0], w["j" + tree[1:]]["groups"][1][0]["attn"])
    return j, w[tree]["layers"][layer]["attn"]


# ---------------------------------------------------------------------------
# config, parameters, quantization
# ---------------------------------------------------------------------------
def test_config_is_the_references():
    """A field-for-field copy; ``reduced()`` equal too (4 layers: 1 dense
    then 3 MoE of 4 experts, top-2; q_lora 64, kv_lora 32, nope 32, rope
    16, v 32)."""
    j, t = JR.get(ARCH), TR.get(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jr, tr = j.reduced(), t.reduced()
    assert dataclasses.asdict(jr) == dataclasses.asdict(tr)
    assert (tr.n_layers, tr.first_dense_layers, tr.n_experts, tr.n_experts_active) == (4, 1, 4, 2)
    assert (tr.q_lora_rank, tr.kv_lora_rank, tr.qk_nope_head_dim, tr.qk_rope_head_dim,
            tr.v_head_dim) == (64, 32, 32, 16, 32)
    TT.check_supported(tr)


def test_init_convert_and_quantize_match_reference():
    """The port's own init has the reference's tree (``mtp_proj`` float,
    ``mtp_layer`` a MoE layer, norms on the generator's device); convert
    round-trips the two layer groups and the MTP head; ``quantize_tree``
    gives every MLA linear its ``_q`` / ``_s`` pair and the MTP layer's
    3-D expert stacks, bit for bit as the reference's."""
    _, tcfg = _configs()
    w = _weights()
    own = TT.init_params(tcfg, seed=0, device="cpu")
    flat = lambda tree: sorted(jax.tree_util.keystr(k) for k, _ in
                               jax.tree_util.tree_flatten_with_path(convert.to_numpy(tree, tcfg))[0])
    assert flat(own) == flat(w["t"])
    assert set(own["layers"][0]["attn"]) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                             "wkv_b", "wo"}
    assert "mlp" in own["layers"][0] and "moe" in own["mtp_layer"]
    back = convert.to_numpy(w["tq"], tcfg)
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_flatten_with_path(_np(w["jq"]))[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert ka == kb
        np.testing.assert_array_equal(a, b, err_msg=str(ka))
    got = t_quantize_tree(w["t"])
    attn = got["layers"][2]["attn"]
    assert {k for k in attn if k.endswith("_q")} == {"wq_a_q", "wq_b_q", "wkv_a_q",
                                                     "wkv_b_q", "wo_q"}
    assert set(got["mtp_proj"]) == {"w"}
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(got, tcfg)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the latent quantizer and the MLA functions
# ---------------------------------------------------------------------------
def test_quantize_latent_bit_equal_to_reference():
    """``_quantize_latent`` on rows spanning 2^-20 .. 2^20 (and a zero
    row): codes and scales equal to JAX's bit for bit."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 40, 48)) * np.exp2(rng.uniform(-20, 20, (6, 40, 1)))
         ).astype(np.float32)
    x[0, 3] = 0.0
    jq, js = JA._quantize_latent(jnp.asarray(x))
    tq, ts = TA._quantize_latent(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (6, 40, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layer", [0, 1])
def test_mla_forward_and_chunk_match_reference(layer):
    """``mla_forward`` (the MTP cell's path) and ``mla_chunk`` (prefill's:
    two chunks of 8 at cursors 0 and 8 into a float carry) against the
    reference's ``mla_forward`` / ``mla_chunk`` on a float layer (the
    dense one, a MoE one): outputs within 1e-3 of their scale, the carried
    K / V and latent within 1e-5."""
    jcfg, tcfg = _configs()
    w = _weights()
    jp = jax.tree.map(lambda a: a[0], w["j"]["groups"][layer and 1][0]["attn"])
    tp = w["t"]["layers"][layer]["attn"]
    x = _x((2, 16, jcfg.d_model), 1)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    jo, jlat = JA.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), "ref_int8")
    to, tlat = TA.mla_forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                              "ref_int8")
    _close(jo, to, argmax=False)
    _close(jlat, tlat, 1e-5, argmax=False)
    jbuf = JT.init_prefill_carry(jcfg, 32)["groups"][layer and 1][0]
    jbuf = jax.tree.map(lambda a: a[0], jbuf)
    tbuf = TT.init_prefill_carry(tcfg, 32, "cpu", batch=1)["layers"][layer]
    for lo in (0, 8):
        xc = x[:1, lo:lo + 8]
        p = np.arange(lo, lo + 8)[None]
        jo, jbuf = JA.mla_chunk(jp, jcfg, jnp.asarray(xc), jnp.asarray(p), jbuf, lo,
                                jnp.asarray([lo + 8]), JT.Runtime(backend="ref_int8"))
        kvl = torch.tensor([lo + 8], dtype=torch.int32)
        to = TA.mla_chunk(tp, tcfg, torch.from_numpy(xc), torch.from_numpy(p), tbuf, lo,
                          kvl, 16, "ref_int8")
        _close(jo, to, argmax=False)
    for k in ("k", "v", "lat_c", "lat_r"):
        _close(jbuf[k][:, :16], tbuf[k][:, :16], 1e-5, argmax=False)


class _Latents:
    """Records every float latent the port quantizes (its argument to
    ``attention._quantize_latent``)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = TA._quantize_latent
        monkeypatch.setattr(TA, "_quantize_latent",
                            lambda lat: self.seen.append(lat.clone()) or real(lat))


def _reference_quantize(lat):
    """The reference's latent quantizer (``attention._quantize_latent``; its
    prefill and finalize spell out the same steps) on the port's floats."""
    q, sc = JA._quantize_latent(jnp.asarray(lat.numpy()))
    return np.asarray(q), np.asarray(sc)


def _near_rows(a_q, a_s, b_q, b_s):
    """Two packages' latent rows of ulp-apart floats: codes within one,
    scales within 1e-5 of each other."""
    assert np.abs(a_q.astype(np.int32) - b_q.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(a_s, b_s, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["decode", "verify", "tree"])
def test_mla_decode_and_verify_match_reference(mode, monkeypatch):
    """Absorbed MLA against the reference on a quantized layer: one token
    (``mla_decode``), a window of 4 (``mla_verify``) or a 4-node tree
    (depths and ancestor masks), at ragged cursors over an int8 latent
    cache; outputs within 1e-3 of their scale; the appended codes and
    scales bit-equal to the reference's quantizer on the port's latent,
    and near JAX's own rows."""
    rec = _Latents(monkeypatch)
    jcfg, tcfg = _configs()
    jp, tp = _layer_attn(_weights(), "tq")
    rng = np.random.default_rng(2)
    S, dim = 32, jcfg.kv_lora_rank + jcfg.qk_rope_head_dim
    lat = _x((3, S, dim), 3)
    c_q, c_s = (np.asarray(a) for a in JA._quantize_latent(jnp.asarray(lat)))
    pos = np.array([5, 17, 26], np.int32)
    T = 1 if mode == "decode" else 4
    x = rng.standard_normal((3, T, jcfg.d_model)).astype(np.float32)
    tc_q, tc_s = torch.from_numpy(c_q.copy()), torch.from_numpy(c_s.copy())
    if mode == "decode":
        jo, (jq, js) = JA.mla_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), c_q, c_s,
                                     "fused_int8")
        to, _ = TA.mla_decode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tc_q, tc_s,
                              "fused_int8")
    else:
        kw_j, kw_t = {}, {}
        if mode == "tree":                     # root, two children, a grandchild
            depth = np.tile(np.array([0, 1, 1, 2], np.int32), (3, 1))
            anc = np.tile(np.array([1, 3, 5, 11], np.int32), (3, 1))
            kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
            kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
        jo, (jq, js) = JA.mla_verify(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), c_q, c_s,
                                     "fused_int8", **kw_j)
        to, _ = TA.mla_verify(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tc_q,
                              tc_s, "fused_int8", **kw_t)
    _close(jo, to, argmax=False)
    (lat,) = rec.seen
    want_q, want_s = _reference_quantize(lat)
    rows = pos[:, None] + np.arange(T)
    b = np.arange(3)[:, None]
    np.testing.assert_array_equal(tc_q.numpy()[b, rows], want_q)
    np.testing.assert_array_equal(tc_s.numpy()[b, rows], want_s)
    _near_rows(tc_q.numpy(), tc_s.numpy(), np.asarray(jq), np.asarray(js))


# ---------------------------------------------------------------------------
# prefill, chunks, decode, verify through the model
# ---------------------------------------------------------------------------
def _decode_from_reference(w, jcfg, tcfg, jl, jstate, backend, steps=3):
    """Three greedy decode steps of both packages from JAX's cache: logits,
    cursors, and the appended latent codes near JAX's."""
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        jl, jstate = JM.decode_step(w["jq"], jcfg, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    for a, b in zip(_jax_layers(jstate), tstate["layers"]):
        _near_rows(b["c_q"].numpy(), b["c_s"].numpy(), a["c_q"], a["c_s"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_match_reference(backend, monkeypatch):
    """One-shot prefill of a ragged batch (24 and 17 real tokens): logits;
    every layer's latent codes and scales bit-equal to the reference's
    quantizer on the port's latent, and near JAX's rows; then three decode
    steps from JAX's cache."""
    rec = _Latents(monkeypatch)
    jcfg, tcfg = _configs()
    w = _weights()
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    jl, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                           "lengths": jnp.asarray(lens)}, MAX_LEN,
                            JT.Runtime(backend=backend))
    tl, tstate = TM.prefill(w["t"], tcfg, {"inputs": torch.from_numpy(toks),
                                           "lengths": torch.from_numpy(lens)}, MAX_LEN,
                            TT.Runtime(backend))
    _close(jl, tl)
    assert len(rec.seen) == tcfg.n_layers
    for a, b, lat in zip(_jax_layers(jstate), tstate["layers"], rec.seen):
        assert b["c_q"].shape == a["c_q"].shape == (2, MAX_LEN, 48)
        want_q, want_s = _reference_quantize(lat)
        np.testing.assert_array_equal(b["c_q"][:, :24].numpy(), want_q)
        np.testing.assert_array_equal(b["c_s"][:, :24].numpy(), want_s)
        _near_rows(b["c_q"].numpy(), b["c_s"].numpy(), a["c_q"], a["c_s"])
    _decode_from_reference(w, jcfg, tcfg, jl, jstate, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_chunks_match_reference(backend):
    """A prompt of 7 tokens in two chunks of 4 (cursors 0 and 4, the second
    cut to 3 real tokens): each chunk's logits; the finalized latent codes
    and scales bit-equal to JAX's ``finalize_prefill_carry`` of the port's
    float carry, and near JAX's own; then decode from JAX's."""
    jcfg, tcfg = _configs()
    w = _weights()
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, 7).astype(np.int32)
    C = 4
    jcarry = JM.init_prefill_carry(jcfg, MAX_LEN + C)
    tcarry = TM.init_prefill_carry(tcfg, TT.carry_len(MAX_LEN, C), "cpu")
    rj, rt = JT.Runtime(backend=backend), TT.Runtime(backend)
    for lo in (0, 4):
        n = min(C, 7 - lo)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = prompt[lo:lo + n]
        jl, jcarry = JM.prefill_chunk(w["j"], jcfg, jcarry, jnp.asarray(chunk), jnp.int32(n), rj)
        tl, tcarry = TM.prefill_chunk(w["t"], tcfg, tcarry, torch.from_numpy(chunk), n, rt)
        _close(jl, tl)
    jstate = JM.finalize_prefill_carry(jcfg, jcarry, MAX_LEN)
    tstate = TM.finalize_prefill_carry(tcfg, tcarry, MAX_LEN)
    # the port's float carry through the reference's finalize
    groups, lo = [], 0
    for g in jcarry["groups"]:
        n = g[0]["lat_c"].shape[0]
        groups.append(({k: np.stack([tcarry["layers"][i][k].numpy()
                                     for i in range(lo, lo + n)]) for k in g[0]},))
        lo += n
    mine = JT.finalize_prefill_carry(jcfg, {"groups": tuple(groups), "pos": jcarry["pos"]},
                                     MAX_LEN)
    for a, b, m in zip(_jax_layers(jstate), tstate["layers"], _jax_layers(mine)):
        np.testing.assert_array_equal(b["c_q"].numpy(), m["c_q"])
        np.testing.assert_array_equal(b["c_s"].numpy(), m["c_s"])
        _near_rows(b["c_q"].numpy(), b["c_s"].numpy(), a["c_q"], a["c_s"])
    _decode_from_reference(w, jcfg, tcfg, jl, jstate, backend)


@pytest.mark.parametrize("chunk", [7, 32, 64])
def test_dense_mla_chunked_prefill_equals_one_shot(chunk):
    """An MLA stack without experts prefills in 64-row pieces, as the GQA
    stacks do: a 90-token prompt's chunks (a chunk that starts inside a
    piece runs that piece again) give the one-shot prefill's logits and
    latent rows bit for bit."""
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg, n_experts=0, n_experts_active=0, first_dense_layers=0,
                              family="dense")
    params = TM.init_params(cfg, seed=1, device="cpu")
    rt = TT.Runtime("fused_int8")
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (1, 90)))
    want, state = TM.prefill(params, cfg, {"inputs": prompt}, 128, rt)
    carry = TM.init_prefill_carry(cfg, TT.carry_len(128, chunk), "cpu")
    for lo in range(0, 90, chunk):
        n = min(chunk, 90 - lo)
        piece = torch.zeros((1, chunk), dtype=torch.int64)
        piece[0, :n] = prompt[0, lo:lo + n]
        got, carry = TM.prefill_chunk(params, cfg, carry, piece, n, rt)
    assert torch.equal(got, want)
    for a, b in zip(TM.finalize_prefill_carry(cfg, carry, 128)["layers"], state["layers"]):
        assert torch.equal(a["c_q"][:, :90], b["c_q"][:, :90])
        assert torch.equal(a["c_s"][:, :90], b["c_s"][:, :90])


@pytest.mark.parametrize("tree", [False, True])
def test_verify_step_matches_reference(tree):
    """A verify window of 4 at 3 ragged cursors, linear and as a tree:
    logits and hidden states within tolerance, cursors equal, and after
    ``tree_commit`` every latent row equal to JAX's."""
    jcfg, tcfg = _configs()
    w = _weights()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (3, 20)).astype(np.int32)
    _, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                          "lengths": jnp.asarray([20, 9, 14])}, MAX_LEN,
                           JT.Runtime())
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    win = rng.integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if tree:
        depth = np.tile(np.array([0, 1, 1, 2], np.int32), (3, 1))
        anc = np.tile(np.array([1, 3, 5, 11], np.int32), (3, 1))
        kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
        kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
    jl, jh, jst = JM.verify_step(w["jq"], jcfg, jstate, jnp.asarray(win),
                                 JT.Runtime(backend="fused_int8"), **kw_j)
    tl, th, tst = TM.verify_step(w["tq"], tcfg, tstate, torch.from_numpy(win),
                                 TT.Runtime("fused_int8"), **kw_t)
    _close(jl, tl)
    _close(jh, th, argmax=False)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    if tree:
        base = np.array([20, 9, 14], np.int32)
        sel = np.array([[1, 3], [2, 0], [1, 0]], np.int32)
        keep = np.array([2, 1, 0], np.int32)
        jst = JM.tree_commit(jst, jnp.asarray(base), jnp.asarray(sel), jnp.asarray(keep),
                             jnp.asarray(base + 1 + keep))
        tst = TM.tree_commit(tst, torch.from_numpy(base), torch.from_numpy(sel),
                             torch.from_numpy(keep), torch.from_numpy(base + 1 + keep))
        np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    for a, b in zip(_jax_layers(jst), tst["layers"]):
        _near_rows(b["c_q"].numpy(), b["c_s"].numpy(), a["c_q"], a["c_s"])


# ---------------------------------------------------------------------------
# top-8 routing and the fixed-order combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [4, 12])
@pytest.mark.parametrize("E", [16, 64])
def test_top8_moe_and_combine_match_reference(E, N):
    """Top-8 with the shared expert at E 16 (cap = N: no drop) and E 64
    (cap = ceil(N / 4): drops shown), float and quantized experts:
    ``moe_local`` within 1e-5 of its scale.  The combine itself, on the same
    weighted expert rows and the port's routing, is bit-equal to the
    reference's scatter-add (XLA's CPU scatter visits the updates in
    buffer order, ascending expert, which is the order the combine sums)."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    x = _x((N, jcfg.d_model), N + E)
    cap = TMOE._capacity(N * 8, E)
    for tree in ("", "q"):
        jp = jax.tree.map(lambda a: a[0], w["j" + tree]["groups"][1][0]["moe"])
        tp = w["t" + tree]["layers"][1]["moe"]
        r = TMOE.route(tp, torch.from_numpy(x), tcfg)
        assert (int(r.dropped) == 0) if E == 16 else (int(r.dropped) > 0)
        assert r.toks.shape == (E, cap) and bool((r.counts <= cap).all())
        jo, _ = JMOE.moe_local(jp, jnp.asarray(x), jcfg)
        to, _ = TMOE.moe_local(tp, torch.from_numpy(x), tcfg)
        jo = np.asarray(jo)
        np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=1e-5 * float(np.abs(jo).max()))
    valid = (torch.arange(cap)[None, :] < r.counts[:, None])[..., None]
    ye = torch.from_numpy(_x((E, cap, jcfg.d_model), 9)) * valid
    want = jnp.zeros((N, jcfg.d_model)).at[jnp.asarray(r.toks.reshape(-1).numpy())].add(
        jnp.asarray(ye.reshape(-1, jcfg.d_model).numpy()))
    np.testing.assert_array_equal(TMOE.combine(ye, r.order).numpy(), np.asarray(want))


def test_combine_order_and_top2_unchanged():
    """``order`` lists each token's buffer rows ascending with its dropped
    choices last (the spare row), and at top-2 the combine equals the
    ``index_add_`` sum of the rows bit for bit."""
    _, tcfg = _configs(64)
    tp = _weights(64)["tq"]["layers"][1]["moe"]
    x = torch.from_numpy(_x((20, tcfg.d_model), 1))
    r = TMOE.route(tp, x, tcfg)
    spare = r.toks.numel()
    o = r.order.numpy()
    for n in range(20):
        kept = sorted(e * r.toks.shape[1] + i for e in range(r.toks.shape[0])
                      for i in range(int(r.counts[e])) if int(r.toks[e, i]) == n)
        assert o[n].tolist() == kept + [spare] * (8 - len(kept))
    _, gcfg = (dataclasses.replace(c, n_experts=8) for c in _configs())
    gp = {"router": torch.from_numpy(_x((tcfg.d_model, 8), 3))}
    rg = TMOE.route(gp, x[:12], gcfg)
    valid = (torch.arange(rg.toks.shape[1])[None, :] < rg.counts[:, None])[..., None]
    ye = torch.from_numpy(_x(tuple(rg.toks.shape) + (tcfg.d_model,), 2)) * valid
    old = torch.zeros((12, tcfg.d_model)).index_add_(0, rg.toks.reshape(-1),
                                                     ye.reshape(-1, tcfg.d_model))
    assert torch.equal(TMOE.combine(ye, rg.order), old)


# ---------------------------------------------------------------------------
# the MTP head
# ---------------------------------------------------------------------------
def _mtp_inputs(cfg, B=3, seed=7):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    h[0] = 0.0                                    # a slot right after its prefill
    return h, rng.integers(0, cfg.vocab_size, B).astype(np.int32), \
        rng.integers(0, 40, B).astype(np.int32)


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_mtp_drafts_match_reference(backend):
    """``mtp_draft`` (k 4) and ``mtp_draft_tree`` ((4, 2) and (5, 3))
    token-equal to JAX's; ``branch = 1`` equals the chain."""
    jcfg, tcfg = _configs()
    w = _weights()
    jp, tp = (w["jq"], w["tq"]) if backend != "dense" else (w["j"], w["t"])
    h, tok, pos = _mtp_inputs(jcfg)
    jargs = (jnp.asarray(h), jnp.asarray(tok), jnp.asarray(pos))
    targs = (torch.from_numpy(h), torch.from_numpy(tok), torch.from_numpy(pos))
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    chain = TM.mtp_draft(tp, tcfg, *targs, 4, trt)
    assert chain.dtype == torch.int32 and chain.shape == (3, 4)
    np.testing.assert_array_equal(chain.numpy(), np.asarray(JM.mtp_draft(jp, jcfg, *jargs, 4,
                                                                         jrt)))
    for n, b in ((4, 2), (5, 3)):
        np.testing.assert_array_equal(
            TM.mtp_draft_tree(tp, tcfg, *targs, n, b, trt).numpy(),
            np.asarray(JM.mtp_draft_tree(jp, jcfg, *jargs, n, b, jrt)))
    assert torch.equal(TM.mtp_draft_tree(tp, tcfg, *targs, 4, 1, trt), chain)
    assert TT.mtp_chain_lengths(5, 3) == JT.mtp_chain_lengths(5, 3) == [2, 2, 1]


def test_mtp_drafter_topology_and_refusal():
    """``MTPDrafter.tree_parents`` at (4, 2) is the reference's [-1, 0, -1,
    2] (two chains of 2); the MTP drafter on a configuration without the
    head raises the reference's ``ValueError``, as ``mtp_draft`` does."""
    _, tcfg = _configs()
    d = make_drafter("mtp", tcfg, TT.Runtime(), 4, tree_branch=2)
    assert isinstance(d, MTPDrafter) and d.kind == "model"
    assert d.tree_parents == [-1, 0, -1, 2]
    assert make_drafter("mtp", tcfg, TT.Runtime(), 3).tree_parents is None
    llama = TR.get("llama3-8b").reduced()
    with pytest.raises(ValueError, match="no MTP head"):
        make_drafter("mtp", llama, TT.Runtime(), 3)
    with pytest.raises(ValueError, match="no MTP head"):
        TT.mtp_draft({}, llama, torch.zeros((1, 8)), torch.zeros(1), torch.zeros(1), 2,
                     TT.Runtime())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
BASE = {"n_slots": 3, "max_len": MAX_LEN}


def _trace(n=6, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 20))).tolist() for _ in range(n)]
    budgets = [int(rng.integers(3, 9)) for _ in range(n)]
    return prompts, budgets


def _drain(prompts, budgets, **submit_kw):
    def drive(eng):
        reqs = [eng.submit(p, b, **submit_kw) for p, b in zip(prompts, budgets)]
        eng.drain()
        return reqs
    return drive


_RUNS: dict = {}


def _jax_runs(E=None) -> JaxRuns:
    if E not in _RUNS:
        _RUNS[E] = JaxRuns(_configs(E)[0], _weights(E)["j"], BASE)
    return _RUNS[E]


def _port(E=None, **kw) -> TCB:
    return TCB(_configs(E)[1], _weights(E)["t"], rt=TT.Runtime("fused_int8"), device="cpu",
               **{**BASE, **kw})


def _mtp_xfer(te) -> int:
    """Bytes the reference's MTP lanes move that the port's do not: each
    verify step the reference pushes the hidden carry [n, d] f32 and
    fetches the window's hidden [n, T, d] f32; the port keeps both on the
    device and pushes instead each slot's last emitted row [n] int32."""
    if te._h_last is None:
        return 0
    n, d = te._h_last.shape
    T = (te.spec_tree or te.spec_k) + 1
    return te.stats["verify_steps"] * (4 * n * d * (1 + T) - 4 * n)


def _same_stats(te, je):
    assert set(te.stats) == set(je.stats)
    for k in sorted(set(te.stats) - set(CLOCKS) - set(XFER)):
        assert te.stats[k] == je.stats[k], k
    dead = 0
    if te._swap is not None:          # the port copies a cold block's live rows only
        whole = te._swap.block_bytes(te.state["layers"][0]["c_q"].shape[1]) + 4
        dead = ((te.stats["swap_outs"] + te.stats["swap_ins"]) * whole
                - te.stats["swap_out_bytes"] - te.stats["swap_in_bytes"])
    assert te.stats["xfer_bytes"] == je.stats["xfer_bytes"] - dead - _mtp_xfer(te)
    assert te.stats["decode_xfer_bytes"] == je.stats["decode_xfer_bytes"] - _mtp_xfer(te)


def _outputs(reqs):
    return [list(r.output) for r in reqs]


LANES = {"fifo": {}, "chunk_4": {"chunk": 4}, "multi_step_4": {"multi_step": 4},
         "spec_k_mtp": {"spec_k": 3, "drafter": "mtp"},
         "spec_k_ngram": {"spec_k": 3, "drafter": "ngram"},
         "spec_tree_mtp": {"spec_tree": 3, "spec_branch": 2, "drafter": "mtp"},
         "kv_swap_preempt": {"kv_swap": True, "chunk": 4, "policy": "priority:preempt"}}


@pytest.mark.parametrize("lane", LANES)
def test_continuous_batching_token_identical(lane):
    """Both engines token-identical with equal stats in every lane (the
    MTP lanes drafting from the head, the swap lane preempting: requests 3-5
    arrive at a higher priority after three steps); the MTP lanes'
    streams equal the plain lane's (greedy verification is lossless) and
    after every verify step of the linear MTP lane, each slot that ran holds
the step's hidden at the row it emitted last (its stats, drafts
included, equal the reference's)."""
    prompts, budgets = _trace()
    kw = LANES[lane]
    if "policy" in kw:
        def drive(eng):
            reqs = [eng.submit(p, b, priority=0) for p, b in zip(prompts[:3], budgets[:3])]
            for _ in range(3):
                eng.step()
            reqs += [eng.submit(p, b, priority=9) for p, b in zip(prompts[3:], budgets[3:])]
            eng.drain()
            return reqs
    else:
        drive = _drain(prompts, budgets)
    jreqs, je = _jax_runs().run(lane, drive, **kw)
    te = _port(**kw)
    if lane == "spec_k_mtp":
        real = te._spec_decode

        def checked(dec):
            before = {slot: len(req.output) for slot, req in dec}
            real(dec)
            for slot, req in dec:
                row = len(req.output) - before[slot] - 1
                assert torch.equal(te._h_last[slot], te._steps.hidden[slot, row])
        te._spec_decode = checked
    treqs = drive(te)
    assert _outputs(treqs) == _outputs(jreqs)
    _same_stats(te, je)
    if "drafter" in kw:
        assert te.stats["verify_steps"] > 0
        plain, _ = _jax_runs().run("fifo", _drain(prompts, budgets))
        assert _outputs(treqs) == _outputs(plain)
    if "kv_swap" in kw:
        assert te.stats["swap_outs"] > 0 and te.stats["preemptions"] > 0


@pytest.mark.parametrize("lane", ["fifo", "spec_k_mtp"])
@pytest.mark.parametrize("E", [16, 64])
def test_top8_engines_token_identical(E, lane):
    """The top-8 variants served: at E 64 a decode step of 3 slots has cap
    ceil(48 / 64) = 1 and drops choices (``count_routing``), at E 16 it
    never does; streams and stats equal JAX's."""
    prompts, budgets = _trace(n=4, seed=1)
    kw = LANES[lane]
    jreqs, je = _jax_runs(E).run(lane, _drain(prompts, budgets), **kw)
    te = _port(E, **kw)
    routing = torch.zeros((3,), dtype=torch.int64)
    TMOE.count_routing(routing)
    try:
        treqs = _drain(prompts, budgets)(te)
    finally:
        TMOE.count_routing(None)
    assert _outputs(treqs) == _outputs(jreqs)
    _same_stats(te, je)
    assert (int(routing[1]) > 0) == (E == 64)


FAULTS = {
    "ecc_correctable": (dict(policy="fair:3", kv_swap=True, chunk=4),
                        lambda F: F.FaultInjector(seed=0, ber=2e-4)),
    "ecc_uncorrectable": (dict(policy="fair:3", kv_swap=True, chunk=4),
                          lambda F: F.FaultInjector(seed=0, ber=0.05)),
    "step_failure": (dict(policy="fifo", kv_swap=True, chunk=4),
                     lambda F: F.FaultInjector(seed=0, step_fail_at=(9, 23))),
    "step_failure_mtp": (dict(spec_k=3, drafter="mtp"),
                         lambda F: F.FaultInjector(seed=0, step_fail_at=(5, 11))),
    "slot_loss": (dict(policy="fifo", chunk=4),
                  lambda F: F.FaultInjector(seed=0, slot_loss_at=((6, 0),))),
    "slot_loss_cold_reread": (dict(policy="fair:3", kv_swap=True, chunk=4),
                              lambda F: F.FaultInjector(seed=0, slot_loss_at=((12, 0),))),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_classes_token_identical(fault):
    """The engine fault classes of ``tests/test_faults.py`` on the latent
    pool (cold blocks of ``c_q`` / ``c_s`` rows, ECC and checksums, step
    failures with in-place rebuilds, also mid MTP lane, lost slots):
    streams equal JAX's faulted run and the port's fault-free run, no
    request failed, stats equal."""
    kw, faults = FAULTS[fault]
    prompts, budgets = _trace(n=6, seed=3 if "reread" in fault else 0)
    drive = _drain(prompts, budgets)
    jreqs, je = _jax_runs().run(("fault", fault), drive, faults=faults(JF), **kw)
    te = _port(faults=faults(TF), **kw)
    treqs = drive(te)
    assert _outputs(treqs) == _outputs(jreqs) == _outputs(drive(_port(**kw)))
    assert all(r.error is None for r in treqs)
    _same_stats(te, je)
    fired = {"ecc_correctable": "ecc_corrected_bits",
             "ecc_uncorrectable": "uncorrectable_blocks",
             "step_failure": "pool_rebuilds", "step_failure_mtp": "pool_rebuilds",
             "slot_loss": "slot_losses", "slot_loss_cold_reread": "cold_rereads"}[fault]
    assert te.stats[fired] > 0


def test_deadline_times_out_on_the_latent_pool():
    prompts, budgets = _trace(n=3)
    drive = _drain(prompts, budgets, deadline_s=1e-6)
    jreqs, je = _jax_runs().run("deadline", drive, chunk=4)
    te = _port(chunk=4)
    assert [r.state.value for r in drive(te)] == [r.state.value for r in jreqs] == ["timeout"] * 3
    assert te.stats["timeouts"] == je.stats["timeouts"] == 3


def test_prefix_cache_is_silently_off():
    """``prefix_cache=True`` under MLA serves the plain streams with no
    cache and no prefix stat, as the reference's engine."""
    prompts, budgets = _trace()
    te = _port(prefix_cache=True, chunk=4)
    je = _jax_runs().engine(prefix_cache=True, chunk=4)
    assert te._pcache is None and je._pcache is None
    assert set(te.stats) == set(je.stats) and "prefix_hits" not in te.stats
    plain, _ = _jax_runs().run("chunk_4", _drain(prompts, budgets), chunk=4)
    assert _outputs(_drain(prompts, budgets)(te)) == _outputs(plain)
    with pytest.raises(NotImplementedError, match="MLA"):
        TT.warm_prefill_carry(_configs()[1], te.state, 0, 4, 64)


def test_serve_cli_takes_deepseek(capsys):
    """``--arch deepseek-v3-671b --reduced --drafter mtp`` serves (the
    continuous engine under ``--spec-k`` and ``--spec-tree``, and the fixed
    batch)."""
    launch.main(["--arch", ARCH, "--reduced", "--continuous", "--requests", "3",
                 "--slots", "2", "--steps", "4", "--spec-k", "3", "--drafter", "mtp",
                 "--device", "cpu"])
    launch.main(["--arch", ARCH, "--reduced", "--continuous", "--requests", "2",
                 "--slots", "2", "--steps", "3", "--spec-tree", "3", "--drafter", "mtp",
                 "--device", "cpu"])
    launch.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
                 "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "deepseek-v3-671b" in out and "drafter=mtp" in out
