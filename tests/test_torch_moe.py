"""The port's MoE slice (``models/moe.py``, the 3-D expert quantizer, the
grouped B1's plain version, MoE stacks in ``transformer.py`` and the
engines) against the JAX reference on the CPU: grok-1-314b ``.reduced()``
(top-2 of 4 experts, where capacity never binds: cap = N) and the same at
grok's own 8 experts (``E8``, where a decode step of 4 slots has cap 2 and
drops choices).

Tolerances: routing (each expert's kept tokens, in order, and its row
count) and the quantized trees equal; ``moe_local`` within 1e-5 of the
output's scale (float experts: a float product summed in another order;
quantized: the same integers and epilogue, the router's softmax within
ulps); logits within 1e-3 of the logit scale with the argmax equal (as
every port test); the engines token-identical to JAX's with equal stats.
The grouped B1 kernel is held against its plain version in
``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro.serve.quantize import _quantize_3d as j_quantize_3d
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import quant
from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import int8_matmul_grouped as gmm
from repro_torch.launch import serve as launch
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.quantize import _quantize_3d as t_quantize_3d
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "grok-1-314b"
EXPERTS = (4, 8)          # reduced() keeps 4 of grok's 8; grok's own 8 make capacity bind
MAX_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(E: int):
    return tuple(dataclasses.replace(R.get(ARCH).reduced(), n_experts=E) for R in (JR, TR))


def _close(j, t, frac=1e-3):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * float(np.abs(j).max()))
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


_WEIGHTS: dict = {}


def _weights(E: int) -> dict:
    """Reduced grok at E experts: the JAX init, quantized, both converted;
    made once a module."""
    if E not in _WEIGHTS:
        params = JM.init_params(jax.random.key(0), _configs(E)[0])
        qparams = j_quantize_tree(params)
        _WEIGHTS[E] = {"j": params, "jq": qparams,
                       "t": convert.from_numpy(_np(params), device="cpu"),
                       "tq": convert.from_numpy(_np(qparams), device="cpu")}
    return _WEIGHTS[E]


def _layer_moe(w: dict, tree: str, layer: int = 1):
    """Layer ``layer``'s MoE params: the JAX tree's (unstacked) and the port's."""
    j = jax.tree.map(lambda a: a[layer], w["j" + tree[1:]]["groups"][0][0]["moe"])
    return j, w[tree]["layers"][layer]["moe"]


# ---------------------------------------------------------------------------
# routing and moe_local
# ---------------------------------------------------------------------------
def _reference_kept(jp, x, cfg):
    """The reference's dispatch (``repro/models/moe.py`` ``moe_local``'s
    steps, outside a mesh): each expert's kept tokens in buffer order and
    its row count, and the choices dropped."""
    N = x.shape[0]
    E, k = cfg.n_experts, cfg.n_experts_active
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    slot_e = topi.reshape(-1)
    order = jnp.argsort(slot_e)
    s_e, s_tok = np.asarray(slot_e[order]), np.asarray((jnp.arange(N * k) // k)[order])
    cap = JMOE._capacity(N * k, E)
    kept = {e: s_tok[s_e == e][:cap].tolist() for e in range(E)}
    dropped = sum(max(0, int((s_e == e).sum()) - cap) for e in range(E))
    return kept, dropped


def _port_kept(r: TMOE.Routing) -> dict:
    return {e: r.toks[e, :int(r.counts[e])].tolist() for e in range(r.toks.shape[0])}


def _inputs(N: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)


@pytest.mark.parametrize("router", ["random", "dominant"])
@pytest.mark.parametrize("N", [4, 20, 208])
@pytest.mark.parametrize("E", EXPERTS)
def test_routing_and_moe_local_match_reference(E, N, router):
    """Kept sets (tokens in buffer order) and row counts equal to the
    reference's stable-argsort dispatch; ``moe_local`` with float and with
    quantized experts, and the load-balance loss, within tolerance.  The
    rows share a component that a dominant router column (expert 1) scores
    high, so nearly every token picks expert 1: at E 8 (cap = N / 2) about
    half of them are dropped; at E 4 (cap = N) nothing ever is."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    jp, tp = _layer_moe(w, "t")
    jq, tq = _layer_moe(w, "tq")
    x = _inputs(N, jcfg.d_model, N + E)
    if router == "dominant":
        u = np.full((jcfg.d_model,), 1.0 / np.sqrt(jcfg.d_model), np.float32)
        x = x + 2.0 * u
        bias = np.zeros((jcfg.d_model, E), np.float32)
        bias[:, 1] = 4.0 * u
        jp, jq = (dict(p, router=p["router"] + bias) for p in (jp, jq))
        tp, tq = (dict(p, router=p["router"] + torch.from_numpy(bias)) for p in (tp, tq))
    want, dropped = _reference_kept(jp, x, jcfg)
    r = TMOE.route(tp, torch.from_numpy(x), tcfg)
    assert _port_kept(r) == want
    assert int(r.dropped) == dropped
    if E == 4:
        assert dropped == 0
    elif router == "dominant":
        assert dropped >= N // 4
    for jtree, ttree in ((jp, tp), (jq, tq)):
        jo, jaux = JMOE.moe_local(jtree, jnp.asarray(x), jcfg)
        to, taux = TMOE.moe_local(ttree, torch.from_numpy(x), tcfg, with_aux=True)
        jo = np.asarray(jo)
        np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=1e-5 * float(np.abs(jo).max()))
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
        assert TMOE.moe_local(ttree, torch.from_numpy(x), tcfg)[1] is None


def test_top_k_ties_go_to_the_lower_index():
    """Equal router probabilities: the port's top-k picks the lower expert
    first, as ``jax.lax.top_k``; rows of zeros (every expert tied) route
    to experts 0 and 1 in both packages, and ``moe_local`` agrees."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1], [0.2, 0.2, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMOE._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcfg, tcfg = _configs(8)
    jp, tp = _layer_moe(_weights(8), "tq")
    x = _inputs(6, jcfg.d_model, 3)
    x[[0, 2, 5]] = 0.0
    r = TMOE.route(tp, torch.from_numpy(x), tcfg)
    assert r.topi[[0, 2, 5]].tolist() == [[0, 1]] * 3
    assert _port_kept(r) == _reference_kept(jp, x, jcfg)[0]
    jo, _ = JMOE.moe_local(jp, jnp.asarray(x), jcfg)
    to, _ = TMOE.moe_local(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jo)).max()))


@pytest.mark.parametrize("C,counts", [(1, [1, 0, 1]), (2, [0, 2, 1]), (10, [10, 0, 3]),
                                      (33, [33, 1, 0]), (2, [0, 0, 0]), (4, [4, 4, 4])])
def test_grouped_plain_matches_per_expert_b1(C, counts):
    """The grouped plain version: expert e's rows below ``counts[e]`` equal
    B1's plain version on that expert's slice bit for bit (odd N 37), the
    rest zero; it matches the reference's ``_int8_expert_mm`` where the rows
    past the count are zero."""
    g = torch.Generator().manual_seed(C)
    E, K, N = 3, 96, 37
    x_q = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8)
    x_s = torch.rand((E, C, 1), generator=g) + 0.01
    w_q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8)
    w_s = torch.rand((E, N), generator=g) + 0.01
    cnt = torch.tensor(counts, dtype=torch.int32)
    out = gmm.int8_matmul_grouped(x_q, x_s, w_q, w_s, cnt)
    assert out.shape == (E, C, N) and out.dtype == torch.float32
    for e in range(E):
        n = counts[e]
        want, _ = mm.int8_matmul_plain(x_q[e], x_s[e], w_q[e], w_s[e])
        assert torch.equal(out[e, :n], want[:n])
        assert not out[e, n:].any()
    live = (torch.arange(C)[None, :] < cnt[:, None])[..., None]
    x_f = torch.where(live, x_q.float() * x_s, torch.zeros(()))
    j_q, j_s = JMOE._q8_rows(jnp.asarray(x_f.numpy()))
    x_q2, x_s2 = quant.quantize_activation(x_f)
    np.testing.assert_array_equal(x_q2.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(x_s2.numpy(), np.asarray(j_s))
    jo = np.asarray(JMOE._int8_expert_mm(jnp.asarray(x_f.numpy()), jnp.asarray(w_q.numpy()),
                                         jnp.asarray(w_s.numpy()), jnp.float32))
    np.testing.assert_array_equal(gmm.int8_matmul_grouped(x_q2, x_s2, w_q, w_s, cnt).numpy(), jo)


def test_moe_apply_over_a_mesh_axis_raises():
    """Over a mesh axis ``moe_apply`` needs the mesh the axis belongs to.
    The load-balance loss over a mesh axis (training on a mesh, which
    raised here until the training mesh) is the reference's: held on an
    axis of one rank (a 1x1 ``CountingMesh`` runs real tensors, a group of
    one moving nothing) against JAX's ``moe_apply``, output and aux; on
    1x2 and 2x2 ranks in ``tests/test_torch_mesh_train_families.py``, and
    expert parallelism in ``tests/test_torch_mesh.py``."""
    from repro_torch.launch.mesh import CountingMesh
    jcfg, tcfg = _configs(8)
    jp, tp = _layer_moe(_weights(8), "t")
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(ValueError, match="needs the mesh"):
        TMOE.moe_apply(tp, x, tcfg, axis_name="model")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, tcfg.d_model)).astype(np.float32))
    out, aux = TMOE.moe_apply(tp, x, tcfg, axis_name="model", with_aux=True,
                              mesh=CountingMesh((1, 1), ("data", "model")))
    jout, jaux = JMOE.moe_apply(jp, jnp.asarray(x.numpy()), jcfg)
    _close(jout, out)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------
def test_quantize_3d_matches_reference_bit_for_bit():
    """The expert quantizer equals ``_quantize_3d`` bit for bit (codes and
    scales, a zero expert column included); the router stays float; a 3-D
    weight outside a ``"moe"`` dict still raises."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((5, 64, 48)) * np.exp(rng.uniform(-8, 8, (5, 1, 48)))).astype(np.float32)
    w[2, :, 7] = 0.0
    jq, js = j_quantize_3d(jnp.asarray(w))
    tq, ts = t_quantize_3d(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (5, 48)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    moe = {"router": torch.ones((64, 5)), "w_up": torch.from_numpy(w)}
    out = t_quantize_tree({"layers": [{"moe": moe}]})["layers"][0]["moe"]
    assert set(out) == {"router", "w_up_q", "w_up_s"} and out["router"] is moe["router"]
    with pytest.raises(NotImplementedError, match="stacked"):
        t_quantize_tree({"mlp": {"w_up": torch.from_numpy(w)}})


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------
def _decode_from_reference(w, jcfg, tcfg, jl, jstate, tstate, backend, steps=3):
    """Hold the two prefilled caches to 99.9% equal codes (the float
    prefills' K/V differ by ulps), then run ``steps`` greedy decode steps
    of both packages from JAX's cache (a flipped code moves a router's
    near-tie, and the slot's expert with it)."""
    for name in ("k_q", "v_q"):
        jk = np.asarray(jstate["groups"][0][0][name])
        assert np.mean(jk == np.stack([c[name].numpy() for c in tstate["layers"]])) > 0.999
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        jl, jstate = JM.decode_step(w["jq"], jcfg, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


@pytest.mark.parametrize("backend", ["dense", "ref_int8", "fused_int8", "pim_bitserial"])
@pytest.mark.parametrize("batch", ["one_bucketed", "two_b_major"])
@pytest.mark.parametrize("E", EXPERTS)
def test_prefill_and_decode_match_reference(E, batch, backend):
    """Prefill routes the call's B*T rows together, b-major: one prompt at
    a bucketed length (27 real tokens in 32, the padding routed too) or two
    of 24; then three decode steps from JAX's cache.  The prefill is one
    piece of the call's rows."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    rng = np.random.default_rng(E)
    if batch == "one_bucketed":
        toks = np.zeros((1, 32), np.int32)
        toks[0, :27] = rng.integers(0, jcfg.vocab_size, 27)
        kw_j, kw_t = {"lengths": jnp.asarray([27])}, {"lengths": torch.tensor([27])}
    else:
        toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
        kw_j, kw_t = {}, {}
    assert TT.prefill_pieces(tcfg, toks.shape[1]) == 1
    jl, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks), **kw_j}, MAX_LEN,
                            JT.Runtime(backend=backend))
    tl, tstate = TM.prefill(w["t"], tcfg, {"inputs": torch.from_numpy(toks), **kw_t}, MAX_LEN,
                            TT.Runtime(backend))
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    _decode_from_reference(w, jcfg, tcfg, jl, jstate, tstate, backend)


@pytest.mark.parametrize("E", EXPERTS)
def test_prefill_chunk_matches_reference(E):
    """Chunks of 20 (cursors 0, 20, 40: not multiples of 64), the last one
    cut to 9 real tokens and padded to 20: each chunk routes its own 20
    rows (padding included) at its cursor, as the reference's ``[1, C]``
    call does; every chunk's logits and the finalized cache against
    JAX's, then decode from it."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    prompt = np.random.default_rng(7 + E).integers(0, jcfg.vocab_size, 49).astype(np.int32)
    C = 20
    jcarry = JM.init_prefill_carry(jcfg, MAX_LEN + C)
    tcarry = TM.init_prefill_carry(tcfg, TT.carry_len(MAX_LEN, C), "cpu")
    rt_j, rt_t = JT.Runtime(backend="fused_int8"), TT.Runtime("fused_int8")
    for lo in range(0, 49, C):
        n = min(C, 49 - lo)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = prompt[lo:lo + n]
        assert TT.chunk_pieces(tcfg, lo, n) == 1
        jl, jcarry = JM.prefill_chunk(w["j"], jcfg, jcarry, jnp.asarray(chunk), jnp.int32(n),
                                      rt_j)
        tl, tcarry = TM.prefill_chunk(w["t"], tcfg, tcarry, torch.from_numpy(chunk), n, rt_t)
        _close(jl, tl)
    assert int(tcarry["pos"][0]) == 49
    jstate = JM.finalize_prefill_carry(jcfg, jcarry, MAX_LEN)
    tstate = TM.finalize_prefill_carry(tcfg, tcarry, MAX_LEN)
    _decode_from_reference(w, jcfg, tcfg, jl, jstate, tstate, "fused_int8")


@pytest.mark.parametrize("E", EXPERTS)
def test_verify_step_matches_reference(E):
    """A verify window of 5 tokens at 4 ragged cursors routes 20 rows
    (cap 10 at E 8): logits and cursors."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
    _, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                          "lengths": jnp.asarray([24, 9, 17, 3])}, MAX_LEN,
                           JT.Runtime())
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    win = rng.integers(0, jcfg.vocab_size, (4, 5)).astype(np.int32)
    jl, _, jst = JM.verify_step(w["jq"], jcfg, jstate, jnp.asarray(win),
                                JT.Runtime(backend="fused_int8"))
    tl, _, tst = TM.verify_step(w["tq"], tcfg, tstate, torch.from_numpy(win),
                                TT.Runtime("fused_int8"))
    _close(jl, tl)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _trace():
    """Seven ragged requests through four slots (prompts 4-39 tokens,
    budgets 3-13): slots go idle while others still decode."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, rng.integers(4, 40)).tolist() for _ in range(7)]
    budgets = [int(rng.integers(3, 14)) for _ in range(7)]
    return prompts, budgets


STATS = ("steps", "decode_steps", "verify_steps", "spec_drafted", "spec_accepted",
         "spec_accept_hist", "prefill_tokens", "chunks", "max_step_prefill_tokens",
         "max_step_total_tokens", "multi_blocks", "multi_tokens", "xfer_bytes",
         "decode_xfer_bytes")
LANES = {"fifo": {}, "chunk": {"chunk": 32}, "multi_step": {"multi_step": 4},
         "spec_k": {"spec_k": 4}, "spec_tree": {"spec_tree": 6}}


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("E", EXPERTS)
def test_continuous_batching_token_identical(E, lane):
    """Under ``fused_int8``: the port's streams equal JAX's, with equal
    stats, in every lane; at E 8 capacity dropped choices on the way, at
    E 4 it never does (counted by ``count_routing``)."""
    jcfg, tcfg = _configs(E)
    w = _weights(E)
    prompts, budgets = _trace()
    kw = LANES[lane]
    want = JCB(jcfg, w["j"], n_slots=4, max_len=MAX_LEN, rt=JT.Runtime(backend="fused_int8"),
               **kw)
    jout = want.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(tcfg, w["t"], n_slots=4, max_len=MAX_LEN,
                                    rt=TT.Runtime("fused_int8"), device="cpu", **kw)
    routing = torch.zeros((3,), dtype=torch.int64)
    TMOE.count_routing(routing)
    try:
        assert teng.generate_all(prompts, budgets) == jout
    finally:
        TMOE.count_routing(None)
    for key in STATS:
        assert teng.stats.get(key) == want.stats.get(key), key
    assert (int(routing[1]) > 0) == (E == 8)     # choices dropped
    ran = {"chunk": "chunks", "multi_step": "multi_blocks", "spec_k": "verify_steps",
           "spec_tree": "verify_steps"}
    if lane in ran:
        assert teng.stats[ran[lane]] > 0


def test_idle_slots_decode_on_the_reference_inputs():
    """Step both engines together at E 8: after every step each slot's
    last token (what an idle slot decodes on) and every cursor (idle slots
    included) equal JAX's; the trace runs decode steps with idle slots,
    and there an idle slot's token changes what the live slots get (its
    choices take capacity ahead of later slots)."""
    jcfg, tcfg = _configs(8)
    w = _weights(8)
    prompts, budgets = _trace()
    jeng = JCB(jcfg, w["j"], n_slots=4, max_len=MAX_LEN, rt=JT.Runtime(backend="fused_int8"))
    teng = ContinuousBatchingEngine(tcfg, w["t"], n_slots=4, max_len=MAX_LEN,
                                    rt=TT.Runtime("fused_int8"), device="cpu")
    for eng in (jeng, teng):
        for p, b in zip(prompts, budgets):
            eng.submit(p, b)
    idle_steps = 0
    while jeng.scheduler.has_work():
        assert teng.scheduler.has_work()
        jeng.step()
        teng.step()
        np.testing.assert_array_equal(teng._last_tok, jeng._last_tok)
        np.testing.assert_array_equal(teng.state["pos"].numpy(), np.asarray(jeng.state["pos"]))
        assert sorted(teng.scheduler.active) == sorted(jeng.scheduler.active)
        idle_steps += 0 < len(teng.scheduler.active) < 4
    assert not teng.scheduler.has_work() and idle_steps > 0
    # an idle slot's input reaches the live slots through capacity: slot 0
    # idle on token a or b, slots 1-3 live on the same tokens
    state = TM.init_decode_state(tcfg, 4, MAX_LEN, "cpu")
    state["pos"].copy_(torch.tensor([5, 9, 7, 3], dtype=torch.int32))
    outs = []
    for idle_tok in range(40):
        st = {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
              "pos": state["pos"].clone()}
        lg, _ = TM.decode_step(w["tq"], tcfg, st, torch.tensor([idle_tok, 11, 11, 11],
                                                                dtype=torch.int32),
                               TT.Runtime("fused_int8"))
        outs.append(lg[1:])
    assert any(not torch.equal(outs[0], o) for o in outs[1:])


def test_engine_generate_token_identical():
    """``Engine.generate`` at E 8: two prompts of 13 tokens prefilled as
    one call (26 rows, b-major), then 6 decode steps of 2 rows."""
    jcfg, tcfg = _configs(8)
    w = _weights(8)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    want, _ = JEngine(cfg=jcfg, params=w["j"], rt=JT.Runtime(backend="fused_int8"),
                      max_len=32).generate({"inputs": jnp.asarray(toks)}, 6)
    got, _ = Engine(cfg=tcfg, params=w["t"], rt=TT.Runtime("fused_int8"), max_len=32,
                    device="cpu").generate({"inputs": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_takes_grok(capfd):
    """``--arch grok-1-314b`` serves (fixed batch and continuous batching,
    reduced, on the CPU), and over a 1x2 mesh (``ep2``: two experts a rank)
    with the tokens of the run without it."""
    fixed = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
             "--steps", "3", "--device", "cpu"]
    launch.main(fixed)
    launch.main(["--arch", ARCH, "--reduced", "--continuous", "--requests", "3",
                 "--slots", "2", "--steps", "3", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "grok-1-314b" in out
    launch.main(fixed + ["--mesh", "1x2"])
    meshed = capfd.readouterr().out
    first = [ln for ln in out.splitlines() if ln.startswith("sample tokens")][0]
    assert [ln for ln in meshed.splitlines() if ln.startswith("sample tokens")] == [first]


def test_convert_groups_runs_of_one_structure():
    """A stack whose first layer is dense and the rest MoE (the reference's
    ``first_dense_layers``) converts to two groups and back, float and
    quantized; ``quantize_tree`` of the port's tree equals the reference's
    bit for bit."""
    jcfg, tcfg = (dataclasses.replace(c, first_dense_layers=1) for c in _configs(8))
    TT.check_supported(tcfg)
    params = JM.init_params(jax.random.key(1), jcfg)
    assert [c for _, c, _ in JT.layer_groups(jcfg)] == [1, 3]
    for tree in (params, j_quantize_tree(params)):
        back = convert.to_numpy(convert.from_numpy(_np(tree), device="cpu"), tcfg)
        flat_a, flat_b = jax.tree_util.tree_flatten_with_path(_np(tree))[0], \
            jax.tree_util.tree_flatten_with_path(back)[0]
        assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
        for (k, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    t = convert.from_numpy(_np(params), device="cpu")
    assert "mlp" in t["layers"][0] and all("moe" in lp for lp in t["layers"][1:])
    want = convert.from_numpy(_np(j_quantize_tree(params)), device="cpu")
    got = t_quantize_tree(t)
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_numpy(want, tcfg)),
                    jax.tree_util.tree_leaves(convert.to_numpy(got, tcfg))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [None, 7, 32])
def test_engine_counts_one_piece_a_prefill_call(monkeypatch, chunk):
    """A MoE stack prefills each call's rows in one piece: one-shot
    admissions and every chunk (budget-cut ones too) run ``_prefill_piece``
    once, with the call's own rows (the bucketed prompt, or the chunk's C
    rows at its cursor), and the engine's ``prefill_pieces`` counts what
    ran."""
    _, tcfg = _configs(8)
    rows = []
    real = TT._prefill_piece
    monkeypatch.setattr(TT, "_prefill_piece",
                        lambda p, cfg, bufs, tokens, start, *a, **k:
                        rows.append((start, tokens.shape[1])) or
                        real(p, cfg, bufs, tokens, start, *a, **k))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (5, 70, 33)]
    kw = {"chunk": chunk} if chunk else {}
    eng = ContinuousBatchingEngine(tcfg, _weights(8)["t"], n_slots=2, max_len=96,
                                   rt=TT.Runtime("fused_int8"), device="cpu", **kw)
    eng.generate_all(prompts, [2] * len(prompts))
    assert eng.prefill_pieces == len(rows)
    if chunk:
        assert len(rows) == eng.stats["chunks"]
        assert all(n == chunk for _, n in rows) and any(s % 64 for s, _ in rows[1:])
    else:
        assert rows == [(0, -(-len(p) // 16) * 16) for p in prompts]
