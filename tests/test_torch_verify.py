"""The port's speculative lanes against the JAX reference on the CPU.

B3 (``verify_attn``) and B4 (``verify_tree_attn``) plain versions against
the Pallas kernels in interpret mode and the ``ref.py`` oracles, within
``rtol=3e-5, atol=3e-6`` (the float stages sum in another order); the
verify step's logits against JAX's within 1e-3 of the logit scale with the
argmax equal (as ``test_torch_model.py``); cursor rollback, tree commit and
path compaction bit for bit; the n-gram drafter token for token; and the
continuous engine's ``spec_k`` / ``spec_tree`` lanes token-identical to the
JAX engine's and to the port's own plain lane, with equal spec stats.  The
CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import kvcache as JKV
from repro.core import quant as jq
from repro.kernels.decode_attn import kernel as j_da_kernel
from repro.kernels.decode_attn import ops as j_da_ops
from repro.kernels.decode_attn import ref as j_da_ref
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve import drafter as JD
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch import kernels as KN
from repro_torch.configs import registry as TR
from repro_torch.core import kvcache as TKV
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import verify_attn as va
from repro_torch.kernels import verify_tree_attn as vt
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import drafter as TD
from repro_torch.serve.engine import ContinuousBatchingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
MAX_LEN = 48
ATOL, RTOL = 3e-6, 3e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.key(0), JCFG)
    qparams = j_quantize_tree(params)
    return {"j": params, "jq": qparams,
            "t": convert.from_numpy(_np(params), device="cpu"),
            "tq": convert.from_numpy(_np(qparams), device="cpu")}


def _close(j, t, frac=1e-3):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * scale)
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


def _random_parents(rng, n):
    """A random topological draft tree of ``n`` nodes (draft space)."""
    return [int(rng.integers(-1, i)) for i in range(n)]


# ---------------------------------------------------------------------------
# B3 / B4 plain versions
# ---------------------------------------------------------------------------
def _window(b, s, g, rep, d, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, g * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    jk_q, jk_s = jq.quantize_kv(jnp.asarray(k))
    jv_q, jv_s = jq.quantize_kv(jnp.asarray(v))
    j = (jnp.asarray(q), jk_q, jk_s, jv_q, jv_s)
    return j, [torch.from_numpy(np.array(a)) for a in j]


# (B, S, G, D, pos): ragged cursors, 0 included, windows up to S
SHAPES = {1: (3, 64, 2, 32, [0, 17, 63]), 3: (3, 300, 2, 64, [0, 150, 297]),
          5: (2, 512, 2, 32, [0, 507])}


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("t", [1, 3, 5])
def test_verify_attention_plain_matches_pallas_and_ref(t, rep):
    b, s, g, d, pos = SHAPES[t]
    j, tt = _window(b, s, g, rep, d, t, 100 * t + rep)
    pos = np.array(pos, np.int32)
    got = va.verify_attention(*tt, torch.from_numpy(pos)).numpy()
    want = np.asarray(j_da_ops.verify_attention(*j, jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_ref = np.asarray(j_da_ref.verify_ref(*j, jnp.asarray(pos)))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("t", [1, 3, 5])
def test_verify_tree_attention_plain_matches_pallas_and_ref(t, rep):
    b, s, g, d, pos = SHAPES[t]
    j, tt = _window(b, s, g, rep, d, t, 200 * t + rep)
    rng = np.random.default_rng(t * rep)
    anc = np.array([JD.tree_depths_ancestors(_random_parents(rng, t - 1))[1]
                    for _ in range(b)], np.int32)
    pos = np.array(pos, np.int32)
    got = vt.verify_attention_tree(*tt, torch.from_numpy(pos),
                                   torch.from_numpy(anc)).numpy()
    want = np.asarray(j_da_ops.verify_attention_tree(*j, jnp.asarray(pos),
                                                     jnp.asarray(anc)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_ref = np.asarray(j_da_ref.verify_tree_ref(*j, jnp.asarray(pos),
                                                   jnp.asarray(anc)))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)


def test_kernel_level_plain_versions_match_pallas():
    """The kernel-layout plain versions ([B,G,T,rep,D] int8 q) against the
    Pallas kernels on the same quantized operands."""
    b, s, g, rep, d, t = 2, 256, 2, 4, 32, 4
    j, tt = _window(b, s, g, rep, d, t, 7)
    q_q, q_s = va.quantize_window(tt[0], g)
    jq_q, jq_s = jnp.asarray(q_q.numpy()), jnp.asarray(q_s.numpy())
    cache = [tt[1], tt[2][..., 0], tt[3], tt[4][..., 0]]
    jcache = [j[1], j[2][..., 0], j[3], j[4][..., 0]]
    lengths = np.array([[3, 4, 5, 6], [200, 201, 202, 203]], np.int32)
    got = va.verify_attn_plain(q_q, q_s, *cache, torch.from_numpy(lengths))
    want = j_da_kernel.verify_attn_pallas(jq_q, jq_s, *jcache, jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    pos = np.array([2, 199], np.int32)
    anc = np.array([[1, 3, 5, 11], [1, 3, 7, 9]], np.int32)
    got = vt.verify_tree_attn_plain(q_q, q_s, *cache, torch.from_numpy(pos),
                                    torch.from_numpy(anc))
    want = j_da_kernel.verify_tree_attn_pallas(jq_q, jq_s, *jcache, jnp.asarray(pos),
                                               jnp.asarray(anc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_verify_plain_at_one_token_is_decode_plain_and_chain_tree_is_verify():
    """B3 plain at T = 1 equals B2 plain, and B4 plain on chain ancestors
    equals B3 plain, bit for bit."""
    b, s, g, rep, d = 3, 200, 2, 4, 32
    j, tt = _window(b, s, g, rep, d, 1, 9)
    cache = [tt[1], tt[2][..., 0], tt[3], tt[4][..., 0]]
    q_q, q_s = va.quantize_window(tt[0], g)
    pos = torch.tensor([0, 77, 199], dtype=torch.int32)
    one = va.verify_attn_plain(q_q, q_s, *cache, (pos + 1)[:, None])
    dec = da.decode_attn_plain(q_q[:, :, 0], q_s[:, :, 0], *cache, pos + 1)
    assert torch.equal(one[:, :, 0], dec)
    t = 6
    _, tt = _window(b, s, g, rep, d, t, 10)
    q_q, q_s = va.quantize_window(tt[0], g)
    pos = torch.tensor([0, 100, 194], dtype=torch.int32)
    lin = va.verify_attn_plain(q_q, q_s, *cache,
                               pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32))
    chain = torch.tensor(JD.tree_depths_ancestors(JD.chain_parents(t - 1))[1],
                         dtype=torch.int32).expand(b, t).contiguous()
    assert torch.equal(vt.verify_tree_attn_plain(q_q, q_s, *cache, pos, chain), lin)


def test_tree_visibility_mask_matches_reference():
    rng = np.random.default_rng(3)
    pos = np.array([0, 5, 20], np.int32)
    anc = np.array([JD.tree_depths_ancestors(_random_parents(rng, 30))[1]
                    for _ in range(3)], np.int32)
    want = np.asarray(JA.tree_visibility_mask(jnp.asarray(pos), jnp.asarray(anc), 64, 31))
    got = vt.tree_visibility_mask(torch.from_numpy(pos), torch.from_numpy(anc), 64, 31)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_windows_take_the_plain_versions_and_cuda_wrappers_refuse_them():
    _, tt = _window(1, 32, 1, 2, 32, 3, 4)
    KN.reset_launch_counts()
    va.verify_attention(*tt, 5)
    vt.verify_attention_tree(*tt, 5, torch.tensor([[1, 3, 5]], dtype=torch.int32))
    assert set(KN.launch_counts().values()) == {0}
    q_q, q_s = va.quantize_window(tt[0], 1)
    cache = [tt[1], tt[2][..., 0].contiguous(), tt[3], tt[4][..., 0].contiguous()]
    with pytest.raises(ValueError, match="CUDA"):
        va.verify_attn_cuda(q_q, q_s, *cache, torch.ones((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        vt.verify_tree_attn_cuda(q_q, q_s, *cache, torch.ones((1,), dtype=torch.int32),
                                 torch.ones((1, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# cache helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs,want", [
    ({}, 0), ({"spec_k": 4}, 4), ({"spec_tree": 6}, 6), ({"multi_step": 4}, 3),
    ({"spec_k": 2, "spec_tree": 5, "multi_step": 4}, 5)])
def test_pool_headroom_matches_reference(kwargs, want):
    assert TKV.pool_headroom(**kwargs) == JKV.pool_headroom(**kwargs) == want


def test_pool_headroom_rejects_bad_arguments():
    for kw in ({"multi_step": 0}, {"spec_k": -1}):
        with pytest.raises(ValueError):
            TKV.pool_headroom(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_path_gather_in_place_matches_reference(seed):
    """Rows move down over their own sources: gathering first keeps them
    intact, and the result equals the reference's bit for bit."""
    rng = np.random.default_rng(seed)
    B, S, W = 3, 16, 5
    buf = rng.standard_normal((2, B, S, 2, 4)).astype(np.float32)
    base = rng.integers(0, S - W - 1, B).astype(np.int32)
    sel = np.zeros((B, W), np.int32)
    keep = rng.integers(0, W + 1, B).astype(np.int32)
    for b in range(B):
        nodes = np.sort(rng.choice(np.arange(1, W + 1), keep[b], replace=False))
        sel[b, :keep[b]] = nodes
    want = np.asarray(JKV.path_gather(jnp.asarray(buf), base, sel, keep))
    got = np.stack([TKV.path_gather(torch.from_numpy(buf[i].copy()), torch.from_numpy(base),
                                    torch.from_numpy(sel), torch.from_numpy(keep)).numpy()
                    for i in range(2)])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# verify step (model level)
# ---------------------------------------------------------------------------
def _prefilled(weights):
    toks = np.random.default_rng(2).integers(0, JCFG.vocab_size, (3, 24)).astype(np.int32)
    lengths = np.array([24, 13, 1], np.int32)
    _, jstate = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks),
                                                "lengths": jnp.asarray(lengths)},
                           MAX_LEN, JT.Runtime())
    return jstate


def _tree_operands(B, T, seed):
    rng = np.random.default_rng(seed)
    depth, anc = zip(*[JD.tree_depths_ancestors(_random_parents(rng, T - 1))
                       for _ in range(B)])
    return np.array(depth, np.int32), np.array(anc, np.int32)


@pytest.mark.parametrize("mode", ["linear", "tree"])
@pytest.mark.parametrize("backend", ["dense", "ref_int8", "fused_int8"])
def test_verify_step_logits_match(weights, backend, mode):
    jstate = _prefilled(weights)
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    T = 5
    # a pinned draw: other draws can put an activation on an int8 rounding
    # boundary, where the float sums' last bits flip one code, in the plain
    # decode step as much as here
    toks = np.random.default_rng(6).integers(0, JCFG.vocab_size, (3, T)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        depth, anc = _tree_operands(3, T, 106)
        kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
        kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
    jl, jh, jst = JM.verify_step(weights["jq"], JCFG, jstate, jnp.asarray(toks),
                                 JT.Runtime(backend=backend), **kw_j)
    tl, th, tst = TM.verify_step(weights["tq"], TCFG, tstate, torch.from_numpy(toks),
                                 TT.Runtime(backend), **kw_t)
    assert tuple(tl.shape) == (3, T, TCFG.vocab_size)
    assert tuple(th.shape) == (3, T, TCFG.d_model)
    _close(jl, tl)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    jk = np.asarray(jst["groups"][0][0]["k_q"])
    tk = np.stack([c["k_q"].numpy() for c in tst["layers"]])
    assert np.mean(jk == tk) > 0.999


def _port_prefilled(weights, B=3, max_len=32):
    state = TM.init_decode_state(TCFG, B, max_len, device="cpu")
    for b, plen in enumerate((4, 6, 5)):
        toks = torch.arange(1, plen + 1)[None]
        _, one = TM.prefill(weights["t"], TCFG, {
            "inputs": toks, "lengths": torch.tensor([plen], dtype=torch.int32)},
            max_len, TT.Runtime())
        TT.write_slot(state, b, one)
    return state


def _clone(state):
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
            "pos": state["pos"].clone()}


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_verify_rows_equal_sequential_decode(weights, backend):
    """Row i of the verify logits equals the i-th sequential decode step's
    logits bit for bit, and the rewound verify state decodes on exactly as
    the sequential state does."""
    p, rt = weights["tq"], TT.Runtime(backend)
    state = _port_prefilled(weights)
    tok = torch.tensor([3, 5, 7], dtype=torch.int32)
    st, seq = _clone(state), []
    for _ in range(4):
        lg, st = TM.decode_step(p, TCFG, st, tok, rt)
        seq.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32)
    fed = torch.stack([torch.tensor([3, 5, 7], dtype=torch.int32)]
                      + [torch.argmax(l, -1).to(torch.int32) for l in seq[:3]], dim=1)
    vlog, hidden, vstate = TM.verify_step(p, TCFG, _clone(state), fed, rt)
    for i in range(4):
        assert torch.equal(vlog[:, i], seq[i]), i
    assert torch.equal(vstate["pos"], state["pos"] + 4)
    rewound = TT.rewind_pos(vstate, st["pos"].clone())
    assert rewound["layers"] is vstate["layers"]
    lg_a, _ = TM.decode_step(p, TCFG, rewound, tok, rt)
    lg_b, _ = TM.decode_step(p, TCFG, st, tok, rt)
    assert torch.equal(lg_a, lg_b)


def test_tree_verify_and_commit_match_reference(weights):
    """A window with a junk sibling: chain-prefix rows equal sequential
    decode bit for bit, and the committed state equals JAX's tree commit of
    the same verified state, leaf for leaf."""
    jstate = _prefilled(weights)
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    rt_j, rt_t = JT.Runtime(), TT.Runtime()
    p_j, p_t = weights["jq"], weights["tq"]
    tok = np.array([3, 5, 7], np.int32)
    st, seq = _clone(tstate), []
    for _ in range(3):
        lg, st = TM.decode_step(p_t, TCFG, st, torch.from_numpy(tok), rt_t)
        seq.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32).numpy()
    greedy = [torch.argmax(l, -1).to(torch.int32).numpy() for l in seq]
    junk = (greedy[0] + 1) % TCFG.vocab_size
    fed = np.stack([np.array([3, 5, 7], np.int32), greedy[0], junk, greedy[1]], axis=1)
    depth, anc = JD.tree_depths_ancestors([-1, -1, 0])
    depth = np.tile(np.array(depth, np.int32), (3, 1))
    anc = np.tile(np.array(anc, np.int32), (3, 1))
    vlog, _, vstate = TM.verify_step(p_t, TCFG, _clone(tstate), torch.from_numpy(fed), rt_t,
                                     depth=torch.from_numpy(depth), anc=torch.from_numpy(anc))
    assert torch.equal(vlog[:, 0], seq[0]) and torch.equal(vlog[:, 1], seq[1])
    np.testing.assert_array_equal(vlog[:, 3].argmax(-1).numpy(), greedy[2])
    # the same verified state through JAX's commit and the port's
    _, _, jv = JM.verify_step(p_j, JCFG, jstate, jnp.asarray(fed), rt_j,
                              depth=jnp.asarray(depth), anc=jnp.asarray(anc))
    jv = {"groups": jv["groups"], "pos": jv["pos"]}
    tv = convert.from_numpy(_np(jv), device="cpu")
    base = np.array(jstate["pos"], np.int32)
    sel = np.tile(np.array([[1, 3, 0]], np.int32), (3, 1))
    keep = np.array([2, 1, 0], np.int32)
    want = JM.tree_commit(jv, jnp.asarray(base), jnp.asarray(sel), jnp.asarray(keep),
                          jnp.asarray(base + 1 + keep))
    got = TM.tree_commit(tv, torch.from_numpy(base), torch.from_numpy(sel),
                         torch.from_numpy(keep), torch.from_numpy(base + 1 + keep))
    want = convert.from_numpy(_np(want), device="cpu")
    assert torch.equal(got["pos"], want["pos"])
    for gl, wl in zip(got["layers"], want["layers"]):
        for k in wl:
            assert torch.equal(gl[k], wl[k]), k


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_ngram_drafter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 6, int(rng.integers(1, 40))).tolist()
    k, branch, max_n = int(rng.integers(1, 8)), int(rng.integers(1, 4)), int(rng.integers(1, 5))
    jd, td = JD.NGramDrafter(max_n), TD.NGramDrafter(max_n)
    assert td.draft(ctx, k) == jd.draft(ctx, k)
    assert td.draft_tree(ctx, k, branch) == jd.draft_tree(ctx, k, branch)
    assert td._candidates(ctx, k, branch) == jd._candidates(ctx, k, branch)


def test_tree_topology_helpers_match_reference():
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 30):
        par = _random_parents(rng, n)
        assert TD.tree_depths_ancestors(par) == JD.tree_depths_ancestors(par)
        assert TD.chain_parents(n) == JD.chain_parents(n)
    with pytest.raises(ValueError):
        TD.tree_depths_ancestors([-1, 2])


def test_make_drafter_parsing():
    assert isinstance(TD.make_drafter("ngram", TCFG), TD.NGramDrafter)
    assert TD.make_drafter("ngram:5", TCFG).max_n == 5
    inst = TD.NGramDrafter()
    assert TD.make_drafter(inst, TCFG) is inst
    with pytest.raises(ValueError):
        TD.make_drafter("oracle", TCFG)


# ---------------------------------------------------------------------------
# engine-level parity
# ---------------------------------------------------------------------------
def _serve_pim_trace():
    """The ragged request trace of ``examples/serve_pim.py`` (6 requests)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    return prompts, budgets


@pytest.fixture(scope="module")
def plain_streams(weights):
    prompts, budgets = _serve_pim_trace()
    return {backend: ContinuousBatchingEngine(
        TCFG, weights["t"], n_slots=2, max_len=64, rt=TT.Runtime(backend),
        device="cpu").generate_all(prompts, budgets)
        for backend in ("dense", "fused_int8")}


SPEC_STATS = ("steps", "decode_steps", "verify_steps", "spec_drafted", "spec_accepted",
              "spec_accept_hist", "prefill_tokens", "xfer_bytes", "decode_xfer_bytes")


@pytest.mark.parametrize("lane", [{"spec_k": 2}, {"spec_k": 4}, {"spec_tree": 2},
                                  {"spec_tree": 6}], ids=lambda d: "-".join(map(str, *d.items())))
@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_spec_engine_token_identical(weights, plain_streams, backend, lane):
    prompts, budgets = _serve_pim_trace()
    jeng = JCB(JCFG, weights["j"], n_slots=2, max_len=64,
               rt=JT.Runtime(backend=backend), **lane)
    want = jeng.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=64,
                                    rt=TT.Runtime(backend), device="cpu", **lane)
    got = teng.generate_all(prompts, budgets)
    assert got == want == plain_streams[backend]
    for key in SPEC_STATS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["verify_steps"] == teng.stats["decode_steps"] > 0
    assert teng.acceptance_rate == jeng.acceptance_rate
    assert teng.state["layers"][0]["k_q"].shape[1] == 64 + max(lane.values())
    assert not teng.scheduler.has_work() and len(teng.scheduler.free_slots) == 2


class _Oracle(TD.Drafter):
    """Drafts a known stream for one prompt (always right there), junk
    elsewhere."""
    name = "oracle"

    def __init__(self, prompt, full):
        self.prompt, self.full = prompt, full

    def draft(self, context, k):
        n = len(self.prompt)
        if context[:n] != self.prompt:
            return [0] * k
        nxt = self.full[len(context) - n:len(context) - n + k]
        return (nxt + [0] * k)[:k]


@pytest.mark.parametrize("lane", [{"spec_k": 4}, {"spec_tree": 4}],
                         ids=["spec_k", "spec_tree"])
def test_eos_inside_verify_window(weights, lane):
    """An accepted draft that equals the EOS id stops the request exactly
    where the plain lane does, with nothing past it, and the slot backfills.
    The EOS is a token whose first occurrence in the plain stream is inside
    the first window (a token that the stream emits earlier would stop it
    there instead)."""
    prompts, _ = _serve_pim_trace()
    prompt = prompts[0]
    full = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=1, max_len=32,
                                    device="cpu").generate_all([prompt], [8])[0]
    idx = next(i for i in range(2, 5) if full[i] not in full[:i])
    eng = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=1, max_len=32,
                                   device="cpu", drafter=_Oracle(prompt, full), **lane)
    r_eos = eng.submit(prompt, 8, eos_id=full[idx])
    r_next = eng.submit(list(reversed(prompt)), 3)
    eng.drain()
    assert r_eos.output == full[:idx + 1]
    assert len(r_next.output) == 3
    # the window stopped inside itself: one verify step covered the EOS
    assert eng.stats["spec_accept_hist"][idx] >= 1
    plain = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=1, max_len=32,
                                     device="cpu").generate_all([prompt], [8], eos_id=full[idx])
    assert plain[0] == r_eos.output


@pytest.mark.parametrize("kwargs", [{"spec_k": -1}, {"spec_tree": -1}, {"spec_tree": 31},
                                    {"spec_k": 2, "spec_branch": 0}])
def test_spec_arguments_are_validated(weights, kwargs):
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=32,
                                 device="cpu", **kwargs)


def test_plain_lane_keeps_its_pool_and_has_no_histogram(weights):
    eng = ContinuousBatchingEngine(TCFG, weights["t"], n_slots=2, max_len=32, device="cpu")
    assert eng.state["layers"][0]["k_q"].shape[1] == 32
    assert "spec_accept_hist" not in eng.stats
    assert np.isnan(eng.acceptance_rate)
