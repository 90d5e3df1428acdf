"""``Runtime.dmvm_dtype``, the SLC intermediates' dtype, against the JAX
reference on the CPU at bf16 and f32.

Both packages run the same weights (the port's init, seed 0, and its
quantized tree, converted through numpy into the reference's layout) on
the same numpy inputs; the reference's prefill and decode steps run under
``jax.jit`` (one compile a step, not one a primitive).  The port forms a
bf16 product as the reference's XLA does on the CPU: the operands rounded
to bf16, their products summed in f32 (``kernels/decode_attn.py``
``at_dtype``).  A product of two bf16 values is exact in f32, so only the
order of the f32 sums differs.

Tolerances: the attention functions on one set of inputs within 2e-6 of
their output's scale (f32 sums in another order); a layer (its linears
too) within 1e-3 of its output's scale, as ``tests/test_torch_model.py``
holds logits, its appended int8 codes equal to JAX's but for 0.1% of
boundary codes; whole decode steps within 1e-3 of the logit scale with the
argmax equal; the engine token-identical on the pinned seed.  Under
``fused_int8`` the port's GQA bits do not depend on the dtype at all.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import quant as JQ
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.models import attention as TA
from repro_torch.models import graphs as TG
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, None)}
PLAIN = ("dense", "ref_int8", "pim_bitserial")
MAX_LEN = 48
_WEIGHTS: dict = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(arch: str) -> dict:
    """The reduced configs, the port's init (seed 0) and its quantized
    tree, and both in the reference's layout; once a module."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = JR.get(arch).reduced(), TR.get(arch).reduced()
        params = TM.init_params(tcfg, seed=0, device="cpu")
        qparams = t_quantize_tree(params)
        _WEIGHTS[arch] = {"jcfg": jcfg, "tcfg": tcfg, "t": params, "tq": qparams,
                          "j": jax.tree.map(jnp.asarray, convert.to_numpy(params, tcfg)),
                          "jq": jax.tree.map(jnp.asarray, convert.to_numpy(qparams, tcfg))}
    return _WEIGHTS[arch]


def _layer_attn(w: dict, group: int = 0):
    """Layer 1's (of group ``group``) quantized attention block in both
    packages."""
    j = jax.tree.map(lambda a: a[1 if group == 0 else 0], w["jq"]["groups"][group][0]["attn"])
    layer = 1 if group == 0 else w["tcfg"].first_dense_layers
    return j, w["tq"]["layers"][layer]["attn"]


def _close(j, t, frac, argmax=False):
    j, t = np.asarray(j, np.float32), t.detach().float().cpu().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=frac * float(np.abs(j).max()))
    if argmax:
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


def _kv_cache(B, S, G, D, seed):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, S, G, D)).astype(np.float32) for _ in range(2))
    out = []
    for x in (k, v):
        q, s = JQ.quantize_kv(jnp.asarray(x))
        out += [np.asarray(q), np.asarray(s)]
    return out                                        # k_q, k_s, v_q, v_s


_TREE_DEPTH = np.array([0, 1, 1, 2], np.int32)      # root, two children, a grandchild
_TREE_ANC = np.array([1, 3, 5, 11], np.int32)


# ---------------------------------------------------------------------------
# the attention functions on one set of inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["decode", "chain", "tree"])
def test_int8_attention_matches_reference(dtype, mode):
    """``decode_attention_int8`` / ``verify_attention_int8`` (plain branch)
    on one q and int8 cache: within 2e-6 of the output's scale."""
    jdt, tdt = DTYPES[dtype]
    B, S, H, G, D = 3, 40, 8, 2, 32
    T = 1 if mode == "decode" else 4
    cache = _kv_cache(B, S, G, D, seed=1)
    q = np.random.default_rng(2).standard_normal((B, T, H, D)).astype(np.float32)
    pos = np.array([5, 17, 30], np.int32)
    tc = [torch.from_numpy(a) for a in cache]
    jc = [jnp.asarray(a) for a in cache]
    if mode == "decode":
        want = JA.decode_attention_int8(jnp.asarray(q), *jc, jnp.asarray(pos + 1), "dense", jdt)
        got = TA.decode_attention_int8(torch.from_numpy(q), *tc, torch.from_numpy(pos + 1),
                                       "dense", tdt)
    else:
        anc = None if mode == "chain" else np.tile(_TREE_ANC, (B, 1))
        want = JA.verify_attention_int8(jnp.asarray(q), *jc, jnp.asarray(pos), "dense", jdt,
                                        anc=None if anc is None else jnp.asarray(anc))
        got = TA.verify_attention_int8(torch.from_numpy(q), *tc, torch.from_numpy(pos), "dense",
                                       anc=None if anc is None else torch.from_numpy(anc),
                                       inter_dtype=tdt)
    _close(want, got, 2e-6)


def test_bf16_moves_the_plain_attention():
    """The dtype takes effect: bf16 and f32 give different outputs (the
    test above would pass for a dtype the port ignored only if the
    reference ignored it too)."""
    B, S, H, G, D = 2, 24, 4, 2, 32
    tc = [torch.from_numpy(a) for a in _kv_cache(B, S, G, D, seed=3)]
    q = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 1, H, D)).astype(np.float32))
    ln = torch.tensor([24, 9], dtype=torch.int32)
    f32 = TA.decode_attention_int8(q, *tc, ln, "ref_int8")
    bf16 = TA.decode_attention_int8(q, *tc, ln, "ref_int8", torch.bfloat16)
    assert not torch.equal(f32, bf16)
    _close(f32.numpy(), bf16, 2e-2)


# ---------------------------------------------------------------------------
# the layer functions: GQA (llama3-8b) and absorbed MLA (deepseek-v3-671b)
# ---------------------------------------------------------------------------
def _layer_inputs(cfg, B, T, seed):
    x = np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return x, np.array([5, 17, 26], np.int32)[:B]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", PLAIN)
@pytest.mark.parametrize("mode", ["decode", "chain", "tree"])
def test_gqa_layer_matches_reference(dtype, backend, mode):
    """``gqa_decode`` / ``gqa_verify`` (chain and tree) on a quantized
    llama3-8b layer at ragged cursors: output within 1e-3 of its scale, the
    appended K/V codes equal to JAX's but for boundary codes."""
    w = _weights("llama3-8b")
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = w["jcfg"], w["tcfg"]
    jp, tp = _layer_attn(w)
    T = 1 if mode == "decode" else 4
    x, pos = _layer_inputs(jcfg, 3, T, seed=5)
    cache = _kv_cache(3, 32, jcfg.n_kv_heads, jcfg.head_dim, seed=6)
    tc = [torch.from_numpy(a.copy()) for a in cache]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if mode == "decode":
        jo, jc = JA.gqa_decode(jp, jcfg, jx, jnp.asarray(pos), *cache, backend, jdt)
        to, _ = TA.gqa_decode(tp, tcfg, tx, torch.from_numpy(pos), *tc, backend,
                              inter_dtype=tdt)
    else:
        kw_j, kw_t = {}, {}
        if mode == "tree":
            depth, anc = np.tile(_TREE_DEPTH, (3, 1)), np.tile(_TREE_ANC, (3, 1))
            kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
            kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
        jo, jc = JA.gqa_verify(jp, jcfg, jx, jnp.asarray(pos), *cache, backend, jdt, **kw_j)
        to, _ = TA.gqa_verify(tp, tcfg, tx, torch.from_numpy(pos), *tc, backend,
                              inter_dtype=tdt, **kw_t)
    _close(jo, to, 1e-3)
    for j, t in zip(jc[0::2], tc[0::2]):                 # k_q, v_q
        assert np.mean(np.asarray(j) == t.numpy()) > 0.999


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", PLAIN)
@pytest.mark.parametrize("mode", ["decode", "chain", "tree"])
def test_mla_layer_matches_reference(dtype, backend, mode):
    """``mla_decode`` / ``mla_verify`` (chain and tree) on a quantized
    deepseek-v3-671b MoE layer's attention at ragged cursors: output within
    1e-3 of its scale (bf16: the absorbed query is rounded to bf16 on both
    sides), the appended latent codes within one of JAX's."""
    w = _weights("deepseek-v3-671b")
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = w["jcfg"], w["tcfg"]
    jp, tp = _layer_attn(w, group=1)
    T = 1 if mode == "decode" else 4
    x, pos = _layer_inputs(jcfg, 3, T, seed=7)
    dim = jcfg.kv_lora_rank + jcfg.qk_rope_head_dim
    lat = np.random.default_rng(8).standard_normal((3, 32, dim)).astype(np.float32)
    c_q, c_s = (np.asarray(a) for a in JA._quantize_latent(jnp.asarray(lat)))
    tc_q, tc_s = torch.from_numpy(c_q.copy()), torch.from_numpy(c_s.copy())
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if mode == "decode":
        jo, (jq, _) = JA.mla_decode(jp, jcfg, jx, jnp.asarray(pos), c_q, c_s, backend, jdt)
        to, _ = TA.mla_decode(tp, tcfg, tx, torch.from_numpy(pos), tc_q, tc_s, backend,
                              inter_dtype=tdt)
    else:
        kw_j, kw_t = {}, {}
        if mode == "tree":
            depth, anc = np.tile(_TREE_DEPTH, (3, 1)), np.tile(_TREE_ANC, (3, 1))
            kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
            kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
        jo, (jq, _) = JA.mla_verify(jp, jcfg, jx, jnp.asarray(pos), c_q, c_s, backend, jdt,
                                    **kw_j)
        to, _ = TA.mla_verify(tp, tcfg, tx, torch.from_numpy(pos), tc_q, tc_s, backend,
                              inter_dtype=tdt, **kw_t)
    _close(jo, to, 1e-3)
    assert np.abs(np.asarray(jq).astype(np.int32) - tc_q.numpy().astype(np.int32)).max() <= 1


@pytest.mark.parametrize("mode", ["decode", "chain", "tree"])
def test_fused_int8_gqa_ignores_the_dtype(mode):
    """Under ``fused_int8`` B2-B4 (here their plain versions, as on any CPU
    tensor) take no dtype: the layer's output and cache are the same bits
    at bf16 and f32."""
    w = _weights("llama3-8b")
    tcfg = w["tcfg"]
    _, tp = _layer_attn(w)
    T = 1 if mode == "decode" else 4
    x, pos = _layer_inputs(tcfg, 3, T, seed=9)
    cache = _kv_cache(3, 32, tcfg.n_kv_heads, tcfg.head_dim, seed=10)
    outs = []
    for tdt in (None, torch.bfloat16):
        tc = [torch.from_numpy(a.copy()) for a in cache]
        args = (tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), *tc, "fused_int8")
        if mode == "decode":
            o, _ = TA.gqa_decode(*args, inter_dtype=tdt)
        else:
            kw = {}
            if mode == "tree":
                kw = {"depth": torch.from_numpy(np.tile(_TREE_DEPTH, (3, 1))),
                      "anc": torch.from_numpy(np.tile(_TREE_ANC, (3, 1)))}
            o, _ = TA.gqa_verify(*args, inter_dtype=tdt, **kw)
        outs.append((o, tc))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# whole decode steps, the captured steps, the engine
# ---------------------------------------------------------------------------
def _prefilled(w):
    """JAX's prefill (``Runtime()``) of two prompts (24 and 13 tokens,
    seed 2): the logits and the state; once a module and arch."""
    if "prefilled" not in w:
        toks = np.random.default_rng(2).integers(0, w["jcfg"].vocab_size, (2, 24)).astype(np.int32)
        fill = jax.jit(functools.partial(JM.prefill, cfg=w["jcfg"], max_len=MAX_LEN,
                                         rt=JT.Runtime()))
        w["prefilled"] = fill(w["j"], batch={"inputs": jnp.asarray(toks),
                                             "lengths": jnp.asarray(np.array([24, 13], np.int32))})
    return w["prefilled"]


@pytest.mark.parametrize("arch,backend", [("llama3-8b", "ref_int8"),
                                          ("llama3-8b", "dense"),
                                          ("deepseek-v3-671b", "ref_int8"),
                                          ("deepseek-v3-671b", "fused_int8")])
def test_decode_step_matches_reference_at_bf16(arch, backend):
    """Three greedy ``decode_step`` calls of both packages at bf16 from
    JAX's prefilled cache: logits within 1e-3 of their scale, argmax and
    cursors equal."""
    w = _weights(arch)
    jcfg, tcfg = w["jcfg"], w["tcfg"]
    jl, jstate = _prefilled(w)
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    jstep = jax.jit(functools.partial(JM.decode_step, cfg=jcfg, rt=JT.Runtime(
        backend=backend, dmvm_dtype=jnp.bfloat16)))
    trt = TT.Runtime(backend, dmvm_dtype=torch.bfloat16)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jstate = jstep(w["jq"], state=jstate, token=jnp.asarray(tok))
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl, 1e-3, argmax=True)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def test_runtime_takes_the_dtype():
    assert TT.Runtime(dmvm_dtype=torch.bfloat16).dmvm_dtype is torch.bfloat16
    assert TT.Runtime().dmvm_dtype is None
    with pytest.raises(TypeError, match="dmvm_dtype"):
        TT.Runtime(dmvm_dtype="bf16")
    with pytest.raises(TypeError, match="dmvm_dtype"):
        TT.Runtime(dmvm_dtype=torch.int8)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_serve_steps_run_the_runtimes_dtype(arch):
    """``ServeSteps`` (eager on CPU tensors, captured on the card) runs its
    Runtime's dtype in the decode, verify and tree steps: the same logits
    as the model's steps at bf16, and not the f32 ones."""
    w = _weights(arch)
    tcfg = w["tcfg"]
    _, jstate = _prefilled(w)
    base = convert.from_numpy(_np(jstate), device="cpu")
    tok = torch.tensor([3, 11], dtype=torch.int32)
    win = torch.tensor([[3, 4, 5], [11, 12, 13]], dtype=torch.int32)
    depth = torch.tensor([[0, 1, 1]] * 2, dtype=torch.int32)
    anc = torch.tensor([[1, 3, 5]] * 2, dtype=torch.int32)

    def clone():
        return convert.tree_map(base, lambda t: t.clone())
    for dt in (torch.bfloat16, None):
        rt = TT.Runtime("ref_int8", dmvm_dtype=dt)
        steps = TG.ServeSteps(w["tq"], tcfg, rt, clone(), verify=(3,), tree=(3,))
        got, want = [], []
        for kind in ("decode", "verify", "tree"):
            state = clone()
            for t, s in zip(TG.state_tensors(steps.state), TG.state_tensors(state)):
                t.copy_(s)
            if kind == "decode":
                steps.tok.copy_(tok)
                got.append(steps.decode()[0].clone())
                want.append(TM.decode_step(w["tq"], tcfg, state, tok, rt)[0])
            else:
                steps.window[3].copy_(win)
                kw = {}
                if kind == "tree":
                    steps.depth[3].copy_(depth)
                    steps.anc[3].copy_(anc)
                    kw = {"depth": depth, "anc": anc}
                got.append((steps.tree(3) if kind == "tree" else steps.verify(3))[0].clone())
                want.append(TM.verify_step(w["tq"], tcfg, state, win, rt, **kw)[0])
        for g, wt in zip(got, want):
            assert torch.equal(g, wt)
        if dt is not None:
            bf16 = got
    assert not all(torch.equal(a, b) for a, b in zip(bf16, got))


def _trace():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, rng.integers(4, 20)).tolist() for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    return prompts, budgets


def test_continuous_engine_token_identical_at_bf16():
    """llama3-8b reduced under ``ref_int8`` at bf16: the port's continuous
    engine gives JAX's tokens and step counts on the pinned seed."""
    w = _weights("llama3-8b")
    prompts, budgets = _trace()
    jeng = JCB(w["jcfg"], w["j"], n_slots=2, max_len=64,
               rt=JT.Runtime(backend="ref_int8", dmvm_dtype=jnp.bfloat16))
    want = jeng.generate_all(prompts, budgets)
    teng = TCB(w["tcfg"], w["t"], n_slots=2, max_len=64,
               rt=TT.Runtime("ref_int8", dmvm_dtype=torch.bfloat16), device="cpu")
    assert teng.generate_all(prompts, budgets) == want
    for key in ("steps", "decode_steps", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key

