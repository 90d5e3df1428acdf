"""The port's remaining dense decoders against the JAX reference on the CPU:
the paper's own OPT family (sinusoidal positions, LayerNorm, gelu, MHA,
tied embedding), granite-3-8b (GQA, tied embedding), phi3-mini-3.8b
(MHA, head dim 96), chameleon-34b (family ``vlm``: embedding inputs,
QK-norm), nemotron-4-340b (relu2; also at its head dim 192) and
grok-1-314b (family ``moe``: top-2 of 4 experts reduced; its routing at
grok's own 8 experts is held in ``test_torch_moe.py``), each
``.reduced()``.

Tolerances: configs, converted trees and quantized trees equal; the
sinusoidal tables within 1e-4 (XLA's f32 ``exp`` differs from torch's by an
ulp in some of the frequencies, which an angle of a few hundred radians
carries to about 3e-5); the LayerNorm plain version within rtol 1e-6 /
atol 1e-6 of the reference's branch; logits within 1e-3 of the logit scale
with the argmax equal (as every port test); OPT's engines token-identical
to JAX's with equal stats, and chameleon's too, its embedding prefill bit
for bit equal to prefill from the token ids whose table rows they are.  The
Pallas kernels run in interpret mode at S <= 512 (ROADMAP C: NaN past 512).
The LayerNorm kernel and B2-B4 at rep 1 and at head dim 192 are held
against their plain versions in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import opt as j_opt
from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import opt as t_opt
from repro_torch.configs import registry as TR
from repro_torch.kernels import layer_norm as ln
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("opt-30b", "granite-3-8b", "phi3-mini-3.8b", "chameleon-34b", "nemotron-4-340b",
         "grok-1-314b")
BACKENDS = ("dense", "ref_int8", "fused_int8", "pim_bitserial")
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


_WEIGHTS: dict = {}
HD192 = "nemotron-4-340b@192"     # reduced nemotron at its own head dim


def _configs(arch: str):
    """(JAX config, port config) of a reduced family; ``HD192`` is reduced
    nemotron-4-340b with head_dim 192 (4 heads, 2 KV groups: rep 2)."""
    if arch == HD192:
        return tuple(dataclasses.replace(R.get("nemotron-4-340b").reduced(), head_dim=192)
                     for R in (JR, TR))
    return JR.get(arch).reduced(), TR.get(arch).reduced()


def _weights(arch: str) -> dict:
    """The reduced family's JAX init, quantized, and both converted; made
    once a module."""
    if arch not in _WEIGHTS:
        params = JM.init_params(jax.random.key(0), _configs(arch)[0])
        qparams = j_quantize_tree(params)
        _WEIGHTS[arch] = {"j": params, "jq": qparams,
                          "t": convert.from_numpy(_np(params), device="cpu"),
                          "tq": convert.from_numpy(_np(qparams), device="cpu")}
    return _WEIGHTS[arch]


@pytest.fixture(params=ARCHS)
def fam(request):
    """(arch, JAX config, port config, weights) of one reduced family."""
    arch = request.param
    return arch, JR.get(arch).reduced(), TR.get(arch).reduced(), _weights(arch)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS + ("opt-125m",))
def test_config_copy_matches_reference(arch, reduced):
    j, t = JR.get(arch), TR.get(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    TT.check_supported(t)


@pytest.mark.parametrize("name", ["CONFIG", "OPT_125M", "OPT_6_7B"])
def test_opt_module_copy_matches_reference(name):
    j, t = getattr(j_opt, name), getattr(t_opt, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.rope_theta == 0 and t.norm_type == "layernorm" and t.n_kv_heads == t.n_heads


def test_registry_ids_are_the_references():
    assert set(TR.ARCHS) <= set(JR.ARCHS)
    assert {"opt-30b", "opt-125m", "granite-3-8b", "phi3-mini-3.8b", "chameleon-34b",
            "nemotron-4-340b", "grok-1-314b", "deepseek-v3-671b", "jamba-1.5-large-398b",
            "whisper-tiny"} <= set(TR.ARCHS)


def test_check_supported_refuses_what_is_not_ported():
    """Embedding inputs, family ``vlm`` (chameleon-34b), experts
    (grok-1-314b; every layer or every other one), MLA (deepseek-v3-671b)
    and hybrid SSM/GQA stacks (jamba-1.5-large-398b) are admitted; experts
    fed embeddings still raise, naming ROADMAP A.11, and so does an
    encoder-decoder, which ``models/encdec.py`` serves instead of the
    decoder stack (A.11.5)."""
    base = TR.get("opt-30b").reduced()
    for kw in ({"input_mode": "embeddings"}, {"family": "vlm"},
               {"family": "vlm", "input_mode": "embeddings", "use_qk_norm": True},
               {"n_experts": 4, "n_experts_active": 2},
               {"family": "moe", "n_experts": 8, "n_experts_active": 2, "moe_d_ff": 64,
                "moe_every": 2}, {"attn_type": "mla"},
               {"family": "hybrid", "attn_every": 2, "ssm_state": 16}):
        TT.check_supported(dataclasses.replace(base, **kw))
    for kw in ({"family": "moe", "n_experts": 8, "n_experts_active": 2,
                "input_mode": "embeddings"},
               {"family": "encdec", "encoder_layers": 2, "encoder_seq": 16},
               {"family": "ssm", "attn_type": "none", "d_ff": 0,
                "input_mode": "embeddings"}):
        with pytest.raises(NotImplementedError, match="A.11"):
            TT.check_supported(dataclasses.replace(base, **kw))


# ---------------------------------------------------------------------------
# sinusoidal positions and LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [32, 96, 128, 7168])
def test_sinusoids_match_reference(d):
    for seq, off in ((48, 0), (64, 448)):
        np.testing.assert_allclose(TL.sinusoidal_positions(seq, d, off).numpy(),
                                   np.asarray(JL.sinusoidal_positions(seq, d, off)),
                                   rtol=0, atol=1e-4)
    pos = np.array([[0, 1, 7], [63, 64, 511]], np.int32)
    got = TL.sinusoid_at(torch.from_numpy(pos), d)
    assert tuple(got.shape) == (2, 3, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JT._sinusoid_at(jnp.asarray(pos), d)),
                               rtol=0, atol=1e-4)
    # the table is sinusoid_at over its positions, bit for bit
    assert torch.equal(TL.sinusoidal_positions(4, d, 5), TL.sinusoid_at(torch.arange(5, 9), d))


@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 768), (4, 7168), (1, 96)])
def test_layer_norm_plain_matches_reference(shape):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(JL.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                    jnp.asarray(x)))
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    got = TL.apply_norm(p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # on CPU tensors apply_norm is the plain version bit for bit
    assert torch.equal(got, ln.layer_norm_plain(torch.from_numpy(x), p["scale"], p["bias"]))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tree", ["j", "jq"])
def test_convert_round_trips(fam, tree):
    arch, jcfg, tcfg, w = fam
    src = _flat(_np(w[tree]))
    back = _flat(convert.to_numpy(convert.from_numpy(_np(w[tree]), device="cpu"), tcfg))
    assert src.keys() == back.keys()
    assert ("/lm_head/w" in back) != jcfg.tie_embeddings and "/embed/w" in back
    if jcfg.norm_type == "layernorm":
        for leaf in ("ln1/bias", "ln2/bias"):
            assert f"/groups/0/0/{leaf}" in back, leaf
        assert "/ln_f/bias" in back
    for k in src:
        assert src[k].dtype == back[k].dtype, k
        np.testing.assert_array_equal(src[k], back[k], err_msg=k)


def test_quantize_tree_matches_reference(fam):
    _, _, tcfg, w = fam
    want = _flat(convert.to_numpy(w["tq"], tcfg))
    got = _flat(convert.to_numpy(t_quantize_tree(w["t"]), tcfg))
    assert want.keys() == got.keys()
    assert got["/embed/w"].dtype == np.float32                    # the tied embedding stays float
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_logits_match(fam, backend):
    """Ragged prefill and three greedy decode steps (W8A8 weights).  A MoE
    stack (grok-1-314b) decodes from JAX's prefilled cache, the two caches
    held to 99.9% equal codes first: with this seed one K code of 24,576
    flips in layer 2 (the float prefills' K differ by ulps), which moves a
    router's near-tie and so a slot's expert two steps later."""
    _, jcfg, tcfg, w = fam
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    lengths = np.array([24, 17], np.int32)
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    jl, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                           "lengths": jnp.asarray(lengths)}, MAX_LEN, jrt)
    tl, tstate = TM.prefill(w["t"], tcfg, {"inputs": torch.from_numpy(toks),
                                           "lengths": torch.from_numpy(lengths)}, MAX_LEN, trt)
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    if tcfg.n_experts:
        for name in ("k_q", "v_q"):
            jk = np.asarray(jstate["groups"][0][0][name])
            assert np.mean(jk == np.stack([c[name].numpy() for c in tstate["layers"]])) > 0.999
        tstate = convert.from_numpy(_np(jstate), device="cpu")
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jstate = JM.decode_step(w["jq"], jcfg, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("mode", ["linear", "tree"])
def test_verify_step_logits_match(fam, mode):
    """A window of 5 tokens at ragged cursors under ``fused_int8`` (B3 / B4
    plain versions against the Pallas kernels): logits, cursors, and the
    int8 K/V rows but for rare codes on a rounding boundary."""
    _, jcfg, tcfg, w = fam
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    lengths = np.array([24, 11], np.int32)
    _, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                          "lengths": jnp.asarray(lengths)}, MAX_LEN,
                           JT.Runtime())
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    win = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        depth = np.array([[0, 1, 1, 2, 3], [0, 1, 2, 1, 2]], np.int32)
        anc = np.array([[1, 3, 5, 11, 27], [1, 3, 7, 9, 25]], np.int32)
        kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
        kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
    jl, jh, jst = JM.verify_step(w["jq"], jcfg, jstate, jnp.asarray(win),
                                 JT.Runtime(backend="fused_int8"), **kw_j)
    tl, th, tst = TM.verify_step(w["tq"], tcfg, tstate, torch.from_numpy(win),
                                 TT.Runtime("fused_int8"), **kw_t)
    _close(jl, tl)
    _close(jh, th)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    jk = np.asarray(jst["groups"][0][0]["k_q"])
    tk = np.stack([c["k_q"].numpy() for c in tst["layers"]])
    assert np.mean(jk == tk) > 0.999


# ---------------------------------------------------------------------------
# OPT's engines against JAX's
# ---------------------------------------------------------------------------
def _trace():
    """Six ragged requests through two slots (prompts 4-19 tokens)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, rng.integers(4, 20)).tolist() for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    return prompts, budgets


STATS = ("steps", "decode_steps", "verify_steps", "spec_drafted", "spec_accepted",
         "spec_accept_hist", "prefill_tokens", "chunks", "max_step_prefill_tokens",
         "max_step_total_tokens", "multi_blocks", "multi_tokens", "xfer_bytes",
         "decode_xfer_bytes")


@pytest.mark.parametrize("lane", [{}, {"spec_k": 4}, {"spec_tree": 6}, {"chunk": 4},
                                  {"multi_step": 4}],
                         ids=["fifo", "spec_k", "spec_tree", "chunk", "multi_step"])
def test_opt_continuous_batching_token_identical(lane):
    """Greedy FIFO under ``fused_int8`` (B1, B2-B4 and the norm's plain
    versions against the Pallas kernels in interpret mode): the port's
    stream equals JAX's, with equal stats, in every lane."""
    jcfg, tcfg = JR.get("opt-30b").reduced(), TR.get("opt-30b").reduced()
    opt_weights = _weights("opt-30b")
    prompts, budgets = _trace()
    jeng = JCB(jcfg, opt_weights["j"], n_slots=2, max_len=64,
               rt=JT.Runtime(backend="fused_int8"), **lane)
    want = jeng.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(tcfg, opt_weights["t"], n_slots=2, max_len=64,
                                    rt=TT.Runtime("fused_int8"), device="cpu", **lane)
    assert teng.generate_all(prompts, budgets) == want
    for key in STATS:
        assert teng.stats.get(key) == jeng.stats.get(key), key
    ran = {"spec_k": "verify_steps", "spec_tree": "verify_steps", "chunk": "chunks",
           "multi_step": "multi_blocks"}
    for name, key in ran.items():
        if name in lane:
            assert teng.stats[key] > 0, key


def test_opt_engine_generate_token_identical():
    jcfg, tcfg = JR.get("opt-30b").reduced(), TR.get("opt-30b").reduced()
    opt_weights = _weights("opt-30b")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    want, _ = JEngine(cfg=jcfg, params=opt_weights["j"], rt=JT.Runtime(backend="fused_int8"),
                      max_len=32).generate({"inputs": jnp.asarray(toks)}, 6)
    got, _ = Engine(cfg=tcfg, params=opt_weights["t"], rt=TT.Runtime("fused_int8"),
                    max_len=32, device="cpu").generate({"inputs": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# nemotron-4-340b at its own head dim (192): B2-B4's plain versions against
# the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
def _prefill_both(jcfg, tcfg, w, inputs, lengths, backend="fused_int8"):
    jl, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(inputs),
                                           "lengths": jnp.asarray(lengths)}, MAX_LEN,
                            JT.Runtime(backend=backend))
    tl, tstate = TM.prefill(w["t"], tcfg, {"inputs": torch.from_numpy(inputs),
                                           "lengths": torch.from_numpy(lengths)}, MAX_LEN,
                            TT.Runtime(backend))
    return jl, jstate, tl, tstate


@pytest.mark.parametrize("backend", ["fused_int8", "ref_int8"])
def test_nemotron_at_head_dim_192_logits_match(backend):
    """Reduced nemotron-4-340b with head_dim 192 (rep 2 at D 192): ragged
    prefill, then three greedy decode steps from JAX's prefilled cache.
    The two float prefills' K/V differ by ulps, which moves a scale's last
    bit and now and then an int8 code (one V code of 18,432 in layer 3 with
    this seed; a later logit then parts by 1.6e-3 of the scale), so the
    prefilled caches are held to 99.9% equal codes and decode starts from
    the same one."""
    jcfg, tcfg = _configs(HD192)
    assert tcfg.head_dim == 192 and tcfg.n_heads // tcfg.n_kv_heads == 2
    w = _weights(HD192)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jstate, tl, tstate = _prefill_both(jcfg, tcfg, w, toks, np.array([24, 13], np.int32),
                                           backend)
    _close(jl, tl)
    for name in ("k_q", "v_q"):
        jk = np.asarray(jstate["groups"][0][0][name])
        assert np.mean(jk == np.stack([c[name].numpy() for c in tstate["layers"]])) > 0.999
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jstate = JM.decode_step(w["jq"], jcfg, jstate, jnp.asarray(tok), jrt)
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(tok), trt)
        _close(jl, tl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("mode", ["linear", "tree"])
def test_nemotron_at_head_dim_192_verify_matches(mode):
    """A verify window of 5 tokens at ragged cursors under ``fused_int8``
    (B3 / B4 at D 192): logits, hidden states and cursors."""
    jcfg, tcfg = _configs(HD192)
    w = _weights(HD192)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    _, jstate = JM.prefill(w["j"], jcfg, {"inputs": jnp.asarray(toks),
                                          "lengths": jnp.asarray([24, 9])}, MAX_LEN,
                           JT.Runtime())
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    win = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if mode == "tree":
        depth = np.array([[0, 1, 1, 2, 2], [0, 1, 2, 3, 1]], np.int32)
        anc = np.array([[1, 3, 5, 11, 13], [1, 3, 7, 15, 17]], np.int32)
        kw_j = {"depth": jnp.asarray(depth), "anc": jnp.asarray(anc)}
        kw_t = {"depth": torch.from_numpy(depth), "anc": torch.from_numpy(anc)}
    jl, jh, jst = JM.verify_step(w["jq"], jcfg, jstate, jnp.asarray(win),
                                 JT.Runtime(backend="fused_int8"), **kw_j)
    tl, th, tst = TM.verify_step(w["tq"], tcfg, tstate, torch.from_numpy(win),
                                 TT.Runtime("fused_int8"), **kw_t)
    _close(jl, tl)
    _close(jh, th)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


# ---------------------------------------------------------------------------
# chameleon-34b: embedding inputs and QK-norm
# ---------------------------------------------------------------------------
def _embeddings(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def test_chameleon_prefill_from_embeddings_matches_reference():
    """Ragged prefill from [B, T, d] embeddings (two 64-row pieces) against
    JAX's: logits and cursors."""
    jcfg, tcfg = _configs("chameleon-34b")
    w = _weights("chameleon-34b")
    emb = _embeddings((2, 40, jcfg.d_model), 7)
    lengths = np.array([40, 23], np.int32)
    jl, jstate, tl, tstate = _prefill_both(jcfg, tcfg, w, emb, lengths)
    _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def test_chameleon_embedding_prefill_equals_id_prefill():
    """Prefill (one-shot, 70 rows: two pieces, ragged) and chunked prefill
    from the table rows of token ids give the bits that prefill from the ids
    gives: logits and every cache entry.  A carry that holds embeddings
    refuses an id chunk."""
    _, tcfg = _configs("chameleon-34b")
    w = _weights("chameleon-34b")["t"]
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 70)))
    emb = w["embed"]["w"][toks]
    assert emb.dtype == torch.float32
    lengths = torch.tensor([70, 45], dtype=torch.int32)
    rt = TT.Runtime("fused_int8")
    a, sa = TM.prefill(w, tcfg, {"inputs": toks, "lengths": lengths}, 96, rt)
    b, sb = TM.prefill(w, tcfg, {"inputs": emb, "lengths": lengths}, 96, rt)
    assert torch.equal(a, b)
    for x, y in zip(sa["layers"], sb["layers"]):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    one, _ = TM.prefill(w, tcfg, {"inputs": toks[:1]}, 96, rt)
    for ids_first in (False, True):  # the first chunk as ids: the carry takes their rows
        carry = TM.init_prefill_carry(tcfg, TT.carry_len(96), "cpu")
        for lo, n in ((0, 30), (30, 25), (55, 15)):
            src = toks if ids_first and lo == 0 else emb
            got, carry = TM.prefill_chunk(w, tcfg, carry, src[:1, lo:lo + n], n, rt)
        assert torch.equal(got, one), ids_first
    with pytest.raises(ValueError, match="embedding chunks only"):
        TM.prefill_chunk(w, tcfg, carry, toks[:1, :4], 4, rt)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chameleon_decode_from_embeddings_matches_reference(backend):
    """Decode steps fed [B, d] embeddings (QK-norm on every query and key)
    against JAX's, from JAX's prefilled cache: the two float prefills' K
    rows differ by ulps, which flips an int8 code now and then (two K codes
    of 20,480 with this seed, which move later logits by 1.5% of the scale
    through the random layers), so the prefilled caches are held to 99.9%
    equal codes and decode starts from the same one."""
    jcfg, tcfg = _configs("chameleon-34b")
    w = _weights("chameleon-34b")
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jstate, tl, tstate = _prefill_both(jcfg, tcfg, w, toks, np.array([20, 11], np.int32),
                                           backend)
    _close(jl, tl)
    for name in ("k_q", "v_q"):
        jk = np.asarray(jstate["groups"][0][0][name])
        assert np.mean(jk == np.stack([c[name].numpy() for c in tstate["layers"]])) > 0.999
    tstate = convert.from_numpy(_np(jstate), device="cpu")
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    for i in range(3):
        e = _embeddings((2, jcfg.d_model), 10 + i)
        jl, jstate = JM.decode_step(w["jq"], jcfg, jstate, jnp.asarray(e), jrt)
        tl, tstate = TM.decode_step(w["tq"], tcfg, tstate, torch.from_numpy(e), trt)
        _close(jl, tl)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def test_chameleon_engine_generate_from_embeddings_token_identical():
    """``Engine.generate`` prefills from an embedding prompt, then decodes
    token ids, token for token as JAX's does."""
    jcfg, tcfg = _configs("chameleon-34b")
    w = _weights("chameleon-34b")
    emb = _embeddings((2, 13, jcfg.d_model), 11)
    want, _ = JEngine(cfg=jcfg, params=w["j"], rt=JT.Runtime(backend="fused_int8"),
                      max_len=32).generate({"inputs": jnp.asarray(emb)}, 6)
    got, _ = Engine(cfg=tcfg, params=w["t"], rt=TT.Runtime("fused_int8"),
                    max_len=32, device="cpu").generate({"inputs": emb}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lane", [{}, {"spec_k": 4}], ids=["fifo", "spec_k"])
def test_chameleon_continuous_batching_token_identical(lane):
    """The continuous engine serves chameleon's token prompts under
    ``fused_int8`` token for token as JAX's, with equal stats."""
    jcfg, tcfg = _configs("chameleon-34b")
    w = _weights("chameleon-34b")
    prompts, budgets = _trace()
    jeng = JCB(jcfg, w["j"], n_slots=2, max_len=64, rt=JT.Runtime(backend="fused_int8"),
               **lane)
    want = jeng.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(tcfg, w["t"], n_slots=2, max_len=64,
                                    rt=TT.Runtime("fused_int8"), device="cpu", **lane)
    assert teng.generate_all(prompts, budgets) == want
    for key in STATS:
        assert teng.stats.get(key) == jeng.stats.get(key), key
    if lane:
        assert teng.stats["verify_steps"] > 0
