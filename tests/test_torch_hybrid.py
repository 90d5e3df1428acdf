"""The port's hybrid stack (jamba-1.5-large-398b reduced) against the JAX
reference.

The reduced config has 8 layers: attention at layers 1 and 5, Mamba2 SSD
layers elsewhere, a MoE FFN (4 experts, top-2) on the odd layers and a
dense SwiGLU on the even ones.  Weights are converted from the JAX init
(``convert``), and a port tree converts back into the reference's one group
of ``attn_every``-layer periods.  Prefill (the port runs B6's path under
``fused_int8``, the reference its tensor path) and 8 decode steps are held
under the four backends: logits within 1e-3 of the logit scale with the
argmax equal, the int8 K/V codes 99.9% equal and their scales within rtol
1e-5 (the two packages' float K/V differ by ulps; decode starts from JAX's
prefilled state), the SSM states within 1e-5 of their scale.  On the float
K/V that JAX's own prefill quantizes, the port's quantizer gives every code
and scale of the reference's quantizer, bit for bit.  Both engines serve
the same tokens with equal stats; the lanes an SSM layer's state cannot take are silently off, as in
the reference; swap-preempt and a step failure (an in-place rebuild of the
mixed pool) keep the streams.  The Pallas paths run as the reference's own
tests run them on the CPU (interpret mode); ``max_len`` stays at most 512.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve import faults as JF
from repro.serve.engine import Engine as JEngine
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as launch
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serve import faults as TF
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.engine import Engine
from repro_torch.serve.quantize import quantize_tree as t_quantize_tree
from torch_parity import JaxRuns, check_kv_quantizations, reference_kv_quantizations
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "jamba-1.5-large-398b"
BACKENDS = ["dense", "ref_int8", "fused_int8", "pim_bitserial"]
JCFG = JR.get(ARCH).reduced()
TCFG = TR.get(ARCH).reduced()
MAX_LEN = 48
DECODE_STEPS = 8
CLOCKS = ("device_s", "step_s", "slow_steps")
XFER = ("xfer_bytes", "decode_xfer_bytes")
BASE = {"n_slots": 3, "max_len": MAX_LEN}


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
# configuration and layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = JR.get(ARCH), TR.get(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    TT.check_supported(t)
    kinds = [(t.layer_kind(i), t.is_moe_layer(i)) for i in range(t.n_layers)]
    assert kinds == [(j.layer_kind(i), j.is_moe_layer(i)) for i in range(j.n_layers)]
    assert convert.layer_groups(t) == JT.layer_groups(j)
    assert TT.has_ssm(t) and TT.has_moe(t)


def test_full_config_period_holds_every_layer_kind():
    """One period of 8 layers (the depth the card serves) holds SSM layers
    at 0-3 and 5-7, attention at 4, MoE at the odd layers, dense SwiGLU at
    the even ones; the reference's groups need whole periods."""
    cfg = dataclasses.replace(TR.get(ARCH), n_layers=8)
    assert [cfg.layer_kind(i) for i in range(8)] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [cfg.is_moe_layer(i) for i in range(8)] == [False, True] * 4
    assert convert.layer_groups(cfg) == [(0, 8, 8)]
    with pytest.raises(ValueError, match="periods"):
        convert.layer_groups(dataclasses.replace(cfg, n_layers=12))


@pytest.mark.parametrize("tree", ["j", "jq"])
def test_convert_round_trip_and_quantize(weights, tree):
    """The reference's tree (one group of 8 slot trees) converts to the
    port's per-layer list and back with ``to_numpy(params, cfg)``, float and
    quantized, leaf for leaf; ``quantize_tree`` of the port's tree equals
    the reference's bit for bit."""
    ref = _np(weights[tree])
    back = convert.to_numpy(convert.from_numpy(ref, device="cpu"), TCFG)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    if tree == "jq":
        got = _flat(convert.to_numpy(t_quantize_tree(weights["t"]), TCFG))
        for k, v in _flat(ref).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_tree_runs_through_the_reference(weights):
    """A tree the port draws (``init_params``) converts into the
    reference's layout and runs through JAX's prefill to the port's
    logits."""
    params = TM.init_params(TCFG, seed=3, device="cpu")
    ref = jax.tree.map(jnp.asarray, convert.to_numpy(params, TCFG))
    toks = np.random.default_rng(5).integers(0, JCFG.vocab_size, (1, 11)).astype(np.int32)
    jl, _ = JM.prefill(ref, JCFG, {"inputs": jnp.asarray(toks)}, 16, JT.Runtime())
    tl, _ = TM.prefill(params, TCFG, {"inputs": torch.from_numpy(toks)}, 16, TT.Runtime())
    _close(jl, tl)


def test_decode_state_dispatches_per_layer(weights):
    """``init_decode_state`` holds an SSM layer's fixed state and an
    attention layer's int8 K/V in the reference's shapes;
    ``write_slot`` / ``read_slot`` move both kinds as the reference's do
    (SSM leaves whole, attention rows at their offsets)."""
    rng = np.random.default_rng(7)

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
    assert [TT.is_seq_cache(c) for c in empty["layers"]] == [
        TCFG.layer_kind(i) == "attn" for i in range(TCFG.n_layers)]
    for slot in (1, 7):
        jstate = JT.write_slot(jstate, jnp.int32(slot), one)
        tstate = TT.write_slot(tstate, slot, convert.from_numpy(_np(one), device="cpu"))
        want = _flat(convert.from_numpy(_np(jstate), device="cpu"))
        for k, v in _flat(tstate).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    back = _flat(convert.from_numpy(_np(JT.read_slot(jstate, jnp.int32(2))), device="cpu"))
    for k, v in _flat(TT.read_slot(tstate, 2)).items():
        np.testing.assert_array_equal(v, back[k], err_msg=k)


def test_chunked_prefill_and_verify_raise(weights):
    """As in the reference, a hybrid stack has no chunked-prefill carry, no
    prefix-cache warm start and no speculative verify."""
    with pytest.raises(NotImplementedError, match="exact length"):
        TM.init_prefill_carry(TCFG, 64, device="cpu")
    state = TM.init_decode_state(TCFG, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="SSM state"):
        TM.warm_prefill_carry(TCFG, state, 0, 4, 64)
    with pytest.raises(NotImplementedError, match="rewindable"):
        TM.verify_step(weights["tq"], TCFG, state, torch.zeros((1, 2), dtype=torch.int32),
                       TT.Runtime())


# ---------------------------------------------------------------------------
# prefill and decode under the four backends
# ---------------------------------------------------------------------------
_RUNS: dict = {}


def _runs(weights, backend: str) -> dict:
    """Both packages' prefill of two 20-token prompts and ``DECODE_STEPS``
    greedy decode steps under ``backend`` (W8A8 weights in decode), the
    port's from JAX's prefilled state (the float prefills' K/V and SSM
    states differ by ulps), computed once a backend."""
    if backend in _RUNS:
        return _RUNS[backend]
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 20)).astype(np.int32)
    jrt, trt = JT.Runtime(backend=backend), TT.Runtime(backend)
    jl, js = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks)}, MAX_LEN, jrt)
    tl, ts = TM.prefill(weights["t"], TCFG, {"inputs": torch.from_numpy(toks)}, MAX_LEN, trt)
    out = {"prefill": (np.asarray(jl), tl.clone(), _np(js),
                       {k: v.copy() for k, v in _flat(ts).items()}), "decode": []}
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 4))
    ts = convert.from_numpy(_np(js), device="cpu")
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(DECODE_STEPS):
        jl, js = jdec(weights["jq"], JCFG, js, jnp.asarray(tok), jrt)
        tl, ts = TM.decode_step(weights["tq"], TCFG, ts, torch.from_numpy(tok), trt)
        out["decode"].append((np.asarray(jl), tl.clone()))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    out["final"] = (_np(js), {k: v.copy() for k, v in _flat(ts).items()})
    _RUNS[backend] = out
    return out


def _same_state(jstate, tflat):
    """The attention layers' int8 codes 99.9% equal (a K/V float that
    differs by an ulp can sit on a rounding boundary) and their scales
    within rtol 1e-5, the SSM states within 1e-5 of their scale, the
    cursors equal."""
    want = _flat(convert.from_numpy(jstate, device="cpu"))
    assert set(want) == set(tflat)
    for k, v in tflat.items():
        w = want[k]
        if k.endswith(("k_q", "v_q")):
            assert np.mean(v == w) > 0.999, k
        elif k.endswith(("k_s", "v_s")):
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=0, err_msg=k)
        elif k.endswith("pos"):
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            np.testing.assert_allclose(v, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()),
                                       err_msg=k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_matches_reference(weights, backend):
    jl, tl, js, ts = _runs(weights, backend)["prefill"]
    _close(jl, tl)
    _same_state(js, ts)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_steps_match_reference(weights, backend):
    run = _runs(weights, backend)
    for jl, tl in run["decode"]:
        _close(jl, tl)
    _same_state(*run["final"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_kv_quantizer_bit_equal_on_reference_floats(weights, backend):
    """The port's ``quantize_kv`` on each float K/V that JAX's exact-length
    prefill writes into an attention layer's int8 cache: every code and
    scale equal to the reference's ``quantize_kv`` on them, bit for bit
    (:func:`torch_parity.check_kv_quantizations`)."""
    toks = np.random.default_rng(3).integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    with reference_kv_quantizations() as seen:
        JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks)}, MAX_LEN,
                   JT.Runtime(backend=backend))
    n_attn = sum(JCFG.layer_kind(i) == "attn" for i in range(JCFG.n_layers))
    assert len(seen) == 2 * n_attn
    for x, _, _ in seen:
        assert x.shape == (2, 16, JCFG.n_kv_heads, JCFG.head_dim)
    check_kv_quantizations(seen)


def test_ragged_prefill_matches_reference(weights):
    """``lengths`` on a hybrid stack: attention masks each row's keys to its
    length and the logits come from each row's last real token, while the
    SSM layers scan the padding, as the reference's (which says so: the
    engine prefills SSM stacks at exact length)."""
    toks = np.random.default_rng(4).integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    jl, js = JM.prefill(weights["j"], JCFG, {"inputs": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lengths)}, 32, JT.Runtime())
    tl, ts = TM.prefill(weights["t"], TCFG, {"inputs": torch.from_numpy(toks),
                                             "lengths": torch.from_numpy(lengths)}, 32,
                        TT.Runtime())
    _close(jl, tl)
    _same_state(_np(js), _flat(ts))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _trace(n=6, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 20))).tolist() for _ in range(n)]
    budgets = [int(rng.integers(3, 9)) for _ in range(n)]
    return prompts, budgets


def _drain(prompts, budgets):
    def drive(eng):
        reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.drain()
        return reqs
    return drive


def _outputs(reqs):
    return [list(r.output) for r in reqs]


_JAX: list = []


def _jax_runs(weights) -> JaxRuns:
    if not _JAX:
        _JAX.append(JaxRuns(JCFG, weights["j"], BASE))
    return _JAX[0]


def _port(weights, **kw) -> TCB:
    return TCB(TCFG, weights["t"], rt=TT.Runtime("fused_int8"), device="cpu", **{**BASE, **kw})


def _same_stats(te, je):
    """Equal stats, clocks aside; ``xfer_bytes`` the reference's less the
    dead attention rows of each block copy (the port copies a cold block's
    live rows, SSM state whole)."""
    assert set(te.stats) == set(je.stats)
    for k in sorted(set(te.stats) - set(CLOCKS) - set(XFER)):
        assert te.stats[k] == je.stats[k], k
    dead = 0
    if te._swap is not None:
        rows = next(c["k_q"].shape[1] for c in te.state["layers"] if TT.is_seq_cache(c))
        whole = te._swap.block_bytes(rows) + 4
        dead = ((te.stats["swap_outs"] + te.stats["swap_ins"]) * whole
                - te.stats["swap_out_bytes"] - te.stats["swap_in_bytes"])
    assert te.stats["xfer_bytes"] == je.stats["xfer_bytes"] - dead
    assert te.stats["decode_xfer_bytes"] == je.stats["decode_xfer_bytes"]


def test_continuous_batching_token_identical(weights):
    """FIFO under ``fused_int8``: each admission prefilled alone at exact
    length, the pool mixing SSM state and int8 K/V rows; the streams equal
    JAX's with equal stats, and capacity dropped choices on the way
    (``count_routing``; 3 slots, cap ceil(6 / 4 * 2) = 3 a decode step, a
    prompt's rows routed together in prefill)."""
    prompts, budgets = _trace()
    jreqs, je = _jax_runs(weights).run("fifo", _drain(prompts, budgets))
    te = _port(weights)
    routing = torch.zeros((3,), dtype=torch.int64)
    TMOE.count_routing(routing)
    try:
        treqs = _drain(prompts, budgets)(te)
    finally:
        TMOE.count_routing(None)
    assert _outputs(treqs) == _outputs(jreqs)
    _same_stats(te, je)
    assert int(routing[0]) > 0 and te.prefill_pieces == len(prompts)


@pytest.mark.parametrize("lane", [{"chunk": 4}, {"spec_k": 3}, {"multi_step": 4},
                                  {"prefix_cache": True, "chunk": 4}],
                         ids=["chunk", "spec_k", "multi_step", "prefix_cache"])
def test_lanes_are_silently_off(weights, lane):
    """Each lane an SSM layer's state cannot take is requested and silently
    off in both packages (exact-length prefill, the one-token decode loop,
    no prefix cache): the streams and stats equal JAX's engine given the
    same arguments, and the plain lane's."""
    prompts, budgets = _trace()
    key = "lane_" + "_".join(sorted(lane))
    jreqs, je = _jax_runs(weights).run(key, _drain(prompts, budgets), **lane)
    te = _port(weights, **lane)
    assert (te.chunk, te.spec_k, te.spec_tree, te.multi_step, te._pcache) == (
        je.chunk, je.spec_k, je.spec_tree, je.multi_step, je._pcache) == (None, 0, 0, 1, None)
    treqs = _drain(prompts, budgets)(te)
    assert _outputs(treqs) == _outputs(jreqs)
    _same_stats(te, je)
    plain, _ = _jax_runs(weights).run("fifo", _drain(prompts, budgets))
    assert _outputs(treqs) == _outputs(plain)
    assert te.stats["verify_steps"] == te.stats["chunks"] == te.stats["multi_blocks"] == 0


def test_kv_swap_preempt_token_identical(weights):
    """``priority:preempt`` with the tiered pool: requests 3-5 arrive at a
    higher priority after three steps, so decoding victims swap out (their
    SSM state whole beside their live K/V rows, ``fixed_bytes``) and come
    back without a prefill; streams and stats equal JAX's."""
    prompts, budgets = _trace()

    def drive(eng):
        reqs = [eng.submit(p, b, priority=0) for p, b in zip(prompts[:3], budgets[:3])]
        for _ in range(3):
            eng.step()
        reqs += [eng.submit(p, b, priority=9) for p, b in zip(prompts[3:], budgets[3:])]
        eng.drain()
        return reqs
    kw = {"kv_swap": True, "policy": "priority:preempt"}
    jreqs, je = _jax_runs(weights).run("kv_swap", drive, **kw)
    te = _port(weights, **kw)
    treqs = drive(te)
    assert _outputs(treqs) == _outputs(jreqs)
    _same_stats(te, je)
    assert te.stats["swap_outs"] > 0 and te.stats["preemptions"] > 0
    assert te._swap.fixed_bytes == je._swap.fixed_bytes > 0


def test_step_failure_rebuilds_the_mixed_pool(weights):
    """Injected step failures: each retry rebuilds the pool (SSM state and
    K/V rows) in place and replays the residents; streams equal JAX's
    faulted run and the port's fault-free run, stats equal."""
    prompts, budgets = _trace()
    drive = _drain(prompts, budgets)
    jreqs, je = _jax_runs(weights).run(
        "step_failure", drive, faults=JF.FaultInjector(seed=0, step_fail_at=(5, 11)))
    te = _port(weights, faults=TF.FaultInjector(seed=0, step_fail_at=(5, 11)))
    treqs = drive(te)
    plain, _ = _jax_runs(weights).run("fifo", _drain(prompts, budgets))
    assert _outputs(treqs) == _outputs(jreqs) == _outputs(plain)
    assert all(r.error is None for r in treqs)
    _same_stats(te, je)
    assert te.stats["pool_rebuilds"] > 0


def test_engine_generate_token_identical(weights):
    """``Engine.generate``: two prompts of 13 tokens prefilled as one call,
    then 6 decode steps."""
    toks = np.random.default_rng(3).integers(0, JCFG.vocab_size, (2, 13)).astype(np.int32)
    want, _ = JEngine(cfg=JCFG, params=weights["j"], rt=JT.Runtime(backend="fused_int8"),
                      max_len=32).generate({"inputs": jnp.asarray(toks)}, 6)
    got, _ = Engine(cfg=TCFG, params=weights["t"], rt=TT.Runtime("fused_int8"), max_len=32,
                    device="cpu").generate({"inputs": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_takes_jamba(capsys):
    """``--arch jamba-1.5-large-398b`` serves, reduced on the CPU, in the
    fixed-batch and the continuous mode."""
    launch.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
                 "--steps", "3", "--device", "cpu"])
    launch.main(["--arch", ARCH, "--reduced", "--continuous", "--requests", "3",
                 "--slots", "2", "--steps", "3", "--device", "cpu"])
    assert ARCH in capsys.readouterr().out
