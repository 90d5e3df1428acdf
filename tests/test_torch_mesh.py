"""The mesh layer of the port (ROADMAP A.14a) against the reference, on the
CPU: gloo worlds of spawned processes (``repro_torch.launch.mesh``), one
torch thread a rank, each world started once for the module.

* the spec builders of ``dist/sharding.py`` equal the reference's
  ``PartitionSpec`` entries for every registry configuration at
  ``.reduced()`` on 1x2, 2x2, 2x4 and 8x1 meshes (``AbstractMesh``: no
  devices), and the port's per-layer tree gets each stacked leaf's spec;
* ``htree_allreduce`` over groups of 2-6 ranks equals ``all_reduce`` and the
  reference's H-tree (one subprocess with six forced host devices), in
  ``2 * tree_depth(n)`` rounds, integer sums bit-equal;
* the tensor-parallel linears and a llama decode step under ``ref_int8``
  are bit-equal to one device on 1x2 and 2x2 (logits and pool) under
  ``psum`` and ``htree``; under ``dense`` within 1e-5 of the logits'
  scale;
* ``_moe_block`` in all five layouts within rtol 2e-3 / atol 2e-4 of JAX's
  single-device ``moe_apply``;
* both engines on a 2x2 mesh token-identical to JAX's single-device engine
  and to the port's one-device engine on the reference's sharded-serve
  trace, every rank's streams equal, and the serve CLI's ``--mesh 2x2``;
* the families and lanes that raised here until A.14b's serving half:
  each family's tree drawn a piece at a time on 1x2 equals its whole tree
  placed, and llama with the prefix cache, the cold tier or the fault
  layer on 2x2 serves the trace as one device does (their parity with the
  reference: ``tests/test_torch_mesh_lanes.py`` and
  ``tests/test_torch_mesh_families.py``);
* the refusals left (an unknown collective, a mesh with no process
  group); training on a mesh is ``tests/test_torch_mesh_train*.py``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.shapes import SHAPES as JSHAPES
from repro.dist import sharding as JSH
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.quantize import quantize_tree as j_quantize_tree
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.htree import tree_depth
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MS
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ContinuousBatchingEngine
import torch_mesh_ranks as R
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 2), (2, 2), (2, 4), (8, 1)]
HTREE_SIZES = (2, 3, 4, 5, 6)
HTREE_SHAPES = {2: (7,), 3: (5, 3), 4: (1,), 5: (2, 3, 5), 6: (7,)}


def _htree_inputs() -> dict:
    return {n: (np.random.default_rng(n).standard_normal((n, *HTREE_SHAPES[n])) * 100.0
                ).astype(np.float32) for n in HTREE_SIZES}


_JAX_HTREE = """
import sys, pickle, numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.collectives import htree_allreduce
from repro.dist.compat import shard_map
xs = pickle.load(open(sys.argv[1], "rb"))
out = {}
for n, x in xs.items():
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("model",))
    spec = P("model", *([None] * (x.ndim - 1)))
    out[n] = np.asarray(shard_map(lambda v: htree_allreduce(v, "model"), mesh, spec, spec)(x))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The module's worlds, started together: 1x2 and 2x2 (the linears, the
    decode step, the MoE layouts; the engines on 2x2), six ranks for the
    H-tree, and the reference's H-tree in a subprocess."""
    xs = _htree_inputs()
    tmp = tmp_path_factory.mktemp("htree")
    import pickle
    with open(tmp / "xs.pkl", "wb") as f:
        pickle.dump(xs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=6",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_HTREE),
                                 str(tmp / "xs.pkl"), str(tmp / "jax.pkl")], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    started = {"2x2": MS.start(R.world, 4, (2, 2), True),
               "1x2": MS.start(R.world, 2, (1, 2), False),
               "htree": MS.start(R.htree_world, 6, xs)}
    out = {k: w.join() for k, w in started.items()}
    _, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err.decode()[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        out["jax_htree"] = pickle.load(f)
    out["xs"] = xs
    return out


# ---------------------------------------------------------------------------
# (a) spec builders
# ---------------------------------------------------------------------------
def _specs(tree):
    """A reference tree of NamedShardings -> the same tree of spec tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda s: hasattr(s, "spec"))


def _as_port(tree):
    """A reference spec tree with tuples for its sequence nodes (the port
    walks lists and tuples alike) and tuple leaves."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and not all(
            e is None or isinstance(e, (str, tuple)) for e in tree)):
        return type(tree)(_as_port(v) for v in tree)
    return tree


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_spec_builders_equal_the_reference(arch):
    """Every builder on the reference's own abstract trees, and the port's
    per-layer tree: each layer's leaf gets its stacked leaf's spec, less
    the stacking dim."""
    jcfg, tcfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    trees = {"float": jp}
    if jcfg.family != "encdec":
        trees["quantized"] = jax.eval_shape(lambda: j_quantize_tree(
            JM.init_params(jax.random.key(0), jcfg)))
    tp = T.init_params(tcfg, 0, "meta") if tcfg.family != "encdec" else None
    for shape in MESHES:
        jm, tm = AbstractMesh(shape, ("data", "model")), MS.AbstractMesh(shape,
                                                                        ("data", "model"))
        assert SH.data_axes(tm) == JSH.data_axes(jm)
        for ax in ("data", "model", ("data", "model")):
            assert SH.axes_size(tm, ax) == JSH.axes_size(jm, ax)
            for dim in (1, 2, 3, 4, 6, 8, 64, 96):
                assert SH._fit(tm, dim, ax) == JSH._fit(jm, dim, ax)
        for serve in (False, True):
            for name, tree in trees.items():
                want = _specs(JSH.param_shardings(jcfg, tree, jm, serve=serve))
                got = SH.param_shardings(tcfg, tree, tm, serve=serve)
                assert jax.tree.leaves(got, is_leaf=lambda s: isinstance(s, tuple)) == \
                    jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple)), \
                    (arch, shape, serve, name)
            if tp is not None:
                _hold_port_tree(jcfg, tcfg, jp, tp, jm, tm, serve)
        if jcfg.n_experts:
            assert SH.moe_serve_strategy(tcfg, tm) == JSH.moe_serve_strategy(jcfg, jm)
            for serve in (False, True):
                w, g = JSH.moe_param_specs(jcfg, jm, serve), SH.moe_param_specs(tcfg, tm, serve)
                assert (g["strategy"], g["ep_axes"], g["gather"]) == (
                    w["strategy"], tuple(w["ep_axes"]), w["gather"])
                assert g["spec"] == {k: tuple(v) for k, v in w["spec"].items()}
                assert g["shared"] == {k: tuple(v) for k, v in w["shared"].items()}
        _hold_state_and_io(jcfg, tcfg, jm, tm)


def _hold_port_tree(jcfg, tcfg, jp, tp, jm, tm, serve):
    want = _specs(JSH.param_shardings(jcfg, jp, jm, serve=serve))
    got = SH.param_shardings(tcfg, tp, tm, serve=serve)
    for key in ("embed", "ln_f", "lm_head"):
        if key in got:
            assert got[key] == {k: tuple(v) for k, v in want[key].items()}
    for i, ls in enumerate(got["layers"]):
        g = next(g for g, (s, c, _) in enumerate(JT.layer_groups(jcfg)) if s <= i < s + c)
        start, _, period = JT.layer_groups(jcfg)[g]
        stacked = want["groups"][g][(i - start) % period]
        flat_w = jax.tree_util.tree_flatten_with_path(
            stacked, is_leaf=lambda s: isinstance(s, tuple))[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(
            ls, is_leaf=lambda s: isinstance(s, tuple))[0])
        leaf = jax.tree_util.tree_flatten_with_path(
            tp["layers"][i], is_leaf=lambda s: isinstance(s, torch.Tensor))[0]
        nd = {p: t.dim() for p, t in leaf}
        assert set(flat_g) == {p for p, _ in flat_w}
        for path, spec in flat_w:
            assert _pad(spec, nd[path] + 1)[1:] == _pad(flat_g[path], nd[path]), (i, path)


def _hold_state_and_io(jcfg, tcfg, jm, tm):
    for n in (1, 4, 6, 8):
        for fn in ("serve_step_shardings", "verify_shardings", "tree_verify_shardings"):
            assert getattr(SH, fn)(n, tm) == _specs(getattr(JSH, fn)(n, jm)), fn
        assert SH.batch_entry(n, tm) == JSH.batch_entry(n, jm)
    for fn in ("prefix_gather_shardings", "swap_row_shardings"):
        assert getattr(SH, fn)(tm) == _specs(getattr(JSH, fn)(jm))
    for sname, jshape in JSHAPES.items():
        specs = jax.eval_shape(lambda: JM.input_specs(jcfg, jshape)) if hasattr(
            JM, "input_specs") else None
        if specs:
            assert SH.input_shardings(tcfg, SHAPES[sname], specs, tm) == _specs(
                JSH.input_shardings(jcfg, jshape, specs, jm))
    if jcfg.family == "encdec":
        return
    shape = JSHAPES["decode_32k"].__class__("pool", 24, 4, "decode")
    st = jax.eval_shape(lambda: JM.init_decode_state(jcfg, 4, 24))
    assert SH.decode_state_shardings(tcfg, shape, st, tm) == _as_port(_specs(
        JSH.decode_state_shardings(jcfg, shape, st, jm)))
    if hasattr(JT, "init_prefill_carry") and jcfg.family != "ssm" and not any(
            jcfg.layer_kind(i) == "ssm" for i in range(jcfg.n_layers)):
        carry = jax.eval_shape(lambda: JT.init_prefill_carry(jcfg, 32))
        assert SH.prefill_carry_shardings(tcfg, carry, tm) == _as_port(_specs(
            JSH.prefill_carry_shardings(jcfg, carry, jm)))


# ---------------------------------------------------------------------------
# (b) the H-tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", HTREE_SIZES)
def test_htree_allreduce_equals_psum_and_the_reference(worlds, n):
    want = worlds["xs"][n].sum(0)
    jref = worlds["jax_htree"][n]
    for r, res in enumerate(worlds["htree"][:n]):
        tree, ring, rounds, ints_equal = res[n]
        np.testing.assert_allclose(tree, ring, rtol=1e-5)
        np.testing.assert_allclose(tree, want, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(tree, jref[r])       # the same pairs and order
        assert rounds == 2 * tree_depth(n)
        assert ints_equal


# ---------------------------------------------------------------------------
# (c) tensor-parallel linears and the decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("backend", R.BACKENDS)
def test_tensor_parallel_linears(worlds, shape, backend):
    """Column-parallel: the rank's columns of the whole product; row-parallel:
    the whole product, bit for bit under the integer backends (the
    quantizer's amax all-reduced with MAX, the int32 accumulator summed,
    the epilogue after it), within 1e-5 of its scale under ``dense``."""
    for res in worlds[shape]:
        for coll in R.COLLECTIVES:
            whole, col, want_col, row = res["linears"][(backend, coll)]
            np.testing.assert_array_equal(col, want_col)
            if backend == "dense":
                np.testing.assert_allclose(row, whole, rtol=0,
                                           atol=1e-5 * np.abs(whole).max())
            else:
                np.testing.assert_array_equal(row, whole)


def test_sharded_init_equals_placing_the_whole_tree(worlds):
    """A rank drawing its blocks a piece at a time gets the blocks and specs
    of the whole seeded tree, quantized whole, then cut."""
    for res in worlds["1x2"]:
        assert {a: res["sharded_init"][a] for a in R.ENGINE_ARCHS} == {
            a: True for a in R.ENGINE_ARCHS}


def test_llama_decode_on_1x4_where_the_kv_heads_do_not_tile(worlds):
    """2 KV heads on a 4-rank model axis: every rank runs every head (its
    attention weights and pool whole), the FFN and vocabulary split; the
    step bit-equal to one device under ``ref_int8``."""
    for res in worlds["2x2"]:
        for coll in R.COLLECTIVES:
            want, got, pools_equal = res["decode_1x4"][("ref_int8", coll)]
            np.testing.assert_array_equal(got, want)
            assert pools_equal


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("coll", R.COLLECTIVES)
def test_llama_decode_step_bit_equal_to_one_device(worlds, shape, coll):
    """A llama ``.reduced()`` decode step from the same state: under
    ``ref_int8`` every rank's logits and its block of the pool equal one
    device's bit for bit; under ``dense`` the logits are within 1e-5 of
    their scale (float partial sums) and the pool is the same."""
    for res in worlds[shape]:
        want, got, pools_equal = res["decode"][("ref_int8", coll)]
        np.testing.assert_array_equal(got, want)
        assert pools_equal
        want, got, _ = res["decode"][("dense", coll)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert res["stats"]["calls"] > 0 and res["stats"]["bytes"] > 0


@pytest.mark.parametrize("arch", R.FAMILY_ARCHS)
def test_other_gqa_families_decode_bit_equal_on_1x2(worlds, arch):
    """OPT (tied embeddings: the vocabulary-parallel table is the head too;
    LayerNorm, sinusoids, MHA) and chameleon (QK-norm on each rank's heads)
    under ``ref_int8``: logits and pool bit-equal to one device."""
    for res in worlds["1x2"]:
        for coll in R.COLLECTIVES:
            want, got, pools_equal = res["families"][arch][("ref_int8", coll)]
            np.testing.assert_array_equal(got, want)
            assert pools_equal


# ---------------------------------------------------------------------------
# (d) the MoE block's layouts
# ---------------------------------------------------------------------------
_MOE_REF: dict = {}


def _moe_reference(E: int, T_: int) -> np.ndarray:
    if (E, T_) not in _MOE_REF:
        cfg, p, x = R.moe_inputs(E, T_)
        jcfg = dataclasses.replace(JARCHS["grok-1-314b"].reduced(), n_experts=E)
        jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        out, _ = JMOE.moe_apply(jp, jnp.asarray(x.numpy()), jcfg, axis_name=None)
        _MOE_REF[(E, T_)] = np.asarray(out)
    return _MOE_REF[(E, T_)]


@pytest.mark.parametrize("strategy,shape,case", [
    ("ep2", "1x2", (4, 1, True)), ("ep", "1x2", (4, 4, False)),
    ("etp", "1x2", (3, 4, False)), ("ep2", "2x2", (4, 1, True)),
    ("ep_data", "2x2", (2, 1, True)), ("etp2", "2x2", (3, 1, True))])
def test_moe_block_layouts_match_single_device(worlds, strategy, shape, case):
    """Each layout (grok's reduced MoE, its expert count changed where a
    layout needs it: ``ep_data`` at 2 experts and ``etp2`` / ``etp`` at 3)
    under ``psum`` and ``htree``, the whole call and a call whose rows are
    the ranks' slots over the data axis, within the reference's rtol 2e-3 /
    atol 2e-4 of JAX's single-device ``moe_apply``."""
    E, T_, _ = case
    ref = _moe_reference(E, T_)
    for res in worlds[shape]:
        for coll in R.COLLECTIVES:
            strat, got, part, (lo, hi) = res["moe"][(*case, coll)]
            assert strat == strategy
            np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(part, ref[lo:hi], rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# (e) the engines
# ---------------------------------------------------------------------------
_ENGINE_REF: dict = {}


def _engine_references(arch: str) -> dict:
    """JAX's single-device engine and the port's one-device engine on the
    trace, each lane, the port's weights converted for JAX."""
    if arch not in _ENGINE_REF:
        cfg, jcfg = ARCHS[arch].reduced(), JARCHS[arch].reduced()
        quantize = R.ENGINE_ARCHS[arch]
        params = T.init_params(cfg, 0, "cpu")
        jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
        prompts, budgets = R.trace(cfg)
        out = {}
        for lane, kw in R.LANES.items():
            j = JCB(jcfg, jparams, n_slots=4, max_len=48, quantize=quantize,
                    **kw).generate_all(prompts, budgets)
            t = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=48, quantize=quantize,
                                         device="cpu", **kw).generate_all(prompts, budgets)
            out[lane] = (j, t)
        _ENGINE_REF[arch] = out
    return _ENGINE_REF[arch]


@pytest.mark.parametrize("lane", list(R.LANES))
@pytest.mark.parametrize("arch", list(R.ENGINE_ARCHS))
def test_engines_token_identical_on_a_2x2_mesh(worlds, arch, lane):
    """llama3-8b (quantized) and grok-1-314b (float, resident ``ep2``)
    ``.reduced()`` on a 2x2 mesh (slots over data, heads / FFN / experts
    over model): every rank's streams equal, and equal JAX's single-device
    engine's and the port's one-device engine's."""
    j, t = _engine_references(arch)[lane]
    assert t == j
    for res in worlds["2x2"]:
        assert res["engines"][(arch, lane)] == j


def test_serve_cli_mesh_2x2_tokens_equal_one_device(capfd):
    argv = ["--arch", "llama3-8b", "--reduced", "--continuous", "--requests", "6",
            "--slots", "4", "--steps", "8", "--device", "cpu"]
    launch.main(argv)
    plain = capfd.readouterr().out
    launch.main(argv + ["--mesh", "2x2"])
    meshed = capfd.readouterr().out

    def pick(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("sample tokens", "generated", "steps="))]
    got, want = pick(meshed), pick(plain)
    assert [ln.split(" in ")[0] for ln in got] == [ln.split(" in ")[0] for ln in want]
    assert len(want) == 3


# ---------------------------------------------------------------------------
# (f) what raised here until A.14b's serving half, and the refusals left
# ---------------------------------------------------------------------------
MESH_RT = T.Runtime(mesh=MS.AbstractMesh((1, 2), ("data", "model")))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b",
                                  "deepseek-v3-671b", "whisper-tiny"])
def test_other_families_on_a_mesh_raise(worlds, arch):
    """These families raised on a mesh until A.14b's serving half; now they
    are accepted, and a rank drawing its blocks a piece at a time
    (deepseek's MTP head last; whisper drawn whole, then cut) gets the
    blocks and specs of the whole seeded tree placed on 1x2."""
    cfg = ARCHS[arch].reduced()
    T.check_mesh_family(cfg)
    if cfg.family != "encdec":
        T.check_mesh(cfg, MESH_RT)
    for res in worlds["1x2"]:
        assert res["sharded_init"][arch]


@pytest.mark.parametrize("kwargs", [{"prefix_cache": True, "chunk": 4}, {"kv_swap": True},
                                    {"faults": True}])
def test_lanes_waiting_for_a14b_raise_on_a_mesh(worlds, kwargs):
    """These lanes raised on a mesh until A.14b's serving half; now llama
    with each serves the reference's trace on 2x2 as the port's one-device
    engine does: the same streams on every rank and every stat but the
    clocks."""
    cfg = ARCHS["llama3-8b"].reduced()
    want = R.lane_run(cfg, T.init_params(cfg, 0, "cpu"), kwargs)
    i = R.NEW_LANES.index(kwargs)
    for res in worlds["2x2"]:
        assert res["new_lanes"][i] == want


def test_seq_shard_and_unknown_collectives_raise():
    """``Runtime(seq_shard=True)`` builds since the training mesh (it
    raised until then) and means nothing off a mesh, as in the reference:
    the same loss, bit for bit; an unknown collective and a mesh with no
    process group still raise."""
    rt = T.Runtime(seq_shard=True)
    assert rt.seq_shard and rt.mesh is None
    cfg = ARCHS["llama3-8b"].reduced()
    p = T.init_params(cfg, 0, "cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)))
    assert torch.equal(T.lm_loss(p, cfg, ids[:, :-1], ids[:, 1:], rt),
                       T.lm_loss(p, cfg, ids[:, :-1], ids[:, 1:], T.Runtime()))
    with pytest.raises(ValueError, match="psum|htree"):
        T.Runtime(collective="ring")
    with pytest.raises(RuntimeError, match="process group"):
        MS.make_local_mesh(1, 2)
