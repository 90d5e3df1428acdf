"""Training over the (data, model) mesh against the reference, on the CPU:
llama3-8b ``.reduced()`` under ``dense`` in gloo worlds of spawned
processes (``repro_torch.launch.mesh``; rank programs in
``tests/torch_mesh_train_ranks.py``), one torch thread a rank, the worlds
started once for the module.

* one step on 1x2, 2x2 and 2x4 (the reference's own sharded-training
  test's mesh): the loss and every leaf's gradient, gathered whole, within
  2e-5 of the leaf's largest magnitude of JAX's single-device
  ``value_and_grad`` and of the port's one-process step; the params after
  one AdamW step within 5e-3 (the reference's bound, lr 1e-3); the loss
  and the gradient norm the same on every rank;
* ``seq_shard`` on 1x2 and 2x2 against the same mesh without it (the
  residual the rank's block of T rows between layers), ``remat`` on and
  off, ``microbatches=2``;
* ``compressed_psum`` on 2 and 4 ranks against the reference's
  ``compress`` per rank, summed as its ``compressed_psum`` sums (codes,
  scales, result and residuals bit-equal);
* ``opt_state_shardings`` equal to the reference's on ``AbstractMesh``
  shapes for f32 and int8 moments, and the int8 moments on a mesh (a last
  dim a rank's block splits inside a 128-block, one on whole blocks, the
  per-tensor fallback) bit-equal to one process's;
* the sharded ``put_batch`` equal to the reference's batch's blocks;
* a checkpoint saved on 2x2 (``save`` and ``AsyncCheckpointer``) restored
  bit-equal on 1x2 and in one process, and one saved in one process
  restored on 2x2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.shapes import ShapeConfig as JShape
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.dist import sharding as JSH
from repro.ft import compress as JC
from repro.models import model as JM
from repro.models.transformer import Runtime as JRuntime
from repro.optim.adamw import AdamW as JAdamW
from repro.train.train_step import opt_state_shardings as j_opt_state_shardings
from repro_torch import convert
from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, put_batch
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MS
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as TS
import torch_mesh_train_ranks as R
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "llama3-8b"
GRAD_ATOL = 2e-5          # of each leaf's largest gradient magnitude
PARAM_ATOL = 5e-3         # the reference's bound on params after one step
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x4": (2, 4)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _jobs(shape):
    step = [("base", "step", {"arch": ARCH})]
    if shape in ((1, 2), (2, 2)):
        step += [("seq", "step", {"arch": ARCH, "seq_shard": True, "rows": True})]
    if shape == (1, 2):
        step += [("remat", "step", {"arch": ARCH, "remat": True}),
                 ("mb2", "step", {"arch": ARCH, "microbatches": 2}),
                 ("adam", "adam", {}),
                 ("compress", "compress", {"axes": ("model",)})]
    if shape == (2, 2):
        step += [("compress", "compress", {"axes": ("data", "model")})]
    return step


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The worlds (1x2, 2x2, 2x4, and 1x2 again for the checkpoints), JAX's
    single-device step and the one-process port steps."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    one = str(tmp / "one")            # written here, restored on 2x2
    quad = str(tmp / "quad")          # written on 2x2, restored on 1x2 and here
    cfg, params, data = R.setup(ARCH)
    opt = AdamW(lr=R.LR, warmup_steps=0, total_steps=10, quantized_state=True)
    p1 = convert.tree_map(params, torch.clone)
    st = opt.init(p1)
    TS.make_train_step(cfg, T.Runtime(), opt)(p1, st, put_batch(data, "cpu"))
    CK.save(one, 1, {"params": p1, "opt": st}, {"arch": ARCH})
    worlds = {name: MS.start(R.world, shape[0] * shape[1], shape, _jobs(shape))
              for name, shape in MESHES.items()}
    worlds["ckpt2x2"] = MS.start(R.world, 4, (2, 2), [
        ("save", "save", {"arch": ARCH, "path": quad}),
        ("restore", "restore", {"arch": ARCH, "path": one})])
    worlds["ckpt1x2"] = MS.start(R.world, 2, (1, 2), [
        ("restore", "restore", {"arch": ARCH, "path": quad})])
    jcfg = JARCHS[ARCH].reduced()
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
    jdata = JTokens(jcfg, JShape("t", R.seq_len(ARCH), R.BATCH, "train"), seed=3).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.train_loss(p, jcfg, b, JRuntime())))(jparams, jdata)
    out = {"jax": (float(jl), _flat(jg)), "one": R.one_process_step(ARCH),
           "one_mb2": R.one_process_step(ARCH, microbatches=2),
           "saved_one": {"params": p1, "opt": st}, "paths": (one, quad), "data": data}
    out.update(R.join_all(worlds))
    return out


def _close_leaves(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=k)


def _hold_step(res: list, one: dict, jax_ref=None):
    """A mesh step's ranks against one process (and JAX)."""
    losses = {r["loss"] for r in res}
    assert len(losses) == 1, losses                    # the same bits on every rank
    assert len({r["grad_norm"] for r in res}) == 1
    loss = res[0]["loss"]
    np.testing.assert_allclose(loss, one["loss"], rtol=1e-6)
    _close_leaves(_flat(res[0]["grads"]), _flat(one["grads"]), GRAD_ATOL)
    if jax_ref is not None:
        np.testing.assert_allclose(loss, jax_ref[0], rtol=1e-6)
        _close_leaves(_flat(res[0]["grads"]), jax_ref[1], GRAD_ATOL)
    np.testing.assert_allclose(res[0]["step_loss"], one["step_loss"], rtol=1e-6)
    np.testing.assert_allclose(res[0]["grad_norm"], one["grad_norm"], rtol=1e-5)
    _close_leaves(_flat(res[0]["params"]), _flat(one["params"]), PARAM_ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_one_step_matches_jax_and_one_process(run, mesh):
    res = [r["base"] for r in run[mesh]]
    _hold_step(res, run["one"], run["jax"])
    assert all(r["stats"]["calls"] > 0 for r in res)
    # the gathered gradients of the other ranks' blocks: one process's too
    assert res[0]["stats"]["all-reduce"] > 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_seq_shard_equals_the_step_without_it(run, mesh):
    base = [r["base"] for r in run[mesh]]
    seq = [r["seq"] for r in run[mesh]]
    _hold_step(seq, {k: base[0][k] for k in ("loss", "grads", "params", "step_loss",
                                             "grad_norm")}, run["jax"])
    T_ = R.seq_len(ARCH)
    m = MESHES[mesh][1]
    for r, b in zip(seq, base):
        assert r["rows"] == [T_ // m] * ARCHS[ARCH].reduced().n_layers
        # the row-parallel sums reduce-scatter the rows (the FSDP gathers'
        # adjoints reduce-scatter over the data axes in both)
        assert r["stats"]["reduce-scatter"] > b["stats"]["reduce-scatter"]
    assert all(r["rows"] == [] for r in base)


def test_remat_and_microbatches_on_a_mesh(run):
    res = run["1x2"]
    _hold_step([r["remat"] for r in res], run["one"], run["jax"])
    _hold_step([r["mb2"] for r in res], run["one_mb2"])
    # remat recomputes the layers' collectives in the backward
    assert res[0]["remat"]["stats"]["calls"] > res[0]["base"]["stats"]["calls"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_compressed_psum_is_the_reference_arithmetic(run, mesh):
    res = sorted((r["compress"] for r in run[mesh]), key=lambda r: r["index"])
    n = len(res)
    inputs = R.compress_inputs(n)
    ref = [[JC.compress(jnp.asarray(g), jnp.asarray(r)) for g, r in zip(*inputs[i])]
           for i in range(n)]
    for leaf in range(len(inputs[0][0])):
        acc = sum(np.asarray(ref[i][leaf][0]).astype(np.int32) for i in range(n))
        smax = max(np.asarray(ref[i][leaf][1]) for i in range(n))
        want = np.asarray(jnp.asarray(acc).astype(jnp.float32) * smax / n)
        for i, r in enumerate(res):
            np.testing.assert_array_equal(r["codes"][leaf], np.asarray(ref[i][leaf][0]))
            assert r["scales"][leaf] == float(ref[i][leaf][1])
            np.testing.assert_array_equal(r["residuals"][leaf], np.asarray(ref[i][leaf][2]))
            np.testing.assert_array_equal(r["mean"][leaf], want)


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple)
                                            and all(isinstance(a, str) for a in e))
        for e in t)


def _port_specs(tree):
    """A tree of NamedShardings or spec tuples -> the same tree of spec
    tuples, its sequence nodes lists."""
    if isinstance(tree, dict):
        return {k: _port_specs(v) for k, v in tree.items()}
    if isinstance(tree, NamedSharding):
        return tuple(tree.spec)
    if _is_spec(tree):
        return tuple(tree)
    if isinstance(tree, (list, tuple)):
        return [_port_specs(v) for v in tree]
    return tree


@pytest.mark.parametrize("quantized", [False, True])
def test_opt_state_shardings_equal_the_reference(quantized):
    """On the reference's own abstract trees at every mesh shape, and on a
    tree whose last dims a rank's block splits inside a 128-block."""
    jcfg, tcfg = JARCHS[ARCH].reduced(), ARCHS[ARCH].reduced()
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    extra = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, (s, _) in R.ADAM_SHAPES.items()}
    for shape in [(1, 2), (2, 2), (2, 4), (8, 1)]:
        jm = AbstractMesh(shape, ("data", "model"))
        tm = MS.AbstractMesh(shape, ("data", "model"))
        for tree, jsh in ((jp, JSH.param_shardings(jcfg, jp, jm)),
                          (extra, {k: NamedSharding(jm, JP(*sp))
                                   for k, (_, sp) in R.ADAM_SHAPES.items()})):
            want = j_opt_state_shardings(JAdamW(quantized_state=quantized), tree, jsh, jm)
            tspecs = _port_specs(jsh)
            got = TS.opt_state_shardings(AdamW(quantized_state=quantized), tree, tspecs, tm)
            assert tuple(got.count) == tuple(want.count.spec)
            assert _port_specs(got.m) == _port_specs(want.m), shape
            assert _port_specs(got.v) == _port_specs(want.v), shape


def test_int8_moments_on_a_mesh_are_one_process_bits(run):
    """Two AdamW steps with int8 moments on 1x2: a last dim split inside a
    128-block (the rank gathers the row for its scales), on whole blocks,
    rows split, and the per-tensor fallback (a max over the blocks) give
    one process's params, codes and scales bit for bit."""
    ps, gs, _ = R.adam_tree()
    want = R.adam_int8(ps, gs)
    for r in run["1x2"]:
        got = r["adam"]
        for k in ps:
            np.testing.assert_array_equal(got["params"][k], want["params"][k].numpy())
            for name in ("m", "v"):
                np.testing.assert_array_equal(got[name][k]["q"], want[name][k]["q"].numpy())
                np.testing.assert_array_equal(got[name][k]["s"], want[name][k]["s"].numpy())
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    assert want["m"]["fallback"]["s"].ndim == 0
    assert want["m"]["inside"]["s"].shape == (4, 3)


def test_sharded_put_batch_is_the_reference_batch_blocks():
    """Each rank's blocks of every input, on 2x2 and 2x4 (counting meshes
    give each rank's index without a world), equal the reference's batch's
    blocks; a batch the data axes do not tile stays whole."""
    cfg = ARCHS[ARCH].reduced()
    jcfg = JARCHS[ARCH].reduced()
    for B in (4, 3):
        shape = ShapeConfig("t", 8, B, "train")
        whole = JTokens(jcfg, JShape("t", 8, B, "train"), seed=9).batch_at(2)
        data = SyntheticTokens(cfg, shape, seed=9).batch_at(2)
        for mshape in ((2, 2), (2, 4)):
            for rank in range(mshape[0] * mshape[1]):
                mesh = MS.CountingMesh(mshape, ("data", "model"), rank)
                specs = SH.input_shardings(cfg, shape, data, mesh)
                got = put_batch(data, "cpu", specs, mesh)
                rows = B // mshape[0] if B % mshape[0] == 0 else B
                lo = mesh.index("data") * rows if rows < B else 0
                for k, v in whole.items():
                    np.testing.assert_array_equal(got[k].numpy(), np.asarray(v)[lo:lo + rows])


def _hold_blocks(got, whole_tree, spec_tree, shape, rank):
    mesh = MS.CountingMesh(shape, ("data", "model"), rank)
    flat_g, flat_w = CK._items(got), dict(CK._items(whole_tree))
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        want = CK._block(w, CK._spec_at(spec_tree, path), mesh)
        np.testing.assert_array_equal(np.asarray(g), want, err_msg=str(path))


def _ckpt_specs(shape):
    cfg, params, _ = R.setup(ARCH)
    mesh = MS.AbstractMesh(shape, ("data", "model"))
    specs = T.mesh_param_specs(cfg, params, mesh)
    opt = AdamW(quantized_state=True)
    return {"params": specs, "opt": TS.opt_state_shardings(opt, params, specs, mesh)}


def test_checkpoints_restore_across_meshes(run):
    """Saved on 2x2: restored in one process it is the tree rank 0
    gathered, and each 1x2 rank's restored blocks are its blocks of it;
    saved in one process: each 2x2 rank's blocks are its blocks of it."""
    one, quad = run["paths"]
    cfg, params, _ = R.setup(ARCH)
    opt = AdamW(quantized_state=True)
    like = {"params": params, "opt": opt.init(params)}
    whole, extra = CK.restore(quad, like)
    assert extra == {"arch": ARCH}
    saved = run["ckpt2x2"][0]["save"]["saved"]
    for (pa, a), (pb, b) in zip(CK._items(whole), CK._items(saved)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))
    # the AsyncCheckpointer on the mesh: the same tree at step 2, every rank
    # back from wait() after its COMMIT
    assert all(r["save"]["async_step"] == 2 for r in run["ckpt2x2"])
    async_whole, _ = CK.restore(quad + "_async", like)
    for (pa, a), (_, b) in zip(CK._items(async_whole), CK._items(whole)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))
    for rank, r in enumerate(run["ckpt1x2"]):
        _hold_blocks(r["restore"]["blocks"], _np(whole), _ckpt_specs((1, 2)), (1, 2), rank)
    for rank, r in enumerate(run["ckpt2x2"]):
        _hold_blocks(r["restore"]["blocks"], _np(run["saved_one"]), _ckpt_specs((2, 2)),
                     (2, 2), rank)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_np(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree
