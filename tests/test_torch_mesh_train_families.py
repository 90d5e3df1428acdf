"""Every other family's training over the (data, model) mesh against the
reference, on the CPU: grok-1-314b (MoE), deepseek-v3-671b (MLA, MoE, the
MTP loss), mamba2-2.7b (SSM), jamba-1.5-large-398b (hybrid, MoE),
chameleon-34b (QK-norm, embedding inputs) and whisper-tiny
(encoder-decoder) at ``.reduced()`` under ``dense``, one step on 1x2 and
2x2 gloo worlds (rank programs in ``tests/torch_mesh_train_ranks.py``),
started once for the module, one torch thread a rank.

The loss and every leaf's gradient, gathered whole, are held within 2e-5
of the leaf's largest magnitude of JAX's single-device ``value_and_grad``
(the SSM stacks at 4 tokens, where the reference's SSD gradient is
finite).  A MoE stack on 2x2 is held to the reference's mesh semantics
rendered on one JAX device: its training MoE block routes, caps and
balances each data shard's rows (``shard_map`` over the data axes), so the
yardstick is the reference's ``train_loss`` on each data shard's rows,
averaged over the shards (the cross-entropy summed over the shards over
the global token count, the auxes averaged); it differs from the
whole-batch loss, which one assertion shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.shapes import ShapeConfig as JShape
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.models import model as JM
from repro.models.transformer import Runtime as JRuntime
from repro_torch import convert
from repro_torch.launch import mesh as MS
import torch_mesh_train_ranks as R
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRAD_ATOL = 2e-5
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MOE = ("grok-1-314b", "deepseek-v3-671b", "jamba-1.5-large-398b")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _jax(arch: str, shards: int):
    """The reference's train loss and gradients on one device, averaged over
    ``shards`` equal blocks of the batch's rows (1: the whole batch)."""
    cfg, params, _ = R.setup(arch)
    jcfg = JARCHS[arch].reduced()
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
    data = JTokens(jcfg, JShape("t", R.seq_len(arch), R.BATCH, "train"), seed=3).batch_at(0)
    n = R.BATCH // shards

    def loss(p, b):
        parts = [JM.train_loss(p, jcfg, {k: v[i * n:(i + 1) * n] for k, v in b.items()},
                               JRuntime()) for i in range(shards)]
        return sum(parts) / shards
    jl, jg = jax.jit(jax.value_and_grad(loss))(jparams, data)
    return float(jl), _flat(jg)


@pytest.fixture(scope="module")
def run():
    jobs = [(arch, "step", {"arch": arch, "update": False}) for arch in R.FAMILIES]
    worlds = {name: MS.start(R.world, s[0] * s[1], s, jobs) for name, s in MESHES.items()}
    ref = {(arch, 1): _jax(arch, 1) for arch in R.FAMILIES}
    ref.update({(arch, 2): _jax(arch, 2) for arch in MOE})
    out = R.join_all(worlds)
    out["jax"] = ref
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", R.FAMILIES)
def test_family_step_matches_the_reference(run, arch, mesh):
    shards = 2 if (mesh == "2x2" and arch in MOE) else 1
    jl, jg = run["jax"][(arch, shards)]
    res = [r[arch] for r in run[mesh]]
    assert len({r["loss"] for r in res}) == 1          # the same bits on every rank
    np.testing.assert_allclose(res[0]["loss"], jl, rtol=1e-6)
    got = _flat(res[0]["grads"])
    assert set(got) == set(jg)
    for k, want in jg.items():
        assert got[k].shape == want.shape, k
        assert np.isfinite(want).all(), k
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("arch", MOE)
def test_moe_mesh_loss_is_not_the_whole_batch_loss(run, arch):
    """On 2x2 the MoE stacks route and balance each data shard's rows: the
    loss is the per-shard average, not the whole batch's."""
    whole, shards = run["jax"][(arch, 1)][0], run["jax"][(arch, 2)][0]
    got = run["2x2"][0][arch]["loss"]
    assert abs(got - shards) <= 1e-6 * abs(shards)
    assert abs(got - whole) > 1e-5 * abs(whole)         # 10x the agreement bound
