"""The SSM, hybrid, MLA and encoder-decoder stacks of the port on a (data,
model) mesh (ROADMAP A.14b's serving half) against the reference, on the
CPU: 1x2 and 2x2 gloo worlds of spawned processes, one torch thread a
rank, started once for the module.

* mamba2-2.7b, jamba-1.5-large-398b, deepseek-v3-671b and whisper-tiny
  ``.reduced()`` under ``ref_int8``: a decode step from one device's
  prefilled state is bit-equal to one device's, logits and every state
  leaf gathered over the model axis.  A MoE stack is held layer by layer
  from one device's input to each layer: every mixer and every state leaf
  bit for bit, each MoE block within the reference's rtol 2e-3 / atol
  2e-4 of JAX's single-device ``moe_apply`` on the same rows (its partial
  sums combine over the ranks in another order);
* ``Engine.generate`` and (decoders) the continuous engine on the
  reference's sharded-serve trace token-identical to JAX's single-device
  engines and the port's one-device engines, every rank's streams equal; a
  MoE stack's stream that parts does so at a near-tie at the first parting
  iteration (the mesh rule of the card's ``chip_smoke.py``); deepseek also
  on the seed-17 trace under ``chunk=4`` (``sjf``) and under ``spec_k=3``
  with the MTP drafter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import ARCHS as JARCHS
from repro.models import moe as JMOE
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
import torch_mesh_serve_ranks as R
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _jax_engines(arch: str) -> dict:
    """JAX's single-device engines on the port's weights: ``Engine`` on
    the fixed batch and (decoders) the continuous engine on the trace,
    deepseek's seed-17 lanes too."""
    cfg, jcfg = ARCHS[arch].reduced(), JARCHS[arch].reduced()
    params = M.init_params(cfg, 0, "cpu")
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
    batch = {k: jnp.asarray(v.numpy()) for k, v in R.fixed_batch(cfg).items()}
    out = {"fixed": np.asarray(JEngine(cfg=jcfg, params=jp, max_len=16).generate(batch, 6)[0])}
    if cfg.family == "encdec":
        return out
    out["trace"] = JCB(jcfg, jp, n_slots=4, max_len=48).generate_all(*R.family_trace(cfg))
    if cfg.mtp:
        p17 = R.seed17_trace(cfg)
        out["seed17_chunk"] = JCB(jcfg, jp, n_slots=4, max_len=32, chunk=4,
                                  policy="sjf").generate_all(*p17)
        out["seed17_mtp"] = JCB(jcfg, jp, n_slots=4, max_len=32, spec_k=3,
                                drafter="mtp").generate_all(*p17)
    return out


@pytest.fixture(scope="module")
def worlds():
    """Both worlds (started first), then, meanwhile, JAX's and the port's
    one-device engines of each family."""
    started = {name: MS.start(R.families_world, d * m, (d, m), True)
               for name, (d, m) in MESHES.items()}
    ref = {a: {"jax": _jax_engines(a), "port": R.family_engines(None, a)} for a in R.FAMILIES}
    return {"ranks": {k: w.join() for k, w in started.items()}, "ref": ref}


def _whole_rows(ranks: list, shape: tuple, j: int) -> np.ndarray:
    """MoE call ``j``'s input rows of every slot: the model-0 ranks' rows
    in data order."""
    d, m = shape
    return np.concatenate([ranks[i * m]["step"]["moe_rows"][j][0] for i in range(d)], axis=0)


@pytest.mark.parametrize("arch", R.FAMILIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_step_bit_equal_to_one_device(worlds, mesh, arch):
    ranks = [r[arch] for r in worlds["ranks"][mesh]]
    for res in ranks:
        st = res["step"]
        assert st["state_diffs"] and max(st["state_diffs"]) == 0.0
        want, got = st["logits"]
        if not st["moe"]:
            np.testing.assert_array_equal(got, want)
            continue
        assert all(st["mixer_equal"]) and all(st["dense_ffn_equal"])
        assert np.isfinite(got).all()
    if not ranks[0]["step"]["moe"]:
        return
    jcfg = JARCHS[arch].reduced()
    for j, layer in enumerate(ranks[0]["step"]["moe_layers"]):
        x = _whole_rows([{"step": r["step"]} for r in ranks], MESHES[mesh], j)
        ref, _ = JMOE.moe_apply(_jax(R.moe_params(arch, layer)), jnp.asarray(x), jcfg)
        ref = np.asarray(ref)
        for res in ranks:
            lo, hi = res["step"]["block"]
            np.testing.assert_allclose(res["step"]["moe_rows"][j][1], ref[lo:hi],
                                       rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_engines_token_identical_to_one_device(worlds, arch):
    """On 1x2 and 2x2 every rank's streams equal rank 0's and the port's
    one-device engines', which equal JAX's single-device engines'; a MoE
    stack's trace may part at a near-tie only."""
    jax_ref, port = worlds["ref"][arch]["jax"], worlds["ref"][arch]["port"]
    np.testing.assert_array_equal(port["fixed"], jax_ref["fixed"])
    for lane in jax_ref:
        if lane != "fixed":
            assert port[lane] == jax_ref[lane], lane
    for mesh, ranks in worlds["ranks"].items():
        eng = [r[arch]["engines"] for r in ranks]
        for e in eng:
            np.testing.assert_array_equal(e["fixed"], jax_ref["fixed"])
            for lane in jax_ref:
                if lane not in ("fixed", "trace"):
                    assert e[lane] == jax_ref[lane], (mesh, lane)
            assert e.get("trace") == eng[0].get("trace")
        if "trace" not in jax_ref:
            continue
        if eng[0]["trace"] != jax_ref["trace"]:
            assert any(ARCHS[arch].reduced().is_moe_layer(i) for i in range(
                ARCHS[arch].reduced().n_layers)), (mesh, "a stack without MoE layers parted")
            assert R.near_tie_failures(eng[0]["trace"], eng[0]["rows"], port["trace"],
                                       port["rows"]) == [], mesh
