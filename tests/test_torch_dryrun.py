"""The port's dry run (``launch/dryrun.py``) and its model-side helpers
(``abstract_params``, ``input_specs``, ``param_bytes``, ``ASSIGNED``)
against the reference.

Nothing here counts or allocates at full size: ``abstract_params`` builds
the full trees on ``meta`` (as ``jax.eval_shape`` does in the reference),
the 40 records are built without their flop count, and only the quick
cells (reduced configs) are counted.  Counted flops are held to a hand
count from the shapes exactly (the counter counts each matmul's 2·M·N·K,
and so does the hand count), and the depth scaling to counts at full depth
exactly.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs import shapes as JS
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TS
from repro_torch.launch import dryrun as D
from repro_torch.models import model as TM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _stacked(trees: list):
    """The reference's stacked [n, ...] (shape, dtype) of per-layer trees
    whose leaves agree in shape and dtype."""
    first = _flat(trees[0])
    for t in trees[1:]:
        assert {k: (v.shape, v.dtype) for k, v in _flat(t).items()} == \
            {k: (v.shape, v.dtype) for k, v in first.items()}
    return {k: ((len(trees), *v.shape), v.dtype) for k, v in first.items()}


def _reference_layout(params: dict, cfg) -> dict:
    """A port tree's (shape, dtype) leaves in the reference's layout: the
    decoder layers in ``convert.layer_groups``' groups, an
    encoder-decoder's ``enc`` / ``dec`` stacked (as ``convert.to_numpy``
    lays them out, without reading a value)."""
    out = {}
    for k, v in params.items():
        if k in ("enc", "dec"):
            out.update({f"/{k}{p}": s for p, s in _stacked(v).items()})
        elif k != "layers":
            out.update({p: (t.shape, t.dtype) for p, t in _flat(v, f"/{k}").items()})
    if "layers" in params:
        for g, (start, count, period) in enumerate(convert.layer_groups(cfg)):
            for s in range(period):
                trees = params["layers"][start + s:start + count:period]
                out.update({f"/groups/{g}/{s}{p}": v for p, v in _stacked(trees).items()})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", list(TR.ARCHS))
def test_abstract_params_match_reference(arch, dtype):
    """Every registry arch at full size: the port's ``meta`` tree (nothing
    allocated) has the reference's ``eval_shape`` leaves, shape and dtype,
    leaf for leaf through the port's per-layer layout."""
    tree = TM.abstract_params(TR.get(arch), dtype=dtype)
    leaves = convert.tree_leaves(tree)
    assert all(t.is_meta for t in leaves)
    want = {p: (tuple(s.shape), s.dtype)
            for p, s in _flat(JM.abstract_params(JR.get(arch), dtype=DT[dtype])).items()}
    got = {p: (tuple(shape), DT[dt]) for p, (shape, dt) in
           _reference_layout(tree, TR.get(arch)).items()}
    assert got == want


@pytest.mark.parametrize("shape", list(TS.SHAPES))
@pytest.mark.parametrize("arch", list(TR.ARCHS))
def test_input_specs_match_reference(arch, shape):
    got = TM.input_specs(TR.get(arch), TS.SHAPES[shape])
    want = JM.input_specs(JR.get(arch), JS.SHAPES[shape])
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.is_meta
        assert (tuple(v.shape), DT[v.dtype]) == (want[k].shape, want[k].dtype), k


def test_registry_shapes_and_counts_match_reference():
    assert TR.ASSIGNED == JR.ASSIGNED and len(TR.ASSIGNED) == 10
    assert list(TR.ARCHS) == list(JR.ARCHS)
    for arch in TR.ARCHS:
        for b in (1, 2, 4):
            assert TM.param_bytes(TR.get(arch), b) == JM.param_bytes(JR.get(arch), b)
        assert TM.param_bytes(TR.get(arch)) == JM.param_bytes(JR.get(arch))
        for name in TS.SHAPES:
            assert (TM.model_flops(TR.get(arch), TS.SHAPES[name])
                    == JM.model_flops(JR.get(arch), JS.SHAPES[name]))


def test_forty_records_carry_the_reference_fields():
    """Every ``ASSIGNED`` x ``SHAPES`` record, uncounted: the reference's
    ``params``, ``active_params``, ``model_flops`` and skip reasons (the 8
    ``long_500k`` cells of full-attention archs)."""
    cells = D.all_cells()
    assert len(cells) == 40
    skipped = 0
    for arch, sname in cells:
        rec = D.base_record(arch, sname)
        jcfg, jshape = JR.get(arch), JS.SHAPES[sname]
        assert rec["mesh"] == "h100x1" and rec["kind"] == jshape.kind
        assert rec["params"] == jcfg.param_count()
        assert rec["active_params"] == jcfg.active_param_count()
        assert rec["model_flops"] == JM.model_flops(jcfg, jshape)
        ok, why = JS.applicable(jcfg, jshape)
        assert (rec.get("status") == "skipped") == (not ok)
        if not ok:
            skipped += 1
            assert rec["reason"] == why
    assert skipped == 8


def _llama_hand_count(kind: str, B: int, S: int) -> float:
    """llama3-8b reduced's matmul flops (2 a multiply-add) from its shapes:
    the linears' weights, the head, and attention's two products over the
    keys each step computes (decode: the whole pool; prefill: 64-row pieces
    each over the keys up to its end; train: flash attention's blocks,
    every key of a block, forward, the two products' four backward
    products, and remat's second forward of each layer but its last
    linear: a non-reentrant checkpoint stops recomputing once it has the
    saved tensors the backward needs, and ``w_down``'s output is none)."""
    cfg = TR.get("llama3-8b").reduced()
    d, H, G, hd, ff, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                             cfg.vocab_size, cfg.n_layers)
    layer = d * H * hd + 2 * d * G * hd + H * hd * d + 3 * d * ff
    head = d * V
    if kind == "decode":
        return B * (2 * (L * layer + head) + L * 4 * H * S * hd)
    if kind == "prefill":
        attn = sum(4 * H * 64 * (lo + 64) * hd for lo in range(0, S, 64))
        return B * (L * (2 * S * layer + attn) + 2 * head)      # the head on the last row
    attn_f = 4 * H * S * S * hd                                  # one block of S keys
    fwd = L * (2 * S * layer + attn_f) + 2 * S * head
    return B * (3 * fwd + L * (2 * S * (layer - ff * d) + attn_f))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_quick_llama_counts_equal_hand_count(shape):
    """The quick llama3-8b cells' counted flops equal the hand count from
    the shapes (tolerance 0: both count 2·M·N·K a product)."""
    sh = D.QUICK_SHAPES[shape]
    rec = D.count_cell("llama3-8b", shape, quick=True)
    assert rec["counted_on"] == "meta" and rec["reduced"] == []
    assert rec["cost"]["flops"] == _llama_hand_count(sh.kind, sh.global_batch, sh.seq_len)


CUT_CASES = [("llama3-8b", "decode"), ("llama3-8b", "train"),
             ("deepseek-v3-671b", "prefill"), ("deepseek-v3-671b", "decode"),
             ("jamba-1.5-large-398b", "decode"), ("jamba-1.5-large-398b", "prefill")]


@pytest.mark.parametrize("arch,kind", CUT_CASES)
def test_depth_scaling_is_exact(arch, kind):
    """A stack counted at two depths a layer group (one and two layers,
    dense and MoE layers apart, a hybrid's periods) and scaled equals the
    count at its own depth: flops and every byte count."""
    cfg = dataclasses.replace(TR.get(arch).reduced(), n_layers={"jamba-1.5-large-398b": 24}.get(
        arch, 5))
    shape = TS.ShapeConfig("s", 128, 2, kind)
    scaled = D.count_config(cfg, shape, cut=True)
    whole = D.count_config(cfg, shape, cut=False)
    assert scaled["cost"] == whole["cost"] and scaled["memory"] == whole["memory"]
    assert scaled["reduced"] and not whole["reduced"]


@pytest.mark.parametrize("variant", D.MESH_VARIANTS)
def test_mesh_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="A.14"):
        D.base_record("llama3-8b", "decode_32k", variant)
    with pytest.raises(NotImplementedError, match="A.14"):
        D.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--variant", variant,
                "--device", "cpu"])


def test_quick_run_writes_records_and_manifest(tmp_path, monkeypatch):
    """``--quick --device cpu`` (then ``--variant bf16dmvm``): 12 records,
    each ``ok`` with flops > 0 or skipped with the reference's reason, no
    peak on the CPU, and the manifest; a second run reads them back."""
    monkeypatch.setattr(D, "ART", tmp_path)
    monkeypatch.setattr(D, "count_workers", lambda cells: 1)    # counted in this process
    assert D.main(["--quick", "--device", "cpu"]) == 0
    manifest = json.loads((tmp_path / "quick_manifest.json").read_text())
    assert len(manifest["artifacts"]) == 12 and manifest["mesh"] == "h100x1"
    for name in manifest["artifacts"]:
        rec = json.loads((tmp_path / name).read_text())
        assert rec["status"] in ("ok", "skipped"), rec
        if rec["status"] == "ok":
            assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_bytes"] is None
            assert rec["memory"]["tree_bytes"] > 0
        else:
            assert rec["reason"].startswith("full quadratic attention")
    assert D.main(["--quick", "--device", "cpu", "--variant", "bf16dmvm"]) == 0
    assert len(list(tmp_path.glob("*__quick__bf16dmvm.json"))) == 12
    assert json.loads((tmp_path / "llama3-8b__decode_32k__quick__bf16dmvm.json").read_text())[
        "cost"]["flops"] == json.loads((tmp_path / "llama3-8b__decode_32k__quick.json")
                                       .read_text())["cost"]["flops"]


def test_an_uncountable_cell_is_skipped_with_its_reason(monkeypatch):
    """A cell that applies but could not be counted keeps the ``skipped``
    status with its reason, and fails the run: only ``applicable``'s own
    skips pass."""
    def boom(*a, **k):
        raise RuntimeError("needs a value")
    monkeypatch.setattr(D, "count_cell", boom)
    rec = D.finish(D.base_record("llama3-8b", "decode_32k"),
                   D._count_or_error("llama3-8b", "decode_32k", "baseline", False),
                   torch.device("cpu"), quick=False)
    assert rec["status"] == "skipped" and "needs a value" in rec["reason"]
    long_ctx = D.base_record("llama3-8b", "long_500k")
    assert long_ctx["status"] == "skipped"
    assert D.unexplained([rec, long_ctx]) == [rec]
    monkeypatch.setattr(D, "run_cells", lambda *a, **k: [long_ctx])
    assert D.main(["--arch", "llama3-8b", "--device", "cpu"]) == 0
    monkeypatch.setattr(D, "run_cells", lambda *a, **k: [rec, long_ctx])
    assert D.main(["--arch", "llama3-8b", "--device", "cpu"]) == 1


def test_records_never_land_in_the_references_folder():
    assert D.ART.name == "dryrun_torch"
    assert D.out_path("llama3-8b", "train_4k").name == "llama3-8b__train_4k__h100x1.json"
    assert D.out_path("llama3-8b", "train_4k", "bf16dmvm").name == \
        "llama3-8b__train_4k__h100x1__bf16dmvm.json"


def test_meta_stays_out_of_the_serve_paths():
    """``meta`` is accepted by the dry run's constructors only: an engine,
    a cache or a conversion on it raises."""
    from repro_torch.core import kvcache as TKV
    from repro_torch.serve.engine import Engine
    cfg = TR.get("llama3-8b").reduced()
    with pytest.raises(ValueError, match="unsupported device"):
        TKV.init_cache(1, 1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        convert.from_numpy({"embed": {"w": np.zeros((2, 2), np.float32)}}, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        Engine(cfg=cfg, params=TM.abstract_params(cfg), device="meta")
