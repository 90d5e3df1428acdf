"""The dry run's meshes, counted on ``meta`` in this process (and one
2-rank gloo world for the counting mesh's yardstick):

* a ``CountingMesh``'s collectives give the shapes and the bytes (by kind)
  of a real 2-rank world's on the same calls, and a real tensor on it
  raises;
* the ``--quick`` cells on ``quick2x4`` are all ``ok`` or skipped for
  ``applicable``'s reason, with the record's mesh fields;
* ``pod16x16``: llama3-8b ``train_4k`` under ``seqshard`` against its
  baseline (the same blocks, rows reduce-scattered) and jamba-1.5-large
  ``decode_32k`` under ``resident`` below 0.25x the baseline's collective
  bytes with its weights and state a rank within 1.02x (the reference's
  ``TestPerfVariants`` gates);
* the mesh variants on ``h100x1`` raise a ``ValueError``.
"""
import json

import pytest
import torch

from repro_torch.dist import collectives as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = {"ar": (3, 5), "ag": (2, 4), "rs": (6, 2), "ht": (7,), "p2p": (4,), "bc": (3,)}


def _calls(mesh, make) -> dict:
    """Every collective over the 2-rank model axis on tensors from
    ``make(shape)`` -> each result's shape and the stats after each."""
    g = mesh.group("model")
    out = {}
    C.reset_stats()
    for name, fn in (("ar", lambda: C.all_reduce(make(SHAPES["ar"]), g)),
                     ("ag", lambda: C.all_gather(make(SHAPES["ag"]), g, dim=1)),
                     ("rs", lambda: C.reduce_scatter(make(SHAPES["rs"]), g, dim=0)),
                     ("ht", lambda: C.htree_allreduce(make(SHAPES["ht"]), g)),
                     ("bc", lambda: C.broadcast(make(SHAPES["bc"]), g, 0))):
        res = fn()
        out[name] = (tuple(res.shape), {k: v for k, v in C.stats.items() if k != "seconds"})
    if g.index == 0:
        C.send(make(SHAPES["p2p"]), g, 1)
        res = None
    else:
        res = C.recv(make(SHAPES["p2p"]), g, 0)
    out["p2p"] = (None if res is None else tuple(res.shape),
                  {k: v for k, v in C.stats.items() if k != "seconds"})
    return out


def _real(rank: int) -> dict:
    return _calls(MS.make_local_mesh(1, 2), lambda s: torch.ones(s))


def test_counting_mesh_counts_what_a_real_world_moves():
    real = MS.spawn(_real, 2)
    for rank in range(2):
        mesh = MS.CountingMesh((1, 2), ("data", "model"), rank)
        got = _calls(mesh, lambda s: torch.empty(s, device="meta"))
        assert got == real[rank]
    C.reset_stats()
    mesh = MS.CountingMesh((2, 2), ("data", "model"), 3)
    with pytest.raises(ValueError, match="meta tensors only"):
        C.all_reduce(torch.ones(3), mesh.group("model"))
    with pytest.raises(ValueError, match="meta tensors only"):
        C.all_gather(torch.ones(3), mesh.group(("data", "model")), dim=0)
    assert mesh.group(("data", "model")).ranks == [0, 1, 2, 3] and mesh.index("data") == 1


def test_quick_cells_on_the_2x4_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART", tmp_path)
    monkeypatch.setattr(D, "count_workers", lambda cells: 1)    # counted in this process
    assert D.main(["--quick", "--mesh", "quick2x4", "--device", "cpu"]) == 0
    manifest = json.loads((tmp_path / "quick_manifest.json").read_text())
    assert manifest["mesh"] == "quick2x4" and len(manifest["artifacts"]) == 12
    for name in manifest["artifacts"]:
        assert name.endswith("__quick2x4.json")
        rec = json.loads((tmp_path / name).read_text())
        assert rec["mesh"] == "quick2x4" and rec["n_devices"] == 8
        if rec["status"] == "skipped":
            assert rec["shape"] == "long_500k" and rec["arch"] != "mamba2-2.7b"
            continue
        assert rec["status"] == "ok" and rec["cost"]["flops"] > 0
        assert rec["collectives"]["total"] == sum(
            v for k, v in rec["collectives"].items() if k != "total") > 0
        assert rec["memory"]["fits_one_card"] is None          # no card here


def _cell(tmp_path, monkeypatch, arch, shape, variant):
    monkeypatch.setattr(D, "ART", tmp_path)
    monkeypatch.setattr(D, "count_workers", lambda cells: 1)
    rec = D.run_cells([(arch, shape)], variant, device="cpu", mesh="pod16x16")[0]
    suffix = "" if variant == "baseline" else f"__{variant}"
    assert (tmp_path / f"{arch}__{shape}__pod16x16{suffix}.json").exists()
    assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
    return rec


def test_pod_seqshard_training_cell(tmp_path, monkeypatch):
    base = _cell(tmp_path, monkeypatch, "llama3-8b", "train_4k", "baseline")
    seq = _cell(tmp_path, monkeypatch, "llama3-8b", "train_4k", "seqshard")
    for k in ("tree_bytes", "opt_bytes"):
        assert seq["memory"][k] == base["memory"][k]
    assert seq["collectives"]["reduce-scatter"] > base["collectives"]["reduce-scatter"]
    assert abs(seq["cost"]["flops"] - base["cost"]["flops"]) <= 0.01 * base["cost"]["flops"]
    assert base["reduced"] and base["memory"]["opt_bytes"] > 0


def test_pod_resident_decode_cell(tmp_path, monkeypatch):
    base = _cell(tmp_path, monkeypatch, "jamba-1.5-large-398b", "decode_32k", "baseline")
    res = _cell(tmp_path, monkeypatch, "jamba-1.5-large-398b", "decode_32k", "resident")
    assert res["collectives"]["total"] < 0.25 * base["collectives"]["total"]
    mine = res["memory"]["tree_bytes"] + res["memory"]["cache_bytes"]
    theirs = base["memory"]["tree_bytes"] + base["memory"]["cache_bytes"]
    assert mine <= 1.02 * theirs


@pytest.mark.parametrize("variant", sorted(D.MESH_VARIANTS))
def test_mesh_variants_need_a_mesh(variant):
    with pytest.raises(ValueError, match="needs a mesh"):
        D.runtime("decode", variant)
    with pytest.raises(ValueError, match="needs a mesh"):
        D.check_variant(variant, "h100x1")
    D.check_variant(variant, "pod16x16")
    D.check_variant("bf16dmvm", "h100x1")
