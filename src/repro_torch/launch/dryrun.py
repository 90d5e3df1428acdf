"""One-card dry run: every (arch x shape) cell's operations and bytes, and
whether it fits one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b [--shape train_4k]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--variant bf16dmvm] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --quick [--device cpu]

The counterpart of the reference's pod dry run (``repro.launch.dryrun``),
which lowers every cell on TPU meshes and reads XLA's cost and memory
analyses.  Here a cell's ``cost.flops`` is counted by
``torch.utils.flop_counter.FlopCounterMode`` over the port's own step
(``train_step``, ``prefill`` or ``decode_step``) under the reference dry
run's backend (``Runtime()``, ``dense``; the train step with ``remat``, as
there), at the cell's full shape, on ``meta`` tensors: every step runs on
``meta`` (the kernels' plain versions; nothing needs a value), so no cell
needs a run on the card to be counted.  The counter takes the place of the
reference's ``launch/hlo_cost.py``: an eager count sees every iteration of
every loop (prefill's 64-row pieces, the SSD's chunks), so there is no
trip count to recover.  A full-size stack is counted at two depths for each
of its layer groups (one and two layers, periods of a hybrid's interleave,
or dense and MoE layers apart) and scaled exactly to its depth: its layers
are alike, so each count is a fixed part plus a part a layer.  Each cut
stands in the record's ``reduced``.

``memory`` holds ``param_bytes`` (the reference's, 2 bytes a parameter),
the bytes of the tree the step takes (the float tree for train and
prefill, ``quantize_tree``'s for decode), the decode state's
``cache_bytes``, the optimizer's (``AdamW(quantized_state=param_count >
50e9)``, as the reference's dry run), the card's bytes and whether the
weights and state fit one card; and, for a decode cell whose int8 weights
fit, ``peak_bytes`` (``torch.cuda.max_memory_allocated``) of one real decode
step at full width under ``fused_int8`` (B1 and B2 run), the batch cut to
fit the card's free bytes where it must be (said in ``reduced``).

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json``;
``--quick`` counts the reference's reduced quick cells uncut and writes
``quick_manifest.json``.  Variants: ``baseline`` and ``bf16dmvm``
(``Runtime.dmvm_dtype = torch.bfloat16``) on any mesh, and the reference's
``MESH_VARIANTS`` (resident experts, sequence-parallel activations, the
H-tree combine, and ``opt`` / ``opt_htree``, which add the bf16 dMVM),
which need a mesh.  A cell that cannot be counted is ``skipped`` with its
reason, and the run then exits 1: only ``applicable``'s skips pass.

**Meshes.**  ``h100x1`` (the default) is one card.  ``--mesh pod16x16``,
``--multi-pod`` (``pod2x16x16``), ``--both-meshes`` and ``--mesh
quick2x4`` count the reference's meshes: a cell is counted for rank 0 of a
``launch.mesh.CountingMesh`` (``make_production_mesh``, ``make_quick_mesh``)
on ``meta``, with ``Runtime(mesh=..., data_axes=..., remat=train)`` and the
variant, over the rank's blocks of the params (``mesh_param_specs``), of
the decode pool (``init_decode_block``) and of the batch
(``input_shardings``), the training step by ``jit_train_step`` with the
reference's microbatches (a device's backward sees about 4k tokens).  The
record adds ``collectives`` (the rank's bytes by kind, as the reference's
HLO names them, and ``total``), ``n_devices``, and the rank's tree, state
and optimizer bytes with ``fits_one_card`` for the rank; the two-depth
scaling holds for the collectives too.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

import torch

from repro_torch import convert
from repro_torch import kernels as KN
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.core.kvcache import cache_bytes
from repro_torch.device import resolve, set_float32_precision
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.models import transformer as TR
from repro_torch.models.transformer import Runtime
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.quantize import quantize_tree
from repro_torch.train.train_step import jit_train_step, make_train_step

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESH = "h100x1"
# the counted meshes: tag -> a CountingMesh of the reference's shape
MESHES = {"pod16x16": lambda: MS.make_production_mesh(multi_pod=False),
          "pod2x16x16": lambda: MS.make_production_mesh(multi_pod=True),
          "quick2x4": MS.make_quick_mesh}
VARIANTS = {"baseline": {}, "bf16dmvm": {"dmvm_dtype": torch.bfloat16}}
MESH_VARIANTS = {
    "resident": {"serve_resident_moe": True},
    "seqshard": {"seq_shard": True},
    "htree": {"collective": "htree"},
    "opt": {"serve_resident_moe": True, "dmvm_dtype": torch.bfloat16, "seq_shard": True},
    "opt_htree": {"serve_resident_moe": True, "dmvm_dtype": torch.bfloat16,
                  "collective": "htree"},
}
ALL_VARIANTS = {**VARIANTS, **MESH_VARIANTS}
# --quick: the reference's reduced configs and CI-sized shapes, uncut
QUICK_ARCHS = ["llama3-8b", "grok-1-314b", "mamba2-2.7b"]
QUICK_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 512, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 512, 4, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 512, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 8_192, 1, "decode"),
}
FIT_SHARE = 0.85     # of the card's bytes a peak run may hold in weights and state


def check_variant(variant: str, mesh: str = MESH) -> None:
    """``ValueError`` for an unknown variant or mesh, or a mesh variant on
    one card (``h100x1``)."""
    if mesh != MESH and mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; one of {[MESH, *MESHES]}")
    _check(variant, mesh != MESH)


def _check(variant: str, on_mesh: bool) -> None:
    if variant not in ALL_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(ALL_VARIANTS)}")
    if variant in MESH_VARIANTS and not on_mesh:
        raise ValueError(f"variant {variant!r} sets the mesh fields and needs a mesh "
                         f"(--mesh one of {list(MESHES)}), not {MESH}")


def runtime(kind: str, variant: str = "baseline", backend: str = "dense",
            mesh=None) -> Runtime:
    """The reference dry run's Runtime for a cell of ``kind``: remat for
    training, the variant's fields, on ``mesh`` (a ``CountingMesh``) where
    one is given."""
    _check(variant, mesh is not None)
    kw = dict(ALL_VARIANTS[variant])
    if mesh is not None:
        kw.update(mesh=mesh, data_axes=SH.data_axes(mesh))
    return Runtime(backend=backend, remat=(kind == "train"), **kw)


def cell_config(arch: str, quick: bool = False) -> ModelConfig:
    cfg = registry.get(arch)
    return cfg.reduced() if quick else cfg


def base_record(arch: str, shape_name: str, variant: str = "baseline",
                quick: bool = False, mesh: str = MESH) -> dict:
    """A cell's fields kept from the reference's record, and its status
    where ``applicable`` skips it; nothing is counted."""
    check_variant(variant, mesh)
    cfg = cell_config(arch, quick)
    shape = (QUICK_SHAPES if quick else SHAPES)[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "variant": variant,
           "kind": shape.kind, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "model_flops": M.model_flops(cfg, shape)}
    if mesh != MESH:
        rec["n_devices"] = MESHES[mesh]().world
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
    return rec


# ---------------------------------------------------------------------------
# counting on meta, with exact depth scaling
# ---------------------------------------------------------------------------
def depth_units(cfg: ModelConfig) -> list[int]:
    """A stack's layer groups in units of its repeating structure: one
    layer, a hybrid's period, or the dense and the MoE layers apart
    (``convert.layer_groups``); none for an encoder-decoder, which is
    counted uncut."""
    if cfg.family == "encdec":
        return []
    return [count // period for _, count, period in convert.layer_groups(cfg)]


def cut_config(cfg: ModelConfig, units: list[int]) -> ModelConfig:
    """``cfg`` with ``units[g]`` units in each layer group."""
    groups = convert.layer_groups(cfg)
    if len(groups) == 2:                      # dense layers, then MoE layers
        return dataclasses.replace(cfg, n_layers=units[0] + units[1],
                                   first_dense_layers=units[0])
    return dataclasses.replace(cfg, n_layers=units[0] * groups[0][2])


def _inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``input_specs`` with float inputs as f32, as the engines land them."""
    return {k: v.to(torch.float32) if v.is_floating_point() else v
            for k, v in M.input_specs(cfg, shape).items()}


def measure(cfg: ModelConfig, shape: ShapeConfig, variant: str,
            quantized_state: bool, mesh: str = MESH) -> dict:
    """One configuration's counted flops and bytes on ``meta`` (on a mesh,
    rank 0's, with its collectives' bytes by kind)."""
    from torch.utils.flop_counter import FlopCounterMode
    if mesh != MESH:
        return _measure_mesh(cfg, shape, variant, quantized_state, MESHES[mesh]())
    rt = runtime(shape.kind, variant)
    params = M.abstract_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    out = {"opt_bytes": 0, "cache_bytes": 0}
    if shape.kind == "decode":
        qparams = quantize_tree(params)
        state = M.init_decode_state(cfg, B, S, device="meta")
        out.update(tree_bytes=cache_bytes(qparams), cache_bytes=cache_bytes(state))
        with FlopCounterMode(display=False) as fc:
            M.decode_step(qparams, cfg, state, _inputs(cfg, shape)["token"], rt)
    elif shape.kind == "prefill":
        out["tree_bytes"] = cache_bytes(params)
        with FlopCounterMode(display=False) as fc:
            _, state = M.prefill(params, cfg, _inputs(cfg, shape), S, rt)
        out["cache_bytes"] = cache_bytes(state)
    else:
        opt = AdamW(quantized_state=quantized_state)
        opt_state = opt.init(params)
        out.update(tree_bytes=cache_bytes(params), opt_bytes=cache_bytes(opt_state))
        with FlopCounterMode(display=False) as fc:
            make_train_step(cfg, rt, opt)(params, opt_state, _inputs(cfg, shape))
    out["flops"] = float(fc.get_total_flops())
    return out


def microbatches(shape: ShapeConfig, mesh) -> int:
    """The reference's ``build_step`` rule: double the microbatches while
    they divide the batch and a device's backward sees over 4,096 tokens."""
    dp_total = SH.axes_size(mesh, SH.data_axes(mesh))
    tokens_per_dev = shape.global_batch * shape.seq_len // dp_total
    mb = 1
    while (mb < shape.global_batch and shape.global_batch % (mb * 2) == 0
           and tokens_per_dev // mb > 4096):
        mb *= 2
    return mb


def _no_specs(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "specs"}


def _measure_mesh(cfg: ModelConfig, shape: ShapeConfig, variant: str,
                  quantized_state: bool, mesh) -> dict:
    """:func:`measure` for rank 0 of the counting ``mesh``: its blocks, its
    step, its flops and its collectives' bytes by kind."""
    from torch.utils.flop_counter import FlopCounterMode
    rt = runtime(shape.kind, variant, mesh=mesh)
    B, S = shape.global_batch, shape.seq_len
    inputs = _inputs(cfg, shape)
    bspecs = SH.input_shardings(cfg, shape, inputs, mesh)
    batch = {k: SH.shard(v, bspecs[k], mesh) for k, v in inputs.items()}
    out = {"opt_bytes": 0, "cache_bytes": 0}
    C.reset_stats()
    if shape.kind == "decode":
        tree = quantize_tree(M.abstract_params(cfg))
        specs = TR.mesh_param_specs(cfg, tree, mesh, serve=rt.serve_resident_moe)
        local = SH.shard_tree(tree, specs, mesh)
        state = M.init_decode_block(cfg, B, S, rt, device="meta")
        out.update(tree_bytes=cache_bytes(local),
                   cache_bytes=cache_bytes({"layers": state["layers"], "pos": state["pos"]}))
        with FlopCounterMode(display=False) as fc:
            M.decode_step(dict(local, specs=specs), cfg, state, batch["token"], rt)
    elif shape.kind == "prefill":
        tree = M.abstract_params(cfg)
        specs = TR.mesh_param_specs(cfg, tree, mesh)
        local = SH.shard_tree(tree, specs, mesh)
        out["tree_bytes"] = cache_bytes(local)
        with FlopCounterMode(display=False) as fc:
            _, state = M.prefill(dict(local, specs=specs), cfg, inputs, S, rt)
        out["cache_bytes"] = cache_bytes(_no_specs(state))
    else:
        tree = M.abstract_params(cfg)
        specs = TR.mesh_param_specs(cfg, tree, mesh)
        local = SH.shard_tree(tree, specs, mesh)
        opt = AdamW(quantized_state=quantized_state)
        opt_state = opt.init(local, specs, mesh)
        out.update(tree_bytes=cache_bytes(local), opt_bytes=cache_bytes(opt_state))
        step = jit_train_step(cfg, rt, opt, mesh, tree, specs, bspecs,
                              microbatches=microbatches(shape, mesh))
        with FlopCounterMode(display=False) as fc:
            step(dict(local, specs=specs), opt_state, batch)
    out["flops"] = float(fc.get_total_flops())
    out.update({f"coll:{k}": C.stats[k] for k in C.KINDS})
    return out


def count_cell(arch: str, shape_name: str, variant: str = "baseline",
               quick: bool = False, mesh: str = MESH) -> dict:
    """``cost``, ``memory`` (but the card's fields), ``counted_on`` and
    ``reduced`` of an applicable cell, counted on ``meta``: a quick cell
    uncut, a full one at two depths a layer group and scaled (see the
    module's docstring)."""
    return count_config(cell_config(arch, quick), (QUICK_SHAPES if quick else SHAPES)[shape_name],
                        variant, cut=not quick, mesh=mesh)


def count_config(cfg: ModelConfig, shape: ShapeConfig, variant: str = "baseline",
                 cut: bool = True, mesh: str = MESH) -> dict:
    """:func:`count_cell` of a configuration: with ``cut``, counted at two
    depths a layer group and scaled to ``cfg``'s depth."""
    qstate = cfg.param_count() > 50e9
    units = depth_units(cfg) if cut else []
    t0 = time.perf_counter()
    if not units:
        vals, reduced = measure(cfg, shape, variant, qstate, mesh), []
    else:
        ones = [1] * len(units)
        base = measure(cut_config(cfg, ones), shape, variant, qstate, mesh)
        vals = dict(base)
        for g, full in enumerate(units):
            step = measure(cut_config(cfg, [1 + (i == g) for i in range(len(units))]),
                           shape, variant, qstate, mesh)
            for k in vals:
                vals[k] += (full - 1) * (step[k] - base[k])
        names = ("dense layers", "MoE layers") if len(units) == 2 else (
            "periods" if cfg.family == "hybrid" else "layers",)
        reduced = [f"depth: counted at 1 and 2 {n} (of {u}) and scaled exactly"
                   for n, u in zip(names, units)]
    rec = {"cost": {"flops": vals["flops"], "counter": "torch.utils.flop_counter"},
           "memory": {"param_bytes": M.param_bytes(cfg),
                      "tree_bytes": int(vals["tree_bytes"]),
                      "cache_bytes": int(vals["cache_bytes"]),
                      "opt_bytes": int(vals["opt_bytes"])},
           "counted_on": "meta", "reduced": reduced,
           "count_s": time.perf_counter() - t0}
    if mesh != MESH:
        rec["collectives"] = C.kind_bytes({k: int(vals[f"coll:{k}"]) for k in C.KINDS})
        rec["counted_rank"] = 0
    return rec


def resident_bytes(kind: str, memory: dict) -> int:
    """Weights and state a cell holds: the tree and the decode state, and
    for training its gradients (the tree's size) and the optimizer's."""
    m = memory
    if kind == "train":
        return 2 * m["tree_bytes"] + m["opt_bytes"]
    return m["tree_bytes"] + m["cache_bytes"]


# ---------------------------------------------------------------------------
# peak memory of one real decode step on the card
# ---------------------------------------------------------------------------
def materialize(tree, device: torch.device, seed: int = 0):
    """A ``meta`` tree's leaves as random tensors on ``device``: int8 codes,
    small positive floats (a peak-memory run needs storage, not trained
    values)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(t):
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8,
                                 device=device)
        out = torch.rand(t.shape, generator=gen, dtype=torch.float32, device=device)
        return out.mul_(0.02).add_(1e-3).to(t.dtype)
    return convert.tree_map(tree, leaf)


def peak_decode(arch: str, shape_name: str, variant: str, quick: bool,
                device: torch.device, tree: int) -> dict:
    """``peak_bytes`` of one decode step at full width under ``fused_int8``
    over a state of the cell's batch, cut to the largest power of two whose
    weights (``tree`` bytes, as counted) and state take at most
    ``FIT_SHARE`` of the card's free bytes."""
    cfg = cell_config(arch, quick)
    shape = (QUICK_SHAPES if quick else SHAPES)[shape_name]
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(device)[0]
    B = shape.global_batch
    while B and tree + cache_bytes(M.init_decode_state(cfg, B, shape.seq_len,
                                                       device="meta")) > FIT_SHARE * free:
        B //= 2
    if not B:
        return {"peak_bytes": None, "peak_free_bytes": free,
                "peak_reason": f"int8 weights and one slot's state exceed {FIT_SHARE} of "
                               "the card's free bytes"}
    qparams = materialize(quantize_tree(M.abstract_params(cfg)), device)
    state = M.init_decode_state(cfg, B, shape.seq_len, device)
    token = torch.zeros((B,), dtype=torch.int32, device=device)
    rt = runtime("decode", variant, backend="fused_int8")
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = KN.launch_counts()
    logits, _ = M.decode_step(qparams, cfg, state, token, rt)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after = KN.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    del qparams, state, logits
    torch.cuda.empty_cache()
    out = {"peak_bytes": int(peak), "peak_batch": B, "peak_free_bytes": free,
           "peak_backend": "fused_int8",
           "peak_launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
           "peak_logits_finite": finite}
    if B < shape.global_batch:
        out["peak_cut"] = f"batch: peak measured at {B} of {shape.global_batch} slots"
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def out_path(arch: str, shape_name: str, variant: str = "baseline",
             quick: bool = False, mesh: str = MESH) -> Path:
    suffix = "" if variant == "baseline" else f"__{variant}"
    tag = mesh if mesh != MESH else ("quick" if quick else MESH)
    return ART / f"{arch}__{shape_name}__{tag}{suffix}.json"


def finish(rec: dict, counted: dict | Exception, device: torch.device,
           quick: bool) -> dict:
    """A record from its counts (or the error that stopped them) and, on the
    card, the cell's fit and its decode peak."""
    if rec.get("status") == "skipped":
        return rec
    if isinstance(counted, Exception):
        rec.update(status="skipped", reason=f"not counted: {type(counted).__name__}: "
                                             f"{counted}"[:400])
        return rec
    rec.update(counted)
    mem = rec["memory"]
    mem["resident_bytes"] = resident_bytes(rec["kind"], mem)
    card = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else None)
    mem["card_bytes"] = card
    mem["fits_one_card"] = None if card is None else mem["resident_bytes"] <= card
    if device.type == "cuda" and rec["kind"] == "decode" and rec["mesh"] == MESH:
        try:
            peak = peak_decode(rec["arch"], rec["shape"], rec["variant"], quick, device,
                               mem["tree_bytes"])
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            peak = {"peak_bytes": None, "peak_reason": f"OutOfMemoryError: {e}"[:300]}
        cut = peak.pop("peak_cut", None)
        if cut:
            rec["reduced"].append(cut)
        mem.update(peak)
    else:
        mem["peak_bytes"] = None
        mem["peak_reason"] = ("no card" if device.type != "cuda"
                              else "peak measured for one card's decode cells only")
    rec["status"] = "ok"
    return rec


def _count_or_error(arch, shape_name, variant, quick, mesh=MESH):
    try:
        return count_cell(arch, shape_name, variant, quick, mesh)
    except Exception as e:      # a cell that cannot be counted is skipped, not an error
        return e


def _worker_init():
    torch.set_num_threads(1)


def count_workers(cells: int) -> int:
    """Processes that count ``cells`` at once: one a cell, at most 6, two
    cores left to the host."""
    return max(1, min(cells, 6, (os.cpu_count() or 2) - 2))


def run_cells(cells: list[tuple[str, str]], variant: str = "baseline", quick: bool = False,
              force: bool = False, device: str | torch.device = "cuda",
              mesh: str = MESH) -> list[dict]:
    """Count ``cells`` on ``mesh`` (:func:`count_workers` spawned processes
    at once, or here where one is enough: a spawned process first spends
    seconds on its imports), finish each record in this process (the
    card's peak runs one at a time) and write it."""
    check_variant(variant, mesh)
    dev = resolve(device)
    set_float32_precision()
    recs, fresh, todo = {}, [], []
    for arch, sname in cells:
        path = out_path(arch, sname, variant, quick, mesh)
        if path.exists() and not force:
            recs[(arch, sname)] = json.loads(path.read_text())
            continue
        rec = base_record(arch, sname, variant, quick, mesh)
        recs[(arch, sname)] = rec
        fresh.append((arch, sname))
        if rec.get("status") != "skipped":
            todo.append((arch, sname))
    workers = count_workers(len(todo))
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                    initializer=_worker_init) as pool:
            futs = {cell: pool.submit(_count_or_error, *cell, variant, quick, mesh)
                    for cell in todo}
            counted = {cell: f.result() for cell, f in futs.items()}
    else:
        counted = {cell: _count_or_error(*cell, variant, quick, mesh) for cell in todo}
    for arch, sname in fresh:
        t0 = time.perf_counter()
        rec = recs[(arch, sname)]
        if (arch, sname) in counted:
            rec = recs[(arch, sname)] = finish(rec, counted[(arch, sname)], dev, quick)
        save(out_path(arch, sname, variant, quick, mesh), rec)
        coll = (f" collectives={rec['collectives']['total']:.4g}B"
                if rec["status"] == "ok" and "collectives" in rec else "")
        extra = (f"flops={rec['cost']['flops']:.4g}{coll} peak={rec['memory'].get('peak_bytes')} "
                 f"count={rec['count_s']:.1f}s finish={time.perf_counter() - t0:.1f}s"
                 if rec["status"] == "ok" else rec["reason"][:120])
        print(f"[{time.strftime('%H:%M:%S')}] {arch} x {sname} x {mesh} x {variant}: "
              f"{rec['status']} ({extra})", flush=True)
    return [recs[cell] for cell in cells]


def unexplained(recs: list[dict], quick: bool = False) -> list[dict]:
    """Records that are neither ``ok`` nor skipped for ``applicable``'s own
    reason: a cell that applies but was not counted is a failed run."""
    shapes = QUICK_SHAPES if quick else SHAPES
    return [r for r in recs if r.get("status") != "ok" and (
        r.get("status") != "skipped"
        or r.get("reason") != applicable(cell_config(r["arch"], quick), shapes[r["shape"]])[1])]


def save(path: Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


def run_quick(force: bool = False, device: str | torch.device = "cuda",
              variant: str = "baseline", mesh: str = MESH) -> list[dict]:
    """The reference's quick sweep (reduced configs x ``QUICK_SHAPES``),
    uncut on one device (or on ``mesh``, the reference's ``quick2x4``),
    and the manifest."""
    cells = [(a, s) for a in QUICK_ARCHS for s in QUICK_SHAPES]
    recs = run_cells(cells, variant, quick=True, force=force, device=device, mesh=mesh)
    save(ART / "quick_manifest.json",
         {"mesh": mesh, "artifacts": [out_path(a, s, variant, True, mesh).name
                                      for a, s in cells]})
    return recs


def all_cells() -> list[tuple[str, str]]:
    return [(arch, sname) for arch in registry.ASSIGNED for sname in SHAPES]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="one arch: its --shape, or every shape")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's reduced quick cells, uncut")
    ap.add_argument("--force", action="store_true", help="count again over saved records")
    ap.add_argument("--variant", default="baseline", choices=sorted(ALL_VARIANTS))
    ap.add_argument("--mesh", default=MESH, choices=[MESH, *MESHES],
                    help="one card, or a mesh counted for one rank")
    ap.add_argument("--multi-pod", action="store_true", help="--mesh pod2x16x16")
    ap.add_argument("--both-meshes", action="store_true", help="pod16x16 and pod2x16x16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    meshes = (["pod16x16", "pod2x16x16"] if args.both_meshes
              else ["pod2x16x16"] if args.multi_pod else [args.mesh])
    for mesh in meshes:
        check_variant(args.variant, mesh)
    bad = []
    for mesh in meshes:
        if args.quick:
            recs = run_quick(args.force, args.device, args.variant, mesh)
        elif args.all:
            recs = run_cells(all_cells(), args.variant, force=args.force, device=args.device,
                             mesh=mesh)
        elif args.arch:
            shapes = [args.shape] if args.shape else list(SHAPES)
            recs = run_cells([(args.arch, s) for s in shapes], args.variant, force=args.force,
                             device=args.device, mesh=mesh)
        else:
            ap.error("give --arch (and --shape), --all or --quick")
        bad += unexplained(recs, args.quick)
    for r in bad:
        print(f"{r['arch']} x {r['shape']} x {r['mesh']}: {r.get('status')}: "
              f"{r.get('reason')}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
