"""The rank programs of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_mesh_train_families.py``: each runs in a spawned process
of a gloo world (``repro_torch.launch.mesh.start``) and returns numpy
arrays for the test process to hold against the reference and against
one process.  Nothing here imports JAX, so a rank starts in about a
second.  The gradients and parameters a rank returns are gathered whole
and laid out as the reference's tree (``convert.to_numpy``).
"""
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokens, put_batch
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.ft.compress import compress, compressed_psum
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as TS

LR = 1e-3
BATCH = 4
# the families' sequence lengths: the reference's SSD gradient is NaN past
# a few tokens (tests/test_torch_train.py), so SSM stacks train at 4
SEQ = {"mamba2-2.7b": 4, "jamba-1.5-large-398b": 4}
FAMILIES = ("grok-1-314b", "deepseek-v3-671b", "mamba2-2.7b", "jamba-1.5-large-398b",
            "chameleon-34b", "whisper-tiny")
# a tree for the int8 moments on a mesh: last dims split inside a 128-block
# (384 over 2 ranks), on whole blocks (512), and the per-tensor fallback
ADAM_SHAPES = {"inside": ((4, 384), (None, "model")), "whole": ((2, 512), ("data", "model")),
               "fallback": ((6, 100), ("data", None)), "rows": ((8, 256), ("model", None))}


def join_all(worlds: dict) -> dict:
    """Every world of ``worlds`` (name -> ``launch.mesh.World``) joined, each
    even where another failed -> name -> its ranks' results; raises after
    the last join, naming every world that failed."""
    out, errors = {}, []
    for name, w in worlds.items():
        try:
            out[name] = w.join()
        except RuntimeError as e:
            errors.append(f"{name}: {e}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def seq_len(arch: str) -> int:
    return SEQ.get(arch, 16)


def setup(arch: str, seq: int | None = None, batch: int = BATCH):
    """The reduced config, the seeded whole params and a batch of the
    pipeline (the reference's batch, bit for bit)."""
    cfg = ARCHS[arch].reduced()
    params = M.init_params(cfg, 0, "cpu")
    shape = ShapeConfig("t", seq or seq_len(arch), batch, "train")
    return cfg, params, SyntheticTokens(cfg, shape, seed=3).batch_at(0)


def gather(tree, specs, mesh):
    """The whole tree from a rank's blocks."""
    if isinstance(tree, dict):
        return {k: gather(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v, s, mesh) for v, s in zip(tree, specs))
    return SH.unshard(tree, specs, mesh)


def placed(cfg, params, mesh):
    """A rank's blocks of ``params`` with their ``specs``."""
    specs = T.mesh_param_specs(cfg, params, mesh)
    return dict(SH.shard_tree(params, specs, mesh), specs=specs), specs


def batch_block(cfg, data, mesh):
    """The rank's block of the batch (``put_batch`` by ``input_shardings``)
    and its specs."""
    shape = ShapeConfig("t", 0, next(iter(data.values())).shape[0], "train")
    bspecs = SH.input_shardings(cfg, shape, data, mesh)
    return put_batch(data, "cpu", bspecs, mesh), bspecs


def ref_layout(cfg, tree):
    return convert.to_numpy(tree, cfg)


def step_job(mesh, arch: str, seq_shard: bool = False, remat: bool = False,
             microbatches: int = 1, rows: bool = False, update: bool = True) -> dict:
    """One training step on ``mesh``: the loss and gradient norm on every
    rank; on rank 0 the whole gradient (before the update) and (with
    ``update``) the whole params after one AdamW step (f32 moments, lr
    1e-3); with ``rows`` the residual's rows each layer saw (the block
    under ``seq_shard``)."""
    cfg, params, data = setup(arch)
    rt = T.Runtime(mesh=mesh, remat=remat, seq_shard=seq_shard)
    local, specs = placed(cfg, params, mesh)
    batch, bspecs = batch_block(cfg, data, mesh)
    split = bool(SH.live(bspecs["labels"], mesh)[0])
    seen = []
    if rows:
        inner = T.apply_layer_train

        def watch(p, cfg_, i, x, *a, **kw):
            seen.append(int(x.shape[1]))
            return inner(p, cfg_, i, x, *a, **kw)
        T.apply_layer_train = watch
    try:
        C.reset_stats()
        loss, grads = TS.value_and_grad(local, cfg, batch, rt, split)
        grads = TS.reduce_grads(grads, specs, mesh)
        stats = dict(C.stats)
    finally:
        if rows:
            T.apply_layer_train = inner
    out = {"loss": float(loss), "stats": stats, "rows": seen}
    whole_g = gather(grads, specs, mesh)
    if mesh.rank == 0:
        out["grads"] = ref_layout(cfg, whole_g)
    if not update:
        return out
    opt = AdamW(lr=LR, warmup_steps=0, total_steps=10)
    body = {k: v for k, v in local.items() if k != "specs"}
    state = opt.init(body, specs, mesh)
    step = TS.jit_train_step(cfg, rt, opt, mesh, params, specs, bspecs, microbatches)
    t0 = time.perf_counter()
    _, state, metrics = step(local, state, batch)
    out.update(step_loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               step_s=time.perf_counter() - t0)
    whole_p = gather(body, specs, mesh)
    if mesh.rank == 0:
        out["params"] = ref_layout(cfg, whole_p)
    return out


def one_process_step(arch: str, microbatches: int = 1, remat: bool = False) -> dict:
    """:func:`step_job`'s numbers in one process: loss, grads, params after
    the step (the reference's layout)."""
    cfg, params, data = setup(arch)
    rt = T.Runtime(remat=remat)
    batch = put_batch(data, "cpu")
    loss, grads = TS.value_and_grad(params, cfg, batch, rt)
    opt = AdamW(lr=LR, warmup_steps=0, total_steps=10)
    p = convert.tree_map(params, torch.clone)
    _, _, m = TS.make_train_step(cfg, rt, opt, microbatches)(p, opt.init(p), batch)
    return {"loss": float(loss), "step_loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "grads": ref_layout(cfg, grads),
            "params": ref_layout(cfg, p)}


def adam_tree(seed: int = 5) -> tuple[dict, dict, dict]:
    """Whole params, gradients and their specs of :data:`ADAM_SHAPES`."""
    rng = np.random.default_rng(seed)
    ps, gs, specs = {}, {}, {}
    for k, (shape, spec) in ADAM_SHAPES.items():
        ps[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        gs[k] = torch.from_numpy((rng.standard_normal(shape) * 1e-2).astype(np.float32))
        specs[k] = spec
    return ps, gs, specs


def adam_int8(params: dict, grads: dict, specs: dict | None = None, mesh=None,
              steps: int = 2) -> dict:
    """``steps`` AdamW updates with int8 moments (no clip: a norm's float
    order would move every element) -> the params, codes and scales (the
    rank's blocks on a mesh) and the gradient norms."""
    opt = AdamW(lr=LR, warmup_steps=0, total_steps=10, quantized_state=True, clip_norm=1e9)
    state = opt.init(params, specs, mesh)
    norms = []
    for _ in range(steps):
        _, state, gn = opt.update(grads, state, params, mesh=mesh, specs=specs)
        norms.append(float(gn))
    return {"params": params, "m": state.m, "v": state.v, "norms": norms}


def adam_job(mesh) -> dict:
    """:func:`adam_int8` on the rank's blocks of :func:`adam_tree`, each
    result gathered whole (the scales by their placement)."""
    ps, gs, specs = adam_tree()
    local = {k: SH.shard(v, specs[k], mesh) for k, v in ps.items()}
    lg = {k: SH.shard(v, specs[k], mesh) for k, v in gs.items()}
    out = adam_int8(local, lg, specs, mesh)
    from repro_torch.train.train_step import opt_state_shardings
    st = opt_state_shardings(AdamW(quantized_state=True), ps, specs, mesh)
    res = {"params": {k: SH.unshard(v, specs[k], mesh).numpy() for k, v in out["params"].items()},
           "norms": out["norms"]}
    for name in ("m", "v"):
        res[name] = {k: {"q": SH.unshard(v["q"], specs[k], mesh).numpy(),
                         "s": SH.unshard(v["s"], getattr(st, name)[k]["s"], mesh).numpy()}
                     for k, v in out[name].items()}
    return res


def compress_inputs(n: int, shapes=((5, 7), (3,), (4, 4, 2))) -> list:
    """Rank r's gradients and residuals of a world of ``n``."""
    out = []
    for r in range(n):
        rng = np.random.default_rng(100 + r)
        g = [rng.standard_normal(s).astype(np.float32) * (r + 1) for s in shapes]
        res = [rng.standard_normal(s).astype(np.float32) * 1e-3 for s in shapes]
        out.append((g, res))
    return out


def compress_job(mesh, axes) -> dict:
    """``compressed_psum`` over ``axes`` of this rank's inputs (its index in
    the group picks them), with the rank's own ``compress``."""
    group = mesh.group(axes)
    g, res = compress_inputs(group.size)[group.index]
    gt, rt_ = [torch.from_numpy(x) for x in g], [torch.from_numpy(x) for x in res]
    mean, new_res = compressed_psum(gt, rt_, group)
    own = [compress(a, b) for a, b in zip(gt, rt_)]
    return {"index": group.index, "mean": [m.numpy() for m in mean],
            "residuals": [r.numpy() for r in new_res],
            "codes": [o[0].numpy() for o in own], "scales": [float(o[1]) for o in own]}


def ckpt_save_job(mesh, arch: str, path: str) -> dict:
    """One step on ``mesh`` (int8 moments), then a checkpoint of the
    rank's params and moments at ``path``; rank 0 returns the whole tree
    it saved."""
    cfg, params, data = setup(arch)
    rt = T.Runtime(mesh=mesh)
    local, specs = placed(cfg, params, mesh)
    batch, bspecs = batch_block(cfg, data, mesh)
    body = {k: v for k, v in local.items() if k != "specs"}
    opt = AdamW(lr=LR, warmup_steps=0, total_steps=10, quantized_state=True)
    state = opt.init(body, specs, mesh)
    _, state, _ = TS.jit_train_step(cfg, rt, opt, mesh, params, specs, bspecs)(local, state,
                                                                                batch)
    from repro_torch.train.train_step import opt_state_shardings
    tree_specs = {"params": specs, "opt": opt_state_shardings(opt, params, specs, mesh)}
    tree = {"params": body, "opt": state}
    CK.save(path, 1, tree, {"arch": arch}, specs=tree_specs, mesh=mesh)
    ck = CK.AsyncCheckpointer(path + "_async", keep=1)
    ck.save(2, tree, {"arch": arch}, specs=tree_specs, mesh=mesh)
    ck.wait()                           # rank 0's thread joined, the others saw COMMIT
    committed = CK.latest_step(path + "_async")
    whole = CK._whole(tree, tree_specs, mesh)
    return {"saved": _np_tree(whole) if mesh.rank == 0 else None, "async_step": committed}


def ckpt_restore_job(mesh, arch: str, path: str, quantized: bool = True) -> dict:
    """The rank's blocks of the checkpoint at ``path`` (waiting for its
    ``COMMIT``), restored onto ``mesh``."""
    cfg, params, _ = setup(arch)
    specs = T.mesh_param_specs(cfg, params, mesh)
    body = SH.shard_tree(params, specs, mesh)
    opt = AdamW(quantized_state=quantized)
    from repro_torch.train.train_step import opt_state_shardings
    like = {"params": body, "opt": opt.init(body, specs, mesh)}
    tree_specs = {"params": specs, "opt": opt_state_shardings(opt, params, specs, mesh)}
    CK._wait_commit(Path(path) / "step_1", timeout_s=120.0)
    got, extra = CK.restore(path, like, specs=tree_specs, mesh=mesh)
    return {"blocks": _np_tree(got), "extra": extra}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def world(rank: int, shape: tuple[int, int], jobs: list) -> dict:
    """Run ``jobs`` (``(name, kind, kwargs)``) on the (d, m) mesh of this
    world, in order (every rank runs every job)."""
    mesh = MS.make_local_mesh(*shape)
    kinds = {"step": step_job, "adam": adam_job, "compress": compress_job,
             "save": ckpt_save_job, "restore": ckpt_restore_job}
    out = {}
    for name, kind, kw in jobs:
        t0 = time.perf_counter()
        out[name] = kinds[kind](mesh, **kw)
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0
    return out


def card_train_pair(rank: int) -> dict:
    """A rank of a 1x2 world on the card: ``chip_smoke.mesh_train_pair``
    (llama3-8b at full width with 2 layers, with and without ``seq_shard``;
    rank 0 also takes one process's step)."""
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as CS
    from repro_torch.device import set_float32_precision
    torch.cuda.set_device(0)
    set_float32_precision()
    return CS.mesh_train_pair(torch, MS.make_local_mesh(1, 2))
