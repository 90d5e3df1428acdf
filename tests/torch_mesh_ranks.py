"""The rank programs of ``tests/test_torch_mesh.py``: each runs in a
spawned process of a gloo world (``repro_torch.launch.mesh.start``) and
returns numpy arrays and lists for the test process to hold against the
reference.  Nothing here imports JAX, so a rank starts in about a second.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCHS
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.quantize import quantize_tree

BACKENDS = ("ref_int8", "fused_int8", "pim_bitserial", "dense")
COLLECTIVES = ("psum", "htree")
LANES = {"plain": {}, "multi_step": {"multi_step": 4}, "chunk": {"chunk": 4},
         "spec_k": {"spec_k": 3}}
ENGINE_ARCHS = {"llama3-8b": True, "grok-1-314b": False}     # arch -> quantize
# the families and the lanes that serve on a mesh since A.14b's serving half
NEW_FAMILIES = ("mamba2-2.7b", "jamba-1.5-large-398b", "deepseek-v3-671b", "whisper-tiny")
NEW_LANES = ({"prefix_cache": True, "chunk": 4}, {"kv_swap": True}, {"faults": True})
# (n_experts, T, serve) -> the MoE layout it reaches on each mesh
MOE_CASES = {(1, 2): [(4, 1, True), (4, 4, False), (3, 4, False)],
             (2, 2): [(4, 1, True), (2, 1, True), (3, 1, True)]}


def trace(cfg):
    """The reference's sharded-serve trace: 10 requests, prompts of 3-16
    tokens, budgets of 2-11, from seed 7."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(3, 17)).tolist()
               for _ in range(10)]
    budgets = [int(rng.integers(2, 12)) for _ in range(10)]
    return prompts, budgets


def moe_inputs(E: int, T_: int):
    """grok's reduced MoE with ``E`` experts: (cfg, params, x [8, T, d])."""
    cfg = dataclasses.replace(ARCHS["grok-1-314b"].reduced(), n_experts=E)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg)
    x = np.random.default_rng(E * 10 + T_).standard_normal((8, T_, cfg.d_model))
    return cfg, p, torch.from_numpy(x.astype(np.float32))


def _linears(mesh) -> dict:
    """Column- and row-parallel linears against the whole linear, under
    every backend (the kernels' plain versions on the CPU)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    q = L.quantize_linear_params({"w": w})
    m = mesh.group("model")
    cols = SH.block(96, mesh, ("model",))
    rows = SH.block(64, mesh, ("model",))
    out = {}
    for backend in BACKENDS:
        lin = {"w": w} if backend == "dense" else q
        whole = L.apply_linear(lin, x, backend)
        col = {"w": w[:, cols]} if backend == "dense" else {"w_q": q["w_q"][:, cols],
                                                             "w_s": q["w_s"][cols]}
        row = {"w": w[rows]} if backend == "dense" else {"w_q": q["w_q"][rows], "w_s": q["w_s"]}
        for coll in COLLECTIVES:
            red = L.RowReduce(m, coll)
            got_row = L.apply_linear(row, x[:, rows], backend, reduce=red)
            out[(backend, coll)] = (whole.numpy(), L.apply_linear(col, x, backend).numpy(),
                                    whole[:, cols].numpy(), got_row.numpy())
    return out


FAMILY_ARCHS = ("opt-125m", "chameleon-34b")   # tied LayerNorm MHA; QK-norm GQA


def _decode(mesh, backends=("ref_int8", "dense"), device: str = "cpu",
            arch: str = "llama3-8b") -> dict:
    """One decode step of ``arch`` from the same prefilled state, one
    device against the mesh: logits and the rank's block of the pool after
    it."""
    cfg = ARCHS[arch].reduced()
    params = T.init_params(cfg, 0, device)
    qp = quantize_tree(params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 9)))
    toks = toks.to(device)
    lengths = torch.tensor([9, 5, 7, 3], dtype=torch.int32, device=device)
    out = {}
    for backend in backends:
        rt1 = T.Runtime(backend)
        logits, st = T.prefill(params, cfg, toks, 32, rt1, lengths=lengths)
        tok = torch.argmax(logits, -1)
        for coll in COLLECTIVES:
            rt = T.Runtime(backend, mesh=mesh, collective=coll, serve_resident_moe=True)
            fp, qpl = T.shard_pair(cfg, params, qp, rt)
            blk = T.decode_block_of(cfg, st, rt)
            lo, hi, _ = blk["block"]
            one = {"layers": [{k: v.clone() for k, v in c.items()} for c in st["layers"]],
                   "pos": st["pos"].clone()}
            want, one = T.decode_step(qp, cfg, one, tok, rt1)
            got, blk = T.decode_step(qpl, cfg, blk, tok[lo:hi], rt)
            pool_want = T.decode_block_of(cfg, one, rt)
            pools_equal = all(torch.equal(a, b) for la, lb in zip(blk["layers"],
                                                                 pool_want["layers"])
                              for a, b in zip(la.values(), lb.values()))
            out[(backend, coll)] = (want[lo:hi].cpu().numpy(), got.cpu().numpy(), pools_equal)
    return out


def card_decode(rank: int) -> dict:
    """A 1x2 world on the card (both ranks on ``cuda:0``): the llama decode
    step under ``fused_int8`` (B1, B2 and the fused norm on each rank's
    block) against one process's."""
    torch.cuda.set_device(0)
    return _decode(MS.make_local_mesh(1, 2), ("fused_int8",), "cuda")


def _moe(mesh, shape) -> dict:
    """Each MoE case of ``MOE_CASES`` through ``_moe_block`` under both
    collectives, a decode call's rows also split over the data axes."""
    out = {}
    for E, T_, serve in MOE_CASES[shape]:
        cfg, p, x = moe_inputs(E, T_)
        for coll in COLLECTIVES:
            rt = T.Runtime(mesh=mesh, collective=coll, serve_resident_moe=serve)
            specs = T.mesh_param_specs(cfg, {"layers": [{"moe": p}]}, mesh,
                                       serve=serve)["layers"][0]["moe"]
            local = SH.shard_tree(p, specs, mesh)
            strat = (SH.moe_serve_strategy(cfg, mesh) if serve
                     else SH._moe_train_strategy(cfg, mesh))
            got = T._moe_block(local, x, cfg, rt, specs)
            lo, hi = T.slot_block(8, rt)
            part = T._moe_block(local, x[lo:hi], cfg, rt, specs, split=hi - lo < 8)
            out[(E, T_, serve, coll)] = (strat, got.numpy(), part.numpy(), (lo, hi))
    return out


def _sharded_init(mesh) -> dict:
    """``init_params_sharded`` (a rank draws a piece at a time) against
    ``place_params`` of the whole tree: the same blocks and specs, float
    and decode tree, for llama, grok and the families of
    ``NEW_FAMILIES`` (deepseek's MTP head drawn last, whisper whole)."""
    from repro_torch.models import model as M
    out = {}
    for arch in (*ENGINE_ARCHS, *NEW_FAMILIES):
        cfg = ARCHS[arch].reduced()
        rt = T.Runtime(mesh=mesh, serve_resident_moe=True)
        a = T.init_params_sharded(cfg, rt, 0, "cpu")
        b = T.place_params(cfg, M.init_params(cfg, 0, "cpu"), True, rt)
        out[arch] = all(x["specs"] == y["specs"] and _same(x, y) for x, y in zip(a, b))
    return out


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a if k != "specs")
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _engines(mesh) -> dict:
    out = {}
    for arch, quantize in ENGINE_ARCHS.items():
        cfg = ARCHS[arch].reduced()
        params = T.init_params(cfg, 0, "cpu")
        prompts, budgets = trace(cfg)
        for lane, kw in LANES.items():
            rt = T.Runtime(mesh=mesh, data_axes=("data",), serve_resident_moe=True)
            eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=48,
                                           quantize=quantize, rt=rt, device="cpu", **kw)
            out[(arch, lane)] = eng.generate_all(prompts, budgets)
    return out


def _new_lanes(mesh) -> list:
    """llama's continuous engine on the trace with each lane of
    ``NEW_LANES`` -> (streams, stats less the clocks) each."""
    cfg = ARCHS["llama3-8b"].reduced()
    params = T.init_params(cfg, 0, "cpu")
    rt = T.Runtime(mesh=mesh, data_axes=("data",), serve_resident_moe=True)
    return [lane_run(cfg, params, kw, rt) for kw in NEW_LANES]


def lane_run(cfg, params, kw: dict, rt=None) -> tuple:
    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=48, rt=rt, device="cpu",
                                   **kw)
    outs = eng.generate_all(*trace(cfg))
    return outs, {k: v for k, v in eng.stats.items()
                  if k not in ("device_s", "step_s", "slow_steps")}


def world(rank: int, shape: tuple[int, int], engines: bool) -> dict:
    """The (d, m) world's checks: the linears, the decode step, the MoE
    cases and (``engines``) both engines on the reference's trace."""
    mesh = MS.make_local_mesh(*shape)
    C.reset_stats()
    res = {"linears": _linears(mesh), "decode": _decode(mesh),
           "moe": _moe(mesh, shape)}
    if shape == (1, 2):
        res["families"] = {a: _decode(mesh, ("ref_int8",), arch=a) for a in FAMILY_ARCHS}
        res["sharded_init"] = _sharded_init(mesh)
    if engines:
        res["engines"] = _engines(mesh)
        res["new_lanes"] = _new_lanes(mesh)
    if shape == (2, 2):
        # the same world as a 1x4 mesh: llama's 2 KV heads do not tile 4 ranks
        # (every rank runs every head), its FFN and vocabulary do
        res["decode_1x4"] = _decode(MS.make_local_mesh(1, 4), ("ref_int8",))
    res["stats"] = dict(C.stats)
    return res


def htree_world(rank: int, xs: dict) -> dict:
    """For each group size n in ``xs`` (a group of the first n ranks):
    ``htree_allreduce`` and ``all_reduce`` of this rank's ``xs[n][rank]``,
    the H-tree's rounds, and an int32 sum both ways."""
    out = {}
    for n, x in sorted(xs.items()):
        ranks = list(range(n))
        pg = dist.new_group(ranks, backend="gloo")     # every rank makes every group
        if rank >= n:
            continue
        g = MS.AxisGroup(("model",), ranks, rank, pg)
        t = torch.from_numpy(x[rank])
        before = C.stats["htree_rounds"]
        tree = C.htree_allreduce(t, g)
        rounds = C.stats["htree_rounds"] - before
        ring = C.allreduce(t, g, "psum")
        ints = torch.from_numpy((x[rank] * 1000).astype(np.int32))
        out[n] = (tree.numpy(), ring.numpy(), rounds,
                  torch.equal(C.htree_allreduce(ints, g), C.allreduce(ints, g, "psum")))
    return out
