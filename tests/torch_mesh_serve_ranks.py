"""The rank programs of ``tests/test_torch_mesh_lanes.py`` and
``tests/test_torch_mesh_families.py``: each runs in a spawned process of a
gloo world (``repro_torch.launch.mesh.start``) and returns numpy arrays,
lists and stats for the test process to hold against the reference.
Nothing here imports JAX, so a rank starts in about a second.  The card
tests' rank programs (``card_*``, the families' ``mesh_family_*``) are
here too; the families' use ``chip_smoke.py``'s helpers.
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.dist import collectives as C
from repro_torch.launch import mesh as MS
from repro_torch.models import encdec as ED
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.kv_swap import to_host
from repro_torch.serve.quantize import quantize_tree

if str(Path(__file__).resolve().parents[1]) not in sys.path:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402  (the repo's root, on the path above)

# stats that read a clock (the watchdog's verdict included)
CLOCKS = ("device_s", "step_s", "slow_steps")
LANE_KW = {
    "swap": dict(n_slots=2, max_len=32, chunk=4, policy="fair:3", kv_swap=True),
    "prefix": dict(n_slots=2, max_len=48, chunk=4, prefix_cache=True),
    "faults": dict(n_slots=2, max_len=48, chunk=4, retry_backoff_s=0.0),
    "faults_swap": dict(n_slots=2, max_len=32, chunk=4, policy="fair:3", kv_swap=True,
                        retry_backoff_s=0.0),
}
FAMILIES = ("mamba2-2.7b", "jamba-1.5-large-398b", "deepseek-v3-671b", "whisper-tiny")


def injector(lane: str):
    """The lane's fault injector (the reference tests' schedule; with the
    cold tier, NAND flips at a BER the ECC corrects and fails by turns)."""
    if lane == "faults":
        return FaultInjector(seed=0, step_fail_at=(7, 19), slot_loss_at=((13, 0),))
    if lane == "faults_swap":
        return FaultInjector(seed=0, ber=2e-3, step_fail_at=(7, 19), slot_loss_at=((13, 0),))
    return None


def run_lane(cfg, params, lane: str, prompts, budgets, rt=None) -> tuple:
    """The lane's engine over the trace -> (streams, stats less the clocks,
    quarantined slots)."""
    eng = ContinuousBatchingEngine(cfg, params, rt=rt, device="cpu", faults=injector(lane),
                                   **LANE_KW[lane])
    outs = eng.generate_all(prompts, budgets)
    stats = {k: v for k, v in eng.stats.items() if k not in CLOCKS}
    return outs, stats, sorted(eng.scheduler.quarantined)


def _pool(cfg, n_slots: int, rows: int, seed: int, device: str = "cpu") -> dict:
    """A whole pool of seeded codes and scales (the same on every rank)."""
    g = torch.Generator().manual_seed(seed)
    st = M.init_decode_state(cfg, n_slots, rows, "cpu")
    for c in st["layers"]:
        for k, v in c.items():
            if v.dtype == torch.int8:
                v.copy_(torch.randint(-127, 128, v.shape, generator=g, dtype=torch.int8))
            else:
                v.copy_(torch.rand(v.shape, generator=g) + 0.01)
    st["pos"].copy_(torch.tensor([rows // 2 + i for i in range(n_slots)], dtype=torch.int32))
    return {"layers": [{k: v.to(device) for k, v in c.items()} for c in st["layers"]],
            "pos": st["pos"].to(device)}


def _same_block(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for la, lb in zip(a["layers"], b["layers"])
               for x, y in zip(la.values(), lb.values())) and torch.equal(a["pos"], b["pos"])


def row_moves(rt, cfg, device: str = "cpu") -> dict:
    """A cross-shard ``copy_slot_prefix`` (slot 0 to slot 1, another data
    owner on 2x2) against one device's on the same whole pool, and a
    swapped row (``gather_slot_row``) of slot 1's live rows against the
    whole pool's ``read_slot``, plus its host block for the checksums."""
    whole = _pool(cfg, 2, 16, 5, device)
    blk = T.decode_block_of(cfg, whole, rt)
    T.copy_slot_prefix(blk, 0, 1, 6, rt)
    one = {"layers": [{k: v.clone() for k, v in c.items()} for c in whole["layers"]],
           "pos": whole["pos"].clone()}
    T.copy_slot_prefix(one, 0, 1, 6)
    copied = _same_block(blk, T.decode_block_of(cfg, one, rt))
    n = int(whole["pos"][1])           # a swap lifts the slot's live rows
    row = T.gather_slot_row(cfg, T.decode_block_of(cfg, whole, rt), 1, n, rt)
    want = T.read_slot(whole, 1, n)
    return {"copy_equal": bool(copied), "row_equal": bool(_same_block(row, want)),
            "row": to_host(row), "whole_row": to_host(want)}


def lanes_world(rank: int, traces: dict) -> dict:
    """The 2x2 world's lanes: llama3-8b ``.reduced()`` (quantized) on each
    lane's trace, and the row moves."""
    mesh = MS.make_local_mesh(2, 2)
    cfg = ARCHS["llama3-8b"].reduced()
    params = T.init_params(cfg, 0, "cpu")
    rt = T.Runtime(mesh=mesh, data_axes=("data",), serve_resident_moe=True)
    C.reset_stats()
    out = {lane: run_lane(cfg, params, lane, *traces[lane], rt=rt) for lane in traces}
    out["moves"] = row_moves(rt, cfg)
    out["stats"] = dict(C.stats)
    return out


def failing_world(rank: int, fail_at: int) -> dict:
    """A 1x2 world whose rank 1 raises inside its engine step ``fail_at``
    (outside any injection): rank 0 must raise in its next collective, not
    wait for gloo's timeout.  Returns (rank 0) what it raised and when."""
    mesh = MS.make_local_mesh(1, 2)
    cfg = ARCHS["llama3-8b"].reduced()
    rt = T.Runtime(mesh=mesh, data_axes=("data",), serve_resident_moe=True)
    eng = ContinuousBatchingEngine(cfg, T.init_params(cfg, 0, "cpu"), n_slots=2, max_len=32,
                                   rt=rt, device="cpu")
    if rank == 1:
        step = eng._step

        def broken():
            if eng.stats["steps"] >= fail_at:
                raise ValueError("a fault outside any injection")
            return step()
        eng._step = broken
    t0 = time.monotonic()
    try:
        eng.generate_all([[1, 2, 3, 4]] * 3, [8] * 3)
    except Exception as e:                      # noqa: BLE001
        if rank == 1:
            raise
        return {"raised": type(e).__name__, "after_s": time.monotonic() - t0}
    return {"raised": None, "after_s": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------
def family_trace(cfg, seed: int = 7, n: int = 10, lo: int = 3, hi: int = 17,
                 budgets: tuple = (2, 12)) -> tuple[list, list]:
    """The reference's sharded-serve trace (seed 7: 10 requests, prompts of
    3-16 tokens, budgets of 2-11), or the seed-17 trace's shape."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(lo, hi)).tolist()
               for _ in range(n)]
    return prompts, [int(rng.integers(*budgets)) for _ in range(n)]


def seed17_trace(cfg) -> tuple[list, list]:
    """``TestMeshRope::test_seed17_rope_parity_pinned``'s trace: 6 requests,
    prompts of 3-14 tokens, budgets of 2-7."""
    return family_trace(cfg, 17, 6, 3, 15, (2, 8))


def frames(cfg, batch: int, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))


def fixed_batch(cfg) -> dict:
    """``Engine.generate``'s batch: 2 prompts of 5 tokens (and frames)."""
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 5)))
    if cfg.family == "encdec":
        return {"frames": frames(cfg, 2), "tokens": toks}
    return {"inputs": toks}


def _prefilled(cfg, params, rt1):
    """One device's prefilled state of 4 rows and their first tokens."""
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 9)))
    if cfg.family == "encdec":
        logits, st = ED.prefill(params, cfg, frames(cfg, 4), toks[:, :5], 32, rt1)
    else:
        lengths = None if T.has_ssm(cfg) else torch.tensor([9, 5, 7, 3], dtype=torch.int32)
        logits, st = T.prefill(params, cfg, toks, 32, rt1, lengths=lengths)
    return st, torch.argmax(logits, -1)


def _clone(st: dict) -> dict:
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in st["layers"]],
            "pos": st["pos"].clone()}


def _leaf_diffs(a: dict, b: dict) -> list[float]:
    return [float((x.double() - y.double()).abs().max())
            for la, lb in zip(a["layers"], b["layers"]) for x, y in zip(la.values(),
                                                                        lb.values())]


def family_step(mesh, arch: str) -> dict:
    """One ``ref_int8`` decode step of ``arch`` from one device's prefilled
    state, one device against the mesh.  A stack without MoE layers runs
    the step whole: its logits and every state leaf (the rank's block,
    gathered over the mesh by the test) against one device's.  A MoE stack
    runs it layer by layer from one device's inputs to each layer: each
    layer's mixer (the FFN's input) and its state leaves bit for bit, a
    dense FFN's output bit for bit, each MoE block's input rows and output
    (held by the test against JAX's ``moe_apply``), and the step's logits."""
    cfg = ARCHS[arch].reduced()
    params = M.init_params(cfg, 0, "cpu")
    qp = quantize_tree(params)
    rt1 = T.Runtime("ref_int8")
    rt = T.Runtime("ref_int8", mesh=mesh, serve_resident_moe=True)
    st, tok = _prefilled(cfg, params, rt1)
    _, qpl = T.place_params(cfg, params, True, rt)
    blk = T.decode_block_of(cfg, st, rt)
    lo, hi, _ = blk["block"]
    one = _clone(st)
    moe = T.has_moe(cfg)
    rec: dict = {"one": [], "mesh": [], "ffn_one": [], "ffn_mesh": [], "moe": []}
    layer, ffn, moe_block = T.apply_layer_decode, T._ffn, T._moe_block
    mode = {"side": "one"}

    def layer_hook(p, cfg_, x, pos, cache, rt_, lm=None):
        if mode["side"] == "one":
            rec["one"].append(x.clone())
        else:                       # the mesh layer starts from one device's input
            x = rec["one"][len(rec["mesh"])][lo:hi]
            rec["mesh"].append(x)
        return layer(p, cfg_, x, pos, cache, rt_, lm)

    def ffn_hook(p, cfg_, x, rt_, lm=None):
        out = ffn(p, cfg_, x, rt_, lm)
        rec["ffn_" + mode["side"]].append((x.clone(), out.clone(), "moe" in p))
        return out

    def moe_hook(p, x, cfg_, rt_, stored, split=False):
        out = moe_block(p, x, cfg_, rt_, stored, split)
        rec["moe"].append((x.numpy().copy(), out.numpy().copy()))
        return out

    if moe:
        T.apply_layer_decode, T._ffn, T._moe_block = layer_hook, ffn_hook, moe_hook
    try:
        want, one = M.decode_step(qp, cfg, one, tok, rt1)
        mode["side"] = "mesh"
        got, blk = M.decode_step(qpl, cfg, blk, tok[lo:hi], rt)
    finally:
        T.apply_layer_decode, T._ffn, T._moe_block = layer, ffn, moe_block
    gather = {"layers": [{k: _gather_leaf(v, c_cut.get(k), rt) for k, v in c.items()}
                         for c, c_cut in zip(blk["layers"], T.layer_cuts(cfg, rt))],
              "pos": blk["pos"]}
    whole_blk = {"layers": [{k: v[lo:hi] for k, v in c.items()} for c in one["layers"]],
                 "pos": one["pos"][lo:hi]}
    out = {"logits": (want[lo:hi].numpy(), got.numpy()),
           "state_diffs": _leaf_diffs(gather, whole_blk), "moe": moe, "block": (lo, hi)}
    if moe:
        out["mixer_equal"] = [torch.equal(a[0][lo:hi], b[0]) for a, b in
                              zip(rec["ffn_one"], rec["ffn_mesh"])]
        out["dense_ffn_equal"] = [torch.equal(a[1][lo:hi], b[1]) for a, b in
                                  zip(rec["ffn_one"], rec["ffn_mesh"]) if not a[2]]
        out["moe_rows"] = rec["moe"]
        out["moe_layers"] = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    return out


def _gather_leaf(v: torch.Tensor, cut, rt) -> torch.Tensor:
    """A rank's block of a state leaf with every head (gathered over the
    model axis where the model axis cuts it)."""
    return v if cut is None else C.all_gather(v, rt.mesh.group(rt.model_axis), dim=cut[0])


def record_rows(cb) -> dict:
    """Patch an engine to keep the logits row that chose each emitted token
    and the engine iteration that chose it: ``rows[(rid, i)] = (iteration,
    row)`` for token i of request rid (every slot's row on a mesh, gathered
    over the data axes, so the ranks stay in step)."""
    rows: dict = {}
    first, nxt = cb._first_token, cb._next_tokens

    def first_token(req, logits):
        rows[(req.rid, len(req.output))] = (cb.stats["steps"],
                                            logits[0].float().cpu().numpy().copy())
        return first(req, logits)

    def next_tokens(logits, argmax, dec):
        host = T.gather_rows(logits, cb.state, cb.rt).float().cpu().numpy()
        for slot, req in dec:
            if req.replay_pos >= len(req.output):
                rows[(req.rid, len(req.output))] = (cb.stats["steps"], host[slot].copy())
        return nxt(logits, argmax, dec)

    cb._first_token, cb._next_tokens = first_token, next_tokens
    return rows


NEAR_TIE_SHARE = 0.1        # chip_smoke.py's: a near-tie's rows lie this close, of the scale


def near_tie_failures(mesh_out: list, mesh_rows: dict, one_out: list, one_rows: dict) -> list:
    """The partings of ``mesh_out`` from ``one_out`` that the mesh near-tie
    rule leaves unexplained: at the first parting iteration (which must be
    the one device's too) the mesh row picks its token, and its gap
    between the two tokens is within the two rows' distance, itself within
    ``NEAR_TIE_SHARE`` of the logit scale; a later parting rides on the
    earlier one (a parted token feeds its slot, and a MoE's capacity is the
    call's)."""
    parts = []
    for rid, (a, b) in enumerate(zip(mesh_out, one_out)):
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None and len(a) != len(b):
            return [(rid, "length")]
        if d is not None:
            parts.append((rid, d, a[d], b[d]))
    if not parts:
        return []
    first = min(mesh_rows[(rid, d)][0] for rid, d, _, _ in parts)
    bad = []
    for rid, d, tm, to in parts:
        step, row = mesh_rows[(rid, d)]
        if step != first:
            continue
        ostep, orow = one_rows[(rid, d)]
        gap, dist = float(row[tm] - row[to]), float(np.abs(row - orow).max())
        if (ostep != step or int(row.argmax()) != tm
                or not abs(gap) <= dist <= NEAR_TIE_SHARE * float(np.abs(row).max())):
            bad.append((rid, d, gap, dist))
    return bad


def traced(cfg, params, rt=None, **kw) -> tuple[list, dict]:
    """The continuous engine on the reference trace -> (streams, the rows
    that chose each token, :func:`record_rows`)."""
    cb = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=48, rt=rt, device="cpu", **kw)
    rows = record_rows(cb)
    return cb.generate_all(*family_trace(cfg)), rows


def family_engines(mesh, arch: str) -> dict:
    """The engines of ``arch`` on the mesh (``mesh`` None: one device):
    ``Engine.generate`` on a fixed batch and (a decoder) the continuous
    engine on the reference trace, with the rows that chose its tokens;
    deepseek also on the seed-17 trace under ``chunk=4`` and under
    ``spec_k=3`` with the MTP drafter."""
    cfg = ARCHS[arch].reduced()
    rt = T.Runtime(mesh=mesh, data_axes=("data",), serve_resident_moe=True)
    placed = T.place_params(cfg, M.init_params(cfg, 0, "cpu"), True, rt)
    out = {"fixed": Engine(cfg, placed, rt=rt, max_len=16, device="cpu").generate(
        fixed_batch(cfg), 6)[0].numpy()}
    if cfg.family == "encdec":
        return out
    out["trace"], out["rows"] = traced(cfg, placed, rt)
    if cfg.mtp:
        p17 = seed17_trace(cfg)
        out["seed17_chunk"] = ContinuousBatchingEngine(
            cfg, placed, n_slots=4, max_len=32, chunk=4, policy="sjf", rt=rt,
            device="cpu").generate_all(*p17)
        out["seed17_mtp"] = ContinuousBatchingEngine(
            cfg, placed, n_slots=4, max_len=32, spec_k=3, drafter="mtp", rt=rt,
            device="cpu").generate_all(*p17)
    return out


def families_world(rank: int, shape: tuple[int, int], engines: bool) -> dict:
    """The (d, m) world's family checks: each family's decode step, and
    (``engines``) its engines."""
    mesh = MS.make_local_mesh(*shape)
    C.reset_stats()
    out = {arch: {"step": family_step(mesh, arch)} for arch in FAMILIES}
    if engines:
        for arch in FAMILIES:
            out[arch]["engines"] = family_engines(mesh, arch)
    out["stats"] = dict(C.stats)
    return out


def moe_params(arch: str, layer: int) -> dict:
    """Layer ``layer``'s MoE params of ``arch``'s seeded reduced tree,
    quantized as the decode tree holds them."""
    cfg = ARCHS[arch].reduced()
    return quantize_tree(M.init_params(cfg, 0, "cpu"))["layers"][layer]["moe"]


def card_ssm_step(rank: int) -> dict:
    """A 1x2 world on the card (both ranks on ``cuda:0``): mamba2
    ``.reduced()`` under ``fused_int8`` on its int8 tree, a B6 prefill over
    each rank's heads and a decode step from the state it leaves, against
    one process's (logits and every gathered state leaf)."""
    torch.cuda.set_device(0)
    mesh = MS.make_local_mesh(1, 2)
    cfg = ARCHS["mamba2-2.7b"].reduced()
    params = M.init_params(cfg, 0, "cuda")
    qp = quantize_tree(params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 9))).cuda()
    rt1 = T.Runtime("fused_int8")
    rt = T.Runtime("fused_int8", mesh=mesh, serve_resident_moe=True)
    # the int8 tree from prefill on: a float row-parallel out_proj's partial
    # sums would part from one process's in the last bits
    _, qpl = T.place_params(cfg, params, True, rt)
    logits, st = T.prefill(qp, cfg, toks, 32, rt1)
    tok = torch.argmax(logits, -1)
    mlog, mst = T.prefill(qpl, cfg, toks, 32, rt)
    cuts = T.layer_cuts(cfg, rt)

    def gathered(s):
        return {"layers": [{k: _gather_leaf(v, cut.get(k), rt) for k, v in c.items()}
                           for c, cut in zip(s["layers"], cuts)], "pos": s["pos"]}
    pre = gathered(_clone(mst))
    want, one = T.decode_step(qp, cfg, _clone(st), tok, rt1)
    got, mst = T.decode_step(qpl, cfg, mst, tok, rt)
    return {"logits_equal": bool(torch.equal(want, got)),
            "state_diffs": _leaf_diffs(gathered(mst), one),
            "prefill_logits_equal": bool(torch.equal(logits, mlog)),
            "prefill_state_diffs": _leaf_diffs(pre, st)}


def card_row_moves(rank: int) -> dict:
    """A 2x2 world on the card: :func:`row_moves` of llama3-8b
    ``.reduced()``'s pool on ``cuda:0``."""
    torch.cuda.set_device(0)
    mesh = MS.make_local_mesh(2, 2)
    cfg = ARCHS["llama3-8b"].reduced()
    rt = T.Runtime("fused_int8", mesh=mesh)
    res = row_moves(rt, cfg, "cuda")
    return {k: res[k] for k in ("copy_equal", "row_equal")}


# the serving lanes on the card: llama3-8b at full width with 2 layers on
# 2x2 (2 slots, a slot a data rank), the traces' prompt and budget shapes
# those of the reference's lane tests
CARD_LANE_LAYERS = 2


def card_lane_traces(vocab_size: int) -> dict:
    """The prefix lane's 4 requests share a 64-token system prompt (tails of
    8-24 tokens, budgets 2-3); the cold tier's and the fault lane's 6
    requests have prompts of 16-64 tokens and budgets of 4-9 (seed 29)."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab_size, 64).tolist()
    prefix = ([shared + rng.integers(0, vocab_size, int(rng.integers(8, 25))).tolist()
               for _ in range(4)], [2, 3, 2, 3])
    rng = np.random.default_rng(29)
    swap = ([rng.integers(0, vocab_size, int(rng.integers(16, 65))).tolist()
             for _ in range(6)], [int(rng.integers(4, 10)) for _ in range(6)])
    return {"prefix": prefix, "swap": swap, "faults_swap": swap}


CARD_LANE_KW = {
    "prefix": dict(n_slots=2, max_len=256, chunk=64, prefix_cache=True),
    "swap": dict(n_slots=2, max_len=256, chunk=64, policy="fair:3", kv_swap=True),
    "faults_swap": dict(n_slots=2, max_len=256, chunk=64, policy="fair:3", kv_swap=True,
                        retry_backoff_s=0.0),
}


def card_injector(lane: str):
    """The fault lane on the card: step failures at 4 and 9 and slot 0 lost
    at 7 (inside the trace's steps), NAND flips at BER 2e-3."""
    if lane != "faults_swap":
        return None
    return FaultInjector(seed=0, ber=2e-3, step_fail_at=(4, 9), slot_loss_at=((7, 0),))


def card_lanes(cfg, params, rt) -> dict:
    """Each card lane's trace on ``cuda:0`` -> (streams, stats less the
    clocks, quarantined slots, the rows that chose each token, the trace's
    wall and collectives: ``move_bytes`` those of its rows' moves)."""
    out = {}
    for lane, (prompts, budgets) in card_lane_traces(cfg.vocab_size).items():
        eng = ContinuousBatchingEngine(cfg, params, rt=rt, faults=card_injector(lane),
                                       **CARD_LANE_KW[lane])
        rows = record_rows(eng)
        C.reset_stats()
        t0 = time.perf_counter()
        outs = eng.generate_all(prompts, budgets)
        torch.cuda.synchronize()
        out[lane] = (outs, {k: v for k, v in eng.stats.items() if k not in CLOCKS},
                     sorted(eng.scheduler.quarantined), rows,
                     dict(C.stats, wall_s=time.perf_counter() - t0))
        del eng
    return out


def card_lanes_rank(rank: int) -> dict:
    """A rank of the 2x2 world on the card: the lanes of llama3-8b at full
    width with ``CARD_LANE_LAYERS`` layers, its blocks drawn a piece at a
    time."""
    import dataclasses

    from repro_torch.device import set_float32_precision
    torch.cuda.set_device(0)
    set_float32_precision()
    cfg = dataclasses.replace(ARCHS["llama3-8b"], n_layers=CARD_LANE_LAYERS)
    rt = T.Runtime("fused_int8", mesh=MS.make_local_mesh(2, 2), data_axes=("data",),
                   serve_resident_moe=True)
    return card_lanes(cfg, T.init_params_sharded(cfg, rt, seed=0, device="cuda"), rt)


# the other families on a 1x2 mesh on the card at full width
# (tests/test_torch_cuda.py; the chip script's time does not hold them):
# each one-process baseline saved to a directory, then one world for them
# all, on chip_smoke.py's helpers
MESH_JAMBA_LAYERS = 5   # jamba's fewest layers with an SSM layer, a MoE FFN and attention (4)
# mamba2-2.7b's depth on the mesh: 16 of 64 layers (64 take a rank's eager
# steps 0.4-0.65 s each)
MESH_MAMBA2_LAYERS = 16


def layer_hooks(T, cfg, base: dict | None, block: tuple | None = None):
    """Hooks on the decode step's layers for a MoE stack: in one process
    (``base`` None) each layer's input, each FFN's input and output are
    recorded; on a rank each layer and each FFN starts from one process's
    input (``base["layer_in"]``, ``base["ffn"]``, the rank's ``block`` of
    slots), the rank's own FFN input (its mixer's output) recorded, so its
    mixer, its state leaves, its dense FFN and its MoE FFN are each held
    on one process's inputs.  Returns (records, undo)."""
    rec = {"layer_in": [], "ffn": []}
    layer, ffn = T.apply_layer_decode, T._ffn

    def layer_hook(p, cfg_, x, pos, cache, rt, lm=None):
        if base is None:
            rec["layer_in"].append(x.detach().cpu())
        else:
            lo, hi = block
            x = base["layer_in"][len(rec["layer_in"])][lo:hi].to(x.device)
            rec["layer_in"].append(None)
        return layer(p, cfg_, x, pos, cache, rt, lm)

    def ffn_hook(p, cfg_, x, rt, lm=None):
        own = x.detach().cpu()
        if base is not None:
            lo, hi = block
            x = base["ffn"][len(rec["ffn"])][0][lo:hi].to(x.device)
        out = ffn(p, cfg_, x, rt, lm)
        rec["ffn"].append((own, out.detach().cpu(), "moe" in p))
        return out

    T.apply_layer_decode, T._ffn = layer_hook, ffn_hook

    def undo():
        T.apply_layer_decode, T._ffn = layer, ffn
    return rec, undo


def mesh_family_baseline(tmp: str, cfg, params, quantized: bool) -> dict:
    """One process's side of a family's mesh gates (``params``: the f32
    tree, or the int8 tree served as it is where ``quantized``): the 4-rank trace's shape through the
    continuous engine (deepseek also under ``spec_k = 3`` with the MTP
    head) with each chosen row recorded, or ``Engine.generate`` from
    seeded frames (an encoder-decoder); one decode step from a ragged pool
    (a MoE stack's recorded layer by layer, :func:`layer_hooks`), saved to
    ``tmp`` with the pool after it."""
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.quantize import quantize_tree, quantized_bytes

    t0 = time.perf_counter()
    out: dict = {}
    if cfg.family == "encdec":
        eng = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=64)
        out["outputs"], out["rows"] = engine_rows(eng, mesh_frames_batch(cfg))
        del eng
    else:
        rows: dict = {}
        cb, reqs, wall, _ = CS.serve(torch, cfg, params, {}, mesh_attn(cfg),
                                  trace=CS.mesh_short_trace(cfg.vocab_size),
                                  quantized=quantized,
                                  setup=lambda e: rows.update({"rows": CS.record_rows(e)}))
        out.update(outputs=[list(r.output) for r in reqs], rows=rows["rows"],
                   serve_wall_s=wall)
        del cb, reqs
        if cfg.mtp:
            cb, reqs, wall, _ = CS.serve(torch, cfg, params, MTP_LANE, None,
                                      trace=CS.mesh_short_trace(cfg.vocab_size),
                                      quantized=quantized)
            out["mtp_outputs"] = [list(r.output) for r in reqs]
            del cb, reqs
    qparams = params if quantized else quantize_tree(params)
    state = CS.ragged_pool(torch, cfg, params, 256, 256)
    tok = torch.randint(0, cfg.vocab_size, (len(CS.RAGGED_LENS),),
                        generator=torch.Generator(device="cuda").manual_seed(5),
                        device="cuda").to(torch.int32)
    after = CS.clone_state(state)
    undo = None
    if T.has_moe(cfg):
        hooks, undo = layer_hooks(T, cfg, None)
    try:
        logits, _ = M.decode_step(qparams, cfg, after, tok, Runtime("fused_int8"))
    finally:
        if undo:
            undo()
    save = {"state": {"layers": [{k: v.cpu() for k, v in c.items()} for c in state["layers"]],
                      "pos": state["pos"].cpu()},
            "tok": tok.cpu(), "logits": logits.cpu(),
            "after": {"layers": [{k: v.cpu() for k, v in c.items()}
                                 for c in after["layers"]]}}
    if undo:
        save.update(layer_in=hooks["layer_in"], ffn=hooks["ffn"])
    torch.save(save, os.path.join(tmp, cfg.name + ".pt"))
    seen: set = set()
    out["param_bytes"] = sum(t.numel() * t.element_size() for tree in (params, qparams)
                             for t in CS._tensors(tree)
                             if not (t.data_ptr() in seen or seen.add(t.data_ptr())))
    out["qparam_bytes"] = quantized_bytes(qparams)
    out["baseline_s"] = time.perf_counter() - t0
    del qparams, state, after, logits
    print(f"   {cfg.name}: one-process mesh baseline in {out['baseline_s']:.1f} s")
    return out


MESH_ENGINE_STEPS = 4          # Engine.generate's steps (an encoder-decoder on the mesh)
MTP_LANE = {"spec_k": 3, "drafter": "mtp"}


def mesh_attn(cfg) -> str | None:
    """The decode-attention kernel a family's decode step launches."""
    return None if cfg.attn_type in ("mla", "none") else "decode_attn"


def mesh_frames_batch(cfg) -> dict:
    """``Engine.generate``'s batch for an encoder-decoder: 2 rows of seeded
    frames and 4-token prompts."""
    g = torch.Generator(device="cuda").manual_seed(8)
    return {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                                  device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, (2, 4), generator=g, device="cuda")}


def engine_rows(eng, batch: dict) -> tuple:
    """``Engine.generate`` over ``batch`` for ``MESH_ENGINE_STEPS`` with the
    logits rows that chose each token kept (row j chose token j: the
    prefill's for token 0, every slot's on a mesh) -> (tokens, rows)."""

    rows = []
    steps = eng._steps_for(batch["tokens"].shape[0])
    prefill, decode = M.prefill, steps.decode

    def rec_prefill(*a, **k):
        logits, st = prefill(*a, **k)
        rows.append(logits.float().cpu())
        return logits, st

    def rec_decode():
        logits, nxt = decode()
        rows.append(T.gather_rows(logits, steps.state, eng.rt).float().cpu())
        return logits, nxt

    M.prefill, steps.decode = rec_prefill, rec_decode
    try:
        toks = eng.generate(batch, MESH_ENGINE_STEPS)[0].cpu()
    finally:
        M.prefill, steps.decode = prefill, decode
    return toks, rows


def engine_tie_failures(mesh: dict, base: dict) -> tuple[list, list]:
    """``Engine`` streams against one process's: at the first step where a
    row parts, each parting row's mesh logits pick its token and hold the
    near-tie rule with one process's row as the witness (later steps feed
    the parted token back).  Returns (unexplained rows, margins)."""
    a, b = mesh["outputs"], base["outputs"]
    diff = (a != b).nonzero().tolist()
    if not diff:
        return [], []
    first = min(j for _, j in diff)
    margins, bad = [], []
    for i in {i for i, j in diff if j == first}:
        rm, r1 = mesh["rows"][first][i], base["rows"][first][i]
        tm, to = int(a[i, first]), int(b[i, first])
        m = {"row": i, "step": first, "tokens": [tm, to], "fused_gap": float(rm[tm] - rm[to]),
             "logit_scale": float(rm.abs().max()),
             "lanes_max_abs_diff": float((rm - r1).abs().max()),
             "fused_reproduced": int(rm.argmax()) == tm}
        margins.append(m)
        if not m["fused_reproduced"] or not (abs(m["fused_gap"]) <= m["lanes_max_abs_diff"]
                                             <= NEAR_TIE_SHARE * m["logit_scale"]):
            bad.append(i)
    return bad, margins


def mesh_family_cfgs() -> dict:
    """name -> (the config the mesh serves, whether its tree is drawn
    int8): mamba2-2.7b at ``MESH_MAMBA2_LAYERS``, deepseek-v3-671b at the
    families phase's 4 layers (with the MTP head), jamba at
    ``MESH_JAMBA_LAYERS``, whisper-tiny uncut."""
    import dataclasses

    from repro_torch.configs import registry
    return {"mamba2-2.7b": (dataclasses.replace(registry.get("mamba2-2.7b"),
                                                n_layers=MESH_MAMBA2_LAYERS), False),
            "deepseek-v3-671b": (dataclasses.replace(registry.get("deepseek-v3-671b"),
                                                     n_layers=CS.DEEPSEEK_LAYERS), True),
            "jamba-1.5-large-398b": (dataclasses.replace(registry.get("jamba-1.5-large-398b"),
                                                         n_layers=MESH_JAMBA_LAYERS), True),
            "whisper-tiny": (registry.get("whisper-tiny"), False)}


def mesh_family_step(cfg, mp, mesh, tmp: str) -> dict:
    """On a rank: one decode step of the placed ``mp`` from the saved pool's
    block (a MoE stack's layers each from one process's input), its
    gathered state leaves and logits against one process's (bit for bit,
    or each leaf's largest difference where not), a MoE FFN's output
    against one process's (rtol 2e-3, atol 2e-4), its launches a rank, its
    wall, collectives and device-busy time."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    base = torch.load(os.path.join(tmp, cfg.name + ".pt"))
    state = {"layers": [{k: v.cuda() for k, v in c.items()} for c in base["state"]["layers"]],
             "pos": base["state"]["pos"].cuda()}
    tok = base["tok"].cuda()
    rt = T.Runtime("fused_int8", mesh=mesh, serve_resident_moe=True)
    model = mesh.group(rt.model_axis)
    cuts = T.layer_cuts(cfg, rt)
    blk = T.decode_block_of(cfg, state, rt)
    lo, hi, _ = blk["block"]
    M.decode_step(mp.qparams, cfg, T.decode_block_of(cfg, state, rt), tok[lo:hi], rt)  # warm
    moe = T.has_moe(cfg)
    undo = None
    if moe:
        hooks, undo = layer_hooks(T, cfg, base, (lo, hi))
    torch.cuda.synchronize()
    reset_launch_counts()
    C.reset_stats()
    t0 = time.perf_counter()
    try:
        logits, blk = M.decode_step(mp.qparams, cfg, blk, tok[lo:hi], rt)
        torch.cuda.synchronize()
    finally:
        if undo:
            undo()
    wall = time.perf_counter() - t0
    counts, coll = launch_counts(), dict(C.stats)
    diffs = {}
    for i, (c, cut) in enumerate(zip(blk["layers"], cuts)):
        for k, v in c.items():
            whole = C.all_gather(v, model, dim=cut[k][0]) if k in cut else v
            want = base["after"]["layers"][i][k][lo:hi]
            diffs[f"L{i}.{k}"] = float((whole.cpu().double() - want.double()).abs().max())
    want = base["logits"][lo:hi]
    rec = {"logits_equal": bool(torch.equal(logits.cpu(), want)),
           "logits_max_abs_diff": float((logits.cpu() - want).abs().max()),
           "scale": float(want.abs().max()), "state_max_abs_diff": diffs,
           "launches": counts, "want_launches": CS.want_launches(cfg, 1, [], mesh_attn(cfg)),
           "wall_ms": wall * 1e3, "collectives": coll}
    if moe:
        mixers, dense, moes = [], [], []
        for (x1, o1, is_moe), (xm, om, _) in zip(base["ffn"], hooks["ffn"]):
            x1, o1 = x1[lo:hi], o1[lo:hi]
            mixers.append((float((xm - x1).abs().max()), float(x1.abs().max())))
            if is_moe:           # on one process's input: the combine's order alone
                moes.append(float(((om - x1) - (o1 - x1)).abs().max()))
                rec.setdefault("moe_close", []).append(bool(torch.allclose(
                    om - x1, o1 - x1, rtol=2e-3, atol=2e-4)))
            else:
                dense.append(bool(torch.equal(om, o1)))
        rec.update(mixer_max_abs_diff=mixers, dense_ffn_equal=dense, moe_max_abs_diff=moes)
    rec["shape_probes"] = shape_probes(cfg, mesh.shape["model"])
    try:
        prof = CS.profile_step(torch, lambda: M.decode_step(
            mp.qparams, cfg, T.decode_block_of(cfg, state, rt), tok[lo:hi], rt),
            f"{cfg.name} mesh decode")
        rec["device_busy_ms"] = prof["device_busy_us"] / 1e3
        rec["profiled_wall_ms"] = prof["wall_us"] / 1e3
    except Exception as e:  # noqa: BLE001 - a measurement, not a gate
        rec["profile_error"] = f"{type(e).__name__}: {e}"
    return rec


def _probe(fn, ops: list, dims: list, out_dim: int, m: int) -> bool:
    """Whether ``fn`` over the rank's block of ``ops`` (1/m of each along
    its ``dims`` entry; None: whole) is the block of ``fn`` over the whole
    operands, bit for bit (the block along ``out_dim``)."""
    whole = fn(*ops)
    part = fn(*[o if d is None else o.narrow(d, 0, o.shape[d] // m).contiguous()
                for o, d in zip(ops, dims)])
    return bool(torch.equal(whole.narrow(out_dim, 0, part.shape[out_dim]), part))


def _einsum(eq: str):
    return lambda *ops: torch.einsum(eq, *ops)


def _seeded(seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=g, device="cuda")


def shape_probes(cfg, m: int) -> dict:
    """The float products of ``cfg``'s step whose shape follows a rank's
    block (1/m of the heads or channels), each run on seeded operands at
    the whole shape and at the rank's, at 4 slots: whether the rank's
    part is one process's bits (name -> bool).  A mixer that parts from
    one process's is held to 1e-3 of its scale only where one of these
    parts."""
    rnd = _seeded(21)

    def probe(eq: str, ops: list, dims: list, out_dim: int) -> bool:
        return _probe(_einsum(eq), ops, dims, out_dim, m)

    B, S = len(CS.RAGGED_LENS), 256
    out = {}
    if cfg.attn_type == "mla":
        H, r = cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        out["mla q_eff bthd,rhd->bthr"] = probe("bthd,rhd->bthr", [rnd(B, 1, H, dn), rnd(r, H, dn)],
                                                [2, 1], 2)
        out["mla scores bthr,bsr->bths"] = probe("bthr,bsr->bths", [rnd(B, 1, H, r), rnd(B, S, r)],
                                                 [2, None], 2)
        out["mla rope bthd,bsd->bths"] = probe("bthd,bsd->bths", [rnd(B, 1, H, dr), rnd(B, S, dr)],
                                               [2, None], 2)
        out["mla sv bths,bsr->bthr"] = probe("bths,bsr->bthr", [rnd(B, 1, H, S), rnd(B, S, r)],
                                             [2, None], 2)
        out["mla uv bthr,rhd->bthd"] = probe("bthr,rhd->bthd", [rnd(B, 1, H, r), rnd(r, H, dv)],
                                             [2, 1], 2)
    if any(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers)):
        H, hd, N, C = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
        out["ssm outer bhd,bhs->bhds"] = probe("bhd,bhs->bhds", [rnd(B, H, hd), rnd(B, H, N)],
                                               [1, 1], 1)
        out["ssm read bhds,bhs->bhd"] = probe("bhds,bhs->bhd", [rnd(B, H, hd, N), rnd(B, H, N)],
                                              [1, 1], 1)
        out["ssm conv (bkc * kc).sum(1)"] = _probe(lambda x, w: (x * w).sum(1),
                                                   [rnd(B, cfg.ssm_conv, C), rnd(cfg.ssm_conv, C)],
                                                   [2, 1], 1, m)
    if cfg.family == "encdec":
        G, hd, Se = cfg.n_kv_heads, cfg.head_dim, cfg.encoder_seq
        out["encoder scores bqgrd,bkgd->bgrqk"] = probe(
            "bqgrd,bkgd->bgrqk", [rnd(2, 64, G, 1, hd), rnd(2, Se, G, hd)], [2, 2], 1)
        out["cross scores bgrd,bkgd->bgrk"] = probe(
            "bgrd,bkgd->bgrk", [rnd(B, G, 1, hd), rnd(B, Se, G, hd)], [1, 2], 1)
        out["cross sv bgrk,bkgd->bgrd"] = probe(
            "bgrk,bkgd->bgrd", [rnd(B, G, 1, Se), rnd(B, Se, G, hd)], [1, 2], 1)
    return out


def prefill_probes(cfg, m: int, rows: int = 64, keys: int = 128) -> dict:
    """The float stages of a GQA decoder's mesh prefill piece (``rows``
    query rows against ``keys`` keys) whose form or shape differs from one
    process's, each on seeded operands: whether the rank's result is one
    process's bits (name -> bool).  RoPE: the mesh prefill rotates by the
    reference's mesh form (``layers.apply_rope_spmd``, a [D, D] rotation
    contraction) where one process rotates half; attention: the blocked
    attention over the rank's 1/m of the heads against the whole."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    rnd = _seeded(23)
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(keys - rows, keys, device="cuda")[None]
    x = rnd(1, rows, H, hd)
    one = L.apply_rope(x, pos, cfg.rope_theta)[:, :, :H // m]
    rank = L.apply_rope_spmd(x[:, :, :H // m].contiguous(), pos, cfg.rope_theta)

    def attend(q, k, v):
        return A.flash_attention(q, k, v, q_offset=keys - rows, kv_block=keys)
    return {"rope: rotation contraction (mesh) against rotate-half": bool(torch.equal(one, rank)),
            "attention bqgrd,bkgd over the rank's heads": _probe(
                attend, [rnd(1, rows, H, hd), rnd(1, keys, G, hd), rnd(1, keys, G, hd)],
                [2, 2, 2], 2, m)}


def mesh_family_rank(rank: int, tmp: str, base: dict) -> dict:
    """A rank of the 1x2 families world on the card: each family of
    :func:`mesh_family_cfgs` drawn as the rank's blocks (mamba2 by
    ``init_params_sharded``, deepseek and jamba by ``int8_params`` a part
    at a time, whisper whole then cut), its decode step and its trace (or
    ``Engine``), each freed before the next."""
    import gc

    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.cuda.set_device(0)
    from repro_torch.device import set_float32_precision

    set_float32_precision()
    mesh = MS.make_local_mesh(1, 2)
    rt = T.Runtime("fused_int8", mesh=mesh, serve_resident_moe=True)
    out = {}
    for name, (cfg, drawn) in mesh_family_cfgs().items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        if drawn:
            mp = CS.int8_params(torch, cfg, rt=rt)
        elif cfg.family == "encdec":
            mp = T.place_params(cfg, M.init_params(cfg, 0, "cuda"), True, rt)
        else:
            mp = T.init_params_sharded(cfg, rt, seed=0, device="cuda")
        torch.cuda.synchronize()
        rec = {"init_s": time.perf_counter() - t0, "param_bytes": CS.mesh_rank_bytes(mp),
               "step": mesh_family_step(cfg, mp, mesh, tmp)}
        if cfg.family == "encdec":
            eng = Engine(cfg=cfg, params=mp, rt=rt, max_len=64)
            t1 = time.perf_counter()
            toks, rows = engine_rows(eng, mesh_frames_batch(cfg))
            rec["engine"] = {"outputs": toks, "rows": rows, "wall_s": time.perf_counter() - t1}
            del eng
        else:
            rec["serve"] = CS.mesh_serve(torch, cfg, mp, mesh, CS.mesh_short_trace(cfg.vocab_size),
                                      base[name]["outputs"], drawn, attn=mesh_attn(cfg))
            if cfg.mtp:
                rec["mtp"] = CS.mesh_serve(torch, cfg, mp, mesh, CS.mesh_short_trace(cfg.vocab_size),
                                        base[name]["mtp_outputs"], drawn, lane=MTP_LANE)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["family_s"] = time.perf_counter() - t0
        out[name] = rec
        del mp
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_families(tmp: str, base: dict) -> dict:
    """mamba2-2.7b
    (``MESH_MAMBA2_LAYERS`` of 64 layers), deepseek-v3-671b (4 of 61 layers,
    the MTP head), jamba-1.5-large-398b (``MESH_JAMBA_LAYERS`` of 72) and whisper-tiny
    (uncut) at full width on a 1x2 mesh, both ranks on ``cuda:0``, against
    the one-process baselines ``base`` that :func:`mesh_family_baseline` saved
    to ``tmp``: each
    decode step's state leaves (gathered over the model axis) and logits
    bit-equal to one process's (a MoE stack layer by layer: its mixers and
    dense FFNs bit for bit, its MoE FFN within rtol 2e-3 / atol 2e-4; a
    float product whose shape follows the rank's block is recorded where it
    parts, held to 1e-3 of its scale), one process's launches a rank, the
    4-rank trace's shape through the continuous engine token-identical (a
    MoE stack's parting held to the near-tie rule), deepseek's MTP
    ``spec_k`` lane, whisper's ``Engine``."""
    cfgs = mesh_family_cfgs()
    t0 = time.perf_counter()
    ranks = MS.spawn(mesh_family_rank, 2, tmp,
                     {n: {k: b[k] for k in ("outputs", "mtp_outputs") if k in b}
                      for n, b in base.items()}, timeout_s=CS.MESH_TIMEOUT_S)
    out: dict = {"world_s": time.perf_counter() - t0}
    fails: list = []
    for name, (cfg, _) in cfgs.items():
        b = base[name]
        recs = [r[name] for r in ranks]
        moe = any(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        for r, rec in enumerate(recs):
            st = rec["step"]
            if st["launches"] != st["want_launches"]:
                fails.append(f"{name} rank {r}: step launches {st['launches']} != "
                             f"{st['want_launches']}")
            worst = max(st["state_max_abs_diff"].values())
            probed = [k for k, eq in st["shape_probes"].items() if not eq]
            if moe:
                # a mixer bit for bit, or (a float product of the rank's shape
                # parts from one process's: the probes name it) within 1e-3
                # of its scale; the state it writes bit for bit
                far = [(d, sc) for d, sc in st["mixer_max_abs_diff"] if d > 1e-3 * sc]
                if (far or (probed == [] and any(d for d, _ in st["mixer_max_abs_diff"]))
                        or not all(st["dense_ffn_equal"]) or not all(st["moe_close"])
                        or worst != 0.0):
                    fails.append(f"{name} rank {r}: mixers {st['mixer_max_abs_diff']} "
                                 f"(probes parting {probed}), dense FFNs "
                                 f"{st['dense_ffn_equal']}, MoE {st['moe_max_abs_diff']}, "
                                 f"state {worst}")
            elif not (st["logits_equal"] and worst == 0.0) and not (
                    probed and st["logits_max_abs_diff"] <= 1e-3 * st["scale"]):
                fails.append(f"{name} rank {r}: step off one process's by "
                             f"{st['logits_max_abs_diff']} (scale {st['scale']}), state "
                             f"{worst}, probes parting {probed}")
        if cfg.family == "encdec":
            for r, rec in enumerate(recs):
                if not torch.equal(rec["engine"]["outputs"], recs[0]["engine"]["outputs"]):
                    fails.append(f"{name} rank {r}: Engine tokens differ from rank 0's")
            bad, margins = engine_tie_failures(recs[0]["engine"], b)
            out.setdefault(name, {})["engine_margins"] = margins
            if bad:
                fails.append(f"{name}: Engine tokens part from one process's beyond a "
                             f"near-tie: {margins}")
        else:
            lanes = [("serve", b["outputs"], b["rows"])]
            if cfg.mtp:
                lanes.append(("mtp", b["mtp_outputs"], None))
            for key, want, rows in lanes:
                for r, rec in enumerate(recs):
                    sv = rec[key]
                    if sv["launches"] != sv["want_launches"]:
                        fails.append(f"{name} {key} rank {r}: launches {sv['launches']} != "
                                     f"{sv['want_launches']}")
                    if sv["outputs"] != recs[0][key]["outputs"]:
                        fails.append(f"{name} {key} rank {r}: streams differ from rank 0's")
                parts = recs[0][key]["partings"]
                if parts and (rows is None or any(p[3] is None for p in parts)):
                    fails.append(f"{name} {key}: streams part from one process's at "
                                 f"{[(p[0], p[1]) for p in parts]}")
                elif parts:
                    margins = CS.mesh_margins(torch, parts, rows, want)
                    bad = CS.mesh_tie_failures(margins, moe)
                    out.setdefault(name, {})[f"{key}_margins"] = margins
                    if bad:
                        fails.append(f"{name}: streams part beyond a near-tie at {bad}")
        st0 = recs[0]["step"]
        out.setdefault(name, {}).update(
            one_process={k: b[k] for k in ("param_bytes", "qparam_bytes", "baseline_s")},
            ranks=[{k: v for k, v in rec.items() if k not in ("serve", "mtp", "engine")}
                   | {k: {kk: vv for kk, vv in rec[k].items() if kk != "outputs"}
                      for k in ("serve", "mtp") if k in rec} for rec in recs])
        for i, rec in enumerate(recs):
            st = rec["step"]
            c = st["collectives"]
            print(f"   {name} 1x2 rank {i}: step wall {st['wall_ms']:.2f} ms, device busy "
                  f"{st.get('device_busy_ms', float('nan')):.2f} ms; collectives a step "
                  f"{c['calls']} calls, {c['bytes'] / 1e6:.3f} MB, {c['seconds'] * 1e3:.2f} ms; "
                  f"params {rec['param_bytes'] / 1e9:.3f} GB (one process "
                  f"{b['param_bytes'] / 1e9:.3f} GB); family {rec['family_s']:.1f} s")
        print(f"   {name} 1x2: logits "
              f"{'bit-equal' if st0['logits_equal'] else 'off by ' + str(st0['logits_max_abs_diff'])}"
              f" (scale {st0['scale']:.3f}), state worst "
              f"{max(st0['state_max_abs_diff'].values())}"
              + (f", mixers (diff, scale) {st0['mixer_max_abs_diff']}, MoE worst "
                 f"{max(st0['moe_max_abs_diff'])}" if moe else "")
              + f"; float products parting at the rank's shape: "
                f"{[k for k, eq in st0['shape_probes'].items() if not eq]}")
    if fails:
        out["failures"] = fails
        err = AssertionError("; ".join(fails))
        err.record = out
        raise err
    return out
