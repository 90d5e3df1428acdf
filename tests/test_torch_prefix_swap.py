"""The port's radix prefix cache and tiered KV pool (A.10, first part)
against the JAX package on the CPU.

Mirrors ``tests/test_prefix_cache.py``, ``tests/test_kv_swap.py`` and
``tests/test_faults.py`` where the port has the piece: the kvcache
leftovers, ``SlotLedger`` and ``ColdStore``; ``copy_slot_prefix`` and
``warm_prefill_carry``, with the cached rows byte-identical after a warm
finalize; ``faults.row_checksums`` and ``FaultInjector.corrupt_block`` bit
for bit on the same blocks and seeds; ``SwapManager``'s cost model; and
both engines token-identical to JAX's with equal stats under
``prefix_cache``, ``kv_swap`` and both (reduced llama3-8b and opt-125m).
Tolerances: tokens, integers, bytes and the modeled cycles exact; the
warm tail's int8 K/V rows equal JAX's but for codes on a rounding boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import kvcache as JKV
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.transformer import Runtime as JRuntime
from repro.serve import faults as JF
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Runtime
from repro_torch.serve import faults as TF
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.prefix_cache import RadixPrefixCache
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("llama3-8b", "opt-125m")
SKIP = ("device_s", "step_s", "xfer_bytes")   # clocks; xfer_bytes: see _same_stats


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = JR.get(request.param).reduced()
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, TR.get(request.param).reduced(), jp, convert.from_numpy(_np(jp), device="cpu")


def _port_state(jstate) -> dict:
    """A JAX decode state (or cold block) in the port's per-layer layout."""
    return convert.from_numpy(_np(jstate), device="cpu")


def _random_state(jcfg, B, S, seed):
    """A JAX decode state filled with random int8 codes and positive scales."""
    rng = np.random.default_rng(seed)
    st = _np(JM.init_decode_state(jcfg, B, S))
    for grp in st["groups"]:
        for b in grp:
            for k in b:
                b[k] = (rng.integers(-127, 128, b[k].shape).astype(np.int8) if k.endswith("_q")
                        else rng.uniform(1e-3, 1.0, b[k].shape).astype(np.float32))
    st["pos"] = rng.integers(0, S, B).astype(np.int32)
    return jax.tree.map(jnp.asarray, st)


def _assert_state_equal(tstate, jstate):
    want = _port_state(jstate)
    for tl, wl in zip(tstate["layers"], want["layers"]):
        for k in wl:
            np.testing.assert_array_equal(tl[k].numpy(), wl[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(tstate["pos"].numpy(), want["pos"].numpy())


# ---------------------------------------------------------------------------
# kvcache leftovers, SlotLedger, ColdStore
# ---------------------------------------------------------------------------
def _caches(seed=0, L=2, B=3, S=12, H=2, D=4):
    rng = np.random.default_rng(seed)
    leaves = {"k_q": rng.integers(-127, 128, (L, B, S, H, D)).astype(np.int8),
              "k_s": rng.uniform(0.01, 1, (L, B, S, H, 1)).astype(np.float32),
              "v_q": rng.integers(-127, 128, (L, B, S, H, D)).astype(np.int8),
              "v_s": rng.uniform(0.01, 1, (L, B, S, H, 1)).astype(np.float32),
              "lengths": np.array([5, 0, 9], np.int32)}
    return (JKV.KVCache(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TKV.KVCache(**{k: torch.from_numpy(v.copy()) for k, v in leaves.items()}))


def _assert_cache_equal(tc, jc):
    for k in ("k_q", "k_s", "v_q", "v_s", "lengths"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
                                      err_msg=k)


@pytest.mark.parametrize("op", ["bump", "bump_mask", "rewind", "alloc", "free",
                                "copy", "copy_past_end", "gather"])
def test_kvcache_leftovers_match_reference(op):
    jc, tc = _caches()
    args = {"bump": (JKV.bump_length, TKV.bump_length, (1,)),
            "bump_mask": (JKV.bump_length, TKV.bump_length, (np.array([1, 0, 2], np.int32),)),
            "rewind": (JKV.rewind_lengths, TKV.rewind_lengths, (np.array([3, 1, 4], np.int32),)),
            "alloc": (JKV.alloc_slot, TKV.alloc_slot, (1, 7)),
            "free": (JKV.free_slot, TKV.free_slot, (2,)),
            "copy": (JKV.copy_prefix, TKV.copy_prefix, (2, 1, 6)),
            "copy_past_end": (JKV.copy_prefix, TKV.copy_prefix, (0, 2, 20)),
            "gather": (JKV.gather_path, TKV.gather_path,
                       (np.array([2, 0, 5], np.int32),
                        np.array([[2, 3, 5], [1, 2, 3], [1, 3, 4]], np.int32),
                        np.array([2, 3, 1], np.int32)))}[op]
    jfn, tfn, a = args
    _assert_cache_equal(tfn(tc, *a), jfn(jc, *a))


def test_slot_ledger_matches_reference():
    j, t = JKV.SlotLedger(), TKV.SlotLedger()
    for op, slot in [("incref", 1), ("incref", 1), ("incref", 3), ("decref", 1),
                     ("count", 1), ("decref", 3), ("count", 3), ("decref", 1)]:
        assert getattr(t, op)(slot) == getattr(j, op)(slot)
        assert t.held() == j.held()
    for led in (j, t):
        with pytest.raises(RuntimeError, match="double free"):
            led.decref(1)


def test_cold_store_matches_reference():
    """The same put / pop / get / pin / touch / drop sequence on both stores:
    the same returns (evicted keys included), rows and bytes."""
    def block(n):
        return {"a": np.zeros((1, n, 2), np.int8), "s": np.zeros((1, n, 1), np.float32)}
    j, t = JKV.ColdStore(10), TKV.ColdStore(10)
    ops = [("put", "a", 4, False), ("put", "b", 3, True), ("put", "c", 3, False),
           ("touch", "a"), ("put", "d", 4, False), ("put", "e", 11, False),
           ("put", "f", 7, False), ("get", "b"), ("unpin", "b"), ("pin", "b"),
           ("put", "g", 3, False), ("pop", "b"), ("drop", "g"), ("drop", "g"),
           ("put", "a", 2, True), ("rows_of", "a")]
    for op in ops:
        outs = []
        for store in (j, t):
            if op[0] == "put":
                r = store.put(op[1], block(op[2]), op[2], pinned=op[3])
            elif op[0] in ("pop", "get"):
                tree, n = getattr(store, op[0])(op[1])
                r = (sorted(tree), n)
            else:
                r = getattr(store, op[0])(op[1])
            outs.append((r, store.rows_used, store.bytes_used, len(store),
                         [store.has(k) for k in "abcdefg"]))
        assert outs[1] == outs[0], op
    with pytest.raises(KeyError):
        t.pop("zz")
    with pytest.raises(ValueError):
        TKV.ColdStore(-1)


# ---------------------------------------------------------------------------
# copy_slot_prefix / warm_prefill_carry / the warm finalize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst,n", [(0, 1, 5), (2, 0, 11), (1, 1, 3)])
def test_copy_slot_prefix_matches_jax(model, src, dst, n):
    jcfg, _, _, _ = model
    js = _random_state(jcfg, 3, 16, seed=n)
    ts = _port_state(js)
    got = TT.copy_slot_prefix(ts, src, dst, n)
    _assert_state_equal(got, JT.copy_slot_prefix(js, jnp.int32(src), jnp.int32(dst),
                                                jnp.int32(n)))
    assert got is ts                           # in place


@pytest.mark.parametrize("slot,n", [(0, 1), (1, 7), (2, 16)])
def test_warm_prefill_carry_matches_jax(model, slot, n):
    """The dequantized carry equals JAX's bit for bit (one f32 multiply a
    value), zero past ``n``, cursor at ``n``; the port's carry is
    ``carry_len(max_len)`` rows and carries the prompt's first ``n`` ids."""
    jcfg, tcfg, _, _ = model
    S, buf = 16, TT.carry_len(16)
    js = _random_state(jcfg, 3, S, seed=slot)
    ids = list(range(100, 100 + n))
    got = TM.warm_prefill_carry(tcfg, _port_state(js), slot, n, buf, ids)
    want = _np(JM.warm_prefill_carry(jcfg, js, jnp.int32(slot), jnp.int32(n), buf))
    for grp in want["groups"]:                  # [L, 1, buf, H, D] vs per layer
        for b in grp:
            for name in ("k", "v"):
                stacked = np.stack([lay[name][0].numpy() for lay in got["layers"]])[:, None]
                np.testing.assert_array_equal(stacked, b[name], err_msg=name)
    assert int(got["pos"][0]) == n == int(want["pos"][0])
    assert got["tokens"][0, :n].tolist() == ids and not got["tokens"][0, n:].any()


def _run_chunks(prefill_chunk, carry, prompt, start, chunk, to_tokens):
    i = start
    logits = None
    while i < len(prompt):
        n = min(chunk, len(prompt) - i)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[i:i + n]
        logits, carry = prefill_chunk(carry, to_tokens(toks), n)
        i += n
    return logits, carry


@pytest.mark.parametrize("n", [5, 12])
def test_warm_finalize_keeps_cached_rows_byte_identical(model, n):
    """The port's form of ``TestWarmFinalizeBitExact``: prefill a prompt
    into slot 0, copy its first ``n`` rows into slot 1, resume chunked
    prefill there from the warm carry and finalize.  The cached rows'
    ``k_q``, ``k_s``, ``v_q`` and ``v_s`` stay byte-identical to slot 0's;
    a whole-row finalize requantizes them to the same bytes on the CPU
    (IEEE division round-trips every scale); the warm tail's first token
    and its rows equal JAX's warm run (int8 codes but for rounding
    boundaries)."""
    jcfg, tcfg, jp, tp = model
    rt, jrt = Runtime(), JRuntime()
    max_len, chunk = 32, 4
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, 18).tolist()
    L = len(prompt)
    buf = TT.carry_len(max_len)

    def tchunk(carry, toks, k):
        return TM.prefill_chunk(tp, tcfg, carry, toks, k, rt)
    state = TM.init_decode_state(tcfg, 2, max_len, "cpu")
    _, carry = _run_chunks(tchunk, TM.init_prefill_carry(tcfg, buf, "cpu"), prompt, 0,
                           chunk, lambda t: torch.from_numpy(t).long())
    TT.write_slot(state, 0, TM.finalize_prefill_carry(tcfg, carry, max_len))
    TT.copy_slot_prefix(state, 0, 1, n)
    wcarry = TM.warm_prefill_carry(tcfg, state, 1, n, buf, prompt[:n])
    tlog, wcarry = _run_chunks(tchunk, wcarry, prompt, n, chunk,
                               lambda t: torch.from_numpy(t).long())
    whole = TM.finalize_prefill_carry(tcfg, wcarry, max_len)
    TT.write_slot(state, 1, TM.finalize_prefill_carry(tcfg, wcarry, max_len, n), n)
    for li, (lay, w) in enumerate(zip(state["layers"], whole["layers"])):
        for name in ("k_q", "k_s", "v_q", "v_s"):
            np.testing.assert_array_equal(lay[name][1, :n].numpy(), lay[name][0, :n].numpy(),
                                          err_msg=f"layer {li} {name} cached rows drifted")
            np.testing.assert_array_equal(w[name][0, :n].numpy(), lay[name][0, :n].numpy(),
                                          err_msg=f"layer {li} {name} round trip")
            np.testing.assert_array_equal(w[name][0, n:L].numpy(), lay[name][1, n:L].numpy())
    assert int(state["pos"][1]) == L

    # the same warm run in JAX
    def jchunk(carry, toks, k):
        return JM.prefill_chunk(jp, jcfg, carry, toks, jnp.int32(k), jrt)
    js = JM.init_decode_state(jcfg, 2, max_len)
    _, jc = _run_chunks(jchunk, JM.init_prefill_carry(jcfg, max_len + chunk), prompt, 0,
                        chunk, jnp.asarray)
    js = JT.write_slot(js, jnp.int32(0), JM.finalize_prefill_carry(jcfg, jc, max_len))
    js = JT.copy_slot_prefix(js, jnp.int32(0), jnp.int32(1), jnp.int32(n))
    jw = JM.warm_prefill_carry(jcfg, js, jnp.int32(1), jnp.int32(n), max_len + chunk)
    jlog, jw = _run_chunks(jchunk, jw, prompt, n, chunk, jnp.asarray)
    js = _port_state(JT.write_slot(js, jnp.int32(1),
                                   JM.finalize_prefill_carry(jcfg, jw, max_len)))
    assert int(np.argmax(np.asarray(jlog))) == int(torch.argmax(tlog))
    for lay, jlay in zip(state["layers"], js["layers"]):
        for name in ("k_q", "v_q"):
            same = (lay[name][1, :L] == jlay[name][1, :L]).float().mean().item()
            assert same > 0.999, (name, same)
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(lay[name][1, :L].numpy(), jlay[name][1, :L].numpy(),
                                       rtol=1e-5)


def test_cold_chunked_prefill_still_bit_equal_to_one_shot(model):
    """A chunk writes the carry only from its cursor on, so a cold chunked
    prefill keeps one-shot prefill's bits for any chunking (the pieces'
    reruns below the cursor rewrote equal bits before)."""
    _, tcfg, _, tp = model
    rt = Runtime()
    max_len = 160
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab_size, 150).tolist()
    want_log, want = TM.prefill(tp, tcfg, {"inputs": torch.tensor([prompt])}, max_len, rt)
    for chunk in (5, 37, 64):
        def tchunk(carry, toks, k):
            return TM.prefill_chunk(tp, tcfg, carry, toks, k, rt)
        log, carry = _run_chunks(tchunk, TM.init_prefill_carry(tcfg, TT.carry_len(max_len),
                                                               "cpu"),
                                 prompt, 0, chunk, lambda t: torch.from_numpy(t).long())
        assert torch.equal(log, want_log)
        got = TM.finalize_prefill_carry(tcfg, carry, max_len)
        for gl, wl in zip(got["layers"], want["layers"]):
            for k in gl:
                assert torch.equal(gl[k][0, :len(prompt)], wl[k][0, :len(prompt)]), (chunk, k)


# ---------------------------------------------------------------------------
# faults: checksums and injected flips bit-equal to the reference's
# ---------------------------------------------------------------------------
def _blocks(jcfg, n, seed):
    """The same truncated cold block in both layouts (reference: stacked
    ``groups``; port: per-layer numpy dicts)."""
    js = _np(_random_state(jcfg, 1, 16, seed))
    groups = tuple(tuple({k: v[:, :, :n] if "q" in k or k.endswith("_s") else v
                          for k, v in b.items()} for b in grp) for grp in js["groups"])
    jblob = {"groups": groups, "pos": np.asarray([n], np.int32)}
    port = convert.from_numpy(jblob, device="cpu")
    tblob = {"layers": [{k: v.numpy() for k, v in lay.items()} for lay in port["layers"]],
             "pos": np.asarray([n], np.int32)}
    return jblob, tblob


@pytest.mark.parametrize("n,seed,ber", [(1, 0, 1e-3), (7, 1, 2e-3), (13, 2, 5e-4)])
def test_checksums_and_injected_flips_match_reference(n, seed, ber):
    jcfg = JR.get("llama3-8b").reduced()
    jblob, tblob = _blocks(jcfg, n, seed)
    sums = TF.row_checksums(tblob)
    np.testing.assert_array_equal(sums, JF.row_checksums(jblob))
    assert TF.verify_rows(tblob, sums) == []
    ji, ti = JF.FaultInjector(seed=seed, ber=ber), TF.FaultInjector(seed=seed, ber=ber)
    for key in (("req", 3), ("leaf", 0)):
        jb, jflips = ji.corrupt_block(key, jblob)
        tb, tflips = ti.corrupt_block(key, tblob)
        np.testing.assert_array_equal(tflips, jflips)
        assert ti.injected == ji.injected
        # the flipped bytes land on the same (layer, row, head) in both
        want = convert.from_numpy(jb, device="cpu")["layers"]
        for tl, wl in zip(tb["layers"], want):
            for k in tl:
                np.testing.assert_array_equal(tl[k], wl[k].numpy(), err_msg=k)
        assert TF.verify_rows(tb, sums) == JF.verify_rows(jb, JF.row_checksums(jblob))
    # the input block is never mutated
    np.testing.assert_array_equal(TF.row_checksums(tblob), sums)


@pytest.mark.parametrize("ber,ecc_t", [(0.0, 8), (3e-4, 8), (2e-2, 1)])
def test_fault_tolerance_read_matches_reference(ber, ecc_t):
    """One cold read through the metered ECC and checksum pipeline: the
    same stats, the same verdict (clean, corrected, or ColdBlockCorrupt)."""
    jcfg = JR.get("llama3-8b").reduced()
    jblob, tblob = _blocks(jcfg, 9, 4)
    keys = ("ecc_checks", "ecc_pages", "ecc_cycles", "ecc_corrected_bits",
            "bitflips_injected", "uncorrectable_blocks")
    outs = []
    for mod, blob in ((JF, jblob), (TF, tblob)):
        stats = dict.fromkeys(keys, 0)
        ft = mod.FaultTolerance(stats, mod.FaultInjector(seed=1, ber=ber), ecc_t=ecc_t)
        ft.note_write("k", blob)
        try:
            ft.read_block("k", blob)
            verdict = "ok"
        except mod.ColdBlockCorrupt as e:
            verdict = ("corrupt", e.bad_rows)
        outs.append((verdict, stats))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# SwapManager's cost model and block shaping
# ---------------------------------------------------------------------------
def test_swap_manager_cost_model_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    je = JCB(jcfg, jp, n_slots=2, max_len=48, kv_swap=True)
    te = TCB(tcfg, tp, n_slots=2, max_len=48, kv_swap=True, device="cpu")
    js, ts = je._swap, te._swap
    assert (ts.row_bytes, ts.fixed_bytes) == (js.row_bytes, js.fixed_bytes)
    assert ts.replay_tpot_s == js.replay_tpot_s and ts.store.row_budget == js.store.row_budget
    for n in (0, 1, 7, 47, 96, 97):
        assert ts.block_bytes(n) == js.block_bytes(n)
        tc, jc = ts.transfer_cost(ts.block_bytes(n)), js.transfer_cost(js.block_bytes(n))
        assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
        assert (tc.cycles_out, tc.cycles_in) == (jc.cycles_out, jc.cycles_in)
        for replay in (0, 1, 3, 30, 300):
            assert ts.prefer_swap(n, replay) == js.prefer_swap(n, replay)
    for tpot in (None, 1e-12, 1e3):
        ts.replay_tpot_s = js.replay_tpot_s = tpot
        for n in (1, 4, 40):
            assert ts.prefer_swap(n, 1) == js.prefer_swap(n, 1)


def test_truncate_keeps_live_rows_verbatim(model):
    """A truncated block is the slot's live rows verbatim (SSM-free stacks:
    every leaf cut to ``n`` rows), and its bytes are the reference's."""
    jcfg, tcfg, jp, tp = model
    te = TCB(tcfg, tp, n_slots=2, max_len=48, kv_swap=True, device="cpu")
    je = JCB(jcfg, jp, n_slots=2, max_len=48, kv_swap=True)
    prompt = list(range(1, 9))
    assert te.generate_all([prompt], [4]) == je.generate_all([prompt], [4])
    n = int(te._slot_pos[0])
    one = {"layers": [{k: v.numpy() for k, v in lay.items()}
                      for lay in TT.read_slot(te.state, 0)["layers"]],
           "pos": np.asarray([n], np.int32)}
    blob = te._swap.truncate(one, n)
    for got, ref in zip(blob["layers"], one["layers"]):
        for k in ref:
            assert got[k].shape == (1, n) + ref[k].shape[2:]
            np.testing.assert_array_equal(got[k], ref[k][:, :n])
    jone = _np(JT.read_slot(je.state, jnp.int32(0)))
    assert TKV.cache_bytes(blob) == JKV.cache_bytes(je._swap.truncate(jone, n))


# ---------------------------------------------------------------------------
# engines token-identical to JAX's, with equal stats
# ---------------------------------------------------------------------------
def _shared_trace(cfg, seed, groups=2, per=3, shared_len=10, tail_len=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(groups):
        shared = rng.integers(0, cfg.vocab_size, shared_len).tolist()
        out += [shared + rng.integers(0, cfg.vocab_size, tail_len).tolist()
                for _ in range(per)]
    return out


def _drive_prefix(eng, prompts):
    """Each group's leader first (a prefix is published at retirement), then
    the followers together."""
    leaders, rest = prompts[::3], [p for i, p in enumerate(prompts) if i % 3]
    return eng.generate_all(leaders, 5) + eng.generate_all(rest, 6)


def _drive_preempt(eng, prompts):
    """Low-priority requests first; after a few steps higher-priority ones
    arrive and preempt decoding residents."""
    reqs = [eng.submit(p, 8, priority=0) for p in prompts[:3]]
    for _ in range(4):
        eng.step()
    reqs += [eng.submit(p, 4, priority=5 + i) for i, p in enumerate(prompts[3:])]
    eng.drain()
    return [r.output for r in reqs]


def _drive_tiers(eng, prompts):
    """Serial requests a, b, c: b's publish pushes a's leaf out of a small
    cache (demoted to the cold tier), and c shares a's prefix (promoted)."""
    return [eng.generate_all([p], [4])[0] for p in prompts]


def _tier_prompts(cfg):
    rng = np.random.default_rng(3)
    pre = rng.integers(0, cfg.vocab_size, 10).tolist()
    return [pre + rng.integers(0, cfg.vocab_size, 4).tolist(),
            rng.integers(0, cfg.vocab_size, 14).tolist(),
            pre + rng.integers(0, cfg.vocab_size, 4).tolist()]


LANES = {
    "prefix": (dict(chunk=4, prefix_cache=True), _drive_prefix,
               lambda cfg: _shared_trace(cfg, 2)),
    "swap": (dict(chunk=4, policy="priority:preempt", kv_swap=True), _drive_preempt,
             lambda cfg: _shared_trace(cfg, 5, groups=2, per=3, shared_len=2)),
    "both": (dict(chunk=4, prefix_cache=True, prefix_cache_rows=20, kv_swap=True),
             _drive_tiers, _tier_prompts),
}


def _same_stats(te, je):
    """Every stat both engines keep is equal but the clocks and
    ``xfer_bytes``: the port moves only a block's live rows between the pool
    and the host, where the reference moves the whole slot row (full pool
    length, then truncates or pads on the host), so the port's transfer
    bytes are the reference's less each block copy's dead rows."""
    shared = set(te.stats) & set(je.stats)
    for k in sorted(shared - set(SKIP)):
        assert te.stats[k] == je.stats[k], k
    dead = 0
    if te._swap is not None:
        whole = te._swap.block_bytes(te.state["layers"][0]["k_q"].shape[1]) + 4
        dead = ((te.stats["swap_outs"] + te.stats["swap_ins"]) * whole
                - te.stats["swap_out_bytes"] - te.stats["swap_in_bytes"])
    assert te.stats["xfer_bytes"] == je.stats["xfer_bytes"] - dead


@pytest.mark.parametrize("lane", sorted(LANES))
def test_engines_token_identical_with_equal_stats(model, lane):
    jcfg, tcfg, jp, tp = model
    kw, drive, trace = LANES[lane]
    prompts = trace(jcfg)
    je = JCB(jcfg, jp, n_slots=2, max_len=48, **kw)
    te = TCB(tcfg, tp, n_slots=2, max_len=48, device="cpu", **kw)
    assert drive(te, prompts) == drive(je, prompts)
    _same_stats(te, je)
    if te._pcache is not None:
        assert te.stats["prefix_hits"] > 0
        assert te.stats["prefill_tokens_saved"] > 0
        assert te._pcache.stats == je._pcache.stats
        free, cached = set(te.scheduler.free_slots), set(te._pcache._slots)
        assert free | cached == set(range(2)) and not free & cached
    if te._swap is not None:
        assert te.stats["swap_outs"] > 0
        assert te._swap.store.rows_used == je._swap.store.rows_used
        assert [d for d, _, _ in te.swap_copies].count("d2h") == te.stats["swap_outs"]
    if lane == "swap":
        assert te.stats["preempt_swaps"] >= 1
        assert te.stats["swap_in_bytes"] == te.stats["swap_out_bytes"]
    if lane == "both":
        assert te._pcache.stats["demotions"] > 0 and te._pcache.stats["promotions"] == 1


def test_swapped_rows_return_verbatim(model):
    """A swap-preempted victim's restored rows are byte-identical to the
    rows that left, and its output equals a solo unpreempted run."""
    jcfg, tcfg, jp, tp = model
    prompts = _shared_trace(jcfg, 5)
    solo = TCB(tcfg, tp, n_slots=1, max_len=48, device="cpu").generate_all(
        [prompts[0]], [10])[0]
    eng = TCB(tcfg, tp, n_slots=1, max_len=48, policy="priority:preempt",
              kv_swap=True, device="cpu")
    lo = eng.submit(prompts[0], 10, priority=0)
    for _ in range(3):
        eng.step()
    n = int(eng._slot_pos[0])
    before = TT.read_slot(eng.state, 0, n)
    hi = eng.submit(prompts[1], 3, priority=9)
    eng.step()                                  # the preemption swaps lo out
    assert eng._swap.has(("req", lo.rid))
    while not hi.done:
        eng.step()
    eng.step()                                  # lo comes back
    after = TT.read_slot(eng.state, lo.slot, n)
    for b, a in zip(before["layers"], after["layers"]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    eng.drain()
    assert lo.output == solo and eng.stats["preempt_swaps"] >= 1
    assert eng._swap.store.rows_used == 0


def test_gating_and_stats_schema(model):
    """The prefix cache needs chunked prefill; SSM stacks turn it off
    silently; the feature keys exist only when the feature is on (the
    fault layer's too, since it is wired in), and a deadline is taken."""
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="chunked prefill"):
        TCB(tcfg, tp, n_slots=2, max_len=48, prefix_cache=True, device="cpu")
    plain = TCB(tcfg, tp, n_slots=2, max_len=48, chunk=4, device="cpu")
    assert not {"prefix_hits", "swap_outs", "preempt_swaps"} & set(plain.stats)
    on = TCB(tcfg, tp, n_slots=2, max_len=48, chunk=4, prefix_cache=True, kv_swap=True,
             device="cpu")
    assert {"prefix_hits", "cached_tokens", "prefill_tokens_saved", "swap_outs",
            "swap_ins", "swap_out_bytes", "swap_in_bytes", "swap_out_cycles",
            "swap_in_cycles", "preempt_swaps", "preempt_recomputes"} <= set(on.stats)
    assert isinstance(on._pcache, RadixPrefixCache)
    assert "ecc_checks" not in on.stats
    ft = TCB(tcfg, tp, n_slots=2, max_len=48, faults=True, device="cpu")
    assert ft._ft is not None and {"ecc_checks", "quarantined_slots"} <= set(ft.stats)
    assert on.submit([1, 2], 2, deadline_s=1.0).deadline_s == 1.0
    with pytest.raises(ValueError):
        TCB(tcfg, tp, n_slots=2, max_len=48, drain_stall_limit=0, device="cpu")
    ssm_cfg = TR.get("mamba2-2.7b").reduced()
    ssm = TCB(ssm_cfg, TM.init_params(ssm_cfg, device="cpu"), n_slots=2, max_len=48,
              chunk=4, prefix_cache=True, device="cpu")
    assert ssm._pcache is None and "prefix_hits" not in ssm.stats
