"""The port's fused multi-step lane (A.9) and its chunked prefill, scheduling
policies with preempt-replay and per-request sampling (A.7), against the JAX
package on the CPU.

Mirrors ``tests/test_multi_step.py`` and ``tests/test_scheduler_policies.py``
class by class, on the reduced llama3-8b and mamba2-2.7b with the JAX
parameters converted to the port (``convert.py``).  Tolerances: tokens
exact; logits within 1e-3 of the logit scale against JAX (as every port
test), bit-equal where both sides are the port; the int8 K/V rows equal to
JAX's but for rare codes on a rounding boundary (> 99.9%).  On the CPU the
engine's captured steps (``models/graphs.py``) run eagerly on the same
static buffers; their CUDA-graph replay is held bit-equal to eager in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.quantize import quantize_tree as jquantize
from repro.serve.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch import kernels as KN
from repro_torch.configs import registry as TR
from repro_torch.models import graphs as G
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, device_topk
from repro_torch.serve.scheduler import Request, RequestState

JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
JSSM = JR.get("mamba2-2.7b").reduced()
TSSM = TR.get("mamba2-2.7b").reduced()
POLICIES = ("fifo", "sjf", "priority:preempt", "fair:3")
STATS = ("steps", "decode_steps", "prefill_tokens", "chunks", "max_step_prefill_tokens",
         "max_step_total_tokens", "preemptions", "multi_blocks", "multi_tokens",
         "xfer_bytes", "decode_xfer_bytes")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def llama():
    jp = JM.init_params(jax.random.key(0), JCFG)
    return jp, convert.from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def mamba():
    jp = JM.init_params(jax.random.key(0), JSSM)
    return jp, convert.from_numpy(_np(jp), device="cpu")


def _trace(cfg, n=6, seed=11):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(l)).tolist()
               for l in rng.integers(3, 16, size=n)]
    budgets = [int(b) for b in rng.integers(2, 9, size=n)]
    return prompts, budgets


def _engine(tp, cfg=TCFG, **kw):
    kw = {"n_slots": 2, "max_len": 32, **kw}
    return ContinuousBatchingEngine(cfg, tp, device="cpu", **kw)


def _serve(eng, prompts, budgets, request=None):
    reqs = [eng.submit(p, b, **(request(i) if request else {}))
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    eng.drain()
    return [r.output for r in reqs]


def _mixed(i):
    """Per-request priorities and users, so the policies reorder and preempt."""
    return {"priority": (0, 2, 1)[i % 3], "user": "AB"[i % 2]}


@pytest.fixture(scope="module")
def plain(llama):
    prompts, budgets = _trace(JCFG)
    return _serve(_engine(llama[1]), prompts, budgets)


def _clone(state):
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
            "pos": state["pos"].clone()}


def _pool(jp, B=3, max_len=32, m=4):
    """A JAX pool of B slots (prompts 4 / 6 / 5 tokens) and its port copy."""
    rt = JT.Runtime()
    state = JM.init_decode_state(JCFG, B, max_len + m - 1)
    for b, plen in enumerate((4, 6, 5)[:B]):
        toks = jnp.asarray(np.arange(1, plen + 1)[None], jnp.int32)
        _, one = JM.prefill(jp, JCFG, {"inputs": toks,
                                       "lengths": jnp.array([plen], jnp.int32)},
                            max_len, rt)
        state = JT.write_slot(state, jnp.int32(b), one)
    return state, convert.from_numpy(_np(state), device="cpu")


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------
class TestMultiDecodeStep:
    @pytest.mark.parametrize("backend", ["dense", "fused_int8"])
    def test_matches_sequential_decode_and_reference(self, llama, backend):
        """The [B, m] block equals m sequential argmax-fed decode steps (tokens
        and every K/V leaf bit for bit) and JAX's ``multi_decode_step``
        (tokens exact, cursor equal, int8 rows > 99.9% equal); rewinding the
        block state to the sequential cursor decodes on bit for bit."""
        jp, tp = llama
        qj = jquantize(jp)
        tq = convert.from_numpy(_np(qj), device="cpu")
        jstate, tstate = _pool(jp)
        m = 4
        tok0 = np.array([3, 5, 7], np.int32)
        rt = TT.Runtime(backend)
        st, tok, seq = _clone(tstate), torch.from_numpy(tok0), []
        for _ in range(m):
            lg, st = TM.decode_step(tq, TCFG, st, tok, rt)
            tok = torch.argmax(lg, -1).to(torch.int32)
            seq.append(tok)
        blk, mstate = TM.multi_decode_step(tq, TCFG, _clone(tstate), torch.from_numpy(tok0),
                                           m, rt)
        assert blk.dtype == torch.int32 and blk.shape == (3, m)
        assert torch.equal(blk, torch.stack(seq, dim=1))
        for a, b in zip(G.state_tensors(mstate), G.state_tensors(st)):
            assert torch.equal(a, b)
        jblk, jst = JM.multi_decode_step(qj, JCFG, jstate, jnp.asarray(tok0), m,
                                         JT.Runtime(backend=backend))
        np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
        np.testing.assert_array_equal(mstate["pos"].numpy(), np.asarray(jst["pos"]))
        jk = np.asarray(jst["groups"][0][0]["k_q"])
        tk = np.stack([c["k_q"].numpy() for c in mstate["layers"]])
        assert np.mean(jk == tk) > 0.999
        # overshoot rollback: rewind one step and decode again
        rewound = TT.rewind_pos(mstate, (st["pos"] - 1).numpy())
        assert rewound["pos"] is mstate["pos"]
        again, _ = TM.decode_step(tq, TCFG, rewound, seq[-2], rt)
        st2 = _clone(tstate)
        for t in [torch.from_numpy(tok0)] + seq[:-2]:
            lg, st2 = TM.decode_step(tq, TCFG, st2, t, rt)
        want, _ = TM.decode_step(tq, TCFG, st2, seq[-2], rt)
        assert torch.equal(again, want)

    def test_state_tensors_stay_in_place(self, llama, mamba):
        """Every step writes into the state's tensors, never swaps one (what
        a captured graph needs, and the counterpart of the reference's
        donation): decode, verify, the fused block, rewind, tree commit and
        admission keep every ``data_ptr``; an SSM stack's decode too."""
        jp, tp = llama
        _, tstate = _pool(jp)
        ptrs = [t.data_ptr() for t in G.state_tensors(tstate)]
        rt = TT.Runtime("fused_int8")
        tok = torch.tensor([1, 2, 3], dtype=torch.int32)
        TM.decode_step(tp, TCFG, tstate, tok, rt)
        TM.multi_decode_step(tp, TCFG, tstate, tok, 2, rt)
        TM.verify_step(tp, TCFG, tstate, tok[:, None].repeat(1, 3), rt)
        TT.rewind_pos(tstate, np.array([5, 6, 7], np.int32))
        depth, anc = (torch.tensor(x, dtype=torch.int32).repeat(3, 1)
                      for x in ([0, 1, 1], [1, 3, 5]))
        TM.verify_step(tp, TCFG, tstate, tok[:, None].repeat(1, 3), rt,
                       depth=depth, anc=anc)
        base = torch.tensor([5, 6, 7], dtype=torch.int32)
        TM.tree_commit(tstate, base, torch.tensor([[2, 0]] * 3, dtype=torch.int32),
                       torch.ones(3, dtype=torch.int32), base + 2)
        _, one = TM.prefill(tp, TCFG, {"inputs": torch.arange(1, 6)[None]}, 32, rt)
        TT.write_slot(tstate, 1, one)
        assert [t.data_ptr() for t in G.state_tensors(tstate)] == ptrs
        np.testing.assert_array_equal(tstate["pos"].numpy(), [7, 5, 9])
        sstate = TM.init_decode_state(TSSM, 2, 8, device="cpu")
        sptrs = [t.data_ptr() for t in G.state_tensors(sstate)]
        for _ in range(2):
            TM.decode_step(mamba[1], TSSM, sstate, torch.tensor([4, 9], dtype=torch.int32),
                           TT.Runtime("fused_int8"))
        assert [t.data_ptr() for t in G.state_tensors(sstate)] == sptrs
        assert float(sstate["layers"][0]["h"].abs().sum()) > 0


class TestServeStepsOnCpu:
    def test_steps_run_eagerly_on_the_static_buffers(self, llama):
        """On the CPU a :class:`ServeSteps` captures nothing: each step runs
        the model function on its static buffers, equal to calling it."""
        jp, tp = llama
        _, tstate = _pool(jp)
        rt = TT.Runtime("fused_int8")
        ref = _clone(tstate)
        steps = G.ServeSteps(tp, TCFG, rt, tstate, verify=(3,))
        assert all(g.graph is None for g in steps.graphs.values())
        steps.tok.copy_(torch.tensor([4, 8, 15], dtype=torch.int32))
        logits, am = steps.decode()
        want, _ = TM.decode_step(tp, TCFG, ref, steps.tok, rt)
        assert torch.equal(logits, want) and torch.equal(am, want.argmax(-1).to(torch.int32))
        steps.window[3].copy_(torch.arange(9, dtype=torch.int32).reshape(3, 3))
        logits, am = steps.verify(3)
        want, _, _ = TM.verify_step(tp, TCFG, ref, steps.window[3], rt)
        assert torch.equal(logits, want)
        tok0 = steps.tok.clone()
        blk = steps.multi(2)
        wblk, _ = TM.multi_decode_step(tp, TCFG, ref, tok0, 2, rt)
        assert torch.equal(blk, wblk) and torch.equal(steps.tok, blk[:, -1])
        for a, b in zip(G.state_tensors(tstate), G.state_tensors(ref)):
            assert torch.equal(a, b)

    def test_replay_credits_the_captured_launches(self):
        """The counters a graph credits on replay add to the live counts, and
        a capture's own counts are taken back off."""
        KN.reset_launch_counts()
        before = KN.launch_counts()
        KN.credit_launches({"int8_matmul": 7, "rms_norm": 3})
        KN.credit_launches({"int8_matmul": 7, "rms_norm": 3})
        now = KN.launch_counts()
        assert now["int8_matmul"] == 14 and now["rms_norm"] == 6
        assert sum(now.values()) == 20
        KN.set_launch_counts(before)
        assert KN.launch_counts() == before


# ---------------------------------------------------------------------------
# engine parity with JAX: every policy x chunked or not x multi_step
# ---------------------------------------------------------------------------
class TestEngineLanesParity:
    @pytest.mark.parametrize("multi_step", [1, 4])
    @pytest.mark.parametrize("chunk", [None, 4])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_token_identical_to_jax(self, llama, plain, policy, chunk, multi_step):
        """Greedy streams token-identical to the JAX engine in the same
        configuration (and so to the plain engine), with the scheduling
        stats equal to JAX's; the chunked and fused lanes run."""
        jp, tp = llama
        prompts, budgets = _trace(JCFG)
        kw = {"policy": policy, "chunk": chunk, "multi_step": multi_step}
        jeng = JCB(JCFG, jp, n_slots=2, max_len=32, **kw)
        want = _serve(jeng, prompts, budgets, _mixed)
        teng = _engine(tp, **kw)
        got = _serve(teng, prompts, budgets, _mixed)
        assert got == want == plain
        for key in STATS:
            assert teng.stats[key] == jeng.stats[key], key
        if chunk:
            assert teng.stats["chunks"] > len(prompts)
        if multi_step > 1:
            assert teng.stats["multi_blocks"] > 0

    @pytest.mark.parametrize("m", [2, 8])
    def test_other_block_sizes(self, llama, plain, m):
        eng = _engine(llama[1], multi_step=m)
        assert _serve(eng, *_trace(JCFG)) == plain
        assert eng.stats["multi_blocks"] > 0
        assert eng.state["layers"][0]["k_q"].shape[1] == 32 + m - 1

    def test_spec_lane_takes_precedence(self, llama, plain):
        for lane in ({"spec_k": 4}, {"spec_tree": 4}):
            eng = _engine(llama[1], multi_step=4, **lane)
            assert _serve(eng, *_trace(JCFG)) == plain
            assert eng.stats["verify_steps"] > 0 and eng.stats["multi_blocks"] == 0

    def test_eos_mid_block_stops_exactly_and_backfills(self, llama):
        """An EOS inside a fused block stops the request where the single-step
        engine does (the EOS token is one whose first occurrence in the
        stream is the intended index), the overshoot unwinds and the freed
        slot backfills."""
        prompts, _ = _trace(JCFG)
        full = _serve(_engine(llama[1], n_slots=1), [prompts[0]], [8])[0]
        stop = next(i for i in range(2, 8) if full[i] not in full[:i])
        eng = _engine(llama[1], n_slots=1, multi_step=4)
        r_eos = eng.submit(prompts[0], 8, eos_id=full[stop])
        eng.drain()
        assert eng.stats["multi_blocks"] > 0
        r_next = eng.submit(list(reversed(prompts[0])), 3)
        eng.drain()
        assert r_eos.output == full[:stop + 1]
        solo = _serve(_engine(llama[1], n_slots=1), [list(reversed(prompts[0]))], [3])[0]
        assert r_next.output == solo

    def test_budget_overshoot_unwound(self, llama):
        prompts, _ = _trace(JCFG)
        ref = _serve(_engine(llama[1], n_slots=1), prompts[:3], [5, 7, 6])
        eng = _engine(llama[1], n_slots=1, multi_step=4)
        assert _serve(eng, prompts[:3], [5, 7, 6]) == ref
        assert eng.stats["multi_blocks"] > 0

    def test_ssm_ignores_chunk_and_multi_step(self, mamba):
        """SSM stacks keep the exact-length prefill and the one-token loop,
        token-identical to JAX's plain engine."""
        jp, tp = mamba
        prompts, budgets = _trace(JSSM, n=3)
        want = JCB(JSSM, jp, n_slots=2, max_len=32).generate_all(prompts, budgets)
        eng = _engine(tp, cfg=TSSM, chunk=4, multi_step=4)
        assert eng.chunk is None and eng.multi_step == 1
        assert _serve(eng, prompts, budgets) == want
        assert eng.stats["chunks"] == eng.stats["multi_blocks"] == 0

    def test_sampled_slots_fall_back_to_single_step(self, llama):
        prompts, _ = _trace(JCFG, n=4)

        def run(m):
            eng = _engine(llama[1], multi_step=m)
            out = _serve(eng, prompts, [6] * 4,
                         lambda i: {"temperature": 0.8, "top_k": 16, "seed": 100 + i})
            return out, eng
        (a, _), (b, eng_m) = run(1), run(4)
        assert a == b and eng_m.stats["multi_blocks"] == 0

    @pytest.mark.parametrize("kwargs", [{"multi_step": 0}, {"chunk": 0},
                                        {"chunk": 4, "max_step_tokens": 2}])
    def test_invalid_arguments_rejected(self, llama, kwargs):
        with pytest.raises(ValueError):
            _engine(llama[1], **kwargs)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
class TestChunkedPrefill:
    def test_prefill_chunks_match_one_shot_and_reference(self, llama):
        """A 13-token prompt in chunks of 4 (the last one ragged): the last
        chunk's logits equal the one-shot prefill's bit for bit and JAX's
        chunked prefill within 1e-3 of the logit scale; the finalized int8
        rows equal the one-shot prefill's; the cursor lands on 13."""
        jp, tp = llama
        prompt = np.random.default_rng(3).integers(0, JCFG.vocab_size, 13).astype(np.int32)
        rt, jrt = TT.Runtime(), JT.Runtime()
        carry = TM.init_prefill_carry(TCFG, TT.carry_len(32), device="cpu")
        jcarry = JM.init_prefill_carry(JCFG, 32 + 4)
        for start in range(0, 13, 4):
            n = min(4, 13 - start)
            toks = np.zeros((1, 4), np.int32)
            toks[0, :n] = prompt[start:start + n]
            lg, carry = TM.prefill_chunk(tp, TCFG, carry, torch.from_numpy(toks), n, rt)
            jlg, jcarry = JM.prefill_chunk(jp, JCFG, jcarry, jnp.asarray(toks), n, jrt)
        one_lg, one = TM.prefill(tp, TCFG, {"inputs": torch.from_numpy(prompt[None])}, 32, rt)
        assert torch.equal(lg, one_lg)
        scale = float(one_lg.abs().max())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-3 * scale)
        fin = TM.finalize_prefill_carry(TCFG, carry, 32)
        assert int(fin["pos"][0]) == 13
        for a, b in zip(fin["layers"], one["layers"]):
            for k in a:
                assert a[k].shape == b[k].shape and torch.equal(a[k][:, :13], b[k][:, :13])

    @pytest.mark.parametrize("sizes", [[3] * 50, [7] * 21 + [3], [64, 64, 22], [100, 50],
                                       [1] * 150], ids=["3", "7", "64", "100", "1"])
    def test_any_chunking_is_bit_equal_to_one_shot(self, llama, sizes):
        """Prefill runs in pieces of ``PREFILL_PIECE`` rows whatever the
        chunking, so a 150-token prompt's last logits and every int8 K/V row
        are the same bits in chunks of 1, 3, 7, 64 or 100 tokens as in one
        shot (pieces across chunk boundaries and blocks of keys no row
        sees included)."""
        tp = llama[1]
        rt = TT.Runtime()
        prompt = torch.from_numpy(np.random.default_rng(3).integers(0, TCFG.vocab_size, 150))
        max_len = 160
        want, one = TM.prefill(tp, TCFG, {"inputs": prompt[None],
                                          "lengths": torch.tensor([150])}, max_len, rt)
        carry = TM.init_prefill_carry(TCFG, TT.carry_len(max_len), device="cpu")
        pos = 0
        for n in sizes:
            toks = torch.zeros((1, max(sizes)), dtype=torch.long)
            toks[0, :n] = prompt[pos:pos + n]
            lg, carry = TM.prefill_chunk(tp, TCFG, carry, toks, n, rt)
            pos += n
        assert torch.equal(lg, want)
        fin = TM.finalize_prefill_carry(TCFG, carry, max_len)
        for a, b in zip(fin["layers"], one["layers"]):
            for k in a:
                assert torch.equal(a[k][:, :150], b[k][:, :150]), k

    @pytest.mark.parametrize("chunk,max_step_tokens", [(None, None), (7, None), (48, 20),
                                                       (100, None)])
    def test_engine_counts_the_pieces_it_runs(self, llama, monkeypatch, chunk,
                                              max_step_tokens):
        """The engine's ``prefill_pieces`` stat equals the prefill pieces its
        admissions run: ``prefill_pieces`` of the bucket one-shot,
        ``chunk_pieces`` a chunk (a chunk, or a budget-cut one, that crosses
        a piece boundary runs both pieces)."""
        ran = []
        real = TT._prefill_piece
        monkeypatch.setattr(TT, "_prefill_piece",
                            lambda *a, **k: ran.append(1) or real(*a, **k))
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, TCFG.vocab_size, n).tolist() for n in (5, 70, 150, 64)]
        kw = {"chunk": chunk} if chunk else {}
        if max_step_tokens:
            kw["max_step_tokens"] = max_step_tokens
        eng = _engine(llama[1], max_len=160, **kw)
        _serve(eng, prompts, [2] * len(prompts))
        assert eng.stats["prefill_pieces"] == len(ran) > len(prompts)

    @pytest.mark.parametrize("cursor,n,want", [(0, 64, 1), (0, 65, 2), (60, 8, 2),
                                               (64, 1, 1), (100, 100, 3)])
    def test_chunk_pieces(self, cursor, n, want):
        assert TT.chunk_pieces(cursor, n) == want

    def test_ssm_carry_raises(self):
        with pytest.raises(NotImplementedError):
            TM.init_prefill_carry(TSSM, 16, device="cpu")

    @pytest.mark.parametrize("chunk", [3, 7])
    @pytest.mark.parametrize("policy", POLICIES)
    def test_every_policy_and_chunk_matches_unchunked(self, llama, plain, policy, chunk):
        """Chunked outputs token-identical to the unchunked engine, and no
        iteration absorbs more prefill work than its budget."""
        prompts, budgets = _trace(JCFG)
        eng = _engine(llama[1], policy=policy, chunk=chunk)
        assert _serve(eng, prompts, budgets) == plain
        assert eng.stats["max_step_prefill_tokens"] <= eng.max_step_tokens
        assert eng.stats["max_step_prefill_tokens"] < max(len(p) for p in prompts)
        assert eng.stats["chunks"] > len(prompts)

    def test_prefill_progress_is_visible_across_steps(self, llama):
        eng = _engine(llama[1], max_len=48, chunk=4, max_step_tokens=6)
        a = eng.submit(list(range(1, 5)), 12)
        eng.step()
        assert a.state is RequestState.DECODING
        b = eng.submit(list(range(1, 17)), 4)
        cursors = []
        while b.state is not RequestState.DECODING:
            before = len(a.output)
            eng.step()
            cursors.append(b.prefill_pos)
            if a.state is RequestState.DECODING:
                assert len(a.output) == before + 1       # decode never stalled
        assert len(cursors) >= 3 and cursors == sorted(cursors)
        eng.drain()
        assert len(b.output) == 4

    def test_budget_holds_when_finalize_and_decode_share_iteration(self, llama):
        """A finalizing chunk's slot decodes in the same iteration, so the
        engine reserves a budget token for it: prefill plus decode tokens an
        iteration stay within ``max_step_tokens``, outputs equal JAX's."""
        jp, tp = llama
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, JCFG.vocab_size, int(l)).tolist()
                   for l in rng.integers(2, 6, size=6)]
        budgets = [int(b) for b in rng.integers(3, 7, size=6)]
        want = JCB(JCFG, jp, n_slots=2, max_len=32).generate_all(prompts, budgets)
        eng = _engine(tp, chunk=4, max_step_tokens=3)
        assert _serve(eng, prompts, budgets) == want
        assert 0 < eng.stats["max_step_total_tokens"] <= eng.max_step_tokens

    def test_failed_chunk_frees_the_slot(self, llama):
        """A prefill that raises fails its request, frees its slot and drops
        its carry; the other requests are served."""
        eng = _engine(llama[1], n_slots=1, chunk=4)
        bad = eng.submit([1, 2, 3, 4, 5], 3)
        real = TM.prefill_chunk

        def failing(*a, **k):
            raise RuntimeError("injected")
        TM.prefill_chunk = failing
        try:
            eng.step()
        finally:
            TM.prefill_chunk = real
        assert bad.error and "injected" in bad.error and bad.slot is None
        assert not eng._carries and eng.scheduler.free_slots == [0]
        good = eng.submit([1, 2, 3], 2)
        eng.drain()
        assert len(good.output) == 2


# ---------------------------------------------------------------------------
# preemption and replay
# ---------------------------------------------------------------------------
SAMPLED = {"temperature": 0.9, "top_k": 12, "seed": 42}


class TestPreemptionResume:
    @pytest.mark.parametrize("sampled", [False, True])
    def test_fair_quantum_preemption_reproduces_unpreempted_output(self, llama, sampled):
        prompts, _ = _trace(JCFG)
        kw = SAMPLED if sampled else {}
        solo = _serve(_engine(llama[1], n_slots=1, max_len=48), [prompts[0]], [14],
                      lambda i: kw)[0]
        eng = _engine(llama[1], n_slots=1, max_len=48, policy="fair:3", chunk=4)
        r1 = eng.submit(prompts[0], 14, user="A", **kw)
        r2 = eng.submit(prompts[1], 6, user="B")
        eng.drain()
        assert r1.n_preemptions >= 1 and eng.stats["preemptions"] >= 1
        assert r1.output == solo and len(r2.output) == 6

    @pytest.mark.parametrize("lane", [{}, {"spec_k": 3}, {"spec_tree": 4}],
                             ids=["decode", "spec_k", "spec_tree"])
    @pytest.mark.parametrize("sampled", [False, True])
    def test_priority_preemption_replays_through_every_lane(self, llama, lane, sampled):
        """A preemptive-priority arrival bumps the resident; it re-prefills and
        replays its recorded tokens (the spec lanes draft them), and its
        output, greedy or sampled, equals the uncontended run."""
        prompts, _ = _trace(JCFG)
        kw = SAMPLED if sampled else {}
        solo = _serve(_engine(llama[1], n_slots=1, max_len=48, **lane), [prompts[2]],
                      [10], lambda i: kw)[0]
        eng = _engine(llama[1], n_slots=1, max_len=48, policy="priority:preempt", **lane)
        lo = eng.submit(prompts[2], 10, priority=0, **kw)
        for _ in range(3):
            eng.step()
        hi = eng.submit(prompts[3], 3, priority=9)
        eng.drain()
        assert lo.n_preemptions >= 1
        assert lo.output == solo and len(hi.output) == 3

    def test_preempted_trace_matches_jax(self, llama):
        """A trace whose requests preempt each other (fair share, quantum 2,
        chunked) equals the JAX engine's request for request, preemption
        counts included."""
        jp, tp = llama
        prompts, budgets = _trace(JCFG, n=5, seed=2)
        kw = {"policy": "fair:2", "chunk": 4}
        want = _serve(JCB(JCFG, jp, n_slots=2, max_len=32, **kw), prompts, budgets, _mixed)
        eng = _engine(tp, **kw)
        assert _serve(eng, prompts, budgets, _mixed) == want
        assert eng.stats["preemptions"] > 0


# ---------------------------------------------------------------------------
# per-request sampling
# ---------------------------------------------------------------------------
def _tied_rows(V, n=24, seed=9):
    """Logit rows with many exact ties, so top-k cuts fall inside tie groups."""
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(0, 2, (n, V)), 1).astype(np.float32)


class TestSampler:
    @pytest.mark.parametrize("top_k", [None, 1, 5, 16, 511, 600])
    @pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
    def test_sample_token_bit_equal_to_reference(self, llama, top_k, temperature):
        """The host sampler draws the reference's token from the same numpy
        row for a whole seeded stream."""
        jeng = JCB(JCFG, llama[0], n_slots=1, max_len=32)
        teng = _engine(llama[1], n_slots=1)
        jreq = JRequest(rid=0, prompt=[1], max_new_tokens=4, temperature=temperature,
                        top_k=top_k, seed=11)
        treq = Request(rid=0, prompt=[1], max_new_tokens=4, temperature=temperature,
                       top_k=top_k, seed=11)
        rows = _tied_rows(JCFG.vocab_size)
        got = [teng._sample_token(treq, r) for r in rows]
        assert got == [jeng._sample_token(jreq, r) for r in rows]

    @pytest.mark.parametrize("k", [1, 5, 16])
    def test_device_preselect_matches_lax_top_k_and_samples_alike(self, llama, k):
        """The device pre-select orders ties lowest id first as
        ``lax.top_k`` does, and ``_sample_candidates`` on its output draws
        the reference's tokens and the full-row sampler's."""
        rows = _tied_rows(JCFG.vocab_size)
        vals, idx = device_topk(torch.from_numpy(rows), k)
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        assert idx.dtype == torch.int32
        jeng = JCB(JCFG, llama[0], n_slots=1, max_len=32)
        teng = _engine(llama[1], n_slots=1)
        mk = dict(rid=0, prompt=[1], max_new_tokens=4, temperature=0.8, top_k=k, seed=5)
        treq, jreq, full = Request(**mk), JRequest(**mk), Request(**mk)
        got = [teng._sample_candidates(treq, v, i) for v, i in zip(vals.numpy(), idx.numpy())]
        assert got == [jeng._sample_candidates(jreq, v, i)
                       for v, i in zip(np.asarray(jv), np.asarray(ji))]
        other = _engine(llama[1], n_slots=1)
        assert got == [other._sample_token(full, r) for r in rows]

    def test_top_k_ties_truncate_to_exactly_k(self, llama):
        eng = _engine(llama[1], n_slots=1)
        req = Request(rid=0, prompt=[1], max_new_tokens=4, temperature=1.0, top_k=2, seed=0)
        row = np.zeros((TCFG.vocab_size,), np.float32)
        row[3] = row[5] = row[9] = 7.0
        seen = {eng._sample_token(req, row) for _ in range(64)}
        assert seen == {3, 5}
        vals, idx = device_topk(torch.from_numpy(row)[None], 2)
        assert idx[0].tolist() == [3, 5]

    def test_seeded_sampling_is_deterministic(self, llama):
        prompts, _ = _trace(JCFG, n=4)

        def run():
            return _serve(_engine(llama[1]), prompts, [6] * 4,
                          lambda i: {"temperature": 0.8, "top_k": 16, "seed": 100 + i})
        a, b = run(), run()
        assert a == b and all(len(o) == 6 for o in a)

    def test_temperature_zero_matches_greedy_and_mixed_batch(self, llama):
        prompts, _ = _trace(JCFG, n=4)
        ref = _serve(_engine(llama[1]), [prompts[0]], [6])[0]
        eng = _engine(llama[1])
        greedy = eng.submit(prompts[0], 6, temperature=0.0)
        sampled = eng.submit(prompts[1], 6, temperature=1.2, seed=7)
        eng.drain()
        assert greedy.output == ref and len(sampled.output) == 6

    def test_topk_preselect_bit_identical_and_optional(self, llama):
        prompts, _ = _trace(JCFG, n=4)

        def run(pre, top_k):
            return _serve(_engine(llama[1], topk_preselect=pre), prompts, [6] * 4,
                          lambda i: {"temperature": 0.8, "top_k": top_k, "seed": 100 + i})
        assert run(True, 16) == run(False, 16)
        assert run(True, None) == run(False, None)

    def test_spec_verify_fetch_shrinks_and_stays_exact(self, llama):
        prompts, _ = _trace(JCFG, n=4)

        def run(lane, pre):
            return _serve(_engine(llama[1], topk_preselect=pre, **lane), prompts, [6] * 4,
                          lambda i: {"temperature": 0.8, "top_k": 16, "seed": 100 + i})
        base = run({}, True)
        for lane in ({"spec_k": 4}, {"spec_tree": 4}):
            assert run(lane, True) == run(lane, False) == base

    def test_bad_sampling_params_rejected(self, llama):
        eng = _engine(llama[1], n_slots=1)
        with pytest.raises(ValueError):
            eng.submit([1, 2], 2, temperature=-1.0)
        with pytest.raises(ValueError):
            eng.submit([1, 2], 2, top_k=0)


# ---------------------------------------------------------------------------
# transfer discipline and fixed addresses
# ---------------------------------------------------------------------------
class TestTransferDiscipline:
    def _steady(self, tp, **kw):
        """Two residents decoding with an empty queue."""
        eng = _engine(tp, max_len=64, **kw)
        for p in _trace(JCFG, n=2)[0]:
            eng.submit(p, 40)
        eng.step()
        return eng

    def test_greedy_transfer_is_O_slots_per_block(self, llama):
        """2 * n_slots int32 a single step (token push, argmax fetch) and
        (1 + m) * n_slots int32 a fused block."""
        eng = self._steady(llama[1])
        base = eng.stats["decode_xfer_bytes"]
        for _ in range(3):
            eng.step()
        assert eng.stats["decode_xfer_bytes"] - base == 3 * (2 * 2 * 4)
        eng4 = self._steady(llama[1], multi_step=4)
        base, blocks0 = eng4.stats["decode_xfer_bytes"], eng4.stats["multi_blocks"]
        for _ in range(2):
            eng4.step()
        assert eng4.stats["multi_blocks"] == blocks0 + 2
        assert eng4.stats["decode_xfer_bytes"] - base == 2 * (2 * 4 + 2 * 4 * 4)

    def test_sampled_transfer_is_O_slots_times_k(self, llama):
        eng = _engine(llama[1], max_len=64)
        for i, p in enumerate(_trace(JCFG, n=2)[0]):
            eng.submit(p, 40, temperature=0.8, top_k=16, seed=i)
        eng.step()
        base = eng.stats["decode_xfer_bytes"]
        for _ in range(3):
            eng.step()
        per_step = (eng.stats["decode_xfer_bytes"] - base) / 3
        assert per_step == 2 * 4 + 2 * 16 * 4 * 2       # push [2] + [2, 16] f32 + i32
        assert per_step < TCFG.vocab_size

    @pytest.mark.parametrize("lane", [{}, {"multi_step": 4}, {"spec_k": 3},
                                      {"spec_tree": 4}, {"chunk": 4}],
                             ids=["decode", "multi_step", "spec_k", "spec_tree", "chunk"])
    def test_pool_addresses_fixed_while_serving(self, llama, lane):
        """Admissions, steps, commits and rewinds all write the pool in
        place: every state tensor keeps its ``data_ptr`` over a whole trace
        (what the captured graphs replay over)."""
        eng = _engine(llama[1], **lane)
        ptrs = [t.data_ptr() for t in G.state_tensors(eng.state)]
        bufs = eng._steps.tok.data_ptr()
        reqs = [eng.submit(p, b) for p, b in zip(*_trace(JCFG))]
        while eng.scheduler.has_work():
            eng.step()
            assert [t.data_ptr() for t in G.state_tensors(eng.state)] == ptrs
        assert eng._steps.state is eng.state and eng._steps.tok.data_ptr() == bufs
        assert all(len(r.output) == r.max_new_tokens for r in reqs)
