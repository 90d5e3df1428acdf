"""The port's async streaming server (``serve/server.py``) and the serve CLI
(``launch/serve.py``) against the JAX engine on the CPU.

Mirrors ``tests/test_serve_server.py`` class by class on the reduced
llama3-8b, 2 slots, ``max_len`` 48, under ``fused_int8`` (the kernels'
plain versions here, the Pallas kernels in interpret mode on the JAX side),
with the JAX parameters converted to the port: streamed tokens equal the
JAX engine's ``generate_all`` on the same configuration (and the port's);
a disconnect frees the slot for a queued request mid-decode,
mid-chunked-prefill and between spec windows, with the engine-level cancels
replayed on the JAX engine (same outputs, same stats); drain hygiene,
backpressure, lifecycle, the monotonic clock, a failing serve loop and a
stream past its deadline behave as the reference's.  Every engine step of
a served run runs on the server's ``serve-step`` thread.  Tokens exact.
"""
import asyncio
import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import registry as JR
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as launch
from repro_torch.models import model as TM
from repro_torch.models.transformer import Runtime
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.engine import RequestFailedError
from repro_torch.serve.scheduler import RequestState
from repro_torch.serve.server import AsyncServer, RequestTimedOut, collect
from torch_parity import JaxRuns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
BASE = {"n_slots": 2, "max_len": 48}
CLOCKS = ("device_s", "step_s", "slow_steps")


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(jax.random.key(0), JCFG)
    return jp, convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(weights):
    return JaxRuns(JCFG, weights[0], BASE)


def _engine(tp, **kw) -> TCB:
    return TCB(TCFG, tp, rt=Runtime("fused_int8"), device="cpu", **{**BASE, **kw})


def _trace(n=5, seed=3, max_prompt=12, max_new=6):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, JCFG.vocab_size, rng.integers(3, max_prompt + 1)).tolist()
               for _ in range(n)]
    budgets = [int(rng.integers(2, max_new + 1)) for _ in range(n)]
    return prompts, budgets


def _generate(jax_runs, key, prompts, budgets, **kw):
    """JAX ``generate_all`` of a trace, computed once."""
    return jax_runs.run(key, lambda e: e.generate_all(prompts, budgets), **kw)[0]


def _stream_all(eng, prompts, budgets, stream_buffer=4, **submit_kw):
    """Submit everything to a live server and collect every stream."""
    async def run():
        async with AsyncServer(eng, stream_buffer=stream_buffer) as srv:
            streams = [await srv.submit(p, b, **submit_kw) for p, b in zip(prompts, budgets)]
            return [list(o) for o in await asyncio.gather(*(collect(s) for s in streams))]
    return asyncio.run(run())


def _same_stats(te, je):
    assert set(te.stats) == set(je.stats)
    for k in sorted(set(te.stats) - set(CLOCKS)):
        assert te.stats[k] == je.stats[k], k


class TestStreamParity:
    """The front end never changes what the engine emits: streamed tokens
    equal ``generate_all`` on a like-configured engine, for every policy."""

    @pytest.mark.parametrize("policy", ["fifo", "sjf", "priority:preempt", "fair:3"])
    def test_stream_matches_generate_all(self, weights, jax_runs, policy):
        prompts, budgets = _trace()
        want = _generate(jax_runs, ("policy", policy), prompts, budgets, policy=policy)
        assert _engine(weights[1], policy=policy).generate_all(prompts, budgets) == want
        eng = _engine(weights[1], policy=policy)
        steps = []
        real = eng.step
        eng.step = lambda: steps.append(threading.current_thread().name) or real()
        assert _stream_all(eng, prompts, budgets) == want
        assert steps and all(n.startswith("serve-step") for n in steps)

    def test_stream_parity_chunked_and_speculative(self, weights, jax_runs):
        """Chunked prefill and the ``spec_k`` lane under the server: the
        pending handoff and the pumps disturb neither chunk interleaving nor
        verify and rollback."""
        prompts, budgets = _trace(seed=5)
        kw = dict(chunk=3, spec_k=4, policy="sjf")
        want = _generate(jax_runs, "chunk_spec", prompts, budgets, **kw)
        eng = _engine(weights[1], **kw)
        assert _stream_all(eng, prompts, budgets, stream_buffer=2) == want
        assert eng.stats["chunks"] > 0 and eng.stats["verify_steps"] > 0


class TestDisconnect:
    """A disconnect frees the slot at the next iteration boundary and the
    next queued request is admitted into it; the cancelled request keeps
    its partial output and ends CANCELLED."""

    def test_cancel_mid_decode_frees_slot_for_queued(self, weights, jax_runs):
        p1, p2 = [1, 2, 3, 4, 5], [9, 8, 7, 6]
        ref1 = _generate(jax_runs, "solo_p1", [p1], [8], n_slots=1)[0]
        ref2 = _generate(jax_runs, "solo_p2", [p2], [4], n_slots=1)[0]
        eng = _engine(weights[1], n_slots=1)

        async def run():
            async with AsyncServer(eng, stream_buffer=4) as srv:
                s1 = await srv.submit(p1, 8)
                s2 = await srv.submit(p2, 4)     # queued behind s1
                got1 = []
                async for tok in s1:
                    got1.append(tok)
                    if len(got1) == 2:
                        s1.cancel()              # disconnect mid-decode
                return s1, got1, await collect(s2)

        s1, got1, got2 = asyncio.run(run())
        assert s1.cancelled and s1.request.state is RequestState.CANCELLED
        # tokens queued before the disconnect may still arrive after it
        assert got1[:2] == ref1[:2]
        out1 = s1.request.output
        assert 2 <= len(out1) < 8 and out1 == ref1[:len(out1)]   # partial, kept
        assert got2 == ref2                      # admitted into the freed slot
        assert not eng.scheduler.has_work() and not eng._carries

    def test_cancel_mid_chunked_prefill_drops_carry(self, weights, jax_runs):
        pA, pB = list(range(1, 13)), [5, 4, 3, 2]    # A: 6 chunks of 2
        kw = dict(n_slots=1, chunk=2)

        def drive(eng):
            rA, rB = eng.submit(pA, 4), eng.submit(pB, 4)
            eng.step()                           # A mid-prefill, carry live
            assert rA.state.value == "prefilling" and eng._carries   # either engine
            eng.cancel(rA)
            eng.drain()
            return rA, rB
        (jA, jB), je = jax_runs.run("cancel_prefill", drive, **kw)
        eng = _engine(weights[1], **kw)
        rA, rB = drive(eng)
        assert rA.state is RequestState.CANCELLED and rA.output == []
        assert not eng._carries and not eng._warm_rows      # carry dropped
        assert rB.output == jB.output == _generate(jax_runs, "solo_pB", [pB], [4], **kw)[0]
        _same_stats(eng, je)

    def test_cancel_between_spec_windows(self, weights, jax_runs):
        pA, pB = [2, 4, 6, 8, 10, 12], [11, 3, 5, 9]
        kw = dict(n_slots=1, spec_k=4)

        def drive(eng):
            rA, rB = eng.submit(pA, 12), eng.submit(pB, 5)
            while len(rA.output) < 2:            # at least one verify window
                eng.step()
            eng.cancel(rA)
            eng.drain()
            return rA, rB
        (jA, jB), je = jax_runs.run("cancel_spec", drive, **kw)
        eng = _engine(weights[1], **kw)
        rA, rB = drive(eng)
        assert rA.state is RequestState.CANCELLED
        assert 2 <= len(rA.output) < 12 and rA.output == jA.output
        # the freed rows were reused without a rewind: B is exact
        assert rB.output == jB.output == _generate(jax_runs, "solo_pB_spec", [pB], [5],
                                                   **kw)[0]
        assert not eng.scheduler.has_work()
        _same_stats(eng, je)

    def test_cancel_queued_request_never_runs(self, weights, jax_runs):
        def drive(eng):
            rA, rB = eng.submit([1, 2, 3], 3), eng.submit([4, 5, 6], 3)  # B queued
            eng.cancel(rB)
            eng.drain()
            return rA, rB
        (jA, _), je = jax_runs.run("cancel_queued", drive, n_slots=1)
        eng = _engine(weights[1], n_slots=1)
        rA, rB = drive(eng)
        assert rB.state is RequestState.CANCELLED and rB.output == [] and rB.slot is None
        assert rA.state is RequestState.FINISHED and rA.output == jA.output
        _same_stats(eng, je)


    def test_concurrent_disconnects_lose_no_cancel(self, weights):
        """Disconnects land in the engine's inbox from the event loop while
        the worker thread steps (the interpreter switching threads every
        microsecond): every request ends, each cancelled one CANCELLED (or
        FINISHED when its last token beat the cancel), and no slot, carry
        or cancel is left behind."""
        prompts, budgets = _trace(n=8, seed=7, max_new=12)
        eng = _engine(weights[1], chunk=4)

        async def run():
            async with AsyncServer(eng, stream_buffer=2) as srv:
                streams = await asyncio.gather(*(srv.submit(p, b)
                                                 for p, b in zip(prompts, budgets)))

                async def consume(i, s):
                    n = 0
                    async for _ in s:
                        n += 1
                        if i % 2 == 0 and n == 1 + i % 3:
                            s.cancel()
                await asyncio.wait_for(
                    asyncio.gather(*(consume(i, s) for i, s in enumerate(streams))), 120)
                return streams

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            streams = asyncio.run(run())
        finally:
            sys.setswitchinterval(interval)
        for i, s in enumerate(streams):
            want = (RequestState.CANCELLED, RequestState.FINISHED) if i % 2 == 0 else (
                RequestState.FINISHED,)
            assert s.request.state in want, i
        assert any(s.cancelled for s in streams)
        assert not eng._cancels and not eng._carries and not eng.scheduler.has_work()
        assert len(eng.scheduler.free_slots) == eng.n_slots


class TestDrainHygiene:
    """drain() terminates, not spins, when every remaining request has
    failed or been cancelled."""

    def test_drain_terminates_after_failing_queued_request(self, weights):
        eng = _engine(weights[1], n_slots=1)
        rA, rB = eng.submit([1, 2, 3], 2), eng.submit([4, 5, 6], 2)
        eng.scheduler.fail(rB, error="client gone")
        eng.drain()
        assert rA.state is RequestState.FINISHED and len(rA.output) == 2
        assert rB.error == "client gone" and rB.done

    def test_admission_failure_frees_slot_and_carry(self, weights, jax_runs, monkeypatch):
        """A chunk that raises mid-prefill (carry live) fails its request,
        drops the carry and frees the slot; the next request is served as
        JAX serves it after the same failure."""
        pA, pB = list(range(1, 11)), [7, 8, 9]
        kw = dict(n_slots=1, chunk=2)

        def exploding(real, calls):
            def fn(*a, **k):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("RESOURCE_EXHAUSTED: synthetic OOM")
                return real(*a, **k)
            return fn

        def drive(eng):
            eng._chunk_fn = exploding(eng._chunk_fn, {"n": 0})
            rA, rB = eng.submit(pA, 3), eng.submit(pB, 3)
            eng.drain()
            return rA, rB
        (jA, jB), je = jax_runs.run("admission_failure", drive, **kw)
        monkeypatch.setattr(TM, "prefill_chunk", exploding(TM.prefill_chunk, {"n": 0}))
        eng = _engine(weights[1], **kw)
        rA, rB = eng.submit(pA, 3), eng.submit(pB, 3)
        eng.drain()
        assert rA.error is not None and rA.done and jA.error is not None
        assert not eng._carries and not eng._pool_consumed()
        assert rB.state is RequestState.FINISHED and rB.output == jB.output
        assert len(rB.output) == 3


class TestBackpressure:
    """A consumer that stops reading parks its own pump at the queue bound;
    the step loop and every other stream keep going."""

    def test_slow_consumer_does_not_stall_step_loop(self, weights, jax_runs):
        p1, p2 = [1, 2, 3, 4], [5, 6, 7, 8]
        eng = _engine(weights[1])

        async def run():
            async with AsyncServer(eng, stream_buffer=1) as srv:
                slow = await srv.submit(p1, 6)
                fast = await srv.submit(p2, 6)
                fast_toks = await collect(fast)  # never touch slow
                while not slow.request.done:
                    await asyncio.sleep(0.005)
                assert slow._pumped < len(slow.request.output)
                return fast_toks, await collect(slow)   # the late reader gets it all

        fast_toks, slow_toks = asyncio.run(run())
        assert len(fast_toks) == 6 and len(slow_toks) == 6
        assert [slow_toks, fast_toks] == _generate(jax_runs, "pair", [p1, p2], [6, 6])

    def test_zero_buffer_rejected(self, weights):
        with pytest.raises(ValueError):
            AsyncServer(_engine(weights[1]), stream_buffer=0)


class TestServerLifecycle:
    def test_stop_cancels_inflight_and_rejects_new(self, weights):
        eng = _engine(weights[1], n_slots=1)

        async def run():
            srv = AsyncServer(eng, stream_buffer=4)
            await srv.start()
            s = await srv.submit([1, 2, 3], 12)
            await s.__anext__()                  # at least one token out
            await srv.stop()
            assert s.request.done                # cancelled by shutdown
            with pytest.raises(RuntimeError):
                await srv.submit([4, 5], 2)
            return s

        s = asyncio.run(run())
        assert s.request.state is RequestState.CANCELLED
        assert not eng.scheduler.has_work() and not eng._carries

    def test_invalid_submit_raises_at_caller(self, weights):
        eng = _engine(weights[1], max_len=16)

        async def run():
            async with AsyncServer(eng) as srv:
                with pytest.raises(ValueError):
                    await srv.submit(list(range(30)), 8)   # oversized
                ok = await srv.submit([1, 2, 3], 2)        # the server survives
                return [t async for t in ok]

        assert len(asyncio.run(run())) == 2


class TestMonotonicClock:
    def test_request_timestamps_ordered(self, weights):
        """arrival <= admit <= first token <= finish on one monotonic
        timebase, for drained and streamed requests."""
        prompts, budgets = _trace(n=4)
        eng = _engine(weights[1])
        rs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        eng.drain()

        async def run(eng2):
            async with AsyncServer(eng2) as srv:
                streams = [await srv.submit(p, b) for p, b in zip(prompts, budgets)]
                await asyncio.gather(*(collect(s) for s in streams))
                return [s.request for s in streams]

        rs += asyncio.run(run(_engine(weights[1])))
        for r in rs:
            assert 0.0 <= r.arrival_time <= r.admit_time
            assert r.admit_time <= r.first_token_time <= r.finish_time

    def test_clock_immune_to_wall_clock_skew(self, weights, monkeypatch):
        eng = _engine(weights[1])
        before = eng.now()
        monkeypatch.setattr(time, "time", lambda: -1e9)   # the wall clock jumps
        after = eng.now()
        assert before <= after < before + 60.0

    def test_reset_clock_rezeros(self, weights):
        eng = _engine(weights[1])
        time.sleep(0.01)
        assert eng.now() > 0.0
        eng.reset_clock()
        assert eng.now() < 0.01 + 1.0


class TestServeLoopFault:
    """An exception out of ``engine.step()`` on the worker thread fails
    every live stream, rejects later submissions, and ``stop()`` raises it."""

    def test_step_exception_fails_all_live_streams(self, weights):
        prompts, budgets = [[1, 2, 3]] * 3, [20] * 3
        eng = _engine(weights[1])
        orig = eng.step

        def flaky():
            if len(eng.scheduler.queue) + len(eng.scheduler.active) >= 3:
                raise RuntimeError("device on fire")
            return orig()
        eng.step = flaky

        async def run():
            srv = AsyncServer(eng, stream_buffer=4)
            await srv.start()
            streams = [await srv.submit(p, b) for p, b in zip(prompts, budgets)]
            failed = 0
            for s in streams:
                with pytest.raises(RequestFailedError):
                    async for _ in s:
                        pass
                failed += 1
            with pytest.raises(RuntimeError, match="serve loop has terminated"):
                await srv.submit(prompts[0], 2)
            with pytest.raises(RuntimeError, match="device on fire"):
                await srv.stop()
            return failed, streams

        failed, streams = asyncio.run(run())
        assert failed == len(streams) == 3

    def test_deadline_stream_raises_request_timed_out(self, weights, jax_runs):
        prompts, budgets = _trace(n=2)
        eng = _engine(weights[1])

        async def run():
            async with AsyncServer(eng, stream_buffer=4) as srv:
                fast = await srv.submit(prompts[0], budgets[0])
                late = await srv.submit(prompts[1], budgets[1], deadline_s=1e-6)
                toks = [t async for t in fast]
                with pytest.raises(RequestTimedOut):
                    async for _ in late:
                        pass
                assert late.timed_out and not late.cancelled
                assert late.request.state is RequestState.TIMEOUT
                return toks

        toks = asyncio.run(run())
        assert toks == _generate(jax_runs, "solo_fast", prompts[:1], budgets[:1])[0]
        assert eng.stats["timeouts"] == 1
        assert not eng.scheduler.has_work()


class TestServeCli:
    """``python -m repro_torch.launch.serve``: the reference's modes and
    flags, on the CPU when asked."""

    def test_serve_mode_shuts_down_clean(self, capsys):
        launch.main(["--arch", "llama3-8b", "--reduced", "--serve", "--requests", "3",
                     "--slots", "2", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "req 1: cancelled after" in out
        assert out.rstrip().endswith("SERVE_SHUTDOWN_CLEAN")

    def test_continuous_mode_with_faults_and_deadline(self, capsys):
        launch.main(["--arch", "llama3-8b", "--reduced", "--continuous", "--requests", "4",
                     "--slots", "2", "--steps", "6", "--chunk", "4", "--kv-swap",
                     "--policy", "priority:preempt", "--fault-steps", "5",
                     "--slot-loss", "7:1", "--deadline", "3600", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "pool_rebuilds=1" in out and "quarantined=1" in out
        assert "timeouts=0" in out

    @pytest.mark.parametrize("argv,item", [
        (["--mesh", "1x1", "--serve"], "req "),
        (["--arch", "mamba2-2.7b", "--mesh", "1x2"], "sample tokens")])
    def test_not_ported_options_raise(self, argv, item, capfd):
        """The streaming front end and the other families raised on a mesh
        until A.14b's serving half; now ``--serve --mesh 1x1`` (a leader
        alone) streams, and mamba2 on ``--mesh 1x2`` decodes, the lines
        ``item`` of the run without ``--mesh``."""
        plain = [a for i, a in enumerate(argv) if a != "--mesh" and argv[i - 1] != "--mesh"]
        launch.main(["--reduced", "--device", "cpu", *plain])
        want = [ln.strip() for ln in capfd.readouterr().out.splitlines()
                if ln.strip().startswith(item)]
        launch.main(["--reduced", "--device", "cpu", *argv])
        got = [ln.strip() for ln in capfd.readouterr().out.splitlines()
               if ln.strip().startswith(item)]
        assert got == want and want

    def test_fault_flags_build_the_injector(self):
        args = type("A", (), dict(faults=False, ber=2e-4, fault_steps="3,9", slot_loss="12:0",
                                  fault_every=0, fault_seed=5, fault_mode="retention"))
        inj = launch._make_faults(args)
        assert (inj.seed, inj.ber, inj.step_fail_at, inj.slot_loss_at) == (
            5, 2e-4, (3, 9), ((12, 0),))
        args.ber, args.fault_steps, args.slot_loss = None, None, None
        assert launch._make_faults(args) is None
