"""The port's engine fault wiring, cancellation and deadlines (A.10) against
the JAX engine on the CPU.

Mirrors the engine-level classes of ``tests/test_faults.py``
(``TestEngineRecovery``, ``TestFaultStatsSchema``) on the reduced
llama3-8b, 2 slots, ``max_len`` 48, chunked prefill of 4, under
``fused_int8`` (the kernels' plain versions here, the Pallas kernels in
interpret mode on the JAX side), with the JAX parameters converted to the
port.  Each fault class runs the same trace and the same seeded
``FaultInjector`` on both engines: the port's streams must be
token-identical to JAX's faulted run and to the port's own fault-free run,
and every stat equal to JAX's but the clocks and ``xfer_bytes`` (the port
moves only a cold block's live rows).  Each JAX run is computed once a
module; JAX engines of one shape share their compiled steps
(``tests/torch_parity.py``).  Also the repairs that came with the wiring: the stats key
set equals the reference's with the features off and on, a retired or
failed request frees its cold block, an uncorrectable swap-in falls back to
recompute, and a rebuild zeroes the pool in place.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM
from repro.serve import faults as JF
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.models import graphs as G
from repro_torch.models.transformer import Runtime
from repro_torch.serve import faults as TF
from repro_torch.serve.engine import ContinuousBatchingEngine as TCB
from repro_torch.serve.scheduler import RequestState
from torch_parity import JaxRuns
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
BASE = {"n_slots": 2, "max_len": 48, "chunk": 4}
CLOCKS = ("device_s", "step_s", "slow_steps")   # wall-clock stats


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(jax.random.key(0), JCFG)
    return jp, convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(weights):
    return JaxRuns(JCFG, weights[0], BASE)


def _port(tp, **kw) -> TCB:
    return TCB(TCFG, tp, rt=Runtime("fused_int8"), device="cpu", **{**BASE, **kw})


def _trace(cfg=JCFG, n=6, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(6, 17))).tolist()
               for _ in range(n)]
    budgets = [int(rng.integers(4, 9)) for _ in range(n)]
    return prompts, budgets


def _drain_all(prompts, budgets, **submit_kw):
    def drive(eng):
        reqs = [eng.submit(p, b, **submit_kw) for p, b in zip(prompts, budgets)]
        eng.drain()
        return reqs
    return drive


def _ledger_ok(eng) -> bool:
    """Every slot free, quarantined or holding a cached leaf; no carry and
    no work left."""
    sched = eng.scheduler
    cached = len(eng._pcache._slots) if eng._pcache is not None else 0
    return (len(sched.free_slots) + len(sched.quarantined) + cached == eng.n_slots
            and not eng._carries and not sched.has_work()
            and not getattr(eng, "_warm_rows", {}))


def _same_stats(te, je):
    """Equal stats key sets; every value equal but the clocks and
    ``xfer_bytes``, which is the reference's less the dead rows of each
    block copy (the reference lifts and lands whole slot rows)."""
    assert set(te.stats) == set(je.stats)
    for k in sorted(set(te.stats) - set(CLOCKS) - {"xfer_bytes"}):
        assert te.stats[k] == je.stats[k], k
    dead = 0
    if te._swap is not None:
        whole = te._swap.block_bytes(te.state["layers"][0]["k_q"].shape[1]) + 4
        dead = ((te.stats["swap_outs"] + te.stats["swap_ins"]) * whole
                - te.stats["swap_out_bytes"] - te.stats["swap_in_bytes"])
    assert te.stats["xfer_bytes"] == je.stats["xfer_bytes"] - dead


def _outputs(reqs):
    return [list(r.output) for r in reqs]


def _check(jax_runs, tp, key, drive, faults, **kw):
    """The faulted trace on both engines and the port's fault-free run:
    streams token-identical, no request failed, stats equal, ledgers
    balanced.  Returns the port's engine."""
    jreqs, je = jax_runs.run(key, drive, faults=faults(JF), **kw)
    te = _port(tp, faults=faults(TF), **kw)
    treqs = drive(te)
    plain = drive(_port(tp, **kw))
    assert _outputs(treqs) == _outputs(jreqs) == _outputs(plain)
    assert all(r.error is None for r in treqs)
    _same_stats(te, je)
    assert _ledger_ok(te) and _ledger_ok(je)
    if te._swap is not None:
        assert te._swap.store.rows_used == je._swap.store.rows_used
    return te


class TestEngineRecovery:
    def test_correctable_ecc_is_transparent(self, weights, jax_runs):
        """Low-BER cold reads decode back to the written bytes: the swap
        engine under injected retention errors equals the fault-free one,
        with the ECC pipeline metered as JAX meters it."""
        kw = dict(policy="fair:3", kv_swap=True)
        te = _check(jax_runs, weights[1], "ecc_correctable", _drain_all(*_trace()),
                    lambda F: F.FaultInjector(seed=0, ber=2e-4), **kw)
        assert te.stats["ecc_checks"] > 0 and te.stats["ecc_cycles"] > 0
        assert te.stats["ecc_corrected_bits"] > 0
        assert te.stats["uncorrectable_blocks"] == 0

    @pytest.mark.parametrize("policy", ["fair:3", "priority:preempt"])
    def test_uncorrectable_block_recompute_parity(self, weights, jax_runs, policy):
        """A BER far past the BCH budget corrupts every cold read: each
        restore falls back to recompute-replay in its admission, and the
        streams still equal the fault-free run."""
        kw = dict(policy=policy, kv_swap=True)
        te = _check(jax_runs, weights[1], ("uncorrectable", policy), _drain_all(*_trace()),
                    lambda F: F.FaultInjector(seed=0, ber=0.05), **kw)
        if te.stats["swap_outs"] > 0:
            assert te.stats["uncorrectable_blocks"] > 0
            assert te.stats["recovery_recomputes"] > 0

    @pytest.mark.parametrize("policy", ["fifo", "sjf", "priority:preempt", "fair:3"])
    def test_step_failure_recovery_parity(self, weights, jax_runs, policy):
        """An injected device error mid-step poisons the pool; the bounded
        retry rebuilds it from committed host state and every stream ends
        token-identical, for every scheduling policy."""
        kw = dict(policy=policy, kv_swap=True)
        te = _check(jax_runs, weights[1], ("step_fail", policy), _drain_all(*_trace()),
                    lambda F: F.FaultInjector(seed=0, step_fail_at=(9, 23)), **kw)
        assert te.stats["pool_rebuilds"] > 0
        assert te.stats["step_retries"] == te.stats["pool_rebuilds"]

    def test_sampled_step_failure_recovery_parity(self, weights, jax_runs):
        """A sampled replay draws its stream again from the top, so
        recompute-recovery reproduces the sampled tokens."""
        prompts, budgets = _trace(n=4)
        drive = _drain_all(prompts, budgets, temperature=1.0, top_k=8, seed=11)
        te = _check(jax_runs, weights[1], "sampled_step_fail", drive,
                    lambda F: F.FaultInjector(seed=0, step_fail_at=(8,)))
        assert te.stats["pool_rebuilds"] > 0

    def test_pool_rebuild_after_real_device_failure(self, weights, jax_runs):
        """A real (not injected) error raised by the decode step after it
        wrote part of the pool is survived: the pool is rebuilt in place,
        every stream drains token-identical to JAX's run of the same failure
        and to the fault-free run, the ledger balances, and the rebuilt
        engine keeps serving."""
        prompts, budgets = _trace()
        drive = _drain_all(prompts, budgets)

        def flaky_jax(eng):
            orig, box = eng._decode, {"calls": 0}

            def flaky(qp, state, tok):
                box["calls"] += 1
                if box["calls"] == 3:
                    for leaf in jax.tree.leaves(eng.state):
                        leaf.delete()             # donated arguments are gone
                    raise RuntimeError("emulated device error")
                return orig(qp, state, tok)
            eng._decode = flaky
            return drive(eng)

        jreqs, je = jax_runs.run("real_failure", flaky_jax)
        te = _port(weights[1])
        ptrs = [t.data_ptr() for t in G.state_tensors(te.state)]
        orig, box = te._steps.decode, {"calls": 0}

        def flaky():
            box["calls"] += 1
            if box["calls"] == 3:
                te.state["layers"][0]["k_q"].fill_(3)    # a partial write
                raise RuntimeError("emulated device error")
            return orig()
        te._steps.decode = flaky
        treqs = drive(te)
        assert box["calls"] > 3
        assert _outputs(treqs) == _outputs(jreqs) == _outputs(drive(_port(weights[1])))
        assert all(r.error is None for r in treqs)
        assert te.stats["step_failures"] == te.stats["pool_rebuilds"] == 1
        _same_stats(te, je)
        assert not te._pool_consumed() and _ledger_ok(te)
        assert [t.data_ptr() for t in G.state_tensors(te.state)] == ptrs
        extra = te.submit([1, 2, 3, 4], 3)
        te.drain()
        assert len(extra.output) == 3 and extra.error is None

    def test_retry_budget_exhaustion_raises(self, weights, jax_runs):
        """A persistently failing step surfaces as an exhausted retry budget
        with the reference's counters, not a loop."""
        def dying_step():
            raise TF.InjectedStepFailure("persistently failing device")

        def jdying_step():
            raise JF.InjectedStepFailure("persistently failing device")

        for eng, dying in ((_port(weights[1], max_step_retries=1, retry_backoff_s=0.0),
                            dying_step),
                           (jax_runs.engine(max_step_retries=1, retry_backoff_s=0.0),
                            jdying_step)):
            eng.submit([1, 2, 3, 4], 3)
            eng._step = dying
            with pytest.raises(RuntimeError, match="retry budget exhausted"):
                eng.step()
            assert (eng.stats["step_failures"], eng.stats["step_retries"],
                    eng.stats["pool_rebuilds"]) == (2, 1, 1)
            assert not eng._pool_consumed()

    def test_sticky_device_error_surfaces(self, weights):
        """A decode step that fails on every call (a sticky device error)
        is retried with a rebuild each time and surfaces as an exhausted
        budget whose cause is the device's error."""
        te = _port(weights[1], chunk=None, max_step_retries=2, retry_backoff_s=0.0)

        def dead():
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        te._steps.decode = dead
        te.submit([1, 2, 3, 4], 3)
        with pytest.raises(RuntimeError, match="retry budget exhausted") as ei:
            te.step()
        assert "illegal memory access" in str(ei.value.__cause__)
        assert te.stats["step_failures"] == 3 and te.stats["pool_rebuilds"] == 2

    def test_slot_loss_quarantine_and_parity(self, weights, jax_runs):
        """Plane loss mid-decode: the resident recovers onto a healthy slot
        token-identically, the dead slot is quarantined for good (it still
        rides in the fixed-batch step), and the rest drains the trace."""
        te = _check(jax_runs, weights[1], "slot_loss", _drain_all(*_trace()),
                    lambda F: F.FaultInjector(seed=0, slot_loss_at=((6, 0),)),
                    policy="fifo")
        assert te.scheduler.quarantined == {0}
        assert te.stats["slot_losses"] == te.stats["quarantined_slots"] == 1

    def test_slot_loss_cold_reread_from_recovery_copy(self, weights, jax_runs):
        """A greedy resident restored from the cold tier keeps its block as
        a recovery copy; when its plane dies, recovery re-reads the stale
        copy and replays the tail, token-identically."""
        kw = dict(policy="fair:3", kv_swap=True)
        te = _check(jax_runs, weights[1], "cold_reread", _drain_all(*_trace(n=6, seed=3)),
                    lambda F: F.FaultInjector(seed=0, slot_loss_at=((20, 0),)), **kw)
        assert te.stats["slot_losses"] == 1 and te.stats["cold_rereads"] >= 1

    def test_all_slots_lost_is_fatal(self, weights, jax_runs):
        prompts, budgets = _trace(n=2)
        for eng, F in ((_port(weights[1], faults=TF.FaultInjector(
                            seed=0, slot_loss_at=((4, 0), (4, 1)))), TF),
                       (jax_runs.engine(faults=JF.FaultInjector(
                            seed=0, slot_loss_at=((4, 0), (4, 1)))), JF)):
            with pytest.raises(RuntimeError, match="quarantined"):
                _drain_all(prompts, budgets)(eng)

    def test_deadline_times_out_straggler(self, weights, jax_runs):
        prompts, budgets = _trace(n=3)
        drive = _drain_all(prompts, budgets, deadline_s=1e-6)
        jreqs, je = jax_runs.run("deadline_tiny", drive)
        te = _port(weights[1])
        reqs = drive(te)
        assert all(r.state is RequestState.TIMEOUT and r.timed_out for r in reqs)
        assert _outputs(reqs) == _outputs(jreqs)
        assert te.stats["timeouts"] == je.stats["timeouts"] == len(reqs)
        _same_stats(te, je)
        assert _ledger_ok(te)

    def test_deadline_roomy_enough_never_fires(self, weights, jax_runs):
        prompts, budgets = _trace(n=3)
        drive = _drain_all(prompts, budgets, deadline_s=3600.0)
        jreqs, je = jax_runs.run("deadline_roomy", drive)
        te = _port(weights[1])
        reqs = drive(te)
        assert all(r.state is RequestState.FINISHED for r in reqs)
        assert _outputs(reqs) == _outputs(jreqs) == _outputs(
            _drain_all(prompts, budgets)(_port(weights[1])))
        assert te.stats["timeouts"] == 0
        _same_stats(te, je)

    def test_deadline_validated(self, weights):
        eng = _port(weights[1])
        with pytest.raises(ValueError):
            eng.submit([1, 2, 3], 2, deadline_s=0.0)

    def test_drain_stall_names_stuck_requests(self, weights):
        """The drain() stall error names every stuck request and state."""
        eng = _port(weights[1], drain_stall_limit=2)
        eng.submit([1, 2, 3, 4], 2)
        eng.step = lambda: False                  # engine wedged
        with pytest.raises(RuntimeError) as ei:
            eng.drain()
        assert "drain() stalled" in str(ei.value)
        assert "rid=0:queued" in str(ei.value)

    @pytest.mark.parametrize("trace", ["reference", "tiers"])
    def test_corrupt_promote_falls_back_to_cold_prefill(self, weights, jax_runs, trace):
        """A demoted prefix leaf whose cold block fails its tier-crossing
        check does not poison warm admissions: the promote is abandoned (the
        block dropped) and the request cold-prefills to the same tokens.
        ``reference`` is the reference test's trace (its cache of 16 rows
        rejects every publish); in ``tiers`` request a's leaf is demoted by
        b's publish and c, which shares a's prefix, promotes it."""
        rng = np.random.default_rng(9 if trace == "reference" else 3)
        if trace == "reference":
            shared = rng.integers(0, JCFG.vocab_size, 10).tolist()
            prompts = [shared + rng.integers(0, JCFG.vocab_size, 4).tolist()
                       for _ in range(4)]
            kw = dict(prefix_cache=True, prefix_cache_rows=16, kv_swap=True, cold_rows=96)
        else:
            pre = rng.integers(0, JCFG.vocab_size, 10).tolist()
            prompts = [pre + rng.integers(0, JCFG.vocab_size, 4).tolist(),
                       rng.integers(0, JCFG.vocab_size, 14).tolist(),
                       pre + rng.integers(0, JCFG.vocab_size, 4).tolist()]
            kw = dict(prefix_cache=True, prefix_cache_rows=20, kv_swap=True)

        def serial(eng):                          # serial: force demote, promote
            return [eng.generate_all([p], [4])[0] for p in prompts]
        jout, je = jax_runs.run(("corrupt_promote", trace), serial,
                                faults=JF.FaultInjector(seed=0, ber=0.05), **kw)
        te = _port(weights[1], faults=TF.FaultInjector(seed=0, ber=0.05), **kw)
        got = serial(te)
        assert got == jout == _port(weights[1]).generate_all(prompts, [4] * len(prompts))
        _same_stats(te, je)
        assert te._pcache.stats == je._pcache.stats
        assert _ledger_ok(te)
        if trace == "tiers":
            assert te._pcache.stats["demotions"] >= 1
            assert te.stats["uncorrectable_blocks"] == 1 and te.stats["prefix_hits"] == 0


# ---------------------------------------------------------------------------
# the repairs that came with the wiring
# ---------------------------------------------------------------------------
class TestRepairs:
    @pytest.mark.parametrize("kw", [
        {}, {"faults": True}, {"chunk": None, "multi_step": 4},
        {"prefix_cache": True, "kv_swap": True},
        {"prefix_cache": True, "kv_swap": True, "faults": True, "spec_k": 2}],
        ids=["plain", "faults", "atomic_multi", "tiers", "all"])
    def test_stats_keys_equal_the_reference(self, weights, jax_runs, kw):
        """The stats key set equals the reference's, the features off and
        on (the recovery counters always, the fault layer's with it)."""
        te, je = _port(weights[1], **kw), jax_runs.engine(**kw)
        assert set(te.stats) == set(je.stats)
        assert all(te.stats[k] == 0 for k in ("timeouts", "slow_steps", "step_failures",
                                               "step_retries", "pool_rebuilds"))

    def test_retired_and_failed_requests_free_their_cold_blocks(self, weights):
        """With the fault layer on a greedy swap restore keeps its block as a
        recovery copy; retirement frees it, and a request that fails while
        its block is held frees it too."""
        prompts, budgets = _trace()
        te = _port(weights[1], policy="fair:3", kv_swap=True, faults=True)
        reqs = _drain_all(prompts, budgets)(te)
        assert te.stats["swap_ins"] > 0 and all(r.error is None for r in reqs)
        assert te._swap.store.rows_used == 0 and not te._ft._sums

        te = _port(weights[1], policy="fair:3", kv_swap=True, faults=True)

        def broken(slot, blob):
            raise RuntimeError("host-to-device copy failed")
        te._land_block = broken
        reqs = _drain_all(prompts, budgets)(te)
        failed = [r for r in reqs if r.error is not None]
        assert failed and all("copy failed" in r.error for r in failed)
        assert te._swap.store.rows_used == 0 and _ledger_ok(te)
        assert not te._pool_consumed()

    def test_uncorrectable_swap_in_recomputes(self, weights):
        """Every swap-in of a preempted victim fails its check: each falls
        back to recompute-replay and the streams equal the plain run."""
        prompts, budgets = _trace()
        kw = dict(policy="priority:preempt", kv_swap=True)

        def drive(eng):
            reqs = [eng.submit(p, b, priority=0) for p, b in zip(prompts[:2], budgets[:2])]
            for _ in range(6):
                eng.step()
            reqs += [eng.submit(p, 3, priority=5) for p in prompts[2:4]]
            eng.drain()
            return reqs
        te = _port(weights[1], faults=TF.FaultInjector(seed=0, ber=0.05), **kw)
        assert _outputs(drive(te)) == _outputs(drive(_port(weights[1], **kw)))
        assert te.stats["preempt_swaps"] > 0
        assert te.stats["uncorrectable_blocks"] == te.stats["recovery_recomputes"] > 0
        assert te._swap.store.rows_used == 0 and _ledger_ok(te)

    def test_rebuild_zeroes_the_pool_in_place(self, weights):
        """An injected failure poisons the pool (nonzero codes, NaN
        scales); the rebuild zeroes every state tensor and static input in
        place, so the captured steps keep their buffers."""
        te = _port(weights[1], spec_tree=2, faults=TF.FaultInjector(seed=0))
        bufs = G.state_tensors(te.state) + te._static_inputs()
        ptrs = [t.data_ptr() for t in bufs]
        te.submit([5, 6, 7, 8, 9], 6)
        while not te.scheduler.active or not te._slot_pos.any():
            te.step()
        te._poison_pool()
        assert te._pool_consumed()
        assert torch.isnan(te.state["layers"][0]["k_s"]).all()
        te._rebuild_pool()
        assert not te._pool_consumed() and te.stats["pool_rebuilds"] == 1
        assert [t.data_ptr() for t in bufs] == ptrs
        assert all(int(t.count_nonzero()) == 0 for t in bufs)
        assert not te._slot_pos.any() and not te.scheduler.active
        te.drain()
        assert _ledger_ok(te)


# ---------------------------------------------------------------------------
# stats schema: always-on recovery keys, fault-layer keys only with it
# ---------------------------------------------------------------------------
class TestFaultStatsSchema:
    def test_recovery_keys_always_on(self, weights):
        eng = _port(weights[1])
        for k in ("timeouts", "slow_steps", "step_failures", "step_retries",
                  "pool_rebuilds"):
            assert eng.stats[k] == 0

    def test_ft_keys_absent_when_off(self, weights):
        eng = _port(weights[1])
        assert eng._ft is None and eng._injector is None
        assert "ecc_checks" not in eng.stats
        assert "quarantined_slots" not in eng.stats

    def test_ft_layer_without_injector(self, weights, jax_runs):
        """faults=True arms checksums and ECC metering with no chaos
        source: real reads still flow the pipeline, as in JAX."""
        kw = dict(policy="fair:3", kv_swap=True)
        te = _check(jax_runs, weights[1], "ft_only", _drain_all(*_trace()),
                    lambda F: True, **kw)
        assert te._ft is not None and te._injector is None
        assert te.stats["swap_ins"] and te.stats["ecc_checks"] >= te.stats["swap_ins"]
        assert te.stats["bitflips_injected"] == te.stats["uncorrectable_blocks"] == 0

    def test_max_step_retries_validated(self, weights):
        with pytest.raises(ValueError):
            _port(weights[1], max_step_retries=-1)
