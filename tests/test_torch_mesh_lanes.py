"""The serving lanes of the port on a (data, model) mesh (ROADMAP A.14b's
serving half) against the reference, on the CPU: a 2x2 gloo world of
spawned processes (``repro_torch.launch.mesh``), one torch thread a rank,
started once for the module.

* llama3-8b ``.reduced()`` (quantized) with the tiered pool (``kv_swap``
  under ``fair:3``), the prefix cache, faults (step failures and a lost
  slot) and faults over the tiered pool with NAND flips: every rank's
  streams equal JAX's single-device engine's and the port's one-device
  engine's on the reference tests' traces, with the reference tests'
  counters and every stat equal to the one-device engine's;
* a cross-shard ``copy_slot_prefix`` whose pool is one device's bit for
  bit, and a swapped row (whole, on every rank) whose checksums are the
  reference's ``row_checksums`` of the same block;
* a rank whose step raises outside an injection ends the world well
  within gloo's timeout;
* ``--serve --mesh 1x2`` (a leader and a follower) streams the tokens of
  the run without ``--mesh``, one stream cancelled.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.serve import faults as JF
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as MS
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as T
from repro_torch.serve import faults as TF
import torch_mesh_serve_ranks as R
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the reference tests' counters, each lane's
COUNTERS = {
    "swap": ("preempt_swaps", "swap_outs", "swap_ins", "swap_out_bytes", "swap_in_bytes",
             "swap_out_cycles", "swap_in_cycles", "preempt_recomputes", "preemptions"),
    "prefix": ("prefix_hits", "prefill_tokens_saved", "cached_tokens", "chunks"),
    "faults": ("step_failures", "pool_rebuilds", "slot_losses", "quarantined_slots",
               "recovery_recomputes", "step_retries"),
    "faults_swap": ("step_failures", "pool_rebuilds", "slot_losses", "quarantined_slots",
                    "recovery_recomputes", "preempt_swaps", "swap_out_bytes",
                    "swap_in_bytes", "ecc_checks", "ecc_pages", "ecc_cycles",
                    "ecc_corrected_bits", "bitflips_injected", "uncorrectable_blocks",
                    "cold_rereads"),
}


def _traces(cfg) -> dict:
    """The reference tests' traces: the swap test's (seed 29: 6 requests,
    prompts of 6-16, budgets of 4-9), the prefix test's (a shared
    10-token prefix plus 4 tokens, 4 requests, budget 6) and the fault
    test's (4 prompts of 6, budget 8), drawn with ``jax.random`` as the
    reference tests draw them."""
    rng = np.random.default_rng(29)
    swap = ([rng.integers(0, cfg.vocab_size, rng.integers(6, 17)).tolist() for _ in range(6)],)
    swap += ([int(rng.integers(4, 10)) for _ in range(6)],)
    shared = jax.random.randint(jax.random.key(2), (10,), 0, cfg.vocab_size).tolist()
    prefix = [shared + jax.random.randint(jax.random.key(10 + i), (4,), 0,
                                          cfg.vocab_size).tolist() for i in range(4)]
    faults = [jax.random.randint(jax.random.key(10 + i), (6,), 0, cfg.vocab_size).tolist()
              for i in range(4)]
    return {"swap": swap, "prefix": (prefix, [6] * 4), "faults": (faults, [8] * 4),
            "faults_swap": swap}


def _jax_injector(lane: str):
    t = R.injector(lane)
    if t is None:
        return None
    return JF.FaultInjector(seed=t.seed, ber=t.ber, step_fail_at=t.step_fail_at,
                            slot_loss_at=t.slot_loss_at)


@pytest.fixture(scope="module")
def world():
    """The 2x2 world's lanes (started first), and meanwhile each lane's
    trace through JAX's single-device engine and the port's one-device
    engine on the same weights."""
    cfg, jcfg = ARCHS["llama3-8b"].reduced(), JARCHS["llama3-8b"].reduced()
    traces = _traces(cfg)
    started = MS.start(R.lanes_world, 4, traces)
    params = T.init_params(cfg, 0, "cpu")
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(params, cfg))
    ref = {}
    for lane, (prompts, budgets) in traces.items():
        je = JCB(jcfg, jparams, faults=_jax_injector(lane), **R.LANE_KW[lane])
        jout = je.generate_all(prompts, budgets)
        ref[lane] = {"jax": (jout, je.stats, sorted(je.scheduler.quarantined)),
                     "port": R.run_lane(cfg, params, lane, prompts, budgets)}
    return {"ranks": started.join(), "ref": ref, "cfg": cfg}


@pytest.mark.parametrize("lane", sorted(COUNTERS))
def test_lane_token_identical_on_a_2x2_mesh(world, lane):
    """Every rank's streams equal JAX's single-device engine's and the
    port's one-device engine's, the reference tests' counters equal, and
    every stat (but the clocks) equals the one-device engine's."""
    jout, jstats, jq = world["ref"][lane]["jax"]
    tout, tstats, tq = world["ref"][lane]["port"]
    assert tout == jout and tq == jq
    for k in COUNTERS[lane]:
        assert tstats[k] == jstats[k], k
    for res in world["ranks"]:
        outs, stats, q = res[lane]
        assert outs == jout
        assert stats == tstats and q == tq
    if lane == "swap":
        assert tstats["preempt_swaps"] > 0
        assert tstats["swap_in_bytes"] == tstats["swap_out_bytes"]
    if lane == "prefix":
        assert tstats["prefix_hits"] > 0
    if lane.startswith("faults"):
        assert tstats["step_failures"] == tstats["pool_rebuilds"] == 2
        assert tstats["slot_losses"] == 1 and tstats["recovery_recomputes"] >= 1
        assert tq == [0] and tstats["quarantined_slots"] == 1
    if lane == "faults_swap":
        assert tstats["preempt_swaps"] > 0 and tstats["ecc_corrected_bits"] > 0
        assert tstats["uncorrectable_blocks"] > 0


def test_cross_shard_prefix_copy_bit_equal_to_one_device(world):
    """Slot 0 (data rank 0) copied into slot 1 (data rank 1): each rank of
    the source owner sends its head block to the destination owner's rank
    at its model index; every rank's block equals one device's copy."""
    for res in world["ranks"]:
        assert res["moves"]["copy_equal"]


def _reference_blob(blob: dict, cfg) -> dict:
    tree = {"layers": [{k: torch.from_numpy(v) for k, v in c.items()}
                       for c in blob["layers"]], "pos": torch.from_numpy(blob["pos"])}
    out = convert.to_numpy(tree, cfg)
    return {"groups": out["groups"], "pos": np.asarray(blob["pos"], np.int32)}


def test_swapped_row_checksums_equal_the_reference(world):
    """A swapped row on a mesh is whole and replicated: every rank holds
    one device's bytes (``read_slot`` of the whole pool), so the port's and
    the reference's per-row checksums of it are those of the same block."""
    cfg = world["cfg"]
    whole = world["ranks"][0]["moves"]["whole_row"]
    want = JF.row_checksums(_reference_blob(whole, cfg))
    assert len(want) == int(whole["pos"][0]) + 1 > 1
    for res in world["ranks"]:
        mv = res["moves"]
        assert mv["row_equal"]
        np.testing.assert_array_equal(TF.row_checksums(mv["row"]), want)
        np.testing.assert_array_equal(JF.row_checksums(_reference_blob(mv["row"], cfg)), want)


def test_a_failing_rank_ends_the_world_within_the_timeout():
    """Rank 1 raises inside its step outside any injection: its process
    ends, and rank 0 raises in its next collective within seconds, well
    inside the world's gloo timeout (60 s), instead of waiting it out."""
    timeout = 60.0
    w = MS.start(R.failing_world, 2, 3, timeout_s=timeout)
    t0 = time.monotonic()
    while any(p.is_alive() for p in w.procs) and time.monotonic() - t0 < timeout:
        time.sleep(0.05)
    elapsed = time.monotonic() - t0
    import pickle
    with open(os.path.join(w._tmp.name, "rank0.pkl"), "rb") as f:
        rank0, err = pickle.load(f)
    with pytest.raises(RuntimeError, match="a fault outside any injection"):
        w.join()
    assert err is None and rank0["raised"] is not None
    assert rank0["after_s"] < timeout / 2 and elapsed < timeout / 2


def _streams(out: str) -> list[str]:
    return [ln.strip() for ln in out.splitlines() if ln.lstrip().startswith("req ")]


def test_serve_cli_mesh_1x2_streams_equal_one_device(capfd):
    """``--serve --mesh 1x2``: the leader (rank 0) runs the streaming front
    end and broadcasts each iteration's decisions, the follower steps with
    it; the streams, the cancelled one included, equal the run without
    ``--mesh``, and both end clean."""
    argv = ["--arch", "llama3-8b", "--reduced", "--serve", "--requests", "3", "--slots", "2",
            "--device", "cpu"]
    launch.main(argv)
    plain = capfd.readouterr().out
    launch.main(argv + ["--mesh", "1x2"])
    meshed = capfd.readouterr().out
    assert _streams(meshed) == _streams(plain) and len(_streams(plain)) == 3
    assert "cancelled after 2 tokens" in meshed
    assert "SERVE_SHUTDOWN_CLEAN" in plain and "SERVE_SHUTDOWN_CLEAN" in meshed
