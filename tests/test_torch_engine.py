"""The port's serve engines against the JAX engines, plus package hygiene.

Greedy streams must be token-identical on the pinned seeds below, for the
plain path (``dense``) and the kernel path (``fused_int8``, whose kernels'
plain versions run on the CPU), and the engines' transfer and step stats
must agree.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM
from repro.models.transformer import Runtime as JRuntime
from repro.serve.engine import ContinuousBatchingEngine as JCB
from repro.serve.engine import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.core import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models.transformer import Runtime
from repro_torch.serve.engine import ContinuousBatchingEngine, Engine

JCFG = JR.get("llama3-8b").reduced()
TCFG = TR.get("llama3-8b").reduced()
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.key(0), JCFG)
    return params, convert.from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _serve_pim_trace():
    """The ragged request trace of ``examples/serve_pim.py`` (6 requests)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    return prompts, budgets


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_engine_generate_token_identical(weights, backend):
    jp, tp = weights
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    want, _ = JEngine(cfg=JCFG, params=jp, rt=JRuntime(backend=backend),
                      max_len=64).generate({"inputs": jnp.asarray(toks)}, 8)
    got, tm = Engine(cfg=TCFG, params=tp, rt=Runtime(backend), max_len=64,
                     device="cpu").generate({"inputs": torch.from_numpy(toks)}, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(tm) == {"prefill_s", "decode_s", "tpot_s"}


@pytest.mark.parametrize("backend", ["dense", "fused_int8"])
def test_continuous_batching_token_identical(weights, backend):
    jp, tp = weights
    prompts, budgets = _serve_pim_trace()
    jeng = JCB(JCFG, jp, n_slots=2, max_len=64, rt=JRuntime(backend=backend))
    want = jeng.generate_all(prompts, budgets)
    teng = ContinuousBatchingEngine(TCFG, tp, n_slots=2, max_len=64,
                                    rt=Runtime(backend), device="cpu")
    assert teng.generate_all(prompts, budgets) == want
    for key in ("steps", "decode_steps", "prefill_tokens", "max_step_prefill_tokens",
                "max_step_total_tokens", "xfer_bytes", "decode_xfer_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["device_s"] <= teng.stats["step_s"]
    assert not teng.scheduler.has_work() and len(teng.scheduler.free_slots) == 2


def test_continuous_batching_eos_matches(weights):
    """An EOS id that the stream emits retires the request early, as in the
    reference."""
    jp, tp = weights
    prompts, budgets = _serve_pim_trace()
    free = JCB(JCFG, jp, n_slots=2, max_len=64).generate_all(prompts, budgets)
    eos = free[0][2]
    want = JCB(JCFG, jp, n_slots=2, max_len=64).generate_all(prompts, budgets, eos_id=eos)
    got = ContinuousBatchingEngine(TCFG, tp, n_slots=2, max_len=64,
                                   device="cpu").generate_all(prompts, budgets, eos_id=eos)
    assert got == want and len(got[0]) == 3


def test_requests_wait_for_slots_and_keep_timestamps(weights):
    _, tp = weights
    eng = ContinuousBatchingEngine(TCFG, tp, n_slots=1, max_len=32, device="cpu")
    reqs = [eng.submit([1, 2, 3], 3), eng.submit([4, 5], 2)]
    eng.drain()
    assert [len(r.output) for r in reqs] == [3, 2]
    for r in reqs:
        assert r.arrival_time <= r.admit_time <= r.first_token_time <= r.finish_time
    assert reqs[1].admit_time >= reqs[0].finish_time


PORTED_SINCE = ("A.7", "A.9")      # items whose arguments serve now


def _served_like_plain(weights, **kwargs):
    """The trace served with ``kwargs`` equals the plain engine's streams."""
    prompts, budgets = _serve_pim_trace()
    plain = ContinuousBatchingEngine(TCFG, weights[1], n_slots=2, max_len=64,
                                     device="cpu").generate_all(prompts, budgets)
    eng = ContinuousBatchingEngine(TCFG, weights[1], n_slots=2, max_len=64,
                                   device="cpu", **kwargs)
    assert eng.generate_all(prompts, budgets) == plain
    return eng


@pytest.mark.parametrize("kwargs,item", [
    ({"chunk": 4}, "A.7"), ({"policy": "sjf"}, "A.7"), ({"multi_step": 4}, "A.9"),
    ({"prefix_cache": True}, "A.10"), ({"kv_swap": True}, "A.10"),
    ({"faults": True}, "A.10"), ({"spec_k": 2, "drafter": "mtp"}, "A.11")])
def test_later_slice_arguments_raise(weights, kwargs, item):
    """Arguments of lanes still to port raise naming their ROADMAP item; those
    of items ported since (chunked prefill and policies, A.7; the fused
    multi-step lane, A.9) serve the trace token-identical to the plain
    engine."""
    if item in PORTED_SINCE:
        eng = _served_like_plain(weights, **kwargs)
        key = {"chunk": "chunks", "multi_step": "multi_blocks"}.get(next(iter(kwargs)))
        assert key is None or eng.stats[key] > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        ContinuousBatchingEngine(TCFG, weights[1], n_slots=2, max_len=32,
                                 device="cpu", **kwargs)


def test_mtp_drafter_waits_for_its_family():
    from repro_torch.serve.drafter import make_drafter
    with pytest.raises(NotImplementedError, match="A.11"):
        make_drafter("mtp", TCFG)


@pytest.mark.parametrize("kwargs,item", [({"temperature": 0.7}, "A.7"),
                                         ({"deadline_s": 1.0}, "A.10")])
def test_later_slice_request_options_raise(weights, kwargs, item):
    """Request deadlines (A.10) still raise; a sampled request (A.7) serves
    its budget, and its seeded stream repeats itself."""
    if item in PORTED_SINCE:
        outs = []
        for _ in range(2):
            eng = ContinuousBatchingEngine(TCFG, weights[1], n_slots=1, max_len=32,
                                           device="cpu")
            req = eng.submit([1, 2], 4, seed=3, **kwargs)
            eng.drain()
            outs.append(req.output)
        assert len(outs[0]) == 4 and outs[0] == outs[1]
        return
    eng = ContinuousBatchingEngine(TCFG, weights[1], n_slots=1, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        eng.submit([1, 2], 2, **kwargs)


def test_engine_sampling_raises(weights):
    """``generate(greedy=False)`` raises without a generator, as the
    reference raises without an rng, and samples with one: the same seed
    gives the same tokens (torch's draws, which do not equal
    ``jax.random``'s)."""
    eng = Engine(cfg=TCFG, params=weights[1], max_len=32, device="cpu")
    prompt = {"inputs": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompt, 2, greedy=False)
    runs = [eng.generate(prompt, 6, greedy=False,
                         generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (1, 6)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < TCFG.vocab_size


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        Runtime("pallas_tpu")


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------
def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax_import():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, n)


def _entry_points(tp):
    return {
        "init_params": lambda: TM.init_params(TCFG),
        "init_decode_state": lambda: TM.init_decode_state(TCFG, 2, 16),
        "init_cache": lambda: TKV.init_cache(2, 2, 8, 2, 16),
        "Engine": lambda: Engine(cfg=TCFG, params=tp),
        "ContinuousBatchingEngine": lambda: ContinuousBatchingEngine(TCFG, tp),
        "convert": lambda: convert.from_numpy({"embed": {"w": np.zeros((2, 2), np.float32)},
                                               "groups": ()}),
    }


@pytest.mark.parametrize("name", list(_entry_points(None)))
def test_entry_points_default_to_the_card(weights, name):
    """Without ``device="cpu"`` every entry point targets the card, and
    raises on a machine without one instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(weights[1])[name]()


def test_engine_refuses_unsupported_device(weights):
    with pytest.raises(ValueError, match="unsupported device"):
        Engine(cfg=TCFG, params=weights[1], device="meta")
