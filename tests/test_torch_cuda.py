"""The port's CUDA kernels and engines on the card (marker ``cuda``).

Every test here needs an NVIDIA card and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: B1 and B5 bit for bit (and B5's int32 sums equal B1's), B2, B3 and
B4 within ``rtol=3e-5, atol=3e-6`` (B2 also in a pool of 4,096 rows); B3 at
one token equals B2, and B4 on a chain equals B3, bit for bit, also with B2
in a pool T - 1 rows smaller; B6 within ``rtol=2e-4, atol=2e-5`` (its
decay within ``rtol=1e-5``); the RMSNorm kernel within ``rtol=1e-6`` and
the LayerNorm kernel within ``rtol=1e-6`` (``atol`` 1e-6 of the output's
scale), both row-invariant bit for bit; B2-B4 also at MHA's rep 1 with head
dims 96 and 128.  The engines' captured steps (CUDA graphs) are
held bit-equal to the eager steps, logits and every state tensor, with their
launch counts, and chunked serving token-identical to one-shot prefill.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import quant
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import launch_counts, pim_mvm as pim, reset_launch_counts
from repro_torch.kernels import layer_norm as lnk
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as ssd
from repro_torch.kernels import verify_attn as va
from repro_torch.kernels import verify_tree_attn as vt
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.quantize import quantize_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _linear(m, k, n, seed, device):
    rng = np.random.default_rng(seed)
    x_q, x_s = quant.quantize_activation(torch.from_numpy(
        rng.standard_normal((m, k)).astype(np.float32)))
    lin = quant.make_quantized_linear(torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.3).astype(np.float32)))
    return (x_q.to(device), x_s.to(device), lin.w_q.to(device), lin.w_scale.to(device))


@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (3, 200, 130), (8, 520, 300),
                                   (3, 1000, 77), (4, 4096, 1024), (4, 14336, 4096),
                                   (17, 256, 512)])
def test_int8_matmul_and_pim_mvm_bit_exact(cuda, m, k, n):
    x_q, x_s, w_q, w_s = _linear(m, k, n, m + k + n, cuda)
    out, acc = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
    out_p, acc_p = mm.int8_matmul_plain(x_q, x_s, w_q, w_s)
    assert torch.equal(acc, acc_p) and torch.equal(out, out_p)
    out5, acc5 = pim.pim_mvm_cuda(x_q, x_s, w_q, w_s)
    assert torch.equal(acc5, acc) and torch.equal(out5, out)


@pytest.mark.parametrize("m,k,n", [
    (20, 4096, 1024), (28, 4096, 14336), (32, 1000, 528), (33, 777, 1000),
    (64, 4096, 4096), (70, 300, 200), (5, 1000, 77), (4, 2560, 5120), (4, 5120, 2560),
    (28, 2560, 5120)])
def test_int8_matmul_bit_exact_at_verify_m_tails_and_mamba2_shapes(cuda, m, k, n):
    """The verify M (20, 28), one and a bit of four n8 tiles (32, 33), M
    past one pass (64, 70), K not a multiple of 32 and N not of 16 (the
    byte-load path), and mamba2-2.7b's linears (2560 -> 5120 and back):
    acc and out bit for bit, with and without the integer sums."""
    x_q, x_s, w_q, w_s = _linear(m, k, n, 3 * m + k + n, cuda)
    reset_launch_counts()
    out, acc = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
    out2, none = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s, with_acc=False)
    assert launch_counts()["int8_matmul"] == 2 and none is None
    out_p, acc_p = mm.int8_matmul_plain(x_q, x_s, w_q, w_s)
    assert torch.equal(acc, acc_p) and torch.equal(out, out_p) and torch.equal(out2, out_p)


@pytest.mark.parametrize("m", [1, 4, 20, 28, 32, 33, 64])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (2560, 5120), (5120, 2560), (200, 130), (1000, 77),
                                 (777, 1000), (128, 16)])
def test_int8_matmul_launch_plan_covers_k_once_and_fills_the_card(cuda, m, k, n):
    """B1's plan: the cluster's CTAs split K into whole 128-row stages
    that cover every row exactly once, none empty; at most 16 CTAs a
    cluster; 64-column output tiles; one pass over M (each weight byte
    streamed once) for M <= 32; every full-width shape of llama3-8b and
    mamba2-2.7b puts at least one CTA on each of the H100's 132 SMs; the
    shared memory fits a block (227 KB)."""
    plan = mm.launch_plan(m, k, n, 132)
    assert 1 <= plan.cluster <= 16 and plan.k_chunk % 128 == 0
    rows = np.zeros(k, np.int64)
    for r in range(plan.cluster):
        lo, hi = r * plan.k_chunk, min(k, (r + 1) * plan.k_chunk)
        assert lo < hi
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert plan.n_tiles * 64 >= n > (plan.n_tiles - 1) * 64
    assert 8 * plan.m_tiles * plan.passes >= m and plan.m_tiles <= 4
    assert plan.passes == 1 or m > 32
    assert plan.smem_bytes <= 232448
    if k >= 2560 and n >= 1024:
        assert plan.cluster * plan.n_tiles >= 132


def test_int8_matmul_refuses_a_misaligned_weight(cuda):
    """A contiguous weight view one byte into its storage cannot take the
    kernel's 16-byte copies: the wrapper raises, launching nothing."""
    x_q, x_s, w_q, w_s = _linear(4, 256, 512, 9, cuda)
    flat = torch.empty(256 * 512 + 1, dtype=torch.int8, device=cuda)
    view = flat[1:].view(256, 512)
    view.copy_(w_q)
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        mm.int8_matmul_cuda(x_q, x_s, view, w_s)
    assert launch_counts()["int8_matmul"] == 0


@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 1024), (4, 4096, 14336), (16, 4096, 1024), (17, 1000, 528), (20, 4096, 1024),
    (28, 4096, 14336), (33, 777, 1000), (64, 4096, 4096), (70, 300, 200), (5, 1000, 77),
    (3, 200, 130), (4, 14336, 4096)])
def test_pim_mvm_bit_exact_at_verify_m_passes_and_tails(cuda, m, k, n):
    """B5 on the nibble-packed byte at decode and verify M (1, 4, 20, 28),
    one pass and more (16, 17, 33, 64, 70 rows: passes of at most 32), K
    not a multiple of 128 and N not of 16 (the byte-load path): its sums
    and output equal B1's and the plain version's on the two cell planes,
    bit for bit, with and without the integer sums, one launch a call."""
    x_q, x_s, w_q, w_s = _linear(m, k, n, 5 * m + k + n, cuda)
    reset_launch_counts()
    out, acc = pim.pim_mvm_cuda(x_q, x_s, w_q, w_s)
    out2, none = pim.pim_mvm_cuda(x_q, x_s, w_q, w_s, with_acc=False)
    assert launch_counts()["pim_mvm"] == 2 and none is None
    out1, acc1 = mm.int8_matmul_cuda(x_q, x_s, w_q, w_s)
    out_p, acc_p = pim.pim_mvm_plain(x_q, x_s, *quant.pack_qlc(w_q), w_s)
    assert torch.equal(acc, acc_p) and torch.equal(acc, acc1)
    assert torch.equal(out, out_p) and torch.equal(out, out1) and torch.equal(out2, out_p)


@pytest.mark.parametrize("m", [1, 2, 4, 16, 17, 20, 28, 33, 64, 70])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (2560, 5120), (777, 1000), (128, 16)])
def test_pim_mvm_launch_plan_covers_k_once_and_fills_the_card(cuda, m, k, n):
    """B5's plan: whole 128-row tiles that cover every row of K exactly
    once, none empty, at most 16 CTAs a cluster; 64-column output tiles;
    the fewest passes of at most 32 rows of x, each a compiled size (1, 4,
    8, 16, 24 or 32), so one pass (the weight streamed once) for M <= 32;
    llama3-8b's full-width linears put at least one CTA on each of the
    H100's 132 SMs; the shared memory fits a block."""
    plan = pim.launch_plan(m, k, n, 132)
    assert 1 <= plan.cluster <= 16 and plan.k_chunk % 128 == 0
    rows = np.zeros(k, np.int64)
    for r in range(plan.cluster):
        lo, hi = r * plan.k_chunk, min(k, (r + 1) * plan.k_chunk)
        assert lo < hi
        rows[lo:hi] += 1
    assert (rows == 1).all()
    assert plan.n_tiles * 64 >= n > (plan.n_tiles - 1) * 64
    passes = -(-m // 32)
    assert plan.rows == min(r for r in (1, 4, 8, 16, 24, 32) if r * passes >= m)
    assert plan.passes == passes == -(-m // plan.rows)
    assert plan.smem_bytes <= 232448
    if k >= 2560 and n >= 1024:
        assert plan.cluster * plan.n_tiles >= 132


def test_pim_mvm_refuses_a_misaligned_weight(cuda):
    """A contiguous weight view one byte into its storage cannot take the
    kernel's 16-byte copies: the wrapper raises, launching nothing."""
    x_q, x_s, w_q, w_s = _linear(4, 256, 512, 11, cuda)
    flat = torch.empty(256 * 512 + 1, dtype=torch.int8, device=cuda)
    view = flat[1:].view(256, 512)
    view.copy_(w_q)
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        pim.pim_mvm_cuda(x_q, x_s, view, w_s)
    assert launch_counts()["pim_mvm"] == 0


@pytest.mark.parametrize("m", [1, 4, 20])
def test_pim_mvm_is_one_device_operation(cuda, m):
    """A model-path B5 call (no integer sums) is one kernel on the device:
    no memset, no copy, no epilogue kernel."""
    from torch.profiler import ProfilerActivity, profile
    x_q, x_s, w_q, w_s = _linear(m, 4096, 1024, 13, cuda)
    pim.pim_mvm_cuda(x_q, x_s, w_q, w_s, with_acc=False)
    torch.cuda.synchronize()
    for _ in range(3):     # a trace that recorded no device event at all is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                pim.pim_mvm_cuda(x_q, x_s, w_q, w_s, with_acc=False)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if names:
            break
    assert len(names) == 3 and all("pim_mvm_cluster" in n for n in names), names


@pytest.mark.parametrize("b,s,g,rep,d,lengths", [
    (2, 64, 2, 2, 32, [1, 64]), (3, 300, 2, 4, 64, [150, 1, 299]),
    (1, 1000, 1, 1, 128, [999]), (4, 512, 8, 4, 128, [1, 200, 377, 512])])
def test_decode_attn_matches_plain(cuda, b, s, g, rep, d, lengths):
    rng = np.random.default_rng(s + d)
    q = torch.from_numpy(rng.standard_normal((b, 1, g * rep, d)).astype(np.float32)).to(cuda)
    k_q, k_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(cuda))
    v_q, v_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(cuda))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = da.decode_attention(q, k_q, k_s, v_q, v_s, ln)
    assert launch_counts()["decode_attn"] == 1
    q_q, q_s = quant.quantize_kv(q.reshape(b, g * rep, d))
    want = da.decode_attn_plain(q_q.reshape(b, g, rep, d), q_s.reshape(b, g, rep, 1),
                                k_q, k_s[..., 0], v_q, v_s[..., 0], ln)
    torch.testing.assert_close(got.reshape(b, g, rep, d), want, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("d", [128, 64])
def test_decode_attn_long_context_matches_plain(cuda, d):
    """B2 in a pool of 4,096 rows at lengths 1, one chunk of 64 keys less one,
    one chunk, one more, and the whole pool (eight CTAs walk eight chunks
    each)."""
    b, s, g, rep = 5, 4096, 8, 4
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((b, g * rep, d)).astype(np.float32)).to(cuda)
    k_q, k_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(cuda))
    v_q, v_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(cuda))
    q_q, q_s = quant.quantize_kv(q)
    args = (q_q.reshape(b, g, rep, d), q_s.reshape(b, g, rep, 1), k_q, k_s[..., 0].contiguous(),
            v_q, v_s[..., 0].contiguous(),
            torch.tensor([1, 63, 64, 65, s], dtype=torch.int32, device=cuda))
    torch.testing.assert_close(da.decode_attn_cuda(*args), da.decode_attn_plain(*args),
                               rtol=3e-5, atol=3e-6)


def test_engine_runs_the_kernels_and_agrees_with_the_cpu(cuda):
    """The continuous engine on the card launches B1 7 times and B2 once per
    layer per decode step, and its first greedy tokens match the same model
    on the CPU (plain versions)."""
    cfg = registry.get("llama3-8b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gparams = convert.to_device(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    cpu = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64,
                                   rt=Runtime("fused_int8"), device="cpu")
    want = cpu.generate_all(prompts, budgets)
    eng = ContinuousBatchingEngine(cfg, gparams, n_slots=2, max_len=64,
                                   rt=Runtime("fused_int8"))
    reset_launch_counts()          # after the capture's eager warm-up step
    got = eng.generate_all(prompts, budgets)
    steps = eng.stats["decode_steps"]
    assert launch_counts() == {"int8_matmul": 7 * cfg.n_layers * steps,
                               "pim_mvm": 0, "decode_attn": cfg.n_layers * steps,
                               "verify_attn": 0, "verify_tree_attn": 0, "ssd_chunk": 0,
                               "rms_norm": (2 * cfg.n_layers + 1) * (steps + len(prompts)),
                               "layer_norm": 0}
    assert [len(o) for o in got] == budgets
    assert [o[0] for o in got] == [o[0] for o in want]     # prefill: float only


def _window(b, s, g, rep, d, t, seed, device):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, g * rep, d)).astype(np.float32))
    k_q, k_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(device))
    v_q, v_s = quant.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, s, g, d)).astype(np.float32)).to(device))
    q_q, q_s = va.quantize_window(q.to(device), g)
    return q_q, q_s, [k_q, k_s[..., 0].contiguous(), v_q, v_s[..., 0].contiguous()]


def _trees(b, t, seed):
    from repro_torch.serve.drafter import tree_depths_ancestors
    rng = np.random.default_rng(seed)
    return torch.tensor([tree_depths_ancestors([int(rng.integers(-1, i)) for i in range(t - 1)])[1]
                         for _ in range(b)], dtype=torch.int32)


@pytest.mark.parametrize("b,s,g,rep,d,t,pos", [
    (2, 64, 2, 2, 32, 3, [0, 61]), (3, 300, 2, 4, 64, 5, [0, 150, 295]),
    (4, 262, 8, 4, 128, 5, [1, 100, 200, 257]), (4, 262, 8, 4, 128, 31, [0, 60, 120, 231])])
def test_verify_kernels_match_plain(cuda, b, s, g, rep, d, t, pos):
    q_q, q_s, cache = _window(b, s, g, rep, d, t, s + t, cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    lengths = (pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32, device=cuda)).contiguous()
    anc = _trees(b, t, t).to(cuda)
    reset_launch_counts()
    got3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
    got4 = vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, anc)
    assert launch_counts()["verify_attn"] == 1 and launch_counts()["verify_tree_attn"] == 1
    torch.testing.assert_close(got3, va.verify_attn_plain(q_q, q_s, *cache, lengths),
                               rtol=3e-5, atol=3e-6)
    torch.testing.assert_close(got4, vt.verify_tree_attn_plain(q_q, q_s, *cache, pos, anc),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("t", [1, 5, 31])
def test_verify_kernels_equal_b2_and_each_other(cuda, t):
    """B3 row (t, r) equals B2 at length pos + t + 1, and B4 on chain
    ancestors equals B3, bit for bit."""
    b, s, g, rep, d = 4, 262, 8, 4, 128
    q_q, q_s, cache = _window(b, s, g, rep, d, t, 11 * t, cuda)
    pos = torch.tensor([0, 37, 130, s - t], dtype=torch.int32, device=cuda)
    lengths = (pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32, device=cuda)).contiguous()
    got3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
    for i in range(t):
        dec = da.decode_attn_cuda(q_q[:, :, i].contiguous(), q_s[:, :, i].contiguous(),
                                  *cache, lengths[:, i].contiguous())
        assert torch.equal(got3[:, :, i], dec), i
    chain = ((1 << torch.arange(1, t + 1, dtype=torch.int64)) - 1).to(torch.int32)
    got4 = vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos,
                                    chain.expand(b, t).contiguous().to(cuda))
    assert torch.equal(got4, got3)


@pytest.mark.parametrize("max_len,pos", [(256, [61, 125, 190, 251]),
                                         (4096, [61, 509, 2045, 4091])])
def test_verify_rows_equal_b2_across_pool_sizes(cuda, max_len, pos):
    """B3's rows and B4's on a chain in a pool of max_len + T - 1 rows equal
    B2 in a pool of max_len rows with the same live K/V, bit for bit, where
    the rows' own keys pos + t cross chunk boundaries (63 / 64 / 65, and 511 /
    512 / 513, where CTA 0 takes its second chunk)."""
    b, g, rep, d, t = 4, 8, 4, 128, 5
    q_q, q_s, cache = _window(b, max_len + t - 1, g, rep, d, t, max_len, cuda)
    small = [c[:, :max_len].contiguous() for c in cache]
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    lengths = (pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32, device=cuda)).contiguous()
    got3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
    chain = ((1 << torch.arange(1, t + 1, dtype=torch.int64)) - 1).to(torch.int32)
    got4 = vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, chain.expand(b, t).contiguous().to(cuda))
    for i in range(t):
        dec = da.decode_attn_cuda(q_q[:, :, i].contiguous(), q_s[:, :, i].contiguous(),
                                  *small, lengths[:, i].contiguous())
        assert torch.equal(got3[:, :, i], dec), i
        assert torch.equal(got4[:, :, i], dec), i


@pytest.mark.parametrize("lane", [{"spec_k": 4}, {"spec_tree": 6}], ids=["spec_k", "spec_tree"])
def test_spec_engine_runs_the_verify_kernels(cuda, lane):
    """Every decode step of a spec lane is a verify step: B1 runs 7 times and
    B3 (or B4) once per layer per step, B2 never, and every request meets
    its budget."""
    cfg = registry.get("llama3-8b").reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64,
                                   rt=Runtime("fused_int8"), **lane)
    reset_launch_counts()          # after the capture's eager warm-up step
    got = eng.generate_all(prompts, budgets)
    steps = eng.stats["verify_steps"]
    attn = "verify_tree_attn" if "spec_tree" in lane else "verify_attn"
    want = {"int8_matmul": 7 * cfg.n_layers * steps, "pim_mvm": 0, "decode_attn": 0,
            "verify_attn": 0, "verify_tree_attn": 0, "ssd_chunk": 0,
            "rms_norm": (2 * cfg.n_layers + 1) * (steps + len(prompts)), "layer_norm": 0}
    want[attn] = cfg.n_layers * steps
    assert steps == eng.stats["decode_steps"] > 0 and launch_counts() == want
    assert [len(o) for o in got] == budgets
    assert all(0 <= tok < cfg.vocab_size for o in got for tok in o)


def test_verify_rows_equal_sequential_decode_on_the_card(cuda):
    """On the reduced config the card's verify window computes what its
    sequential decode steps compute: logits and every layer's K/V entries
    bit for bit (at this width no float stage sums a row in an order that
    depends on the row count)."""
    cfg = registry.get("llama3-8b").reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen, dtype=torch.int32).to(cuda)
    _, state = M.prefill(params, cfg, {"inputs": prompts}, 64, rt)

    def clone(st):
        return {"layers": [{k: v.clone() for k, v in c.items()} for c in st["layers"]],
                "pos": st["pos"].clone()}
    sv, sd = clone(state), clone(state)
    lv, _, _ = M.verify_step(qparams, cfg, sv, toks, rt)
    for t in range(toks.shape[1]):
        ld, sd = M.decode_step(qparams, cfg, sd, toks[:, t].contiguous(), rt)
        assert torch.equal(lv[:, t], ld), t
    for cv, cd in zip(sv["layers"], sd["layers"]):
        for k in cv:
            assert torch.equal(cv[k], cd[k]), k


def _ssd_inputs(N, Q, H, dh, S, seed, device):
    """The reference test's input distribution (``tests/test_kernels_ssm.py``)."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g)
    args = (normal(N, Q, H, dh), normal(N, Q, H, S) * 0.5, normal(N, Q, H, S) * 0.5,
            torch.nn.functional.softplus(normal(N, Q, H)), -torch.exp(normal(H) * 0.3),
            torch.ones(H), normal(N, H, dh, S) * 0.1)
    return [a.to(device).contiguous() for a in args]


@pytest.mark.parametrize("N,Q,H,dh,S", [(4, 128, 80, 64, 128), (1, 37, 80, 64, 128),
                                        (2, 1, 80, 64, 128), (3, 33, 2, 16, 8)])
def test_ssd_chunk_matches_plain(cuda, N, Q, H, dh, S):
    """B6 at mamba2-2.7b's full-width shapes (80 heads of 64, state 128), at
    a whole chunk, a prompt-length chunk and one token, and at an odd Q."""
    args = _ssd_inputs(N, Q, H, dh, S, N * Q + H, cuda)
    reset_launch_counts()
    y, s_out, dec = ssd.ssd_chunk(*args)
    assert launch_counts()["ssd_chunk"] == 1
    py, ps, pd = ssd.ssd_chunk_plain(*args)
    torch.testing.assert_close(y, py, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(s_out, ps, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dec, pd, rtol=1e-5, atol=0)


@pytest.mark.parametrize("N,Q,H,G,dh,S", [(2, 37, 4, 1, 64, 128), (2, 37, 4, 2, 64, 128),
                                          (1, 128, 4, 2, 32, 16), (3, 33, 6, 2, 16, 8),
                                          (4, 128, 80, 1, 64, 128), (1, 1, 4, 1, 64, 128),
                                          (2, 20, 4, 2, 6, 10)])
def test_ssd_chunk_grouped_matches_plain(cuda, N, Q, H, G, dh, S):
    """B and C per group (head h reads group h // (H // G)): the kernel
    against the plain version, which expands the groups to heads itself;
    mamba2-2.7b's one group of 80 heads among the shapes, and a head width
    and state off the 16-byte copies (dh 6, S 10)."""
    x, B, C, dt, A, D, h0 = _ssd_inputs(N, Q, H, dh, S, 7 * N + Q + G, cuda)
    B, C = B[:, :, :G].contiguous(), C[:, :, :G].contiguous()
    reset_launch_counts()
    y, s_out, dec = ssd.ssd_chunk(x, B, C, dt, A, D, h0)
    assert launch_counts()["ssd_chunk"] == 1
    py, ps, pd = ssd.ssd_chunk_plain(x, B, C, dt, A, D, h0)
    torch.testing.assert_close(y, py, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(s_out, ps, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dec, pd, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [128, 256, 2560, 4096, 5120])
def test_rms_norm_matches_plain_and_is_row_invariant(cuda, d):
    """Within ``rtol=1e-6`` of the plain version, and each row's output the
    same bits whether the call holds 4, 20 or 124 rows."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn((124, d), generator=g).to(cuda)
    scale = torch.randn((d,), generator=g).to(cuda)
    reset_launch_counts()
    full = rn.rms_norm(x, scale)
    assert launch_counts()["rms_norm"] == 1
    torch.testing.assert_close(full, rn.rms_norm_plain(x, scale), rtol=1e-6, atol=0)
    for m in (4, 20):
        parts = torch.cat([rn.rms_norm_cuda(x[i:i + m], scale) for i in range(0, 124, m)])
        assert torch.equal(parts, full), m
    assert torch.equal(rn.rms_norm_cuda(x[:20].reshape(4, 5, d), scale).reshape(20, d), full[:20])


@pytest.mark.parametrize("d", [96, 128, 768, 3072, 7168])
def test_layer_norm_matches_plain_and_is_row_invariant(cuda, d):
    """Within ``rtol=1e-6`` of the plain version (``atol`` 1e-6 of the
    output's scale: an output near zero is the difference of two rounded
    terms), and each row's output the same bits whether the call holds 1,
    4, 20, 28 or 140 rows."""
    g = torch.Generator().manual_seed(d)
    x = (torch.randn((140, d), generator=g) * 3 + 0.5).to(cuda)
    scale = torch.randn((d,), generator=g).to(cuda)
    bias = torch.randn((d,), generator=g).to(cuda)
    reset_launch_counts()
    full = lnk.layer_norm(x, scale, bias)
    assert launch_counts()["layer_norm"] == 1
    want = lnk.layer_norm_plain(x, scale, bias)
    torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    for m in (1, 4, 20, 28):
        parts = torch.cat([lnk.layer_norm_cuda(x[i:i + m], scale, bias)
                           for i in range(0, 140, m)])
        assert torch.equal(parts, full), m


@pytest.mark.parametrize("g,d", [(32, 96), (56, 128)], ids=["phi3", "opt"])
def test_attention_kernels_at_rep_1_match_plain(cuda, g, d):
    """B2, B3 (T 5) and B4 (T 7) at MHA's rep 1, with phi3-mini's 32 heads
    of 96 and OPT-30B's 56 of 128: each within ``rtol=3e-5, atol=3e-6`` of
    its plain version; B3's rows equal B2 and B4 on a chain equals B3, bit
    for bit."""
    b, s = 4, 262
    for t in (1, 5, 7):
        q_q, q_s, cache = _window(b, s, g, 1, d, t, d + t, cuda)
        pos = torch.tensor([0, 62, 130, s - t], dtype=torch.int32, device=cuda)
        lengths = (pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32,
                                               device=cuda)).contiguous()
        got3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
        torch.testing.assert_close(got3, va.verify_attn_plain(q_q, q_s, *cache, lengths),
                                   rtol=3e-5, atol=3e-6)
        for i in range(t):
            args = (q_q[:, :, i].contiguous(), q_s[:, :, i].contiguous(), *cache,
                    lengths[:, i].contiguous())
            dec = da.decode_attn_cuda(*args)
            torch.testing.assert_close(dec, da.decode_attn_plain(*args), rtol=3e-5, atol=3e-6)
            assert torch.equal(got3[:, :, i], dec), (t, i)
        chain = ((1 << torch.arange(1, t + 1, dtype=torch.int64)) - 1).to(torch.int32)
        chain = chain.expand(b, t).contiguous().to(cuda)
        assert torch.equal(vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, chain), got3)
        anc = _trees(b, t, t).to(cuda)
        torch.testing.assert_close(vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, anc),
                                   vt.verify_tree_attn_plain(q_q, q_s, *cache, pos, anc),
                                   rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("arch", ["opt-30b", "granite-3-8b", "phi3-mini-3.8b"])
def test_reduced_families_serve_on_the_card_like_the_cpu(cuda, arch):
    """The continuous engine on the card under ``fused_int8`` launches B1
    once a linear (6 a layer under gelu, 7 under SwiGLU) and B2 once a
    layer a decode step, and one norm kernel (LayerNorm for OPT, RMSNorm
    otherwise) a norm, and its first tokens (prefill, float only) equal
    the CPU's."""
    cfg = registry.get(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    want = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64,
                                    rt=Runtime("fused_int8"), device="cpu").generate_all(
        prompts, budgets)
    eng = ContinuousBatchingEngine(cfg, convert.to_device(params, cuda), n_slots=2,
                                   max_len=64, rt=Runtime("fused_int8"))
    reset_launch_counts()          # after the capture's eager warm-up step
    got = eng.generate_all(prompts, budgets)
    steps, L = eng.stats["decode_steps"], cfg.n_layers
    norm = "layer_norm" if cfg.norm_type == "layernorm" else "rms_norm"
    counts = launch_counts()
    assert counts[norm] == (2 * L + 1) * (steps + len(prompts))
    linears = 7 if cfg.mlp_type == "swiglu" else 6
    assert counts["int8_matmul"] == linears * L * steps and counts["decode_attn"] == L * steps
    assert counts["layer_norm" if norm == "rms_norm" else "rms_norm"] == 0
    assert [len(o) for o in got] == budgets
    assert [o[0] for o in got] == [o[0] for o in want]


def test_reduced_mamba2_on_the_card_matches_the_cpu(cuda):
    """mamba2 reduced under ``fused_int8``: prefill (B6 once per layer and
    chunk) and decode (B1 three times per layer) on the card within 2% of
    the logit scale of the CPU's plain versions, argmax equal; then both
    engines serve on the card, every request to its budget."""
    cfg = registry.get("mamba2-2.7b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    prompts = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cpu", "cuda"):
        p, q = convert.to_device(params, dev), convert.to_device(qparams, dev)
        reset_launch_counts()
        lg0, st = M.prefill(p, cfg, {"inputs": prompts.to(dev)}, 256, rt)
        lg1, _ = M.decode_step(q, cfg, st, torch.argmax(lg0, -1).to(torch.int32), rt)
        res[dev] = (lg0.cpu(), lg1.cpu(), launch_counts())
    L = cfg.n_layers
    assert res["cpu"][2] == {k: 0 for k in res["cpu"][2]}
    assert res["cuda"][2] == {"int8_matmul": 3 * L, "pim_mvm": 0, "decode_attn": 0,
                              "verify_attn": 0, "verify_tree_attn": 0,
                              "ssd_chunk": 2 * L, "rms_norm": 2 * (2 * L + 1),
                              "layer_norm": 0}
    for a, b in zip(res["cpu"][:2], res["cuda"][:2]):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())
    gparams = convert.to_device(params, cuda)
    rng = np.random.default_rng(0)
    trace = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist() for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    eng = ContinuousBatchingEngine(cfg, gparams, n_slots=2, max_len=64, rt=rt)
    reset_launch_counts()          # after the capture's eager warm-up step
    got = eng.generate_all(trace, budgets)
    steps = eng.stats["decode_steps"]
    assert launch_counts() == {"int8_matmul": 3 * L * steps, "pim_mvm": 0, "decode_attn": 0,
                               "verify_attn": 0, "verify_tree_attn": 0,
                               "ssd_chunk": L * len(trace),
                               "rms_norm": (2 * L + 1) * (steps + len(trace)),
                               "layer_norm": 0}
    assert [len(o) for o in got] == budgets


# ---------------------------------------------------------------------------
# the serve steps as CUDA graphs
# ---------------------------------------------------------------------------
def _ragged_pool(cfg, params, rows, device, lens=(5, 17, 9, 30)):
    from repro_torch.models import transformer as T
    state = M.init_decode_state(cfg, len(lens), rows, device)
    g = torch.Generator().manual_seed(3)
    for slot, n in enumerate(lens):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g).to(device)
        _, one = M.prefill(params, cfg, {"inputs": toks}, rows - 3, Runtime("fused_int8"))
        T.write_slot(state, slot, one)
    return state


def _clone_state(st):
    return {"layers": [{k: v.clone() for k, v in c.items()} for c in st["layers"]],
            "pos": st["pos"].clone()}


@pytest.mark.parametrize("arch,kind,width", [
    ("llama3-8b", "decode", 0), ("llama3-8b", "verify", 5), ("llama3-8b", "tree", 7),
    ("llama3-8b", "multi", 4), ("mamba2-2.7b", "decode", 0)])
def test_captured_steps_replay_bit_equal_to_eager(cuda, arch, kind, width):
    """Eight consecutive steps replayed from the captured graph equal the
    eager steps on a copy of the same pool (4 slots at ragged cursors): the
    logits (the fused block's tokens, m replays of the decode graph) and
    every state tensor bit for bit, and each replay credits the launches
    its capture recorded."""
    from repro_torch.models import graphs as G
    from repro_torch.models import transformer as T
    from repro_torch.serve.drafter import tree_depths_ancestors
    cfg = registry.get(arch).reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    pool = _ragged_pool(cfg, params, 64, cuda)
    eager, replay = _clone_state(pool), _clone_state(pool)
    steps = G.ServeSteps(qparams, cfg, rt, replay, decode=kind in ("decode", "multi"),
                         verify=(width,) if kind == "verify" else (),
                         tree=(width,) if kind == "tree" else ())
    key = ("decode",) if kind in ("decode", "multi") else (kind, width)
    L, n_steps = cfg.n_layers, (width if kind == "multi" else 1)
    lin = 3 if cfg.family == "ssm" else 7
    per = {"int8_matmul": lin * L, "rms_norm": 2 * L + 1}
    if cfg.family != "ssm":
        per[{"tree": "verify_tree_attn", "verify": "verify_attn"}.get(kind, "decode_attn")] = L
    assert steps.graphs[key].launches == per
    want = {k: v * n_steps for k, v in per.items()}
    depth, anc = (torch.tensor(x, dtype=torch.int32, device=cuda).repeat(4, 1)
                  for x in tree_depths_ancestors([-1, -1, 0, 0, 1, 2][:max(width - 1, 0)]))
    g = torch.Generator().manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (4,), generator=g, dtype=torch.int32).to(cuda)
    for i in range(8 // n_steps):
        if kind in ("verify", "tree"):
            win = torch.randint(0, cfg.vocab_size, (4, width), generator=g,
                                dtype=torch.int32).to(cuda)
            steps.window[width].copy_(win)
            kw = {}
            if kind == "tree":
                steps.depth[width].copy_(depth)
                steps.anc[width].copy_(anc)
                kw = {"depth": depth, "anc": anc}
            want_out, _, _ = M.verify_step(qparams, cfg, eager, win, rt, **kw)
        elif kind == "multi":
            steps.tok.copy_(tok)
            want_out, _ = M.multi_decode_step(qparams, cfg, eager, tok, width, rt)
        else:
            steps.tok.copy_(tok)
            want_out, _ = M.decode_step(qparams, cfg, eager, tok, rt)
        reset_launch_counts()
        got = getattr(steps, kind)(*((width,) if width else ()))
        counts = {k: v for k, v in launch_counts().items() if v}
        assert counts == want, i
        got = got if kind == "multi" else got[0]
        assert torch.equal(got, want_out), i
        if kind in ("verify", "tree"):
            back = (eager["pos"] - width + 1 + i % width).cpu().numpy()
            for st in (eager, replay):
                T.rewind_pos(st, back)
        tok = (want_out[:, -1] if kind == "multi"
               else want_out.reshape(4, -1, want_out.shape[-1])[:, -1].argmax(-1)
               .to(torch.int32))
        for a, b in zip(G.state_tensors(eager), G.state_tensors(replay)):
            assert torch.equal(a, b), i


@pytest.mark.parametrize("policy", ["fifo", "sjf", "priority:preempt", "fair:2"])
def test_chunked_and_fused_serving_token_identical_on_the_card(cuda, policy):
    """On the card the chunked engine (chunk 8) under each policy, and the
    fused lane (multi_step 4), serve the one-shot engine's tokens (prefill
    in pieces of fixed shape keeps chunking bit-exact), with exact launch
    counts for the fused lane."""
    cfg = registry.get("llama3-8b").reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(10, 90)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]

    def serve(**kw):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=128,
                                       rt=Runtime("fused_int8"), **kw)
        reset_launch_counts()
        reqs = [eng.submit(p, b, priority=i % 3, user="AB"[i % 2])
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        eng.drain()
        return [r.output for r in reqs], eng, launch_counts()
    plain, _, _ = serve()
    chunked, eng, _ = serve(policy=policy, chunk=8)
    assert chunked == plain and eng.stats["chunks"] > len(prompts)
    fused, eng, counts = serve(multi_step=4)
    assert fused == plain and eng.stats["multi_blocks"] > 0
    steps = eng.stats["decode_steps"]
    from repro_torch.models import transformer as T
    pieces = sum(T.prefill_pieces(cfg, eng._bucket(len(p))) for p in prompts)
    assert counts["int8_matmul"] == 7 * cfg.n_layers * steps
    assert counts["rms_norm"] == (2 * cfg.n_layers + 1) * (steps + pieces)
