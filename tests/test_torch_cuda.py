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
dims 96 and 128, and at head dim 192 (nemotron-4-340b's rep 12, and rep 1);
the three quantizers' scales and codes equal to the CPU's (IEEE division by
127); B1's grouped entry bit-equal to its plain version and to B1 on each
expert's slice, and B2 at grok-1-314b's rep 6; the top-8 combine on the
card equal to the CPU's sums and repeating (and replaying, captured) its
bits, MLA's latent quantizer IEEE, and reduced deepseek-v3-671b's streams
(MTP lanes too) equal to the CPU's; B6 at jamba-1.5-large-398b's 256
heads, the grouped B1 at its 16 experts, B2 at whisper-tiny's rep 1 and
head dim 64, and both reduced models' streams equal to the CPU's with
their launch counts; the two norms' backward kernels against autograd of
their plain versions within 1e-5 of the gradient's scale, repeating their
bits with and without the forward's saved statistics and on graph replays,
``apply_norm`` on CUDA tensors keeping the gradient, and a reduced
train step on the card against the CPU's; the RMSNorm fused with the
activation quantizer bit-equal to the RMSNorm kernel followed by
``quantize_activation`` at every served width, row-invariant, one kernel
node, the LayerNorm fused the same way at d 64 to 24,576 (16.8 M codes, 8
replays), the LayerNorm forward's saved mean bit-equal to the numpy
emulation of its order, and reduced decode steps (OPT-30B and
whisper-tiny among them) with each norm's int8 pair handed to its
linears bit-equal to steps with a quantizer a linear.  The engines' captured steps (CUDA graphs) are
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
from repro_torch.kernels import int8_matmul_grouped as gmm
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
                               "int8_matmul_grouped": 0,
                               "pim_mvm": 0, "decode_attn": cfg.n_layers * steps,
                               "verify_attn": 0, "verify_tree_attn": 0, "ssd_chunk": 0,
                               "rms_norm": (2 * cfg.n_layers + 1) * len(prompts) + steps,
                               "rms_norm_quant": 2 * cfg.n_layers * steps,
                               "layer_norm": 0, "layer_norm_quant": 0,
                               "rms_norm_backward": 0, "layer_norm_backward": 0}
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
    want = {"int8_matmul": 7 * cfg.n_layers * steps, "int8_matmul_grouped": 0,
            "pim_mvm": 0, "decode_attn": 0,
            "verify_attn": 0, "verify_tree_attn": 0, "ssd_chunk": 0,
            "rms_norm": (2 * cfg.n_layers + 1) * len(prompts) + steps,
            "rms_norm_quant": 2 * cfg.n_layers * steps, "layer_norm": 0,
            "layer_norm_quant": 0, "rms_norm_backward": 0, "layer_norm_backward": 0}
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


SERVED_RMS_WIDTHS = [1536, 2560, 3072, 4096, 5120, 6144, 7168, 8192, 16384, 18432]


@pytest.mark.parametrize("d", [64, 300] + SERVED_RMS_WIDTHS)
def test_rms_norm_quant_equals_the_kernel_and_the_quantizer(cuda, d):
    """The fused entry's output is the RMSNorm kernel's, bit for bit, and its
    codes and scales ``quantize_activation`` of that output (a zero row at
    the scale's floor, a row scaled by 1e-20 and one by 1e20 among random
    ones), in one launch; each row's three outputs are the same bits
    whether the call holds 1, 4, 20 or 124 rows, and as [4, 5, d]."""
    g = torch.Generator().manual_seed(d)
    x = (torch.randn((124, d), generator=g) * 2).to(cuda)
    x[7] = 0
    x[9] *= 1e-20
    x[11] *= 1e20
    scale = torch.randn((d,), generator=g).to(cuda)
    reset_launch_counts()
    whole = rn.rms_norm_quant(x, scale)
    assert launch_counts()["rms_norm_quant"] == 1 and launch_counts()["rms_norm"] == 0
    h = rn.rms_norm_cuda(x, scale)
    for a, b in zip(whole, (h, *quant.quantize_activation(h))):
        assert torch.equal(a, b)
    assert whole[1].dtype == torch.int8 and whole[2].shape == (124, 1)
    for m in (1, 4, 20):
        for j in range(3):
            parts = torch.cat([rn.rms_norm_quant_cuda(x[i:i + m], scale)[j]
                               for i in range(0, 124, m)])
            assert torch.equal(parts, whole[j]), (m, j)
    shaped = rn.rms_norm_quant_cuda(x[:20].reshape(4, 5, d), scale)
    assert shaped[2].shape == (4, 5, 1)
    for j in range(3):
        assert torch.equal(shaped[j].reshape(20, -1), whole[j][:20])


def test_rms_norm_quant_codes_equal_the_quantizer_on_many_rows(cuda):
    """16.8 M codes (4,096 rows of 4,096, rows scaled from 1e-6 to 1e6):
    the fused entry's division (one fma step from the reciprocal, no
    ``__fdiv_rn``) gives ``quantize_activation``'s codes and scales on the
    kernel's own output, every one."""
    g = torch.Generator().manual_seed(29)
    x = torch.randn((4096, 4096), generator=g)
    x = (x * torch.logspace(-6, 6, 4096)[:, None]).to(cuda)
    scale = (torch.rand((4096,), generator=g) * 4 - 2).to(cuda)
    h, codes, scales = rn.rms_norm_quant_cuda(x, scale)
    want_q, want_s = quant.quantize_activation(h)
    assert torch.equal(scales, want_s)
    assert int((codes != want_q).sum()) == 0


@pytest.mark.parametrize("d", [4096, 5120])
def test_rms_norm_quant_replays_its_bits(cuda, d):
    """The fused entry captured in a CUDA graph is one kernel node and gives
    the eager call's bits on every replay."""
    g = torch.Generator().manual_seed(d + 1)
    x = torch.randn((4, d), generator=g).to(cuda)
    scale = torch.randn((d,), generator=g).to(cuda)
    want = rn.rms_norm_quant_cuda(x, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rn.rms_norm_quant_cuda(x, scale)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _captured_node_types(lambda: rn.rms_norm_quant_cuda(x, scale)) == [0]


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "deepseek-v3-671b",
                                  "opt-30b", "whisper-tiny"])
@pytest.mark.parametrize("backend", ["fused_int8", "pim_bitserial"])
def test_norm_pairs_give_the_unfused_logits(cuda, arch, backend, monkeypatch):
    """A reduced decode step on the card with each norm's int8 pair handed
    to its linears (the norm's entry fused with the quantizer:
    ``rms_norm_quant``, or ``layer_norm_quant`` for OPT and whisper) gives
    the logits of the same step with a quantizer a linear, bit for bit,
    and launches the fused entry once for each norm whose output feeds
    quantized linears."""
    from repro_torch.models import layers as L
    cfg = registry.get(arch).reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    qparams = quantize_tree(params)
    rt = Runtime(backend)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    batch = {"inputs": toks.to(cuda)}
    if cfg.family == "encdec":
        batch = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g).to(cuda),
                 "tokens": toks.to(cuda)}
    _, state = M.prefill(params, cfg, batch, 32, rt)
    tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    fused_name = ("layer_norm" if cfg.norm_type == "layernorm" else "rms_norm") + "_quant"
    reset_launch_counts()
    fused, _ = M.decode_step(qparams, cfg, _clone_state(state), tok, rt)
    n_fused = launch_counts()[fused_name]
    monkeypatch.setattr(L, "PAIR_BACKENDS", ())
    reset_launch_counts()
    plain, _ = M.decode_step(qparams, cfg, _clone_state(state), tok, rt)
    assert launch_counts()[fused_name] == 0
    assert torch.equal(fused, plain)
    L_ = cfg.n_layers
    want = (3 * L_ if cfg.family == "encdec" else
            sum(1 + (cfg.layer_kind(i) == "ssm") + bool(cfg.d_ff and not cfg.is_moe_layer(i))
                + (cfg.attn_type == "mla") for i in range(L_)))
    assert n_fused == want


def _norm_backward_inputs(rows, d, device):
    g = torch.Generator().manual_seed(rows * 7 + d)
    x = (torch.randn((rows, d), generator=g) * 3 + 0.5).to(device)
    scale = torch.randn((d,), generator=g).to(device)
    bias = torch.randn((d,), generator=g).to(device)
    dy = torch.randn((rows, d), generator=g).to(device)
    return x, scale, bias, dy


def _close_to(got, want):
    """Within 1e-5 of the plain gradient's scale: dx is a difference of
    terms of that size, dscale and dbias sums over the rows, in other
    orders than autograd's."""
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("rows", [1, 7, 8, 1024, 4099])
@pytest.mark.parametrize("d", [768, 4096, 8192])
def test_rms_norm_backward_matches_autograd_of_plain(cuda, rows, d):
    """The backward kernel against autograd through ``rms_norm_plain``,
    one launch (one device kernel), the same bits on a second call (no
    float atomics), with and without the forward's ``rstd``."""
    x, scale, _, dy = _norm_backward_inputs(rows, d, cuda)
    _, rstd = rn.rms_norm_cuda(x, scale, with_rstd=True)
    reset_launch_counts()
    dx, dscale = rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    assert launch_counts()["rms_norm_backward"] == 1
    want_dx, want_ds = rn.rms_norm_backward_plain(x, scale, dy)
    _close_to(dx, want_dx)
    _close_to(dscale, want_ds)
    dx2, ds2 = rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    assert torch.equal(dx, dx2) and torch.equal(dscale, ds2)
    dx3, ds3 = rn.rms_norm_backward_cuda(x, scale, dy)
    _close_to(dx3, want_dx)
    _close_to(ds3, want_ds)


@pytest.mark.parametrize("rows", [1, 7, 1024, 4099])
@pytest.mark.parametrize("d", [768, 4096, 8192])
def test_rms_norm_rstd_equals_the_backwards_own(cuda, rows, d):
    """The forward's ``rstd`` is the r the backward recomputes without it
    (the same sum in the same order): both backwards give the same bits;
    the forward's output is the same with and without ``rstd``; ``rstd``
    is within 1e-6 of torch's ``rsqrt(mean(x^2) + eps)``."""
    x, scale, _, dy = _norm_backward_inputs(rows, d, cuda)
    out, rstd = rn.rms_norm_cuda(x, scale, with_rstd=True)
    assert torch.equal(out, rn.rms_norm_cuda(x, scale))
    torch.testing.assert_close(rstd, torch.rsqrt((x * x).mean(-1) + 1e-5), rtol=1e-6, atol=0)
    got = rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    own = rn.rms_norm_backward_cuda(x, scale, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, own))


@pytest.mark.parametrize("rows,d", [(1024, 4096), (7, 768)])
def test_rms_norm_backward_replays_its_bits(cuda, rows, d):
    """The backward captured in a CUDA graph (after one call outside it)
    gives the eager call's bits on every replay (its tickets are back at
    zero after each launch), and the graph holds one kernel node."""
    x, scale, _, dy = _norm_backward_inputs(rows, d, cuda)
    _, rstd = rn.rms_norm_cuda(x, scale, with_rstd=True)
    want = rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        got = rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _captured_node_types(lambda: rn.rms_norm_backward_cuda(x, scale, dy, rstd=rstd)) == [0]


@pytest.mark.parametrize("rows", [1, 7, 8, 1024, 4099])
@pytest.mark.parametrize("d", [96, 384, 768, 1000, 4096, 8192, 18432])
def test_layer_norm_backward_matches_autograd_of_plain(cuda, rows, d):
    """The backward kernel (``layer_norm_bwd``: a warp a row up to d 1,024,
    a block a row past it) against autograd through ``layer_norm_plain``,
    handed the forward's mean and ``rstd``: one launch, the same bits on a
    second call (no float atomics) and without the saved stats (the kernel
    recomputes them in the forward's order)."""
    x, scale, bias, dy = _norm_backward_inputs(rows, d, cuda)
    _, mean, rstd = lnk.layer_norm_cuda(x, scale, bias, with_stats=True)
    reset_launch_counts()
    got = lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)
    assert launch_counts()["layer_norm_backward"] == 1
    for a, b in zip(got, lnk.layer_norm_backward_plain(x, scale, bias, dy)):
        _close_to(a, b)
    again = lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, lnk.layer_norm_backward_cuda(x, scale, dy)))


@pytest.mark.parametrize("rows", [1, 7, 1024])
@pytest.mark.parametrize("d", [768, 4096])
def test_layer_norm_stats_are_the_forwards_own(cuda, rows, d):
    """The forward's output is the same bits with and without its saved
    statistics, and the mean and ``rstd`` it saves are within 1e-6 of
    torch's."""
    x, scale, bias, _ = _norm_backward_inputs(rows, d, cuda)
    out, mean, rstd = lnk.layer_norm_cuda(x, scale, bias, with_stats=True)
    assert torch.equal(out, lnk.layer_norm_cuda(x, scale, bias))
    torch.testing.assert_close(mean, x.mean(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rstd, torch.rsqrt(x.var(-1, unbiased=False) + 1e-5),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows,d", [(1024, 768), (1024, 4096), (7, 768)])
def test_layer_norm_backward_replays_its_bits(cuda, rows, d):
    """The backward captured in a CUDA graph (after one call outside it)
    gives the eager call's bits on every replay (its tickets are back at
    zero after each launch), and the graph holds one kernel node."""
    x, scale, bias, dy = _norm_backward_inputs(rows, d, cuda)
    _, mean, rstd = lnk.layer_norm_cuda(x, scale, bias, with_stats=True)
    want = lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        got = lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _captured_node_types(
        lambda: lnk.layer_norm_backward_cuda(x, scale, dy, mean=mean, rstd=rstd)) == [0]


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_keeps_the_gradient_on_the_card(cuda, kind):
    """``apply_norm`` on CUDA tensors under ``requires_grad`` has a
    ``grad_fn`` (the autograd Function), launches the forward and then the
    backward kernel once each, and its gradients are autograd's of the
    plain version."""
    from repro_torch.models import layers as L
    x, scale, bias, dy = _norm_backward_inputs(20, 768, cuda)
    p = {"scale": scale.clone().requires_grad_(True)}
    if kind == "layernorm":
        p["bias"] = bias.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    reset_launch_counts()
    y = L.apply_norm(p, xr)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, [xr, *p.values()], dy)
    name = "layer_norm" if kind == "layernorm" else "rms_norm"
    counts = launch_counts()
    assert counts[name] == 1 and counts[f"{name}_backward"] == 1
    want = (lnk.layer_norm_backward_plain(x, scale, bias, dy) if kind == "layernorm"
            else rn.rms_norm_backward_plain(x, scale, dy))
    for a, b in zip(got, want):
        _close_to(a, b)
    assert torch.count_nonzero(got[1]) > 0
    with torch.no_grad():
        assert L.apply_norm(p, xr).grad_fn is None


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """llama3-8b and opt-125m reduced: the loss and every leaf's gradient
    on the card (norm kernels, their backward kernels) against the CPU's
    (plain norms), the loss within rtol 1e-5 and each gradient within 1e-4
    of its leaf's scale (f32 sums in other orders), one forward and one
    backward norm launch a norm; then a train step runs on the card.  (The
    weights after an AdamW step are not compared elementwise: Adam's first
    step divides a gradient by its own magnitude, so an entry whose
    gradient is near zero moves by an amount its last bits decide.)"""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens, put_batch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step, value_and_grad
    for arch in ("llama3-8b", "opt-125m"):
        cfg = registry.get(arch).reduced()
        batch = SyntheticTokens(cfg, ShapeConfig("t", 16, 2, "train"), seed=3).batch_at(0)
        out = {}
        for dev in ("cpu", "cuda"):
            params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), dev)
            reset_launch_counts()
            loss, grads = value_and_grad(params, cfg, put_batch(batch, dev), Runtime())
            out[dev] = (float(loss), convert.tree_leaves(grads), launch_counts())
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
        for a, b in zip(out["cpu"][1], out["cuda"][1]):
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4 * float(a.abs().max()))
        name = "layer_norm" if cfg.norm_type == "layernorm" else "rms_norm"
        norms = 2 * cfg.n_layers + 1
        assert out["cuda"][2][name] == norms and out["cuda"][2][f"{name}_backward"] == norms
        assert set(out["cpu"][2].values()) == {0}
        opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10, quantized_state=True)
        params = M.init_params(cfg, seed=0, device="cuda")
        params, state, m = make_train_step(cfg, Runtime(), opt)(params, opt.init(params), batch)
        assert np.isfinite(float(m["loss"])) and int(state.count) == 1


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


QUANT_LN_WIDTHS = [96, 384, 768, 1000, 4096, 7168, 18432, 24576]


def _layer_norm_rows(rows, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, d), generator=g) * 3 + 0.5
    return x, torch.randn((d,), generator=g), torch.randn((d,), generator=g)


@pytest.mark.parametrize("d", [64, 300] + QUANT_LN_WIDTHS)
def test_layer_norm_quant_equals_the_kernel_and_the_quantizer(cuda, d):
    """The fused LayerNorm entry's output is the LayerNorm kernel's, bit for
    bit, and its codes and scales ``quantize_activation`` of that output (a
    zero row, a constant row, a row scaled by 1e-20 and one by 1e20 among
    random ones), in one launch; each row's three outputs are the same bits
    whether the call holds 1, 4, 20, 28 or 140 rows, and as [4, 5, d]."""
    x, scale, bias = (t.to(cuda) for t in _layer_norm_rows(140, d, d))
    x[7] = 0
    x[8] = 1.7
    x[9] *= 1e-20
    x[11] *= 1e20
    reset_launch_counts()
    whole = lnk.layer_norm_quant(x, scale, bias)
    assert launch_counts()["layer_norm_quant"] == 1 and launch_counts()["layer_norm"] == 0
    h = lnk.layer_norm_cuda(x, scale, bias)
    for a, b in zip(whole, (h, *quant.quantize_activation(h))):
        assert torch.equal(a, b)
    assert whole[1].dtype == torch.int8 and whole[2].shape == (140, 1)
    for m in (1, 4, 20, 28):
        for j in range(3):
            parts = torch.cat([lnk.layer_norm_quant_cuda(x[i:i + m], scale, bias)[j]
                               for i in range(0, 140, m)])
            assert torch.equal(parts, whole[j]), (m, j)
    shaped = lnk.layer_norm_quant_cuda(x[:20].reshape(4, 5, d), scale, bias)
    assert shaped[2].shape == (4, 5, 1)
    for j in range(3):
        assert torch.equal(shaped[j].reshape(20, -1), whole[j][:20])


def test_layer_norm_quant_codes_equal_the_quantizer_on_many_rows(cuda):
    """16.8 M codes (2,340 rows of 7,168, rows scaled from 1e-6 to 1e6): the
    fused LayerNorm's division gives ``quantize_activation``'s codes and
    scales on the kernel's own output, every one."""
    x, scale, bias = _layer_norm_rows(2340, 7168, 30)
    x = (x * torch.logspace(-6, 6, 2340)[:, None]).to(cuda)
    h, codes, scales = lnk.layer_norm_quant_cuda(x, scale.to(cuda), bias.to(cuda))
    want_q, want_s = quant.quantize_activation(h)
    assert torch.equal(scales, want_s)
    assert int((codes != want_q).sum()) == 0


@pytest.mark.parametrize("d", [384, 7168])
def test_layer_norm_quant_replays_its_bits(cuda, d):
    """The fused LayerNorm captured in a CUDA graph is one kernel node and
    gives the eager call's bits on each of 8 replays."""
    x, scale, bias = (t.to(cuda) for t in _layer_norm_rows(4, d, d + 1))
    want = lnk.layer_norm_quant_cuda(x, scale, bias)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = lnk.layer_norm_quant_cuda(x, scale, bias)
    for _ in range(8):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _captured_node_types(lambda: lnk.layer_norm_quant_cuda(x, scale, bias)) == [0]


@pytest.mark.parametrize("d", [384, 768, 7168])
def test_layer_norm_mean_is_the_forward_order_emulated(cuda, d):
    """The forward's saved mean equals, bit for bit, the numpy emulation of
    its order (``test_torch_norm_split.forward_stats``: thread t's elements
    t, t + 256, ... in order, each warp's butterfly, the warp sums in
    order), on rows of three scales and offsets."""
    from test_torch_norm_split import forward_stats
    rng = np.random.default_rng(d)
    rows = np.stack([(rng.standard_normal(d) * a + b).astype(np.float32)
                     for a, b in ((1.0, 0.0), (3.0, 0.5), (1e-3, 1e3))])
    _, mean, _ = lnk.layer_norm_cuda(torch.from_numpy(rows).to(cuda),
                                     torch.ones(d, device=cuda), torch.zeros(d, device=cuda),
                                     with_stats=True)
    want = np.array([forward_stats(r)[0] for r in rows], np.float32)
    assert mean.cpu().numpy().tobytes() == want.tobytes()


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


@pytest.mark.parametrize("arch", ["opt-30b", "granite-3-8b", "phi3-mini-3.8b",
                                  "chameleon-34b", "nemotron-4-340b", "grok-1-314b"])
def test_reduced_families_serve_on_the_card_like_the_cpu(cuda, arch):
    """The continuous engine on the card under ``fused_int8`` launches B1
    once a linear (6 a layer under gelu and relu2, 7 under SwiGLU; a MoE
    layer's 4 attention linears and 3 grouped launches for its experts)
    and B2 once a layer a decode step, and one norm kernel (LayerNorm for
    OPT, RMSNorm otherwise) a norm, QK-norm's two a layer included (a
    decode step's norms that feed quantized linears through the norm's
    entry fused with the quantizer), and its first tokens (prefill, float
    only) equal the CPU's."""
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
    qk = 2 * L if cfg.use_qk_norm else 0
    fused = (1 if cfg.n_experts else 2) * L * steps
    assert counts[norm + "_quant"] == fused
    assert counts[norm] == (2 * L + 1 + qk) * (steps + len(prompts)) - fused
    linears = 4 if cfg.n_experts else 7 if cfg.mlp_type == "swiglu" else 6
    assert counts["int8_matmul"] == linears * L * steps and counts["decode_attn"] == L * steps
    assert counts["int8_matmul_grouped"] == (3 * L * steps if cfg.n_experts else 0)
    other = "layer_norm" if norm == "rms_norm" else "rms_norm"
    assert counts[other] == counts[other + "_quant"] == 0
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
    assert res["cuda"][2] == {"int8_matmul": 3 * L, "int8_matmul_grouped": 0,
                              "pim_mvm": 0, "decode_attn": 0,
                              "verify_attn": 0, "verify_tree_attn": 0,
                              "ssd_chunk": 2 * L, "rms_norm": 2 * L + 2,
                              "rms_norm_quant": 2 * L, "layer_norm": 0,
                              "layer_norm_quant": 0, "rms_norm_backward": 0,
                              "layer_norm_backward": 0}
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
    assert launch_counts() == {"int8_matmul": 3 * L * steps, "int8_matmul_grouped": 0,
                               "pim_mvm": 0, "decode_attn": 0,
                               "verify_attn": 0, "verify_tree_attn": 0,
                               "ssd_chunk": L * len(trace),
                               "rms_norm": (2 * L + 1) * len(trace) + steps,
                               "rms_norm_quant": 2 * L * steps, "layer_norm": 0,
                               "layer_norm_quant": 0, "rms_norm_backward": 0,
                               "layer_norm_backward": 0}
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
    per = {"int8_matmul": lin * L, "rms_norm": 1, "rms_norm_quant": 2 * L}
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
    assert counts["rms_norm"] == (2 * cfg.n_layers + 1) * pieces + steps
    assert counts["rms_norm_quant"] == 2 * cfg.n_layers * steps


# ---------------------------------------------------------------------------
# the prefix cache and the tiered pool on the card (A.10)
# ---------------------------------------------------------------------------
def test_quantize_kv_division_and_round_trip_on_the_card(cuda):
    """Which division ``quantize_kv``'s ``amax / 127`` runs on the card, over
    a row for every float32 mantissa in [1, 2): its scales must equal
    float32 IEEE division or a multiply by ``fl(1/127)`` bit for bit, and
    dequantizing then quantizing again must move exactly the scales (and
    codes) that division's host emulation moves: none for IEEE division."""
    amax = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(127 << 23)).view(np.float32)
    x = torch.from_numpy(np.stack([amax, -0.5 * amax], -1)[:, None, :]).to(cuda)
    q, s = quant.quantize_kv(x)
    card = s.reshape(-1).cpu().numpy()
    forms = {"ieee": lambda a: a / np.float32(127.0),
             "reciprocal": lambda a: a * (np.float32(1.0) / np.float32(127.0))}
    division = [k for k, f in forms.items() if np.array_equal(card, f(amax))]
    assert division, "scales match neither division"
    q2, s2 = quant.quantize_kv(quant.dequantize_kv(q, s))
    host_s2 = forms[division[0]](np.abs(np.float32(127.0) * card))
    np.testing.assert_array_equal(s2.reshape(-1).cpu().numpy(), host_s2)
    if division[0] == "ieee":
        assert torch.equal(s2, s) and torch.equal(q2, q)


def _mantissa_rows():
    """Rows whose amax is each float32 mantissa in [1, 2), and random rows."""
    amax = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(127 << 23)).view(np.float32)
    frac = np.array([-0.5, 0.3, -0.99], np.float32)
    rows = np.concatenate([amax[:, None], amax[:, None] * frac], 1)
    rand = (np.random.default_rng(5).standard_normal((4096, 128)) * 3).astype(np.float32)
    return amax, rows, rand


@pytest.mark.parametrize("which", ["weight", "activation", "kv"])
def test_quantizers_on_the_card_equal_the_cpu(cuda, which):
    """Each quantizer on the card gives the CPU's scales and codes bit for
    bit: on rows whose amax runs over all 2^23 float32 mantissas in [1, 2)
    (the scales IEEE ``amax / 127``) and on random rows."""
    amax, rows, rand = _mantissa_rows()
    fn = {"weight": lambda x: quant.quantize_weight(x.T.contiguous(), axis=0),
          "activation": quant.quantize_activation,
          "kv": lambda x: quant.quantize_kv(x[:, None, :])}[which]
    for x in (rows, rand):
        cpu = fn(torch.from_numpy(x))
        card = fn(torch.from_numpy(x).to(cuda))
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu()), which
    scales = fn(torch.from_numpy(rows).to(cuda))[1].reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(scales, amax / np.float32(127.0))


def test_quantizer_divisor_is_made_once_outside_capture(cuda, monkeypatch):
    """The quantizers' divisor is made on the first eager call on a device
    and reused: a captured quantizer then adds no fill node and replays the
    eager bits; a first call inside a capture raises, because the capture
    would record the divisor's fill without running it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((4, 4096), device=cuda) * 3
    monkeypatch.setattr(quant, "_DIVISORS", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            quant.quantize_activation(x)
    want = quant.quantize_activation(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = quant.quantize_activation(x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    assert not [e for e in prof.events() if "FillFunctor" in e.name]
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g,rep", [(8, 12), (3, 1)], ids=["nemotron", "rep1"])
def test_attention_kernels_at_head_dim_192(cuda, g, rep):
    """B2, B3 (T 5) and B4 (T 7) at head dim 192 (nemotron-4-340b's 8 groups
    of 12 heads, and MHA's rep 1): each within ``rtol=3e-5, atol=3e-6`` of
    its plain version; B3's rows equal B2 in the same pool and in a pool
    T - 1 rows smaller, and B4 on a chain equals B3, bit for bit."""
    b, max_len, d = 4, 256, 192
    for t in (1, 5, 7):
        s = max_len + t - 1
        q_q, q_s, cache = _window(b, s, g, rep, d, t, 7 * t + rep, cuda)
        small = [c[:, :max_len].contiguous() for c in cache]
        pos = torch.tensor([0, 61, 125, max_len - t], dtype=torch.int32, device=cuda)
        lengths = (pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32,
                                               device=cuda)).contiguous()
        reset_launch_counts()
        got3 = va.verify_attn_cuda(q_q, q_s, *cache, lengths)
        assert launch_counts()["verify_attn"] == 1
        torch.testing.assert_close(got3, va.verify_attn_plain(q_q, q_s, *cache, lengths),
                                   rtol=3e-5, atol=3e-6)
        for i in range(t):
            args = (q_q[:, :, i].contiguous(), q_s[:, :, i].contiguous())
            dec = da.decode_attn_cuda(*args, *cache, lengths[:, i].contiguous())
            torch.testing.assert_close(dec, da.decode_attn_plain(*args, *cache,
                                                                 lengths[:, i].contiguous()),
                                       rtol=3e-5, atol=3e-6)
            assert torch.equal(got3[:, :, i], dec), (t, i)
            assert torch.equal(da.decode_attn_cuda(*args, *small, lengths[:, i].contiguous()),
                               dec), (t, i)
        chain = ((1 << torch.arange(1, t + 1, dtype=torch.int64)) - 1).to(torch.int32)
        chain = chain.expand(b, t).contiguous().to(cuda)
        assert torch.equal(vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, chain), got3)
        anc = _trees(b, t, t).to(cuda)
        torch.testing.assert_close(vt.verify_tree_attn_cuda(q_q, q_s, *cache, pos, anc),
                                   vt.verify_tree_attn_plain(q_q, q_s, *cache, pos, anc),
                                   rtol=3e-5, atol=3e-6)
    assert da.smem_bytes(d) > 48 * 1024 >= da.smem_bytes(128)


def test_rms_norm_row_invariant_on_qk_norm_rows(cuda):
    """QK-norm's rows (chameleon-34b's 64 query heads of 128): a token's
    rows normalise to the same bits whether the call holds 1, 4, 20 or 28
    tokens' rows or 140."""
    h, d = 64, 128
    g = torch.Generator().manual_seed(12)
    x = torch.randn((140, h, d), generator=g).to(cuda)
    scale = torch.randn((d,), generator=g).to(cuda)
    full = rn.rms_norm_cuda(x, scale)
    torch.testing.assert_close(full, rn.rms_norm_plain(x, scale), rtol=1e-6, atol=0)
    for m in (1, 4, 20, 28):
        parts = torch.cat([rn.rms_norm_cuda(x[i:i + m], scale) for i in range(0, 140, m)])
        assert torch.equal(parts, full), m


def test_reduced_chameleon_prefill_from_embeddings_on_the_card(cuda):
    """Reduced chameleon-34b prefilled from [B, T, d] embeddings (ragged)
    and decoding from [B, d] embeddings on the card under ``fused_int8``:
    within 2% of the CPU's logit scale, argmax equal; QK-norm runs the
    RMSNorm kernel."""
    cfg = registry.get("chameleon-34b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    qparams = quantize_tree(params)
    rng = np.random.default_rng(4)
    emb = torch.from_numpy((rng.standard_normal((2, 24, cfg.d_model)) * 0.5).astype(np.float32))
    nxt = torch.from_numpy((rng.standard_normal((2, cfg.d_model)) * 0.5).astype(np.float32))
    lengths = torch.tensor([24, 17], dtype=torch.int32)
    rt = Runtime("fused_int8")
    res = {}
    for dev in ("cpu", cuda):
        reset_launch_counts()
        lg0, st = M.prefill(convert.to_device(params, dev), cfg,
                            {"inputs": emb.to(dev), "lengths": lengths.to(dev)}, 64, rt)
        lg1, _ = M.decode_step(convert.to_device(qparams, dev), cfg, st, nxt.to(dev), rt)
        res[str(dev)] = (lg0.cpu(), lg1.cpu(), launch_counts())
    L = cfg.n_layers
    assert res["cuda"][2]["rms_norm"] == (4 * L + 1) + (2 * L + 1)
    assert res["cuda"][2]["rms_norm_quant"] == 2 * L
    for a, b in zip(res["cpu"][:2], res["cuda"][:2]):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max())


def _pool(cfg, device, B=3, S=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    st = M.init_decode_state(cfg, B, S, "cpu")
    for lay in st["layers"]:
        for k, v in lay.items():
            v.copy_(torch.randint(-127, 128, v.shape, generator=g, dtype=torch.int8)
                    if k.endswith("_q") else torch.rand(v.shape, generator=g) + 1e-3)
    st["pos"].copy_(torch.tensor([5, 17, 33][:B], dtype=torch.int32))
    return {"layers": [{k: v.to(device) for k, v in lay.items()} for lay in st["layers"]],
            "pos": st["pos"].to(device)}


def test_copy_slot_prefix_and_host_round_trip_on_the_card(cuda):
    """``copy_slot_prefix`` on the card equals the CPU's bit for bit; a
    slot's live rows lifted to host numpy (``read_slot`` + ``to_host``) and
    landed in another slot through ``write_slot`` come back byte-exact."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.kv_swap import to_host
    cfg = registry.get("llama3-8b").reduced()
    cpu, dev = _pool(cfg, "cpu"), _pool(cfg, cuda)
    T.copy_slot_prefix(cpu, 2, 0, 21)
    T.copy_slot_prefix(dev, 2, 0, 21)
    for a, b in zip(cpu["layers"], dev["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k].cpu()), k
    assert torch.equal(cpu["pos"], dev["pos"].cpu())
    host = to_host(T.read_slot(dev, 1, 17))
    T.write_slot(dev, 2, host)
    for lay in dev["layers"]:
        for k, v in lay.items():
            assert torch.equal(v[2, :17], v[1, :17]), k
    assert int(dev["pos"][2]) == int(dev["pos"][1])


def test_warm_finalize_keeps_cached_rows_byte_identical_on_the_card(cuda):
    """A warm chunked prefill on the card (rows copied from a prefilled slot,
    the warm carry, the rest of the prompt in chunks, the finalize past the
    cached rows) leaves the cached rows' k_q, k_s, v_q and v_s byte-identical
    in every layer, and its tail rows equal a CPU run's int8 codes but for
    rounding boundaries."""
    from repro_torch.models import transformer as T
    cfg = registry.get("llama3-8b").reduced()
    params_cpu = M.init_params(cfg, seed=0, device="cpu")
    max_len, chunk, n = 96, 8, 40
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 70).tolist()
    results = []
    for device in ("cpu", cuda):
        params = convert.to_device(params_cpu, device)
        rt = Runtime("fused_int8")
        state = M.init_decode_state(cfg, 2, max_len, device)

        def chunks(carry, start):
            for i in range(start, len(prompt), chunk):
                k = min(chunk, len(prompt) - i)
                toks = torch.zeros((1, chunk), dtype=torch.int64, device=device)
                toks[0, :k] = torch.tensor(prompt[i:i + k])
                _, carry = M.prefill_chunk(params, cfg, carry, toks, k, rt)
            return carry
        carry = chunks(M.init_prefill_carry(cfg, T.carry_len(max_len), device), 0)
        T.write_slot(state, 0, M.finalize_prefill_carry(cfg, carry, max_len))
        T.copy_slot_prefix(state, 0, 1, n)
        warm = chunks(M.warm_prefill_carry(cfg, state, 1, n, T.carry_len(max_len),
                                           prompt[:n]), n)
        T.write_slot(state, 1, M.finalize_prefill_carry(cfg, warm, max_len, n), n)
        for lay in state["layers"]:
            for k in ("k_q", "k_s", "v_q", "v_s"):
                assert torch.equal(lay[k][1, :n], lay[k][0, :n]), k
        results.append(state)
    for a, b in zip(*[r["layers"] for r in results]):
        same = (a["k_q"][1, :len(prompt)] == b["k_q"][1, :len(prompt)].cpu()).float().mean()
        assert same > 0.999


def test_prefix_and_swap_lanes_serve_on_the_card(cuda):
    """On the card the prefix cache serves followers of a published prompt
    warm (with their cached rows byte-identical to the leaf's), and a
    swap-preempted resident's rows come back verbatim, its stream equal to
    the plain engine's."""
    cfg = registry.get("llama3-8b").reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 64).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, 10).tolist() for _ in range(4)]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=128, chunk=16,
                                   prefix_cache=True, rt=Runtime("fused_int8"))
    lead = eng.generate_all(prompts[:1], [6])
    slot = next(iter(eng._pcache._slots))
    leaf_rows = [{k: v[slot, :64].clone() for k, v in lay.items()}
                 for lay in eng.state["layers"]]
    # one follower at a time: followers admitted together would reclaim the
    # leaf's slot before either looks the prefix up (the reference's order)
    outs = [eng.generate_all([p], [6])[0] for p in prompts[1:3]]
    assert len(lead[0]) == 6 and [len(o) for o in outs] == [6, 6]
    assert eng.stats["prefix_hits"] == 2 and eng.stats["prefill_tokens_saved"] == 128
    for s in range(2):
        if eng._pcache.leaf_for(s) is not None:
            for lay, want in zip(eng.state["layers"], leaf_rows):
                for k in want:
                    assert torch.equal(lay[k][s, :64], want[k]), k

    def serve(**kw):
        e = ContinuousBatchingEngine(cfg, params, n_slots=1, max_len=128,
                                     rt=Runtime("fused_int8"), **kw)
        lo = e.submit(prompts[0], 10, priority=0)
        for _ in range(3):
            e.step()
        hi = e.submit(prompts[1], 3, priority=9)
        e.drain()
        return [lo.output, hi.output], e
    plain, _ = serve()
    swapped, e = serve(policy="priority:preempt", kv_swap=True)
    assert swapped == plain and e.stats["preempt_swaps"] >= 1
    assert e.stats["swap_in_bytes"] == e.stats["swap_out_bytes"] > 0


# ---------------------------------------------------------------------------
# fault recovery on the card (A.10): a rebuild keeps the captured steps
# ---------------------------------------------------------------------------
def test_pool_rebuild_keeps_the_captured_steps(cuda, monkeypatch):
    """An injected device error poisons the pool mid-step; the rebuild zeroes
    it in place, so every state tensor and static input keeps its address,
    nothing is captured again, a replayed decode step after the rebuild is
    bit-equal to the eager step on the same state, and the trace ends
    token-identical to the fault-free engine's."""
    from repro_torch.models import graphs as G
    from repro_torch.serve.faults import FaultInjector
    cfg = registry.get("llama3-8b").reduced()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    rt = Runtime("fused_int8")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(10, 60)).tolist()
               for _ in range(5)]
    budgets = [int(rng.integers(6, 13)) for _ in range(5)]
    plain = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=96,
                                     rt=rt).generate_all(prompts, budgets)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=96, rt=rt,
                                   faults=FaultInjector(seed=0, step_fail_at=(6,)))
    bufs = G.state_tensors(eng.state) + eng._static_inputs()
    ptrs = [t.data_ptr() for t in bufs]
    graphs = {k: g.graph for k, g in eng._steps.graphs.items()}
    captures = []
    monkeypatch.setattr(G.StepGraph, "_capture", lambda *a: captures.append(a))
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    while not eng.stats["pool_rebuilds"]:
        eng.step()
    while not any(r.state.value == "decoding" for r in eng.scheduler.active.values()):
        eng.step()
    saved = [t.clone() for t in G.state_tensors(eng.state)]
    eager = _clone_state(eng.state)
    tok = torch.from_numpy(eng._last_tok.copy()).to(cuda)
    want, _ = M.decode_step(eng.qparams, cfg, eager, tok, rt)
    eng._steps.tok.copy_(tok)
    got, _ = eng._steps.decode()
    assert torch.equal(got, want)
    for a, b in zip(G.state_tensors(eager), G.state_tensors(eng.state)):
        assert torch.equal(a, b)
    for t, s in zip(G.state_tensors(eng.state), saved):
        t.copy_(s)                          # the check's step is undone
    eng.drain()
    assert [r.output for r in reqs] == plain
    assert eng.stats["pool_rebuilds"] == eng.stats["step_retries"] == 1
    assert [t.data_ptr() for t in bufs] == ptrs and not captures
    assert {k: g.graph for k, g in eng._steps.graphs.items()} == graphs


# ---------------------------------------------------------------------------
# the MoE slice (grok-1-314b): B1's grouped entry, routing, B2 at rep 6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,K,N", [(1, 128, 256), (2, 6144, 1000), (10, 520, 77),
                                   (33, 1000, 528), (2, 777, 1024), (33, 1024, 512),
                                   (13, 8192, 3072)])
def test_int8_matmul_grouped_matches_plain_and_per_expert_b1(cuda, C, K, N):
    """The grouped entry (one launch) against its plain version and against
    B1 on each expert's slice, bit for bit, with counts 0, 1, C and between
    (rows past a count zero), odd N (byte loads) and K not a multiple of 32;
    a misaligned weight and a count vector of the wrong dtype raise."""
    E = 6
    counts = [0, 1, C, max(0, C // 2), C, 0][:E]
    g = torch.Generator().manual_seed(C * K + N)
    x_q = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8).to(cuda)
    x_s = (torch.rand((E, C, 1), generator=g) + 0.01).to(cuda)
    w_q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8).to(cuda)
    w_s = (torch.rand((E, N), generator=g) + 0.01).to(cuda)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt)
    assert launch_counts()["int8_matmul_grouped"] == 1 and launch_counts()["int8_matmul"] == 0
    assert torch.equal(got, gmm.int8_matmul_grouped_plain(x_q, x_s, w_q, w_s, cnt))
    for e, n in enumerate(counts):
        if n:
            # a copy: B1 takes a 16-byte aligned weight, and expert e's
            # slice starts e * K * N bytes in
            want, _ = mm.int8_matmul_cuda(x_q[e, :n].contiguous(), x_s[e, :n].contiguous(),
                                          w_q[e].clone(), w_s[e])
            assert torch.equal(got[e, :n], want), e
        assert not got[e, n:].any(), e
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(E * K * N + 1, dtype=torch.int8, device=cuda)
        gmm.int8_matmul_grouped_cuda(x_q, x_s, flat[1:].view(E, K, N), w_s, cnt)
    with pytest.raises(TypeError):
        gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt.to(torch.int64))


def _captured_node_types(fn):
    """The device operations of one ``fn()`` captured in a CUDA graph (after
    a call on a side stream): the graph's node types, 0 a kernel."""
    from repro_torch.models.graphs import node_types
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return node_types(graph)


def _grouped_inputs(E, C, K, N, counts, seed, device):
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8).to(device)
    x_s = (torch.rand((E, C, 1), generator=g) + 0.01).to(device)
    w_q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8).to(device)
    w_s = (torch.rand((E, N), generator=g) + 0.01).to(device)
    return x_q, x_s, w_q, w_s, torch.tensor(counts, dtype=torch.int32, device=device)


@pytest.mark.parametrize("E", [8, 16, 256])
@pytest.mark.parametrize("live", ["none", "one", "all"])
def test_int8_matmul_grouped_with_no_one_or_every_expert_live(cuda, E, live):
    """The grouped kernel with no expert live (every row zero), one (the
    last) and all, bit-equal to its plain version, one device kernel a call
    (a captured call's graph holds one kernel node: no memset, no copy)."""
    C = 3
    counts = ([0] * E if live == "none" else [0] * (E - 1) + [C] if live == "one"
              else [C] * E)
    args = _grouped_inputs(E, C, 512, 1024, counts, E, cuda)
    got = gmm.int8_matmul_grouped_cuda(*args)
    assert torch.equal(got, gmm.int8_matmul_grouped_plain(*args))
    assert _captured_node_types(lambda: gmm.int8_matmul_grouped_cuda(*args)) == [0]
    plan = gmm.launch_plan(counts, C, 512, 1024, 132)
    assert plan.passes == sum(1 for c in counts if c) and plan.tma == 1
    assert plan.stages == plan.passes * plan.tiles_per_pass * plan.stages_per_tile


def test_int8_matmul_grouped_replays_with_counts_changed_in_place(cuda):
    """A captured grouped call replayed after the counts change in place
    (as a decode step's routing does): bit-equal to the plain version at
    the new counts after every replay, the grid sized from the SM count
    alone."""
    E, C, K, N = 8, 4, 1024, 2048
    first = [4, 0, 1, 2, 0, 3, 4, 1]
    x_q, x_s, w_q, w_s, cnt = _grouped_inputs(E, C, K, N, first, 26, cuda)
    gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt)
    for counts in (first, [0] * E, [C] * E, [1, 2, 3, 4, 0, 0, 0, 1], first):
        cnt.copy_(torch.tensor(counts, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gmm.int8_matmul_grouped_plain(x_q, x_s, w_q, w_s, cnt)), counts


@pytest.mark.parametrize("counts", [(2, 1, 0, 2, 1, 0, 1, 1), (10, 3, 0, 1, 10, 5, 7, 4)])
@pytest.mark.parametrize("K,N", [(6144, 32768), (32768, 6144)])
def test_int8_matmul_grouped_plan_shares_the_live_weight_evenly(cuda, counts, K, N):
    """The plan at grok-1-314b's expert stacks: one CTA an SM, full waves of
    whole tiles and the last wave's stages split to within one stage, no
    stage for a dead expert."""
    C = max(counts)
    plan = gmm.launch_plan(list(counts), C, K, N, 132)
    live = sum(1 for c in counts if c)
    assert plan.ctas == 132 and plan.passes == live
    assert plan.stages == live * -(-N // 128) * -(-K // 128)
    tiles = plan.stages // plan.stages_per_tile
    assert plan.waves == tiles // 132
    assert plan.stages_per_cta == (plan.waves * plan.stages_per_tile
                                   + -(-(tiles % 132) * plan.stages_per_tile // 132))
    assert plan.cut_tiles <= tiles % 132


def _grok8():
    import dataclasses
    return dataclasses.replace(registry.get("grok-1-314b").reduced(), n_experts=8)


@pytest.mark.parametrize("N", [4, 20, 208])
def test_moe_local_on_the_card_matches_the_cpu(cuda, N):
    """Reduced grok at 8 experts: the card routes every choice where the
    CPU does (kept sets and counts equal, drops counted alike) and its
    MoE output, float and quantized experts, lies within 1e-5 of the
    output's scale of the CPU's."""
    from repro_torch.models import moe
    cfg = _grok8()
    p = M.init_params(cfg, seed=0, device="cpu")["layers"][1]["moe"]
    q = quantize_tree({"moe": p})["moe"]
    x = torch.randn((N, cfg.d_model), generator=torch.Generator().manual_seed(N))
    rc, rg = moe.route(p, x, cfg), moe.route(convert.to_device(p, cuda), x.to(cuda), cfg)
    assert torch.equal(rc.counts, rg.counts.cpu()) and int(rc.dropped) == int(rg.dropped)
    for e in range(cfg.n_experts):
        n = int(rc.counts[e])
        assert torch.equal(rc.toks[e, :n], rg.toks[e, :n].cpu()), e
    for tree in (p, q):
        want, _ = moe.moe_local(tree, x, cfg)
        got, _ = moe.moe_local(convert.to_device(tree, cuda), x.to(cuda), cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_captured_steps_of_reduced_grok_equal_eager(cuda):
    """Reduced grok at 8 experts, 4 slots at ragged cursors: the captured
    decode step (routing included: no host sync) replays bit-equal to the
    eager step over 8 steps, logits and every state tensor, crediting 4 B1
    and 3 grouped launches, one B2 and two RMSNorms a layer and one more
    RMSNorm a step; so do the verify step (T 5, 20 rows routed), the tree
    step (T 7) and a fused block of 4 decode replays, each state committed
    alike between steps; capacity drops choices on the way."""
    from repro_torch.models import graphs as G
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serve.drafter import tree_depths_ancestors
    cfg = _grok8()
    params = convert.to_device(M.init_params(cfg, seed=0, device="cpu"), cuda)
    qparams = quantize_tree(params)
    rt = Runtime("fused_int8")
    state = M.init_decode_state(cfg, 4, 64, cuda)
    gen = torch.Generator().manual_seed(3)
    for slot, n in enumerate((5, 17, 30, 9)):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen).to(cuda)
        _, one = M.prefill(params, cfg, {"inputs": toks}, 64, rt)
        T.write_slot(state, slot, one)
    eager = {"layers": [{k: v.clone() for k, v in c.items()} for c in state["layers"]],
             "pos": state["pos"].clone()}

    def same_state(i):
        for a, b in zip(G.state_tensors(state), G.state_tensors(eager)):
            assert torch.equal(a, b), i
    routing = torch.zeros((3,), dtype=torch.int64, device=cuda)
    moe.count_routing(routing)
    try:
        steps = G.ServeSteps(qparams, cfg, rt, state, verify=(5,), tree=(7,))
        L = cfg.n_layers
        per = {"int8_matmul": 4 * L, "int8_matmul_grouped": 3 * L, "rms_norm": L + 1,
               "rms_norm_quant": L}
        assert steps.graphs[("decode",)].launches == dict(per, decode_attn=L)
        assert steps.graphs[("verify", 5)].launches == dict(per, verify_attn=L)
        assert steps.graphs[("tree", 7)].launches == dict(per, verify_tree_attn=L)
        tok = torch.randint(0, cfg.vocab_size, (4,), generator=gen, dtype=torch.int32).to(cuda)
        routing.zero_()
        for i in range(8):
            steps.tok.copy_(tok)
            logits, _ = steps.decode()
            want, _ = M.decode_step(qparams, cfg, eager, tok, rt)
            assert torch.equal(logits, want), i
            same_state(i)
            tok = torch.argmax(want, -1).to(torch.int32)
        depth, anc = (torch.tensor(x, dtype=torch.int32, device=cuda).repeat(4, 1)
                      for x in tree_depths_ancestors([-1, -1, 0, 0, 1, 2]))
        for i, (kind, t) in enumerate((("verify", 5), ("verify", 5), ("tree", 7))):
            win = torch.randint(0, cfg.vocab_size, (4, t), generator=gen,
                                dtype=torch.int32).to(cuda)
            steps.window[t].copy_(win)
            kw = {}
            if kind == "tree":
                steps.depth[t].copy_(depth)
                steps.anc[t].copy_(anc)
                kw = {"depth": depth, "anc": anc}
            logits, _ = getattr(steps, kind)(t)
            want, _, _ = M.verify_step(qparams, cfg, eager, win, rt, **kw)
            assert torch.equal(logits, want), (kind, i)
            same_state((kind, i))
            pos = (eager["pos"] - t + 1 + i).cpu().numpy()    # commit 1 + i rows
            for st in (state, eager):
                T.rewind_pos(st, pos)
        steps.tok.copy_(tok)
        blk = steps.multi(4)
        want, _ = M.multi_decode_step(qparams, cfg, eager, tok, 4, rt)
        assert torch.equal(blk, want)
        same_state("multi")
    finally:
        moe.count_routing(None)
    # each step routed once a layer replayed and once eager
    assert int(routing[0]) == 2 * (8 + 3 + 4) * L and int(routing[1]) > 0


def test_decode_attn_at_rep_6_matches_plain(cuda):
    """B2 at grok-1-314b's attention (8 groups of 6 heads of 128, 4 slots)
    in a pool of 512 rows, within ``rtol=3e-5, atol=3e-6`` of its plain
    version, at lengths 1, 200, 377 and 512."""
    b, s, g, rep, d = 4, 512, 8, 6, 128
    q_q, q_s, cache = _window(b, s, g, rep, d, 1, 66, cuda)
    args = (q_q[:, :, 0].contiguous(), q_s[:, :, 0].contiguous(), *cache,
            torch.tensor([1, 200, 377, 512], dtype=torch.int32, device=cuda))
    reset_launch_counts()
    got = da.decode_attn_cuda(*args)
    assert launch_counts()["decode_attn"] == 1
    torch.testing.assert_close(got, da.decode_attn_plain(*args), rtol=3e-5, atol=3e-6)


def _deepseek_top8():
    import dataclasses
    return dataclasses.replace(registry.get("deepseek-v3-671b").reduced(), n_experts=64,
                               n_experts_active=8)


@pytest.mark.parametrize("N", [4, 20])
def test_top8_combine_is_deterministic_and_capturable(cuda, N):
    """Top-8 of 64 experts with the shared expert (reduced deepseek-v3-671b
    widths): the combine on the card sums each token's rows in the CPU's
    order, bit for bit, on the same rows; ``moe_local`` on the card repeats
    its bits, and captured as a CUDA graph (routing and combine: no host
    sync) replays them."""
    from repro_torch.models import moe
    cfg = _deepseek_top8()
    q = quantize_tree({"moe": M.init_params(cfg, seed=0, device="cpu")["layers"][1]["moe"]})
    p = convert.to_device(q["moe"], cuda)
    x = torch.randn((N, cfg.d_model), generator=torch.Generator().manual_seed(N)).to(cuda)
    r = moe.route(p, x, cfg)
    ye = torch.randn(tuple(r.toks.shape) + (cfg.d_model,), device=cuda)
    assert torch.equal(moe.combine(ye, r.order).cpu(), moe.combine(ye.cpu(), r.order.cpu()))
    want, _ = moe.moe_local(p, x, cfg)
    assert torch.equal(moe.moe_local(p, x, cfg)[0], want)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        moe.moe_local(p, x, cfg)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = moe.moe_local(p, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_latent_quantizer_is_ieee_on_the_card(cuda):
    """MLA's latent quantizer on the card gives the CPU's codes and scales
    bit for bit, its scales IEEE ``amax / 127`` over all 2^23 mantissas."""
    from repro_torch.models import attention as A
    amax, rows, rand = _mantissa_rows()
    for x in (rows, rand):
        cpu = A._quantize_latent(torch.from_numpy(x))
        card = A._quantize_latent(torch.from_numpy(x).to(cuda))
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())
    scales = A._quantize_latent(torch.from_numpy(rows).to(cuda))[1].reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(scales, amax / np.float32(127.0))


def test_reduced_deepseek_serves_on_the_card_like_the_cpu(cuda):
    """Reduced deepseek-v3-671b (MLA, 1 dense then 3 MoE layers) on the
    card under ``fused_int8``: a decode step launches B1 for each layer's
    wq_a, wq_b, wkv_a and wo and the dense layer's three FFN linears, the
    grouped B1 three times a MoE layer and RMSNorm four times a layer plus
    ``ln_f``; the streams equal the CPU's, and so do the MTP lanes'
    (``spec_k = 3``, ``spec_tree = 3, spec_branch = 2``)."""
    cfg = registry.get("deepseek-v3-671b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 20)).tolist()
               for _ in range(6)]
    budgets = [int(rng.integers(4, 13)) for _ in range(6)]
    want = ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=64,
                                    rt=Runtime("fused_int8"), device="cpu").generate_all(
        prompts, budgets)
    on_card = convert.to_device(params, cuda)
    eng = ContinuousBatchingEngine(cfg, on_card, n_slots=2, max_len=64, rt=Runtime("fused_int8"))
    reset_launch_counts()
    assert eng.generate_all(prompts, budgets) == want
    steps, L = eng.stats["decode_steps"], cfg.n_layers
    counts = launch_counts()
    fused = (2 * L + sum(not cfg.is_moe_layer(i) for i in range(L))) * steps
    assert counts["rms_norm_quant"] == fused
    assert counts["rms_norm"] == (4 * L + 1) * (steps + len(prompts)) - fused
    assert counts["int8_matmul"] == (4 * L + 3) * steps
    assert counts["int8_matmul_grouped"] == 3 * (L - 1) * steps
    assert counts["decode_attn"] == counts["verify_attn"] == counts["verify_tree_attn"] == 0
    for lane in ({"spec_k": 3}, {"spec_tree": 3, "spec_branch": 2}):
        eng = ContinuousBatchingEngine(cfg, on_card, n_slots=2, max_len=64,
                                       rt=Runtime("fused_int8"), drafter="mtp", **lane)
        assert eng.generate_all(prompts, budgets) == want
        assert eng.stats["verify_steps"] > 0


# ---------------------------------------------------------------------------
# the hybrid stack (jamba-1.5-large-398b) and the encoder-decoder
# (whisper-tiny): B6 at 256 heads, the grouped B1 at 16 experts, B2 at rep 1
# and head dim 64, the reduced models' streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,Q", [(2, 128), (1, 37)])
def test_ssd_chunk_at_jamba_heads_matches_plain(cuda, N, Q):
    """B6 at jamba-1.5-large-398b's 256 SSM heads of 64 in one group, state
    128 (the H the model's kernel route passes it), against its plain
    version: y and the chunk state within ``rtol=2e-4, atol=2e-5``, the
    decay within ``rtol=1e-5``, one launch."""
    x, B, C, dt, A, D, h0 = _ssd_inputs(N, Q, 256, 64, 128, 11 * N + Q, cuda)
    B, C = B[:, :, :1].contiguous(), C[:, :, :1].contiguous()
    reset_launch_counts()
    y, s_out, dec = ssd.ssd_chunk(x, B, C, dt, A, D, h0)
    assert launch_counts()["ssd_chunk"] == 1
    py, ps, pd = ssd.ssd_chunk_plain(x, B, C, dt, A, D, h0)
    torch.testing.assert_close(y, py, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(s_out, ps, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dec, pd, rtol=1e-5, atol=0)


@pytest.mark.parametrize("C", [1, 13])
def test_int8_matmul_grouped_at_16_experts(cuda, C):
    """The grouped entry at jamba's 16 experts (a decode step's cap 1 and a
    prefill call's cap 13, experts of 0, 1 and C rows), K 8192 -> N 3072
    and back: bit-equal to its plain version and to B1 on each expert's
    slice, rows past a count zero, one launch a call."""
    E = 16
    counts = [C if e % 3 == 0 else (1 if e % 3 == 1 else 0) for e in range(E)]
    g = torch.Generator().manual_seed(16 + C)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    for K, N in ((8192, 3072), (3072, 8192)):
        x_q = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8).to(cuda)
        x_s = (torch.rand((E, C, 1), generator=g) + 0.01).to(cuda)
        w_q = torch.randint(-127, 128, (E, K, N), generator=g, dtype=torch.int8).to(cuda)
        w_s = (torch.rand((E, N), generator=g) + 0.01).to(cuda)
        reset_launch_counts()
        got = gmm.int8_matmul_grouped_cuda(x_q, x_s, w_q, w_s, cnt)
        assert launch_counts()["int8_matmul_grouped"] == 1
        assert torch.equal(got, gmm.int8_matmul_grouped_plain(x_q, x_s, w_q, w_s, cnt))
        for e, c in enumerate(counts):
            assert not got[e, c:].any()
            if c:
                want, _ = mm.int8_matmul_cuda(x_q[e, :c].contiguous(), x_s[e, :c].contiguous(),
                                             w_q[e], w_s[e], with_acc=False)
                assert torch.equal(got[e, :c], want), e


def test_decode_attn_at_rep_1_head_dim_64_matches_plain(cuda):
    """B2 at whisper-tiny's self-attention (6 heads of 64, MHA) in a pool of
    512 rows at ragged lengths, within ``rtol=3e-5, atol=3e-6`` of its
    plain version."""
    q_q, q_s, cache = _window(4, 512, 6, 1, 64, 1, 64, cuda)
    lengths = torch.tensor([1, 200, 377, 512], dtype=torch.int32, device=cuda)
    args = (q_q[:, :, 0].contiguous(), q_s[:, :, 0].contiguous(), *cache, lengths)
    reset_launch_counts()
    got = da.decode_attn_cuda(*args)
    assert launch_counts()["decode_attn"] == 1
    torch.testing.assert_close(got, da.decode_attn_plain(*args), rtol=3e-5, atol=3e-6)


def test_reduced_jamba_serves_on_the_card_like_the_cpu(cuda):
    """Reduced jamba-1.5-large-398b (SSM layers, attention at 1 and 5, MoE
    on the odd layers) on the card under ``fused_int8``: each prompt
    prefilled alone at exact length launches B6 once an SSM layer (prompts
    under 128 tokens); a decode step launches B1 for each SSM layer's 3 and
    each attention layer's 4 linears and each dense FFN's 3, the grouped B1
    three times a MoE layer, B2 once an attention layer and RMSNorm once a
    norm (an SSM layer's gated norm included); the streams equal the
    CPU's."""
    cfg = registry.get("jamba-1.5-large-398b").reduced()
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
    reset_launch_counts()
    assert eng.generate_all(prompts, budgets) == want
    L = cfg.n_layers
    ssm = [cfg.layer_kind(i) == "ssm" for i in range(L)]
    moe = [cfg.is_moe_layer(i) for i in range(L)]
    steps, n = eng.stats["decode_steps"], len(prompts)
    linears = sum((3 if s else 4) + (0 if e else 3) for s, e in zip(ssm, moe))
    counts = launch_counts()
    assert counts["int8_matmul"] == linears * steps
    assert counts["int8_matmul_grouped"] == 3 * sum(moe) * steps
    assert counts["decode_attn"] == (L - sum(ssm)) * steps
    assert counts["ssd_chunk"] == sum(ssm) * n
    fused = (L + sum(ssm) + sum(not e for e in moe)) * steps
    assert counts["rms_norm_quant"] == fused
    assert counts["rms_norm"] == (1 + sum(2 + s for s in ssm)) * (steps + n) - fused


def test_reduced_whisper_serves_on_the_card_like_the_cpu(cuda):
    """Reduced whisper-tiny through ``Engine.generate`` on the card under
    ``fused_int8``: a decode step launches B1 for each decoder layer's 8
    linears, B2 once a layer (the cross-attention runs the plain int8
    path), the LayerNorm fused with the quantizer three times a layer
    (``ln1``, ``ln_x``, ``ln2``) and the unfused LayerNorm for ``ln_f``;
    the float prefill only the unfused LayerNorm; the tokens equal the
    CPU's."""
    cfg = registry.get("whisper-tiny").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(3)
    batch = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 6), generator=g)}
    from repro_torch.serve.engine import Engine
    want, _ = Engine(cfg=cfg, params=params, rt=Runtime("fused_int8"), max_len=64,
                     device="cpu").generate(batch, 8)
    eng = Engine(cfg=cfg, params=convert.to_device(params, cuda), rt=Runtime("fused_int8"),
                 max_len=64)
    eng.generate(batch, 1)                       # captures the decode step
    reset_launch_counts()
    got, _ = eng.generate(batch, 8)
    assert torch.equal(got.cpu(), want)
    L, counts = cfg.n_layers, launch_counts()
    assert counts["int8_matmul"] == 8 * L * 8 and counts["decode_attn"] == L * 8
    assert counts["layer_norm_quant"] == 3 * L * 8
    assert counts["layer_norm"] == 3 * L + 9 + 2 * cfg.encoder_layers + 1
    assert counts["rms_norm"] == counts["int8_matmul_grouped"] == 0


def test_mesh_decode_step_on_the_card_bit_equal(cuda):
    """A 1x2 mesh of two processes sharing the card (gloo through host
    memory): a reduced llama decode step under ``fused_int8`` on each
    rank's block of heads, columns and rows, its logits and pool bit-equal
    to one process's under ``psum`` and ``htree``."""
    import torch_mesh_ranks as R
    from repro_torch.launch import mesh as MS
    for res in MS.spawn(R.card_decode, 2):
        for coll in R.COLLECTIVES:
            want, got, pools_equal = res[("fused_int8", coll)]
            np.testing.assert_array_equal(got, want)
            assert pools_equal


def test_mesh_ssm_step_and_row_moves_on_the_card(cuda):
    """A 1x2 mesh on the card: mamba2 ``.reduced()`` under ``fused_int8``,
    B6 prefilling each rank's heads and a decode step from the state it
    leaves, bit-equal to one process's (logits and every state leaf
    gathered over the model axis); a 2x2 mesh: a cross-shard prefix copy
    and a swapped row of llama's pool equal one process's."""
    import torch_mesh_serve_ranks as R
    from repro_torch.launch import mesh as MS
    for res in MS.spawn(R.card_ssm_step, 2):
        assert res["prefill_logits_equal"] and max(res["prefill_state_diffs"]) == 0.0
        assert res["logits_equal"] and max(res["state_diffs"]) == 0.0
    for res in MS.spawn(R.card_row_moves, 4):
        assert res["copy_equal"] and res["row_equal"]


def test_mesh_lanes_on_the_card_token_identical(cuda):
    """The serving lanes on a 2x2 mesh on the card (every rank on
    ``cuda:0``): llama3-8b at full width with 2 layers under ``fused_int8``
    with the prefix cache, the cold tier under ``fair:3`` and faults over
    the cold tier (step failures, a lost slot, NAND flips under the ECC):
    every rank's stats (but the clocks) and quarantined slots equal one
    process's, its streams equal rank 0's, and rank 0's equal one
    process's or part at a near-tie at the first parting iteration, a
    parting with its cause named by ``prefill_probes`` (the mesh prefill's
    RoPE takes the reference's mesh form, a rotation contraction, and its
    attention runs the rank's heads), each lane exercised."""
    import dataclasses

    import torch_mesh_serve_ranks as R
    from repro_torch.launch import mesh as MS
    cfg = dataclasses.replace(registry.get("llama3-8b"), n_layers=R.CARD_LANE_LAYERS)
    world = MS.start(R.card_lanes_rank, 4, timeout_s=1200)
    params = M.init_params(cfg, seed=0, device="cuda")
    want = R.card_lanes(cfg, params, Runtime("fused_int8"))
    del params
    ranks = world.join()
    for r, res in enumerate(ranks):
        for lane, (outs, stats, q, rows, _) in want.items():
            c = res[lane][4]
            print(f"lane {lane} rank {r}: trace {c['wall_s']:.2f} s (one process "
                  f"{want[lane][4]['wall_s']:.2f} s); collectives {c['calls']} calls, "
                  f"{c['bytes'] / 1e6:.3f} MB, {c['seconds']:.2f} s; row moves "
                  f"{c['move_bytes'] / 1e6:.3f} MB; swap bytes out "
                  f"{stats.get('swap_out_bytes', 0)}, in {stats.get('swap_in_bytes', 0)}")
            assert res[lane][0] == ranks[0][lane][0], lane
            assert res[lane][1] == stats and res[lane][2] == q, lane
            assert R.near_tie_failures(res[lane][0], res[lane][3], outs, rows) == [], lane
    # a parting stream needs a named cause: a float stage of the mesh
    # prefill whose rank's bits are not one process's
    probes = R.prefill_probes(cfg, 2)
    parted = sorted(lane for lane in want if ranks[0][lane][0] != want[lane][0])
    print(f"lanes parting from one process's: {parted}; mesh prefill stages parting: "
          f"{[k for k, eq in probes.items() if not eq]} of {list(probes)}")
    assert not parted or not all(probes.values()), parted
    assert want["prefix"][1]["prefix_hits"] > 0
    assert want["swap"][1]["preempt_swaps"] > 0
    st = want["faults_swap"][1]
    assert st["pool_rebuilds"] == 2 and st["slot_losses"] == 1 and want["faults_swap"][2] == [0]


def test_mesh_families_on_the_card(cuda, tmp_path):
    """mamba2-2.7b (16 of 64 layers), deepseek-v3-671b (4 of 61 layers and
    the MTP head), jamba-1.5-large-398b (5 of 72: an SSM layer, a MoE FFN,
    attention) and whisper-tiny uncut at full width on a 1x2 mesh on the
    card, against one process's baselines drawn here
    (``torch_mesh_serve_ranks.mesh_families``: each decode step's gathered
    state and logits bit-equal, a MoE stack layer by layer with its MoE FFN
    within rtol 2e-3 / atol 2e-4, a float product of the rank's shape that
    parts named by ``shape_probes`` and held to 1e-3 of its scale; one
    process's launches a rank; the short trace, deepseek's MTP lane and
    whisper's ``Engine`` equal or parted at a near-tie).  The chip script's
    time does not hold them, so they run here."""
    import gc

    import torch_mesh_serve_ranks as R
    base = {}
    for name, (cfg, drawn) in R.mesh_family_cfgs().items():
        params = R.CS.int8_params(torch, cfg) if drawn else M.init_params(cfg, 0, "cuda")
        base[name] = R.mesh_family_baseline(str(tmp_path), cfg, params, drawn)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out = R.mesh_families(str(tmp_path), base)
    assert set(out) >= set(R.mesh_family_cfgs()) and "failures" not in out


def test_mesh_training_seq_shard_on_the_card(cuda):
    """llama3-8b at full width with 2 of 32 layers on a 1x2 world on the
    card (every rank on ``cuda:0``), one step at phase ``train``'s batch with
    f32 moments, with and without ``seq_shard``, against one process's
    (``chip_smoke.mesh_train_pair`` and ``mesh_train_gates``: the loss
    within 1e-5, every leaf's gathered gradient within 1e-4 of its scale,
    the params after the step within 5e-3, the residual T/2 rows between
    layers under ``seq_shard``, the RMSNorm backward launches a rank as
    predicted)."""
    import sys
    from pathlib import Path

    from repro_torch.launch import mesh as MS
    import torch_mesh_train_ranks as R
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as CS
    ranks = MS.spawn(R.card_train_pair, 2, timeout_s=900)
    failures: list = []
    gates = CS.mesh_train_gates(ranks, failures)
    assert not failures, failures
    assert gates["worst_grad_vs_one"] <= CS.MESH_TRAIN_GRAD_TOL
