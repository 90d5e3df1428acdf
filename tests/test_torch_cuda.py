"""The port's CUDA kernels and engines on the card (marker ``cuda``).

Every test here needs an NVIDIA card and skips without one; the file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs: B1 and B5 bit for bit (and B5's int32 sums equal B1's), B2 within
``rtol=3e-5, atol=3e-6``.
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
from repro_torch.models import model as M
from repro_torch.models.transformer import Runtime
from repro_torch.serve.engine import ContinuousBatchingEngine

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
    hi, lo = quant.pack_qlc(w_q)
    out5, acc5 = pim.pim_mvm_cuda(x_q, x_s, hi, lo, w_s)
    assert torch.equal(acc5, acc) and torch.equal(out5, out)


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
    reset_launch_counts()
    eng = ContinuousBatchingEngine(cfg, gparams, n_slots=2, max_len=64,
                                   rt=Runtime("fused_int8"))
    got = eng.generate_all(prompts, budgets)
    steps = eng.stats["decode_steps"]
    assert launch_counts() == {"int8_matmul": 7 * cfg.n_layers * steps,
                               "pim_mvm": 0, "decode_attn": cfg.n_layers * steps}
    assert [len(o) for o in got] == budgets
    assert [o[0] for o in got] == [o[0] for o in want]     # prefill: float only
