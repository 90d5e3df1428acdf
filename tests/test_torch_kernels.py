"""Each ported kernel's plain PyTorch version against the JAX reference.

The JAX side runs the Pallas wrapper in interpret mode (its default) and the
pure-jnp oracle in ``ref.py``.  Integer stages must match bit for bit, B2's
float stages within ``rtol=3e-5, atol=3e-6`` (the Pallas kernel's own
tolerance: the softmax sums run in another order).  The CUDA kernels are
held against these plain versions in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.decode_attn import ops as j_da_ops, ref as j_da_ref
from repro.kernels.int8_matmul import ops as j_mm_ops, ref as j_mm_ref
from repro.kernels.pim_mvm import ops as j_pim_ops, ref as j_pim_ref
from repro_torch import kernels as KN
from repro_torch.core import quant as tq
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import int8_matmul_grouped as gmm
from repro_torch.kernels import pim_mvm as pim
from repro_torch.kernels import layer_norm as lnk
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as ssd
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# M of 1, 3 and 8; K and N tails off the TPU's 512 / 128 tiling; the verify
# M (20, 28), one and a bit of four n8 tiles (32, 33) and M past one pass
# (64) with K not a multiple of 32 and N not of 16
MKN = [(1, 128, 256), (3, 200, 130), (8, 520, 300), (3, 1000, 77), (20, 777, 1000),
       (28, 200, 130), (32, 1000, 77), (33, 520, 300), (64, 136, 24)]


def _linear(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    jlin = jq.make_quantized_linear(jnp.asarray(w))
    x_q, x_s = jq.quantize_activation(jnp.asarray(x))
    t = {"x_q": torch.from_numpy(np.array(x_q)), "x_s": torch.from_numpy(np.array(x_s)),
         "w_q": torch.from_numpy(np.array(jlin.w_q)),
         "w_s": torch.from_numpy(np.array(jlin.w_scale))}
    return x_q, x_s, jlin, t


@pytest.mark.parametrize("m,k,n", MKN)
def test_int8_matmul_plain_matches_pallas_and_ref(m, k, n):
    x_q, x_s, jlin, t = _linear(m, k, n, m * k + n)
    out, acc = mm.int8_matmul_plain(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    want_acc = np.asarray(x_q).astype(np.int64) @ np.asarray(jlin.w_q).astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_mm_ops.int8_matmul(x_q, x_s, jlin)))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(j_mm_ref.ref(x_q, jlin.w_q, x_s, jlin.w_scale)))


@pytest.mark.parametrize("m,k,n", MKN)
def test_pim_mvm_plain_matches_pallas_and_equals_b1(m, k, n):
    x_q, x_s, jlin, t = _linear(m, k, n, 7 * m + k + n)
    hi, lo = tq.pack_qlc(t["w_q"])
    out, acc = pim.pim_mvm_plain(t["x_q"], t["x_s"], hi, lo, t["w_s"])
    out1, acc1 = mm.int8_matmul_plain(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    np.testing.assert_array_equal(acc.numpy(), acc1.numpy())   # B5 sums == B1 sums
    np.testing.assert_array_equal(out.numpy(), out1.numpy())
    jhi, jlo = jq.pack_qlc(jlin.w_q)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_pim_ops.pim_mvm(x_q, x_s, jlin)))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(j_pim_ref.ref_bitserial(x_q, jhi, jlo, x_s, jlin.w_scale)))


def test_model_facing_linears_keep_leading_dims():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jlin = jq.make_quantized_linear(jnp.asarray(w))
    tlin = tq.make_quantized_linear(torch.from_numpy(w))
    jx_q, jx_s = jq.quantize_activation(jnp.asarray(x))
    tx_q, tx_s = tq.quantize_activation(torch.from_numpy(x))
    want = np.asarray(j_mm_ops.int8_matmul(jx_q, jx_s, jlin))
    got = mm.int8_matmul(tx_q, tx_s, tlin)
    assert tuple(got.shape) == (2, 3, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pim.pim_mvm(tx_q, tx_s, tlin).numpy(), want)


def _attn_inputs(b, s, g, rep, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, g * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    jk_q, jk_s = jq.quantize_kv(jnp.asarray(k))
    jv_q, jv_s = jq.quantize_kv(jnp.asarray(v))
    tt = [torch.from_numpy(np.array(a)) for a in (q, jk_q, jk_s, jv_q, jv_s)]
    return (jnp.asarray(q), jk_q, jk_s, jv_q, jv_s), tt


@pytest.mark.parametrize("b,s,g,rep,d,lengths", [
    (2, 64, 2, 2, 32, [1, 64]),           # length 1 and S
    (3, 300, 2, 4, 64, [150, 1, 299]),    # mid, 1, non-aligned S
    (1, 1024, 1, 1, 128, [520]),
    (4, 96, 8, 4, 128, [1, 40, 77, 96]),  # llama3-8b's G, rep, D
])
def test_decode_attention_plain_matches_pallas_and_ref(b, s, g, rep, d, lengths):
    j, t = _attn_inputs(b, s, g, rep, d, b * s + d)
    ln = np.array(lengths, np.int32)
    want = np.asarray(j_da_ops.decode_attention(*j, jnp.asarray(ln)))
    want_ref = np.asarray(j_da_ref.ref(*j, jnp.asarray(ln)[:, None, None, None]))
    got = da.decode_attention(*t, torch.from_numpy(ln)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(got, want_ref, rtol=3e-5, atol=3e-6)


def test_decode_attention_scalar_length_and_tail_mask():
    """A scalar length broadcasts over slots, and keys past it do not move
    the result."""
    j, t = _attn_inputs(2, 128, 2, 2, 32, 11)
    got = da.decode_attention(*t, 50)
    want = np.asarray(j_da_ops.decode_attention(*j, jnp.asarray(50, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-6)
    t[3][:, 50:] = 0                   # scribble over dead value rows
    np.testing.assert_array_equal(da.decode_attention(*t, 50).numpy(), got.numpy())


def test_cpu_tensors_take_the_plain_versions_without_launching():
    KN.reset_launch_counts()
    _, _, _, t = _linear(2, 64, 32, 3)
    mm.int8_matmul_2d(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    gmm.int8_matmul_grouped(t["x_q"][None], t["x_s"][None], t["w_q"][None], t["w_s"][None],
                           torch.tensor([2], dtype=torch.int32))
    out5, acc5 = pim.pim_mvm_2d(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    hi, lo = tq.pack_qlc(t["w_q"])
    want5, want_acc5 = pim.pim_mvm_plain(t["x_q"], t["x_s"], hi, lo, t["w_s"])
    assert torch.equal(out5, want5) and torch.equal(acc5, want_acc5)
    _, tt = _attn_inputs(1, 16, 1, 1, 32, 4)
    da.decode_attention(*tt, 5)
    rn.rms_norm(torch.ones(2, 8), torch.ones(8))
    rn.rms_norm_quant(torch.ones(2, 8), torch.ones(8))
    lnk.layer_norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    lnk.layer_norm_quant(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    x = torch.ones(1, 4, 2, 8)
    ssd.ssd_chunk(x, torch.ones(1, 4, 2, 3), torch.ones(1, 4, 2, 3), torch.ones(1, 4, 2),
                  -torch.ones(2), torch.ones(2), torch.zeros(1, 2, 8, 3))
    assert KN.launch_counts() == {"int8_matmul": 0, "int8_matmul_grouped": 0, "pim_mvm": 0,
                                  "decode_attn": 0, "verify_attn": 0, "verify_tree_attn": 0,
                                  "ssd_chunk": 0, "rms_norm": 0, "rms_norm_quant": 0,
                                  "layer_norm": 0, "layer_norm_quant": 0,
                                  "rms_norm_backward": 0, "layer_norm_backward": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    _, _, _, t = _linear(2, 64, 32, 3)
    with pytest.raises(ValueError, match="CUDA"):
        mm.int8_matmul_cuda(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    with pytest.raises(ValueError, match="CUDA"):
        pim.pim_mvm_cuda(t["x_q"], t["x_s"], t["w_q"], t["w_s"])
    with pytest.raises(ValueError, match="CUDA"):
        gmm.int8_matmul_grouped_cuda(t["x_q"][None], t["x_s"][None], t["w_q"][None],
                                    t["w_s"][None], torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        rn.rms_norm_cuda(torch.ones(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        rn.rms_norm_quant_cuda(torch.ones(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        lnk.layer_norm_cuda(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        lnk.layer_norm_quant_cuda(torch.ones(2, 8), torch.ones(8), torch.zeros(8))


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="span devices"):
        KN.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
