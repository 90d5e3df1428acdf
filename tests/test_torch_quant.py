"""The port's ``core/quant.py`` against the JAX reference.

Inputs come from numpy with a fixed seed and go through both packages;
integer codes, scales and int32 sums must be equal bit for bit, float
epilogues equal (same operations in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq

SHAPES = [(7, 33), (64, 128), (3, 300)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight(shape, axis):
    jw, tw = _both(_rand(shape, 1))
    jqw, js = jq.quantize_weight(jw, axis=axis)
    tqw, ts = tq.quantize_weight(tw, axis=axis)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(jqw, tqw)
    _eq(js, ts)


@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 64)])
def test_quantize_activation(shape):
    jx, tx = _both(_rand(shape, 2, scale=3.0))
    for j, t in zip(jq.quantize_activation(jx), tq.quantize_activation(tx)):
        _eq(j, t)


def test_quantize_activation_zero_row_and_ties():
    """An all-zero row hits the 1e-8 scale floor; exact .5 ties round half
    to even in both packages."""
    x = np.zeros((3, 8), np.float32)
    x[1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]   # scale 1: ties stay ties
    x[2, 0] = 1e-12
    for j, t in zip(jq.quantize_activation(jnp.asarray(x)),
                    tq.quantize_activation(torch.from_numpy(x))):
        _eq(j, t)


@pytest.mark.parametrize("shape", [(2, 5, 4, 32), (1, 9, 2, 128)])
def test_quantize_and_dequantize_kv(shape):
    jx, tx = _both(_rand(shape, 3))
    (jqv, js), (tqv, ts) = jq.quantize_kv(jx), tq.quantize_kv(tx)
    _eq(jqv, tqv)
    _eq(js, ts)
    _eq(jq.dequantize_kv(jqv, js), tq.dequantize_kv(tqv, ts))


def test_smooth_factors():
    a = np.abs(_rand((64,), 4)) * 5
    w = np.abs(_rand((64,), 5))
    a[0], w[1] = 0.0, 1e-9                  # clamp floors
    j = jq.smooth_factors(jnp.asarray(a), jnp.asarray(w), 0.5)
    t = tq.smooth_factors(torch.from_numpy(a), torch.from_numpy(w), 0.5)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("smooth", [False, True])
def test_make_quantized_linear(smooth):
    w = _rand((96, 40), 6)
    amax = np.abs(_rand((96,), 7)) * 4 if smooth else None
    jl = jq.make_quantized_linear(jnp.asarray(w),
                                  None if amax is None else jnp.asarray(amax))
    tl = tq.make_quantized_linear(torch.from_numpy(w),
                                  None if amax is None else torch.from_numpy(amax))
    if smooth:
        np.testing.assert_allclose(np.asarray(jl.smooth), tl.smooth.numpy(), rtol=1e-6)
    else:
        assert jl.smooth is None and tl.smooth is None
        _eq(jl.w_q, tl.w_q)
        _eq(jl.w_scale, tl.w_scale)


def test_pack_unpack_qlc_all_codes():
    w = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    (jh, jl), (th, tl) = jq.pack_qlc(jnp.asarray(w)), tq.pack_qlc(torch.from_numpy(w))
    _eq(jh, th)
    _eq(jl, tl)
    assert int(th.min()) == -8 and int(th.max()) == 7
    assert int(tl.min()) == 0 and int(tl.max()) == 15
    np.testing.assert_array_equal(tq.unpack_qlc(th, tl).numpy(), w)
    _eq(jq.unpack_qlc(jh, jl), tq.unpack_qlc(th, tl))


def test_pack_qlc_rejects_non_int8():
    with pytest.raises(TypeError):
        tq.pack_qlc(torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("bits", [8, 4])
def test_input_bitplanes_and_bit_weights(bits):
    x = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    _eq(jq.input_bitplanes(jnp.asarray(x), bits), tq.input_bitplanes(torch.from_numpy(x), bits))
    _eq(jq.bit_weights(bits), tq.bit_weights(bits))
    if bits == 8:    # the planes with their weights rebuild the codes
        planes = tq.input_bitplanes(torch.from_numpy(x), 8)
        rebuilt = (planes * tq.bit_weights(8)[:, None, None]).sum(0)
        np.testing.assert_array_equal(rebuilt.numpy(), x.astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(1, 4096, 16), (3, 200, 130), (8, 64, 64)])
def test_int8_matmul_ref_int32_exact(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = rng.random((m, 1)).astype(np.float32) * 0.01
    ws = rng.random((n,)).astype(np.float32) * 0.01
    want_acc = x.astype(np.int64) @ w.astype(np.int64)
    acc = tq.exact_int_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    jlin = jq.QuantizedLinear(w_q=jnp.asarray(w), w_scale=jnp.asarray(ws))
    tlin = tq.QuantizedLinear(w_q=torch.from_numpy(w), w_scale=torch.from_numpy(ws))
    _eq(jq.int8_matmul_ref(jnp.asarray(x), jnp.asarray(xs), jlin),
        tq.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(xs), tlin))
