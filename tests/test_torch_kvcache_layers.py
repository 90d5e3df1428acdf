"""The port's per-layer cache API (``append_layer``, ``append_layer_chunk``,
``layer_view``, ``LatentCache``, ``init_latent_cache``, ``append_latent``)
against the reference's functions on the cases ``tests/test_kvcache.py``
exercises, bit for bit.

Both packages quantize with an IEEE division by 127, so every code and
scale is equal.  Where JAX runs jitted, XLA on the CPU divides by 127 as a
multiply by its reciprocal: a scale may sit one ulp from the IEEE one, and
wherever the scales are equal so are the codes (``tests/torch_parity.py``
``check_kv_quantizations``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as JKV
from repro_torch.core import kvcache as TKV
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

L, B, S, H, D = 2, 3, 16, 2, 8
LEAVES = ("k_q", "k_s", "v_q", "v_s", "lengths")


def _kv(seed, t=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, t, H, D)).astype(np.float32) for _ in range(2))


def _pair():
    return JKV.init_cache(L, B, S, H, D), TKV.init_cache(L, B, S, H, D, device="cpu")


def _same(j, t, leaves=LEAVES):
    for name in leaves:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def _both_append(j, t, layer, k, v, pos):
    j = JKV.append_layer(j, layer, jnp.asarray(k), jnp.asarray(v),
                         pos if np.isscalar(pos) else jnp.asarray(pos))
    t = TKV.append_layer(t, layer, torch.from_numpy(k), torch.from_numpy(v),
                         pos if np.isscalar(pos) else torch.from_numpy(np.array(pos)))
    return j, t


@pytest.mark.parametrize("pos", [3, [0, 5, 11], [15, 2, 9]])
@pytest.mark.parametrize("t", [1, 3])
def test_append_layer_bit_equal(pos, t):
    """One append at a scalar or a [B] position (the last one clamped at
    the pool's end, as XLA clamps it), one token or three: every leaf of
    both layers equal; the appends write in place."""
    j, tc = _pair()
    k, v = _kv(1, t)
    before = tc.k_q.data_ptr()
    j, tc2 = _both_append(j, tc, 1, k, v, np.asarray(pos, np.int32) if not np.isscalar(pos)
                          else pos)
    assert tc2 is tc and tc.k_q.data_ptr() == before
    _same(j, tc)


def test_scalar_pos_matches_vector_pos():
    k, v = _kv(1)
    _, t1 = _pair()
    _, t2 = _pair()
    TKV.append_layer(t1, 1, torch.from_numpy(k), torch.from_numpy(v), 3)
    TKV.append_layer(t2, 1, torch.from_numpy(k), torch.from_numpy(v),
                     torch.full((B,), 3, dtype=torch.int32))
    for name in LEAVES:
        assert torch.equal(getattr(t1, name), getattr(t2, name))


def test_append_free_roundtrip():
    """alloc, append at the lengths, bump, free, append again over the
    stale rows: the reference's lengths and rows."""
    j, t = _pair()
    j, t = JKV.alloc_slot(j, 1, 4), TKV.alloc_slot(t, 1, 4)
    j, t = _both_append(j, t, 0, *_kv(2), np.asarray(j.lengths))
    step = np.array([0, 1, 0], np.int32)
    j, t = JKV.bump_length(j, jnp.asarray(step)), TKV.bump_length(t, torch.from_numpy(step))
    j, t = JKV.free_slot(j, 1), TKV.free_slot(t, 1)
    _same(j, t)
    j, t = _both_append(j, t, 0, *_kv(3), np.asarray(j.lengths))
    _same(j, t)


def test_churn_keeps_bytes_and_bits():
    """The reference's slot churn (alloc, ragged appends clipped to the
    pool, frees): cache bytes invariant, every leaf equal after each op."""
    j, t = _pair()
    base = TKV.cache_bytes(t)
    assert base == JKV.cache_bytes(j)
    rng = np.random.default_rng(0)
    for step in range(30):
        op = step % 3
        if op == 0:
            slot, n = int(rng.integers(B)), int(rng.integers(S // 2))
            j, t = JKV.alloc_slot(j, slot, n), TKV.alloc_slot(t, slot, n)
        elif op == 1:
            layer = int(rng.integers(L))
            pos = np.minimum(np.asarray(j.lengths), S - 1)
            j, t = _both_append(j, t, layer, *_kv(step), pos)
        else:
            slot = int(rng.integers(B))
            j, t = JKV.free_slot(j, slot), TKV.free_slot(t, slot)
        assert TKV.cache_bytes(t) == base
        _same(j, t)


@pytest.mark.parametrize("cuts", [(3,), (1, 4), (2, 2, 2), (7,)])
def test_chunks_equal_one_shot_and_reference(cuts):
    """Chunked appends (``append_layer_chunk`` at each chunk's offset)
    equal one ``append_layer`` of all 8 rows and the reference's chunked
    appends, bit for bit."""
    k, v = _kv(5, t=8)
    j, t = _pair()
    _, one = _pair()
    TKV.append_layer(one, 0, torch.from_numpy(k), torch.from_numpy(v), 0)
    lo = 0
    for hi in (*np.cumsum(cuts), 8):
        if hi <= lo:
            continue
        j = JKV.append_layer_chunk(j, 0, jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]), lo)
        TKV.append_layer_chunk(t, 0, torch.from_numpy(k[:, lo:hi]),
                               torch.from_numpy(v[:, lo:hi]), lo)
        lo = hi
    _same(j, t)
    for name in LEAVES:
        assert torch.equal(getattr(t, name), getattr(one, name))


def test_chunk_append_clamps_like_reference():
    k, v = _kv(6, t=4)
    j, t = _pair()
    j = JKV.append_layer_chunk(j, 1, jnp.asarray(k), jnp.asarray(v), S - 2)
    TKV.append_layer_chunk(t, 1, torch.from_numpy(k), torch.from_numpy(v), S - 2)
    _same(j, t)


def test_rewind_then_overwrite_equals_reference():
    """The speculative pattern: a 4-token window, rewind to 2 accepted, the
    next window over the dead rows; both packages' leaves equal at every
    step."""
    k, v = _kv(7, t=4)
    k2, v2 = _kv(8, t=4)
    pos = np.array([0, 3, 6], np.int32)
    j, t = _pair()
    j = JKV.alloc_slot(j, jnp.arange(B), jnp.asarray(pos))
    for slot in range(B):
        t = TKV.alloc_slot(t, slot, int(pos[slot]))
    j, t = _both_append(j, t, 0, k, v, pos)
    j, t = JKV.rewind_lengths(j, jnp.asarray(pos + 2)), TKV.rewind_lengths(t, pos + 2)
    _same(j, t)
    j, t = _both_append(j, t, 0, k2, v2, np.asarray(j.lengths))
    _same(j, t)


def test_layer_view_is_the_layer():
    j, t = _pair()
    j, t = _both_append(j, t, 1, *_kv(9, 2), np.array([1, 4, 8], np.int32))
    views = TKV.layer_view(t, 1)
    for got, want in zip(views, JKV.layer_view(j, 1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    views[0][0, 0] = 5                                     # a view, not a copy
    assert int(t.k_q[1, 0, 0, 0, 0]) == 5


@pytest.mark.parametrize("pos", [2, [1, 9, 4], [15, 0, 14]])
@pytest.mark.parametrize("t", [1, 2])
def test_append_latent_bit_equal(pos, t):
    """``append_latent`` at a scalar or [B] position, one or two tokens
    (rows of zeros too, where the scale's floor of 1e-8 applies): codes,
    scales and lengths equal to the reference's."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((B, t, 6)).astype(np.float32) * 3
    c[0, 0] = 0.0
    j = JKV.init_latent_cache(L, B, S, dim=6)
    tc = TKV.init_latent_cache(L, B, S, dim=6, device="cpu")
    assert isinstance(tc, TKV.LatentCache) and (tc.n_slots, tc.max_len) == (B, S)
    p = pos if np.isscalar(pos) else np.asarray(pos, np.int32)
    j = JKV.append_latent(j, 1, jnp.asarray(c), p if np.isscalar(p) else jnp.asarray(p))
    before = tc.c_q.data_ptr()
    out = TKV.append_latent(tc, 1, torch.from_numpy(c),
                            p if np.isscalar(p) else torch.from_numpy(p))
    assert out is tc and tc.c_q.data_ptr() == before
    _same(j, tc, ("c_q", "c_s", "lengths"))
    assert int(torch.count_nonzero(tc.c_q[0])) == 0
    row = min(int(np.atleast_1d(p)[0]), S - t)             # clamped as XLA clamps it
    np.testing.assert_array_equal(tc.c_s[1].numpy()[0, row],
                                  [np.float32(1e-8) / np.float32(127)])
    assert TKV.cache_bytes(tc) == JKV.cache_bytes(j)


def test_jitted_reference_within_one_ulp():
    """Against the reference's ``append_layer`` under ``jax.jit`` (a divide
    by 127 becomes a multiply by its reciprocal): scales within one ulp,
    codes equal wherever the scales are."""
    k, v = _kv(12, t=5)
    j, t = _pair()
    pos = np.array([0, 4, 11], np.int32)
    j = jax.jit(JKV.append_layer, static_argnums=1)(j, 0, jnp.asarray(k), jnp.asarray(v),
                                                     jnp.asarray(pos))
    TKV.append_layer(t, 0, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos))
    for q, s in (("k_q", "k_s"), ("v_q", "v_s")):
        js, ts = np.asarray(getattr(j, s)), getattr(t, s).numpy()
        np.testing.assert_array_max_ulp(js, ts, maxulp=1)
        same = np.broadcast_to(js == ts, ts.shape[:-1] + (D,))
        jq, tq = np.asarray(getattr(j, q)), getattr(t, q).numpy()
        np.testing.assert_array_equal(tq[same], jq[same])
