"""The split-key arithmetic of the attention body (``csrc/decode_attn.cu``:
B2, B3 and B4), emulated in f32 on the CPU.

The kernel cuts the key axis into chunks of 64 keys at fixed, absolute
positions; the 8 CTAs of a cluster share the chunks of one (slot, group,
block of up to 16 query rows), CTA c taking chunks c, c + 8, ... up to the
block's largest key limit.  Each CTA keeps an online softmax (m, l, acc)
over its chunks; the cluster merges them in rank order.  :func:`split_attn`
repeats that arithmetic step for step: the int32 scores and their descale,
the row sums in the kernel's butterfly order, a chunk's P . (V * v_s) as
(P * v_s) . V on tf32 ``mma`` tiles of 8 keys (A split into tf32 hi + lo;
each ``mma`` emulated as its exact products added to the accumulator and
rounded once, which the tensor cores match only to about an ulp), the
running sum's ``acc * corr + chunk`` and the merge.  It must agree with
the plain version and the JAX reference within ``rtol=3e-5, atol=3e-6``,
and the partition must make a row's bits independent of the walk, the
pool size and the mask that chose its keys: B3's rows equal B2, B4 on a
chain equals B3.  The kernel itself is held to the same on the card
(``test_torch_cuda.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.decode_attn import ref as j_da_ref
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import verify_attn as va
from repro_torch.kernels import verify_tree_attn as vt

CHUNK, NC, MAX_ROWS = 64, 8, 16
NEG_INF = -1e30


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as ``__fmaf_rn``: the product is exact
    in f64 and the f64 sum is rounded to f32 (double rounding can differ
    from a true fused multiply-add only at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _tf32(t):
    """``cvt.rna.tf32.f32``: round to nearest (ties away from zero) at 10
    mantissa bits."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma(a, b, c):
    """One tf32 ``mma`` k-step: ``c + a @ b`` with exact products, rounded
    once to f32."""
    return (a.double() @ b.double() + c.double()).float()


def _row_sums(p):
    """Sums over a chunk's 64 keys in the kernel's order: thread (warp w,
    tig) adds keys 16w + 2tig, +1, +8, +9 in turn, a butterfly over tig
    (xor 1, then xor 2), then the four warps in order."""
    x = p.reshape(*p.shape[:-1], 4, 2, 4, 2)                  # warp, nt, tig, e
    local = ((x[..., 0, :, 0] + x[..., 0, :, 1]) + x[..., 1, :, 0]) + x[..., 1, :, 1]
    per_warp = (local[..., 0] + local[..., 1]) + (local[..., 2] + local[..., 3])
    return ((per_warp[..., 0] + per_warp[..., 1]) + per_warp[..., 2]) + per_warp[..., 3]


def split_attn(q_q, q_s, k_q, k_s, v_q, v_s, seen, walk):
    """One block of query rows through the kernel's arithmetic: q_q int8
    [B,G,R,D] (R <= 16), q_s f32 [B,G,R,1], k_q/v_q int8 [B,S,G,D],
    k_s/v_s f32 [B,S,G], ``seen`` bool [B,1|G,R,S] (the rows' masks),
    ``walk`` int [B] (the block's largest key limit) -> f32 [B,G,R,D]."""
    B, G, R, D = q_q.shape
    S = k_q.shape[1]
    n_chunks = -(-int(walk.max()) // CHUNK)
    pad = n_chunks * CHUNK - S
    key = torch.arange(n_chunks * CHUNK)
    live = key[None, :] < walk[:, None]                             # [B, keys]: copied
    seen = torch.nn.functional.pad(seen.expand(B, G, R, S), (0, max(pad, 0)))
    seen = seen[..., :n_chunks * CHUNK] & live[:, None, None, :]

    def keys(t):                                # [B,S,G,...] -> [B,G,keys,...], zero-filled
        t = t.transpose(1, 2)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, max(pad, 0)))
        t = t[:, :, :n_chunks * CHUNK]
        mask = live[:, None, :].reshape(B, 1, -1, *([1] * (t.dim() - 3)))
        return torch.where(mask, t, torch.zeros_like(t))
    kq, ksc = keys(k_q), keys(k_s)
    vq, vsc = keys(v_q), keys(v_s)
    s_int = torch.einsum("bgrd,bgkd->bgrk", q_q.double(), kq.double()).to(torch.int32)
    sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32)
    sc = (s_int.float() * q_s) * ksc[:, :, None, :] / sqrt_d         # [B,G,R,keys]
    vf = vq.float()                                                 # exact in tf32

    m = torch.full((NC, B, G, R), NEG_INF)
    l = torch.zeros((NC, B, G, R))
    acc = torch.zeros((NC, B, G, R, D))
    for ch in range(n_chunks):
        c, ks = ch % NC, slice(ch * CHUNK, (ch + 1) * CHUNK)
        walked = (ch * CHUNK < walk).reshape(B, 1, 1)                 # this CTA takes it
        vis = seen[..., ks]
        s = torch.where(vis, sc[..., ks], torch.full_like(sc[..., ks], NEG_INF))
        m_new = torch.maximum(m[c], s.amax(-1))
        corr = torch.exp(m[c] - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        l_new = _fma(l[c], corr, _row_sums(p))
        pv = p * vsc[:, :, None, ks]                                # A = p * v_s
        hi = _tf32(pv)
        lo = _tf32(pv - hi)
        chunk = torch.zeros((B, G, R, D))
        for k8 in range(0, CHUNK, 8):
            kk = slice(ch * CHUNK + k8, ch * CHUNK + k8 + 8)
            chunk = _mma(lo[..., k8:k8 + 8], vf[:, :, kk], chunk)
            chunk = _mma(hi[..., k8:k8 + 8], vf[:, :, kk], chunk)
        a = _fma(acc[c], corr[..., None], chunk)
        m[c] = torch.where(walked, m_new, m[c])
        l[c] = torch.where(walked, l_new, l[c])
        acc[c] = torch.where(walked[..., None], a, acc[c])
    m_all = m.amax(0)
    l_out = torch.zeros((B, G, R))
    o = torch.zeros((B, G, R, D))
    for c in range(NC):                                             # rank order
        f = torch.exp(m[c] - m_all)
        l_out = _fma(l[c], f, l_out)
        o = _fma(acc[c], f[..., None], o)
    return o / torch.clamp(l_out, min=1e-30)[..., None]


def split_decode(q_q, q_s, k_q, k_s, v_q, v_s, lengths):
    """B2: q_q [B,G,rep,D], lengths [B]."""
    S = k_q.shape[1]
    seen = torch.arange(S)[None, None, None, :] < lengths.reshape(-1, 1, 1, 1)
    return split_attn(q_q, q_s, k_q, k_s, v_q, v_s, seen, torch.clamp(lengths, max=S))


def split_window(q_q, q_s, k_q, k_s, v_q, v_s, seen, walk):
    """A verify window q_q [B,G,T,rep,D] with ``seen`` [B,T,S], in blocks of
    16 rows; ``walk(rows)`` gives a block's walk from its row indices."""
    B, G, T, rep, D = q_q.shape
    R = T * rep
    q2, s2 = q_q.reshape(B, G, R, D), q_s.reshape(B, G, R, 1)
    rows_seen = seen[:, None, :, None, :].expand(B, 1, T, rep, seen.shape[-1]).reshape(
        B, 1, R, -1)
    out = []
    for r0 in range(0, R, MAX_ROWS):
        rows = slice(r0, min(R, r0 + MAX_ROWS))
        out.append(split_attn(q2[:, :, rows], s2[:, :, rows], k_q, k_s, v_q, v_s,
                              rows_seen[:, :, rows], walk(range(R)[rows])))
    return torch.cat(out, 2).reshape(B, G, T, rep, D)


def split_verify(q_q, q_s, k_q, k_s, v_q, v_s, lengths):
    """B3: lengths [B,T] per-row key limits; a block walks to its rows'
    largest."""
    S, rep = k_q.shape[1], q_q.shape[3]
    seen = torch.arange(S)[None, None, :] < lengths[..., None]
    lim = torch.clamp(lengths, max=S)
    return split_window(q_q, q_s, k_q, k_s, v_q, v_s, seen,
                        lambda rows: lim[:, [r // rep for r in rows]].amax(1))


def split_tree(q_q, q_s, k_q, k_s, v_q, v_s, pos, anc):
    """B4: committed prefix plus ancestor bits; every block walks to
    pos + T."""
    S, T = k_q.shape[1], q_q.shape[2]
    seen = vt.tree_visibility_mask(pos, anc, S, T)
    return split_window(q_q, q_s, k_q, k_s, v_q, v_s, seen,
                        lambda rows: torch.clamp(pos + T, max=S))


def _cache(b, s, g, d, rng):
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    jk_q, jk_s = jq.quantize_kv(jnp.asarray(k))
    jv_q, jv_s = jq.quantize_kv(jnp.asarray(v))
    j = (jk_q, jk_s, jv_q, jv_s)
    t = [torch.from_numpy(np.array(a)) for a in j]
    return j, [t[0], t[1][..., 0].contiguous(), t[2], t[3][..., 0].contiguous()]


def _window(b, s, g, rep, d, t, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, g * rep, d)).astype(np.float32))
    q_q, q_s = va.quantize_window(q, g)
    return q_q, q_s, _cache(b, s, g, d, rng)[1]


@pytest.mark.parametrize("b,s,g,rep,d,lengths", [
    (2, 64, 2, 2, 32, [1, 64]),                # one chunk, length 1 and S
    (3, 300, 2, 4, 64, [150, 1, 299]),         # five chunks, non-aligned S
    (4, 200, 2, 4, 32, [63, 64, 65, 200]),     # chunk boundary -1, 0, +1
    (1, 1100, 1, 16, 16, [1090]),              # 18 chunks: CTAs take a third round
    (3, 300, 4, 1, 96, [150, 1, 299]),         # MHA (rep 1) at phi3's head dim 96
    (2, 200, 3, 1, 128, [63, 200]),            # MHA at OPT's head dim 128
])
def test_split_matches_plain_and_jax_reference(b, s, g, rep, d, lengths):
    rng = np.random.default_rng(b * s + d)
    q = rng.standard_normal((b, 1, g * rep, d)).astype(np.float32)
    j, cache = _cache(b, s, g, d, rng)
    ln = np.array(lengths, np.int32)
    jq_q, jq_s = jq.quantize_kv(jnp.asarray(q).reshape(b, g * rep, d))
    q_q = torch.from_numpy(np.array(jq_q)).reshape(b, g, rep, d)
    q_s = torch.from_numpy(np.array(jq_s)).reshape(b, g, rep, 1)
    got = split_decode(q_q, q_s, *cache, torch.from_numpy(ln))
    plain = da.decode_attn_plain(q_q, q_s, *cache, torch.from_numpy(ln))
    torch.testing.assert_close(got, plain, rtol=3e-5, atol=3e-6)
    want = np.asarray(j_da_ref.ref(jnp.asarray(q), *j, jnp.asarray(ln)[:, None, None, None]))
    np.testing.assert_allclose(got.reshape(b, 1, g * rep, d).numpy(), want,
                               rtol=3e-5, atol=3e-6)


def test_split_of_an_empty_slot_is_zero():
    q_q, q_s, cache = _window(2, 80, 2, 2, 32, 1, 3)
    got = split_decode(q_q[:, :, 0], q_s[:, :, 0], *cache, torch.tensor([0, 80]))
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("length", [1, 63, 64, 65, 130, 513])
def test_dead_chunks_leave_a_row_unchanged(length):
    """A row walked past its length, by up to two rounds of the cluster's
    chunks, has the bits of the row walked to its length."""
    s = 1100
    q_q, q_s, cache = _window(1, s, 1, 4, 32, 1, length)
    q_q, q_s = q_q[:, :, 0], q_s[:, :, 0]
    seen = torch.arange(s)[None, None, None, :] < length
    own = split_attn(q_q, q_s, *cache, seen, torch.tensor([length]))
    for walk in (length + 1, length + CHUNK, length + NC * CHUNK, s):
        assert torch.equal(split_attn(q_q, q_s, *cache, seen, torch.tensor([walk])), own), walk


@pytest.mark.parametrize("t", [5, 7])
def test_same_bits_in_pools_of_s_and_s_plus_window(t):
    """B2 at pos + i + 1 in a pool of max_len rows equals B3's row i in the
    lane's pool of max_len + T - 1 rows holding the same live K/V."""
    max_len, b, g, rep, d = 192, 4, 2, 4, 32
    q_q, q_s, cache = _window(b, max_len + t - 1, g, rep, d, t, 17 * t)
    small = [c[:, :max_len].contiguous() for c in cache]
    pos = torch.tensor([0, 60, 127, max_len - t], dtype=torch.int32)
    lengths = pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32)
    got3 = split_verify(q_q, q_s, *cache, lengths)
    for i in range(t):
        assert torch.equal(got3[:, :, i], split_decode(q_q[:, :, i], q_s[:, :, i], *small,
                                                       lengths[:, i])), i


@pytest.mark.parametrize("t,pos", [(5, [0, 61, 124, 250]), (7, [3, 60, 200, 248])])
def test_masks_give_b3_equal_b2_and_chain_equal_b3(t, pos):
    """The three masks over one body: B3's row (t, r) equals B2 at length
    pos + t + 1 in the same pool, B4 on chain ancestors equals B3 (both
    across the window's two blocks of rows), and both stay within the
    tolerance of their plain versions, B4 also on branching trees."""
    _check_masks(t, pos, g=2, rep=4, d=32)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("t,pos", [(5, [0, 61, 124, 250]), (7, [3, 60, 200, 248])])
def test_masks_at_rep_1(t, pos, d):
    """The same at MHA's rep 1 (a block holds the window's T rows) and the
    head dims of phi3-mini (96: three int8 k-steps of the four) and OPT
    (128)."""
    _check_masks(t, pos, g=3, rep=1, d=d)


def _check_masks(t, pos, g, rep, d):
    from repro_torch.serve.drafter import tree_depths_ancestors
    b, s = 4, 255
    q_q, q_s, cache = _window(b, s, g, rep, d, t, t)
    pos = torch.tensor(pos, dtype=torch.int32)
    lengths = pos[:, None] + torch.arange(1, t + 1, dtype=torch.int32)
    got3 = split_verify(q_q, q_s, *cache, lengths)
    for i in range(t):
        assert torch.equal(got3[:, :, i], split_decode(q_q[:, :, i], q_s[:, :, i], *cache,
                                                       lengths[:, i])), i
    chain = ((1 << torch.arange(1, t + 1, dtype=torch.int64)) - 1).to(torch.int32)
    assert torch.equal(split_tree(q_q, q_s, *cache, pos, chain.expand(b, t)), got3)
    torch.testing.assert_close(got3, va.verify_attn_plain(q_q, q_s, *cache, lengths),
                               rtol=3e-5, atol=3e-6)
    rng = np.random.default_rng(t)
    anc = torch.tensor([tree_depths_ancestors([int(rng.integers(-1, i)) for i in range(t - 1)])[1]
                        for _ in range(b)], dtype=torch.int32)
    torch.testing.assert_close(split_tree(q_q, q_s, *cache, pos, anc),
                               vt.verify_tree_attn_plain(q_q, q_s, *cache, pos, anc),
                               rtol=3e-5, atol=3e-6)
