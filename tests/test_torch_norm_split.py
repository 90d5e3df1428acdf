"""The LayerNorm backward's summation order (``csrc/layer_norm.cu``
``layer_norm_bwd``), emulated in numpy float32 on the CPU.

The kernel runs only on the card; these tests replay its sums as the
source orders them: the forward's row statistics (one block of 256
threads a row, each thread's elements in order, a warp's xor butterfly,
the 8 warp sums in order), the backward's recomputation of them when no
statistics are saved (a warp a row, each lane's elements split by the
forward's warp), and the whole backward of a warp-a-row grid (each row's
two sums by one butterfly, the column sums warp by warp, then over a
cluster's 8 blocks in rank order, then over the clusters in order).
``rsqrtf`` and ``fmaf`` stand in as the same float32 functions on both
sides, so the tests hold the orders and not the card's instructions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import layer_norm as lnk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NT, WARPS = 256, 8
F = np.float32


def fma(a, b, c):
    return F(np.float64(a) * np.float64(b) + np.float64(c))


def rsqrt(v):
    return F(1.0) / np.sqrt(F(v))


def butterfly(lanes):
    """A warp's xor butterfly over its 32 lanes' values (float32 adds):
    every lane ends with the same bits."""
    v = np.asarray(lanes, dtype=F).copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(F)
    assert (v == v[0]).all()
    return v[0]


def forward_stats(row, eps=1e-5):
    """``layer_norm_kernel``'s mean and r: thread t sums elements t, t + 256,
    ... in order; each warp's butterfly; the warp sums in index order."""
    d = row.shape[0]

    def block_sum(term):
        s = np.zeros(NT, F)
        for t in range(NT):
            for i in range(t, d, NT):
                s[t] = term(s[t], row[i])
        total = F(0)
        for w in range(WARPS):
            total = F(total + butterfly(s[32 * w:32 * w + 32]))
        return total
    mean = F(block_sum(lambda s, v: F(s + v)) / F(d))
    var = F(block_sum(lambda s, v: fma(F(v - mean), F(v - mean), s)) / F(d))
    return mean, rsqrt(F(var + F(eps)))


def warp_stats(row, eps=1e-5):
    """``warp_rows``' recomputation: lane l holds elements l + 32 k; element
    k goes to the forward's warp k % 8, each warp's partial folds by the
    butterfly, the 8 folds are added in order."""
    d = row.shape[0]
    K = -(-d // 32)

    def fold(term):
        p = np.zeros((32, WARPS), F)
        for lane in range(32):
            for k in range(K):
                if lane + 32 * k < d:
                    p[lane, k % WARPS] = term(p[lane, k % WARPS], row[lane + 32 * k])
        total = F(0)
        for w in range(WARPS):
            total = F(total + butterfly(p[:, w]))
        return total
    mean = F(fold(lambda s, v: F(s + v)) / F(d))
    var = F(fold(lambda s, v: fma(F(v - mean), F(v - mean), s)) / F(d))
    return mean, rsqrt(F(var + F(eps)))


@pytest.mark.parametrize("d", [1, 31, 64, 100, 255, 256, 257, 384, 768, 1000, 1024, 7168])
def test_warp_rows_recompute_the_forwards_statistics_bit_for_bit(d):
    rng = np.random.default_rng(d)
    for scale, shift in ((1.0, 0.0), (3.0, 0.5), (1e-3, 1e3)):
        row = (rng.standard_normal(d) * scale + shift).astype(F)
        fm, fr = forward_stats(row)
        wm, wr = warp_stats(row)
        assert fm.tobytes() == wm.tobytes() and fr.tobytes() == wr.tobytes(), (scale, shift)


def emulate_backward(x, scale, g, clusters, eps=1e-5):
    """The kernel's warp-a-row backward on the grid the wrapper plans:
    (dx, dscale, dbias)."""
    M, d = x.shape
    blocks, rows = lnk.backward_grid(M, d, clusters)
    K = -(-d // 32)
    dx = np.zeros((M, d), F)
    block_cols = np.zeros((blocks, 2, d), F)
    for b in range(blocks):
        r0, r1 = b * rows, min(M, (b + 1) * rows)
        warp_cols = np.zeros((WARPS, 2, d), F)
        for w in range(WARPS):
            for m in range(r0 + w, r1, WARPS):
                mean, r = forward_stats(x[m], eps)
                xh = ((x[m] - mean).astype(F) * r).astype(F)
                gs = (g[m] * scale).astype(F)
                sa, sb = np.zeros(32, F), np.zeros(32, F)
                for k in range(K):                    # each lane's elements in order
                    i = np.arange(32) + 32 * k
                    ok = i < d
                    sa[ok] = (sa[ok] + gs[i[ok]]).astype(F)
                    sb[ok] = [fma(a, b_, c) for a, b_, c in zip(gs[i[ok]], xh[i[ok]], sb[ok])]
                ra = F(butterfly(sa) / F(d))
                rb = F(butterfly(sb) / F(d))
                inner = ((gs - ra).astype(F) - (xh * rb).astype(F)).astype(F)
                dx[m] = (r * inner).astype(F)
                warp_cols[w, 0] = [fma(a, b_, c) for a, b_, c in zip(g[m], xh, warp_cols[w, 0])]
                warp_cols[w, 1] = (warp_cols[w, 1] + g[m]).astype(F)
        for w in range(WARPS):                          # warp by warp
            block_cols[b] = (block_cols[b] + warp_cols[w]).astype(F)
    parts = np.zeros((blocks // 8, 2, d), F)
    for c in range(blocks // 8):                        # a cluster's blocks in rank order
        for q in range(8):
            parts[c] = (parts[c] + block_cols[8 * c + q]).astype(F)
    dparams = np.zeros((2, d), F)
    for c in range(blocks // 8):                        # the clusters in order
        dparams = (dparams + parts[c]).astype(F)
    return dx, dparams[0], dparams[1]


@pytest.mark.parametrize("M,d,clusters", [(37, 96, 1), (37, 96, 2), (20, 300, 1), (9, 64, 3)])
def test_warp_rows_backward_matches_autograd_of_plain(M, d, clusters):
    """The emulated backward within 1e-5 of the gradient's scale of autograd
    through ``layer_norm_plain`` (the card test's tolerance), and each row's
    dx the same bits whatever rows share the call."""
    rng = np.random.default_rng(M * d)
    x = (rng.standard_normal((M, d)) * 3 + 0.5).astype(F)
    scale, bias = rng.standard_normal(d).astype(F), rng.standard_normal(d).astype(F)
    g = rng.standard_normal((M, d)).astype(F)
    got = emulate_backward(x, scale, g, clusters)
    want = lnk.layer_norm_backward_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                         torch.from_numpy(bias), torch.from_numpy(g))
    for a, b in zip(got, want):
        b = b.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
    few = emulate_backward(x[3:5], scale, g[3:5], clusters)
    assert few[0].tobytes() == got[0][3:5].tobytes()
