"""B5's arithmetic as ``csrc/pim_mvm.cu`` does it, emulated on the CPU.

The kernel cannot run here, so this file repeats its integer steps in numpy
and holds the result bit for bit against the plain version
(``pim_mvm_plain``), the JAX oracle (``ref_bitserial``) and the Pallas
kernel in interpret mode:

- the cell split of four nibble-packed weight bytes in one 32-bit register
  (``split_cells``), for all 256 byte values in every byte position;
- the operands as the kernel reads them: a 128-row u tile of a 64-column
  stage, 16 columns a warp (A row r is column 2r, A row r + 8 column
  2r + 1), the K order of each 16-row half permuted (slot 4t + i holds row
  4i + t) for the weight and x alike, the 0/1 plane g of an x row as
  ``(word >> g) & 0x01010101``;
- per u tile, the hi-cell and lo-cell bit-line sums of every plane as
  separate int8 m16n8k32 products, shift-added once a tile with a thread's
  two planes 2t and 2t + 1, then summed over the quad (t ^ 1, t ^ 2);
- K split across a cluster in whole tiles, the CTAs' int32 partials summed
  in rank order and in shuffled orders; passes of at most 32 rows of x, a
  pass's rows rounded up to a compiled size (rows past M are zeros); the
  f32 epilogue ``(float(acc) * x_s) * w_s``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.pim_mvm import ops as j_pim_ops, ref as j_pim_ref
from repro_torch.core import quant as tq
from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import pim_mvm as pim
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BK, BN, WARP_COLS = 128, 64, 16
ROW_SIZES, MAX_ROWS = (1, 4, 8, 16, 24, 32), 32   # compiled rows of x a pass
# slot -> row inside one 32-row k step
SLOT_ROW = np.array([4 * (s % 4) + s // 4 for s in range(16)]
                    + [16 + 4 * (s % 4) + s // 4 for s in range(16)])
# A row -> column inside a warp's 16
COL_OF_AROW = np.array([2 * r for r in range(8)] + [2 * r + 1 for r in range(8)])
# the shift-adders' weight of each input plane; the sign plane's is negative
WB = np.array([1 << b for b in range(7)] + [-(1 << 7)], np.int64)


def split_cells(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's register split of uint32 words of four weight bytes."""
    u = u.astype(np.uint32)
    lo = u & np.uint32(0x0F0F0F0F)
    h = (u >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    hi = h + (h & np.uint32(0x08080808)) * np.uint32(0x1E)
    return hi, lo


def _words(b: np.ndarray) -> np.ndarray:
    """int8 bytes [..., 4n] -> little-endian uint32 words [..., n]."""
    return np.ascontiguousarray(b).view(np.uint8).view("<u4")


def _bytes(u: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(u.astype("<u4")).view(np.int8)


def tile_sums(w_tile: np.ndarray, x_tile: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One u tile's plane ops: w_tile int8 [128, 64] (zero past K / N),
    x_tile int8 [R, 128] -> hi_dp, lo_dp int64 [R, 4 warps, 4 k steps
    summed, 16 A rows, 8 planes], each from its own int8 m16n8k32
    products."""
    R = x_tile.shape[0]
    hi_dp = np.zeros((R, 4, 16, 8), np.int64)
    lo_dp = np.zeros_like(hi_dp)
    for ks in range(4):
        rows = 32 * ks + SLOT_ROW                                  # [32] by slot
        # A [warp, A row, slot]: columns 16w + COL_OF_AROW[r] of those rows
        cols = (WARP_COLS * np.arange(4))[:, None] + COL_OF_AROW[None, :]
        a = w_tile[rows][:, cols].transpose(1, 2, 0)               # [4, 16, 32]
        hi_w, lo_w = split_cells(_words(a))                        # registers a[0..3]
        a_hi = _bytes(hi_w).reshape(4, 16, 32).astype(np.int64)
        a_lo = _bytes(lo_w).reshape(4, 16, 32).astype(np.int64)
        # B [row, slot, plane]: bit g of the staged x bytes, word by word
        xw = _words(x_tile[:, rows])                               # [R, 8] words
        b = np.stack([_bytes((xw >> np.uint32(g)) & np.uint32(0x01010101)).reshape(R, 32)
                      for g in range(8)], axis=-1).astype(np.int64)
        hi_dp += np.einsum("wrk,mkc->mwrc", a_hi, b)
        lo_dp += np.einsum("wrk,mkc->mwrc", a_lo, b)
    return hi_dp, lo_dp


def shift_add(hi_dp: np.ndarray, lo_dp: np.ndarray) -> np.ndarray:
    """Each thread (g, t)'s shift-adders over its planes 2t, 2t + 1 ->
    [R, 4 warps, 16 A rows, 4 threads t]."""
    s = 16 * hi_dp + lo_dp                                         # [R, 4, 16, 8]
    return np.stack([WB[2 * t] * s[..., 2 * t] + WB[2 * t + 1] * s[..., 2 * t + 1]
                     for t in range(4)], axis=-1)


def quad_sum(total: np.ndarray) -> np.ndarray:
    """__shfl_xor over t ^ 1 then t ^ 2: every t ends with the quad's sum."""
    v = total + total[..., [1, 0, 3, 2]]
    return v + v[..., [2, 3, 0, 1]]


def rows_for(M: int) -> int:
    """Rows of x a pass: the fewest passes of at most 32 rows, each rounded
    up to a compiled size."""
    passes = -(-M // MAX_ROWS)
    return min(r for r in ROW_SIZES if r >= -(-M // passes))


def emulate(x_q: np.ndarray, x_s: np.ndarray, w_q: np.ndarray, w_s: np.ndarray,
            split: int, order=None) -> tuple[np.ndarray, np.ndarray]:
    """B5 on int8 x [M,K] and the nibble-packed weight [K,N]: K cut into
    ``split`` chunks of whole u tiles (the CTAs of a cluster), each output
    tile's CTA partials summed in ``order`` (rank order by default), passes
    of :func:`rows_for` rows -> (out f32, acc int32)."""
    M, K = x_q.shape
    N = w_q.shape[1]
    tiles = -(-K // BK)
    k_chunk = -(-tiles // split) * BK
    cluster = -(-K // k_chunk)
    n_tiles = -(-N // BN)
    wp = np.zeros((tiles * BK, n_tiles * BN), np.int8)
    wp[:K, :N] = w_q
    acc = np.zeros((M, N), np.int64)
    mr = rows_for(M)
    xz = np.zeros((-(-M // mr) * mr, K), np.int8)        # rows past M are zeros
    xz[:M] = x_q
    for m0 in range(0, M, mr):
        rows = min(mr, M - m0)
        for nt in range(n_tiles):
            parts = []
            for q in range(cluster):
                kb, ke = q * k_chunk, min(K, (q + 1) * k_chunk)
                total = np.zeros((mr, 4, 16, 4), np.int64)
                for k0 in range(kb, ke, BK):
                    xt = np.zeros((mr, BK), np.int8)
                    xt[:, :min(BK, ke - k0)] = xz[m0:m0 + mr, k0:min(k0 + BK, ke)]
                    wt = wp[k0:k0 + BK, nt * BN:(nt + 1) * BN].copy()
                    wt[max(0, ke - k0):] = 0                       # rows past the CTA's chunk
                    total += shift_add(*tile_sums(wt, xt))
                    assert np.abs(total).max() < 2 ** 31
                part = quad_sum(total)[:rows, ..., 0]              # [rows, 4, 16]
                tile = np.zeros((rows, BN), np.int64)
                for w in range(4):
                    tile[:, WARP_COLS * w + COL_OF_AROW] = part[:, w]
                parts.append(tile)
            s = np.zeros((rows, BN), np.int64)
            for q in (range(cluster) if order is None else order(cluster)):
                s += parts[q]
            n1 = min(N, (nt + 1) * BN)
            acc[m0:m0 + rows, nt * BN:n1] = s[:, :n1 - nt * BN]
    assert np.abs(acc).max() < 2 ** 31
    acc = acc.astype(np.int32)
    out = (acc.astype(np.float32) * x_s.reshape(-1, 1)) * w_s
    return out, acc


def _linear(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    jlin = jq.make_quantized_linear(jnp.asarray(w))
    x_q, x_s = jq.quantize_activation(jnp.asarray(x))
    return x_q, x_s, jlin


def test_split_cells_all_bytes_in_every_position():
    """The register split gives pack_qlc's planes for every byte value in
    every byte of a word (no carry between bytes), and the byte of (hi, lo)
    is the weight itself."""
    codes = np.arange(-128, 128, dtype=np.int8)
    for shift in range(4):
        b = np.roll(codes, shift).reshape(64, 4)
        hi_w, lo_w = split_cells(_words(b))
        hi, lo = _bytes(hi_w).reshape(-1), _bytes(lo_w).reshape(-1)
        th, tl = tq.pack_qlc(torch.from_numpy(np.roll(codes, shift)))
        np.testing.assert_array_equal(hi, th.numpy())
        np.testing.assert_array_equal(lo, tl.numpy())
    jh, jl = jq.pack_qlc(jnp.asarray(codes))
    hi_w, lo_w = split_cells(_words(codes.reshape(64, 4)))
    hi, lo = _bytes(hi_w).reshape(-1), _bytes(lo_w).reshape(-1)
    np.testing.assert_array_equal(hi, np.asarray(jh))
    np.testing.assert_array_equal(lo, np.asarray(jl))
    assert hi.min() == -8 and hi.max() == 7 and lo.min() == 0 and lo.max() == 15
    packed = ((hi.astype(np.int32) & 0xF) << 4 | lo).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(packed, codes)
    np.testing.assert_array_equal(
        tq.unpack_qlc(torch.from_numpy(hi), torch.from_numpy(lo)).numpy(), codes)


@pytest.mark.parametrize("m", [1, 3, 4, 5, 20])
def test_tile_sums_are_eq2_bit_line_sums(m):
    """One u tile: the emulated products give, for every x row, plane and
    column, the hi-cell and lo-cell bit-line sums of Eq. 2 over the tile's
    128 rows, and the thread's shift-adders sum to the tile's x . w."""
    rng = np.random.default_rng(m)
    w = rng.integers(-128, 128, (BK, BN)).astype(np.int8)
    x = rng.integers(-128, 128, (m, BK)).astype(np.int8)
    hi_dp, lo_dp = tile_sums(w, x)
    hi, lo = (p.numpy().astype(np.int64) for p in tq.pack_qlc(torch.from_numpy(w)))
    planes = tq.input_bitplanes(torch.from_numpy(x)).numpy().astype(np.int64)  # [8, m, 128]
    for wi in range(4):
        cols = WARP_COLS * wi + COL_OF_AROW
        for b in range(8):
            np.testing.assert_array_equal(hi_dp[:, wi, :, b], planes[b] @ hi[:, cols])
            np.testing.assert_array_equal(lo_dp[:, wi, :, b], planes[b] @ lo[:, cols])
    total = quad_sum(shift_add(hi_dp, lo_dp))
    assert (total == total[..., :1]).all()
    want = x.astype(np.int64) @ w.astype(np.int64)
    for wi in range(4):
        np.testing.assert_array_equal(total[:, wi, :, 0], want[:, WARP_COLS * wi + COL_OF_AROW])


@pytest.mark.parametrize("m,k,n", [(1, 333, 77), (3, 200, 130), (4, 520, 300), (5, 1000, 24),
                                   (20, 256, 64), (33, 390, 100), (64, 136, 40)])
def test_emulated_kernel_matches_plain_ref_and_pallas(m, k, n):
    """M 1 to 64 (one pass and more, dead rows in a pass) with K and N tails: the
    emulated kernel's sums and output equal the plain version's, B1's plain
    sums, the JAX oracle's and the Pallas kernel's (interpret mode), bit for
    bit, at a split of K across 2 CTAs."""
    x_q, x_s, jlin = _linear(m, k, n, 11 * m + k + n)
    xq, xs = np.asarray(x_q), np.asarray(x_s)
    wq, ws = np.asarray(jlin.w_q), np.asarray(jlin.w_scale)
    out, acc = emulate(xq, xs, wq, ws, split=2)
    t = [torch.from_numpy(np.array(a)) for a in (xq, xs, wq, ws)]
    out_p, acc_p = pim.pim_mvm_plain(t[0], t[1], *tq.pack_qlc(t[2]), t[3])
    _, acc1 = mm.int8_matmul_plain(*t)
    np.testing.assert_array_equal(acc, acc_p.numpy())
    np.testing.assert_array_equal(acc, acc1.numpy())
    np.testing.assert_array_equal(out, out_p.numpy())
    jhi, jlo = jq.pack_qlc(jlin.w_q)
    np.testing.assert_array_equal(
        out, np.asarray(j_pim_ref.ref_bitserial(x_q, jhi, jlo, x_s, jlin.w_scale)))
    np.testing.assert_array_equal(out, np.asarray(j_pim_ops.pim_mvm(x_q, x_s, jlin)))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_cluster_partials_in_any_order_give_the_same_bits(split):
    """K split across 1 to 8 CTAs (whole u tiles, the last CTA short), the
    partials summed in rank order and in three shuffled orders: the same
    int32 sums and f32 output, equal to the plain version's."""
    x_q, x_s, jlin = _linear(4, 1000, 130, 17 + split)
    xq, xs = np.asarray(x_q), np.asarray(x_s)
    wq, ws = np.asarray(jlin.w_q), np.asarray(jlin.w_scale)
    out, acc = emulate(xq, xs, wq, ws, split)
    rng = np.random.default_rng(split)
    for _ in range(3):
        out_s, acc_s = emulate(xq, xs, wq, ws, split, order=lambda c: rng.permutation(c))
        np.testing.assert_array_equal(acc_s, acc)
        np.testing.assert_array_equal(out_s, out)
    t = [torch.from_numpy(np.array(a)) for a in (xq, xs, wq, ws)]
    out_p, acc_p = pim.pim_mvm_plain(t[0], t[1], *tq.pack_qlc(t[2]), t[3])
    np.testing.assert_array_equal(acc, acc_p.numpy())
    np.testing.assert_array_equal(out, out_p.numpy())


def test_extreme_codes_through_the_emulated_kernel():
    """Weights and inputs at -128, -1, 0, 127 (every sign plane and sign
    cell set, the largest magnitudes): the emulated sums equal x . w."""
    codes = np.array([-128, -1, 0, 127, -8, 15, -16, 112], np.int8)
    rng = np.random.default_rng(3)
    x = rng.choice(codes, (5, 300)).astype(np.int8)
    w = rng.choice(codes, (300, 70)).astype(np.int8)
    out, acc = emulate(x, np.ones((5, 1), np.float32), w, np.ones(70, np.float32), split=3)
    np.testing.assert_array_equal(acc, x.astype(np.int64) @ w.astype(np.int64))
