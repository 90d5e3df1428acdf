"""The grouped B1's work split and operand layout as
``csrc/int8_matmul_grouped.cu`` does them, emulated on the CPU.

The kernel cannot run here, so this file repeats its index arithmetic in
numpy and holds the result bit for bit against the plain version
(``int8_matmul_grouped_plain``):

- the work split: the live passes (an expert's rows in groups of up to 32)
  in expert order, their (pass, 128-column tile) tiles of 128-row stages,
  full waves of P tiles (CTA p tile w * P + p, whole), then the last
  wave's stages cut into one contiguous range for each CTA; every stage
  streamed once, the CTAs' shares equal to within one stage, each CTA's
  tiles in increasing order; a range cutting at most two tiles, the cut
  tiles' pieces in distinct scratch slots (``2q + (q == pa)``) and their
  tickets (the tile's first CTA) distinct;
- the sums: each CTA's int32 partials of its pieces, a cut tile's pieces
  added in CTA order, then the f32 epilogue ``(float(acc) * x_s) * w_s``,
  with dead experts and rows past a count zero;
- the operands as the consumer warps read them: a stage of 128 weight rows
  x 128 columns and x rows of 128 bytes in the 128-byte swizzle TMA writes
  (16-byte chunk c of row r at chunk c ^ (r & 7)); warp (h, sl) takes
  columns 64h.. and rows 32sl..; slot 4t + i of a 32-row slab holds row
  8 * (i // 2) + 2t + i % 2; the A fragments from 8-byte reads by 4x4 byte
  transposes, the B fragments from two 4-byte reads by one byte permute;
  the m16n8k32 products summed over the slabs equal the tile's product,
  and every read instruction is free of shared-memory bank conflicts.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import int8_matmul_grouped as gmm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MR, BN, BK = gmm.PASS_ROWS, gmm.TILE_COLS, gmm.STAGE_ROWS


def passes(counts, C):
    """[(expert, first row, rows)] of the live passes, in expert order."""
    out = []
    for e, c in enumerate(counts):
        r = min(max(int(c), 0), C)
        out += [(e, m0, min(MR, r - m0)) for m0 in range(0, r, MR)]
    return out


def range_start(T, P, p):
    return T // P * p + min(p, T % P)


def cta_of(T, P, s):
    base, rem = T // P, T % P
    big = rem * (base + 1)
    return s // (base + 1) if s < big else rem + (s - big) // base


def _counts(E, C, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, C + 1, E)
    c[rng.random(E) < 0.4] = 0
    return c.tolist()


def cta_stages(V, n_tiles, ks, P, p):
    """[(tile, k stage, last)] of CTA p, in the order its producer streams
    them: tile w * P + p of each full wave w, whole; then its range of the
    last wave's stages."""
    tiles = V * n_tiles
    W = tiles // P
    trem = (tiles - W * P) * ks
    out = [(w * P + p, k, k == ks - 1) for w in range(W) for k in range(ks)]
    r0, r1 = range_start(trem, P, p), range_start(trem, P, p + 1)
    out += [(W * P + s // ks, s % ks, s % ks == ks - 1 or s == r1 - 1) for s in range(r0, r1)]
    return out


def pieces_of(tile, V, n_tiles, ks, P):
    """(pa, pb): the CTAs that hold the tile's stages (one for a full-wave tile)."""
    W = V * n_tiles // P
    if tile < W * P:
        return tile % P, tile % P
    trem = (V * n_tiles - W * P) * ks
    t0 = (tile - W * P) * ks
    return cta_of(trem, P, t0), cta_of(trem, P, t0 + ks - 1)


@pytest.mark.parametrize("E,C,K,N,P", [(8, 2, 6144, 32768, 132), (8, 10, 32768, 6144, 132),
                                       (256, 1, 7168, 2048, 132), (16, 13, 8192, 3072, 132),
                                       (3, 1, 128, 128, 132), (6, 33, 1000, 528, 7),
                                       (1, 64, 32768, 128, 132)])
def test_ranges_cover_every_stage_once_and_cut_tiles_meet_in_distinct_slots(E, C, K, N, P):
    counts = _counts(E, C, E * C + K)
    V = len(passes(counts, C))
    n_tiles, ks = -(-N // BN), -(-K // BK)
    seen = np.zeros((V * n_tiles, ks), np.int64)
    sizes = []
    for p in range(P):
        st = cta_stages(V, n_tiles, ks, P, p)
        sizes.append(len(st))
        for tile, k, last in st:
            seen[tile, k] += 1
            assert pieces_of(tile, V, n_tiles, ks, P)[0] <= p <= pieces_of(tile, V, n_tiles,
                                                                           ks, P)[1]
        tiles_of_p = [t for t, _, _ in st]
        assert tiles_of_p == sorted(tiles_of_p)        # the producer's walk only moves on
    assert (seen == 1).all()
    assert max(sizes, default=0) - min(sizes, default=0) <= 1
    slots, tickets = set(), set()
    cut_of = {p: 0 for p in range(P)}
    for tile in range(V * n_tiles):
        pa, pb = pieces_of(tile, V, n_tiles, ks, P)
        if pa == pb:
            continue
        assert pa not in tickets
        tickets.add(pa)
        for q in range(pa, pb + 1):
            slot = 2 * q + (q == pa)
            assert slot not in slots
            slots.add(slot)
            cut_of[q] += 1
    assert max(cut_of.values(), default=0) <= 2
    assert max(slots, default=0) < 2 * P


def _emulate_split(x_q, x_s, w_q, w_s, counts, P):
    """The kernel's sums: each CTA's pieces in int32, cut tiles added in CTA
    order, the epilogue in f32; rows not written stay zero (the sweep)."""
    E, C, K = x_q.shape
    N = w_q.shape[2]
    ps = passes(counts, C)
    n_tiles, ks = -(-N // BN), -(-K // BK)
    xq, wq = x_q.astype(np.int64), w_q.astype(np.int64)
    pieces = {}
    for p in range(P):
        for tile, kst, _ in cta_stages(len(ps), n_tiles, ks, P, p):
            v, nt = divmod(tile, n_tiles)
            e, m0, rows = ps[v]
            k0, n0 = kst * BK, nt * BN
            part = (xq[e, m0:m0 + rows, k0:k0 + BK] @ wq[e, k0:k0 + BK, n0:n0 + BN])
            key = (tile, p)
            pieces[key] = pieces.get(key, 0) + part
    out = np.zeros((E, C, N), np.float32)
    for tile in range(len(ps) * n_tiles):
        v, nt = divmod(tile, n_tiles)
        e, m0, rows = ps[v]
        pa, pb = pieces_of(tile, len(ps), n_tiles, ks, P)
        acc = np.zeros_like(pieces[(tile, pa)], dtype=np.int32)
        for q in range(pa, pb + 1):
            acc = (acc + pieces[(tile, q)]).astype(np.int32)
        n0 = nt * BN
        cols = acc.shape[1]
        out[e, m0:m0 + rows, n0:n0 + cols] = (
            (acc.astype(np.float32) * x_s[e, m0:m0 + rows]) * w_s[e, n0:n0 + cols])
    return out


@pytest.mark.parametrize("E,C,K,N,P,counts", [
    (4, 2, 640, 384, 132, [2, 0, 1, 2]),
    (4, 2, 640, 384, 5, [2, 0, 1, 2]),
    (3, 33, 300, 200, 4, [33, 0, 17]),
    (8, 3, 256, 256, 3, [0, 0, 0, 3, 0, 1, 0, 0]),
    (5, 4, 200, 136, 9, [0, 0, 0, 0, 0])])
def test_emulated_split_equals_the_plain_version(E, C, K, N, P, counts):
    rng = np.random.default_rng(C * K + P)
    x_q = rng.integers(-127, 128, (E, C, K), dtype=np.int8)
    x_s = (rng.random((E, C, 1)) + 0.01).astype(np.float32)
    w_q = rng.integers(-127, 128, (E, K, N), dtype=np.int8)
    w_s = (rng.random((E, N)) + 0.01).astype(np.float32)
    got = _emulate_split(x_q, x_s, w_q, w_s, counts, P)
    want = gmm.int8_matmul_grouped_plain(torch.from_numpy(x_q), torch.from_numpy(x_s),
                                         torch.from_numpy(w_q), torch.from_numpy(w_s),
                                         torch.tensor(counts, dtype=torch.int32))
    np.testing.assert_array_equal(got, want.numpy())


def _swizzled(rows: np.ndarray) -> np.ndarray:
    """[R, 128] bytes in TMA's 128-byte swizzle: chunk c of row r at c ^ (r & 7)."""
    R = rows.shape[0]
    out = np.zeros(R * 128, np.uint8)
    for r in range(R):
        for c in range(8):
            dst = r * 128 + ((c ^ (r & 7)) << 4)
            out[dst:dst + 16] = rows[r, 16 * c:16 * c + 16].view(np.uint8)
    return out


def _word(buf, addr):
    return int(buf[addr:addr + 4].view("<u4")[0])


def _byte_perm(x, y, sel):
    b = list(x.to_bytes(4, "little")) + list(y.to_bytes(4, "little"))
    return int.from_bytes(bytes(b[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def _transpose4(words):
    """out[i] byte j = words[j] byte i."""
    bs = [w.to_bytes(4, "little") for w in words]
    return [int.from_bytes(bytes(bs[j][i] for j in range(4)), "little") for i in range(4)]


def _signed(word):
    return np.frombuffer(word.to_bytes(4, "little"), np.int8).astype(np.int64)


def _warp_reads(wbuf, xbuf, h, sl, rows):
    """One warp's fragments and the m16n8k32 products over its slab, as the
    kernel builds them: {(m, n): int} and each read instruction's byte
    addresses by lane."""
    mtn = -(-rows // 8)
    acc = {}
    lds64, lds32 = [[] for _ in range(8)], [[] for _ in range(4 * mtn)]
    frag = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c, half = 4 * h + (g >> 1), (g & 1) << 3
        lo, hi = [], []
        for q in range(4):
            r0 = 32 * sl + 8 * (q >> 1) + 2 * t + (q & 1)
            r1 = r0 + 16
            a0 = r0 * BN + ((c ^ (r0 & 7)) << 4) + half
            a1 = r1 * BN + ((c ^ (r1 & 7)) << 4) + half
            lds64[q].append(a0)
            lds64[4 + q].append(a1)
            lo.append((_word(wbuf, a0), _word(wbuf, a0 + 4)))
            hi.append((_word(wbuf, a1), _word(wbuf, a1 + 4)))
        a = [[0] * 4 for _ in range(4)]
        tr = _transpose4([w[0] for w in lo])
        a[0][0], a[0][1], a[1][0], a[1][1] = tr
        tr = _transpose4([w[1] for w in lo])
        a[2][0], a[2][1], a[3][0], a[3][1] = tr
        tr = _transpose4([w[0] for w in hi])
        a[0][2], a[0][3], a[1][2], a[1][3] = tr
        tr = _transpose4([w[1] for w in hi])
        a[2][2], a[2][3], a[3][2], a[3][3] = tr
        wa, sel = (t >> 1) << 2, 0x7632 if t & 1 else 0x5410
        bs = []
        for mt in range(mtn):
            xr = (8 * mt + g) * BK
            c0 = xr + (((2 * sl) ^ g) << 4) + wa
            c1 = xr + (((2 * sl + 1) ^ g) << 4) + wa
            for k, addr in enumerate((c0, c0 + 8, c1, c1 + 8)):
                lds32[4 * mt + k].append(addr)
            bs.append((_byte_perm(_word(xbuf, c0), _word(xbuf, c0 + 8), sel),
                       _byte_perm(_word(xbuf, c1), _word(xbuf, c1 + 8), sel)))
        frag[(g, t)] = (a, bs)
    for mt in range(mtn):
        for j in range(4):
            A = np.zeros((16, 32), np.int64)
            B = np.zeros((32, 8), np.int64)
            for (g, t), (a, bs) in frag.items():
                A[g, 4 * t:4 * t + 4] = _signed(a[j][0])
                A[g + 8, 4 * t:4 * t + 4] = _signed(a[j][1])
                A[g, 16 + 4 * t:20 + 4 * t] = _signed(a[j][2])
                A[g + 8, 16 + 4 * t:20 + 4 * t] = _signed(a[j][3])
                B[4 * t:4 * t + 4, g] = _signed(bs[mt][0])
                B[16 + 4 * t:20 + 4 * t, g] = _signed(bs[mt][1])
            Cm = A @ B
            for g in range(8):
                for col in range(8):
                    n = 64 * h + 8 * g + 2 * j
                    acc[(8 * mt + col, n)] = acc.get((8 * mt + col, n), 0) + int(Cm[g, col])
                    acc[(8 * mt + col, n + 1)] = (acc.get((8 * mt + col, n + 1), 0)
                                                  + int(Cm[g + 8, col]))
    return acc, lds64, lds32


def _banks_free(addrs, width):
    """A read of `width` bytes a lane is free of bank conflicts: each
    hardware phase (128 bytes of distinct addresses) touches every bank at
    most once."""
    per = 128 // width          # lanes a phase for 8-byte reads: 16
    for p0 in range(0, 32, per if width == 8 else 32):
        phase = addrs[p0:p0 + (per if width == 8 else 32)]
        words = {}
        for a in set(phase):
            for k in range(width // 4):
                words.setdefault(((a // 4) + k) % 32, set()).add((a // 4) + k)
        if any(len(v) > 1 for v in words.values()):
            return False
    return True


@pytest.mark.parametrize("rows", [1, 8, 13, 32])
def test_consumer_fragments_sum_to_the_tile_product_without_bank_conflicts(rows):
    rng = np.random.default_rng(rows)
    w = rng.integers(-128, 128, (BK, BN), dtype=np.int8)
    x = rng.integers(-128, 128, (MR, BK), dtype=np.int8)
    wbuf, xbuf = _swizzled(w), _swizzled(x)
    tile = {}
    for h in range(2):
        for sl in range(4):
            acc, lds64, lds32 = _warp_reads(wbuf, xbuf, h, sl, rows)
            for k, v in acc.items():
                tile[k] = tile.get(k, 0) + v
            assert all(_banks_free(a, 8) for a in lds64)
            assert all(_banks_free(a, 4) for a in lds32)
    want = x.astype(np.int64) @ w.astype(np.int64)
    mtn = -(-rows // 8)
    got = np.array([[tile[(m, n)] for n in range(BN)] for m in range(8 * mtn)])
    np.testing.assert_array_equal(got, want[:8 * mtn])


def test_scratch_and_shape_limits():
    """The wrapper's scratch: two cut tiles (32 x 128 int32) for each CTA;
    the shapes it refuses before any launch."""
    assert gmm.scratch_elems(132) == 2 * 132 * 32 * 128
    assert gmm.scratch_elems(1) == 8192
    gmm.check_shape(256, 2, 7168, 2048)
    gmm.check_shape(65535, 1, 16, 16)
    for bad in ((0, 1, 1, 1), (65536, 1, 16, 16), (1, 2 ** 16, 2 ** 16, 16),
                (2, 1, 2 ** 16, 2 ** 15)):
        with pytest.raises(ValueError, match="unsupported shape"):
            gmm.check_shape(*bad)
