// The grouped B1: the W8A8 products of a stack of experts in one launch,
// CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: it is the port's counterpart of the reference's
// expert product src/repro/models/moe.py _int8_expert_mm (an XLA einsum),
// with B1's integers and epilogue.  x int8 [E,C,K], w int8 [E,K,N], xs f32
// [E,C], ws f32 [E,N] and an int32 row count for each expert, read on the
// device (so a CUDA graph replays it with the counts of the step): expert
// e's rows below min(count[e], C) are (float(acc) * xs) * ws, acc the int32
// sum over K; its rows at or past the count are zero, and an expert with no
// row reads none of its weight.
//
// What bounds it on the H100: the weight bytes of the experts that hold a
// row.  At C <= 32 a weight byte feeds at most 64 operations, far under the
// int8 ridge point (about 590 a byte), so the call is a stream of those
// bytes (grok-1-314b's w_down at a decode step: 6 of 8 experts of
// 32768 x 6144).
//
// What the design does about it:
// - One persistent CTA on each SM.  Each launch reads the counts and lists
//   the live passes (an expert's rows in groups of up to 32) in expert
//   order; the tiles are (pass, 128-column tile) in that order, each of
//   ks 128-row K stages.  Dead experts hold no tile.  The tiles go out in
//   full waves, CTA p taking tile w * P + p of wave w for its whole K, so
//   that the CTAs at work read neighbouring 128-byte segments of the same
//   weight rows (the DRAM pages stay open); the stages of the last, partial
//   wave are cut into one contiguous range a CTA, equal to within one stage
//   (stream-K).  Every CTA streams the same share of the live weight, to
//   within one stage.  A range cuts at most two tiles: the cut tiles' int32
//   partials meet in scratch, and the CTA that brings a tile's ticket to
//   its number of pieces adds them in CTA order and resets the ticket.  A
//   unit's CTA and the order of every sum follow from the counts alone;
//   int32 addition is exact, so the bits equal the plain version's.
// - The weight and x stream by TMA (cp.async.bulk.tensor over the stacks
//   seen as [E, K, N] and [E, C, K], 128-byte swizzle, rows and columns out
//   of bounds zero) into a ring of 8 stages (16 KB of weight, up to 4 KB of
//   x), their arrival signalled through mbarriers.  One producer warp walks
//   the CTA's whole range, across tile boundaries, so the next tile's bytes
//   arrive while the consumers run the current tile's epilogue.  x is
//   loaded for the pass's own rows rounded up to 8.
// - Eight consumer warps (a 64-column half x a 32-row slab of each stage)
//   run int8 mma.sync m16n8k32 with the weight as the A operand, built from
//   8-byte N-major shared-memory reads by 4x4 byte transposes (prmt).  The
//   K order inside a 32-row slab is permuted (slot 4t + i holds row
//   8 * (i / 2) + 2t + i % 2) so that under the 128-byte swizzle each
//   half-warp's reads hit 32 distinct banks; x's B fragments take the same
//   order with one prmt from two 4-byte reads.
// - Shapes whose rows TMA cannot address (K or N not a multiple of 16, or x
//   not on a 16-byte boundary) run the same kernel with the producer warp
//   copying each stage itself (byte loads) into the same layout.
// - The rows past a count, and every row of a dead expert, are written zero
//   by the consumer warps before their first stage, CTA p rows p, p + P, ...
#include <algorithm>

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int BN = 128;                  // output columns of a tile: one 128-byte row
constexpr int BK = 128;                  // weight rows a stage
constexpr int MR = 32;                   // rows of x a pass (four n8 tiles)
constexpr int STAGES = 8;
constexpr int CWARPS = 8;                // consumer warps: 2 column halves x 4 slabs
constexpr int THREADS = 32 * (CWARPS + 1);
constexpr int W_BYTES = BK * BN;         // 16 KB
constexpr int X_BYTES = MR * BK;         // 4 KB
constexpr int TILE_INTS = MR * BN;

// One stage's work, written by the producer beside its bytes.
struct Unit {
  int e, m0, rows, n0;   // expert, first row and rows of the pass, first column
  long long tile;        // the tile's index in the whole sequence
  int last, pad;         // 1 on the CTA's last stage of the tile
};

// offsets in the dynamic shared memory, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes)
constexpr int OFF_X = STAGES * W_BYTES;
constexpr int OFF_TILE = OFF_X + STAGES * X_BYTES;
constexpr int OFF_UNIT = OFF_TILE + TILE_INTS * 4;
constexpr int OFF_BAR = OFF_UNIT + STAGES * (int)sizeof(Unit);
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the box at (c0, c1, c2) of a 3-D map into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// the eight consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CWARPS * 32) : "memory");
}

__device__ __forceinline__ int rows_of(const int32_t* __restrict__ counts, int e, int C) {
  return min(max(counts[e], 0), C);
}

// CTA p's stages: [start(p), start(p + 1)) of T, equal to within one
__device__ __forceinline__ long long range_start(long long T, int P, int p) {
  return T / P * p + min((long long)p, T % P);
}

// the CTA whose range holds stage s
__device__ __forceinline__ int cta_of(long long T, int P, long long s) {
  const long long base = T / P, rem = T % P, big = rem * (base + 1);
  return s < big ? (int)(s / (base + 1)) : (int)(rem + (s - big) / base);
}

// Warp-collective walk of the pass list: (e, vb, np, re) describe expert e,
// which holds passes [vb, vb + np) and re rows; moved forward to the expert
// that holds pass v (v >= vb, v below the list's length).
__device__ void seek(const int32_t* __restrict__ counts, int E, int C, long long v, int& e,
                     long long& vb, int& np, int& re, int lane) {
  while (e < 0 || v >= vb + np) {
    if (e + 1 >= E) __trap();     // the counts changed under the launch
    const long long base = vb + np;
    const int ee = e + 1 + lane;
    const int r = ee < E ? rows_of(counts, ee, C) : 0;
    const int pc = (r + MR - 1) / MR;
    long long incl = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, pc > 0 && v < base + incl);
    if (hit) {
      const int l = __ffs(hit) - 1;
      np = __shfl_sync(0xffffffffu, pc, l);
      re = __shfl_sync(0xffffffffu, r, l);
      vb = base + __shfl_sync(0xffffffffu, incl, l) - np;
      e += 1 + l;
    } else {
      vb = base + __shfl_sync(0xffffffffu, incl, 31);
      np = 0;
      e += 32;
    }
  }
}

// The stage's bytes copied by the producer warp itself (shapes TMA cannot
// address): weight rows [k0, k0 + BK) x columns [n0, n0 + BN) of expert e
// and x rows [m0, m0 + xrows) x columns [k0, k0 + BK), zero out of bounds,
// in the 128-byte swizzle TMA would write.
__device__ void copy_stage(int8_t* wdst, int8_t* xdst, const int8_t* __restrict__ w,
                           const int8_t* __restrict__ x, int e, int k0, int n0, int m0,
                           int xrows, int C, int K, int N, int lane) {
  const int8_t* we = w + (size_t)e * K * N;
  for (int q = lane; q < BK * 8; q += 32) {
    const int r = q >> 3, c = q & 7, k = k0 + r, n = n0 + 16 * c;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (k < K) {
      const int8_t* row = we + (size_t)k * N;
      for (int b = 0; b < 16; ++b)
        if (n + b < N) v[b >> 2] |= (uint32_t)(uint8_t)__ldg(row + n + b) << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(wdst + r * BN + ((c ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  const int8_t* xe = x + (size_t)e * C * K;
  for (int q = lane; q < xrows * 8; q += 32) {
    const int m = q >> 3, c = q & 7, k = k0 + 16 * c;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (m0 + m < C) {
      const int8_t* row = xe + (size_t)(m0 + m) * K;
      for (int b = 0; b < 16; ++b)
        if (k + b < K) v[b >> 2] |= (uint32_t)(uint8_t)__ldg(row + k + b) << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(xdst + m * BK + ((c ^ (m & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
int8_mm_grouped(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ ws,
                const int32_t* __restrict__ counts, float* __restrict__ out,
                int32_t* __restrict__ partial, int32_t* __restrict__ tickets, int E, int C,
                int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int8_t* wring = reinterpret_cast<int8_t*>(smem);
  int8_t* xring = reinterpret_cast<int8_t*>(smem + OFF_X);
  int32_t* tile = reinterpret_cast<int32_t*>(smem + OFF_TILE);
  Unit* units = reinterpret_cast<Unit*>(smem + OFF_UNIT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  __shared__ long long warp_passes[THREADS / 32];
  __shared__ int last_piece;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = gridDim.x, p = blockIdx.x;
  const int n_tiles = (N + BN - 1) / BN, ks = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, TMA ? 1 : 32);
      bar_init(empty + s, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < TILE_INTS; i += THREADS) tile[i] = 0;
  // the list's length: every CTA counts the passes itself
  long long mine = 0;
  for (int e = tid; e < E; e += THREADS) mine += (rows_of(counts, e, C) + MR - 1) / MR;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  if (lane == 0) warp_passes[warp] = mine;
  __syncthreads();
  long long V = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) V += warp_passes[i];
  // W full waves of P tiles, then the last wave's Trem stages in ranges
  const long long tiles = V * n_tiles, W = tiles / P, Trem = (tiles - W * P) * ks;
  const long long n_full = W * ks, r0 = range_start(Trem, P, p);
  const long long n_stages = n_full + range_start(Trem, P, p + 1) - r0;

  if (warp == CWARPS) {
    // ---- producer: the CTA's stages, in order, into the ring
    int e = -1, np = 0, re = 0;
    long long vb = 0;
    for (long long i = 0; i < n_stages; ++i) {
      const int slot = (int)(i % STAGES);
      const uint32_t ph = (uint32_t)(i / STAGES) & 1u;
      long long tl;
      int kst;
      bool last;
      if (i < n_full) {
        tl = i / ks * P + p;
        kst = (int)(i % ks);
        last = kst == ks - 1;
      } else {
        const long long s = r0 + (i - n_full);
        tl = W * P + s / ks;
        kst = (int)(s % ks);
        last = kst == ks - 1 || i == n_stages - 1;
      }
      const long long v = tl / n_tiles;
      const int nt = (int)(tl - v * n_tiles);
      seek(counts, E, C, v, e, vb, np, re, lane);
      const int m0 = (int)(v - vb) * MR, rows = min(MR, re - m0), xb = (rows + 7) >> 3;
      bar_wait(empty + slot, ph ^ 1u);
      int8_t* wdst = wring + slot * W_BYTES;
      int8_t* xdst = xring + slot * X_BYTES;
      if (lane == 0) {
        Unit& u = units[slot];
        u.e = e;
        u.m0 = m0;
        u.rows = rows;
        u.n0 = nt * BN;
        u.tile = tl;
        u.last = last;
      }
      if (TMA) {
        if (lane == 0) {
          bar_expect(full + slot, W_BYTES + xb * 8 * BK);
          tma_load(wdst, &wmap, nt * BN, kst * BK, e, full + slot);
          for (int b = 0; b < xb; ++b)
            tma_load(xdst + b * 8 * BK, &xmap, kst * BK, m0 + 8 * b, e, full + slot);
        }
      } else {
        copy_stage(wdst, xdst, w, x, e, kst * BK, nt * BN, m0, 8 * xb, C, K, N, lane);
        bar_arrive(full + slot);
      }
    }
    return;
  }

  // ---- consumers
  const int ct = tid;                     // 0..255
  {
    // rows past a count and dead experts' rows: zero
    const long long all_rows = (long long)E * C;
    for (long long r = p; r < all_rows; r += P) {
      const int e = (int)(r / C), m = (int)(r - (long long)e * C);
      if (m < rows_of(counts, e, C)) continue;
      float* o = out + r * N;
      if ((N & 3) == 0)
        for (int n = 4 * ct; n < N; n += 4 * CWARPS * 32)
          *reinterpret_cast<float4*>(o + n) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        for (int n = ct; n < N; n += CWARPS * 32) o[n] = 0.f;
    }
  }
  const int h = warp & 1, sl = warp >> 1, g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

  for (long long i = 0; i < n_stages; ++i) {
    const int slot = (int)(i % STAGES);
    bar_wait(full + slot, (uint32_t)(i / STAGES) & 1u);
    const Unit u = units[slot];
    const int mtn = (u.rows + 7) >> 3;

    // this warp's 32-row slab and 64-column half: thread (g, t) reads
    // columns 64h + 8g .. + 7 of rows 8(i/2) + 2t + i%2 (slots 4t + i) and
    // 16 + the same (slots 16 + 4t + i)
    const int8_t* slab = wring + slot * W_BYTES + sl * 32 * BN;
    const int c = 4 * h + (g >> 1), half = (g & 1) << 3;
    uint2 lo[4], hi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r0 = 8 * (q >> 1) + 2 * t + (q & 1), r1 = r0 + 16;
      lo[q] = *reinterpret_cast<const uint2*>(slab + r0 * BN + ((c ^ (r0 & 7)) << 4) + half);
      hi[q] = *reinterpret_cast<const uint2*>(slab + r1 * BN + ((c ^ (r1 & 7)) << 4) + half);
    }
    // mma j: A row g is column 8g + 2j of the half, A row g + 8 column 8g + 2j + 1
    uint32_t a[4][4], tr[4];
    transpose4(lo[0].x, lo[1].x, lo[2].x, lo[3].x, tr);
    a[0][0] = tr[0]; a[0][1] = tr[1]; a[1][0] = tr[2]; a[1][1] = tr[3];
    transpose4(lo[0].y, lo[1].y, lo[2].y, lo[3].y, tr);
    a[2][0] = tr[0]; a[2][1] = tr[1]; a[3][0] = tr[2]; a[3][1] = tr[3];
    transpose4(hi[0].x, hi[1].x, hi[2].x, hi[3].x, tr);
    a[0][2] = tr[0]; a[0][3] = tr[1]; a[1][2] = tr[2]; a[1][3] = tr[3];
    transpose4(hi[0].y, hi[1].y, hi[2].y, hi[3].y, tr);
    a[2][2] = tr[0]; a[2][3] = tr[1]; a[3][2] = tr[2]; a[3][3] = tr[3];
    // x row 8mt + g: slots 4t..4t+3 of the slab are bytes 2t, 2t+1, 8+2t,
    // 9+2t of its first 16-byte chunk (2sl), slots 16 + those of its second
    const int8_t* xt = xring + slot * X_BYTES;
    const int wa = (t >> 1) << 2;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mtn) {
        const int8_t* xr = xt + (8 * mt + g) * BK;
        const int8_t* c0 = xr + (((2 * sl) ^ g) << 4) + wa;
        const int8_t* c1 = xr + (((2 * sl + 1) ^ g) << 4) + wa;
        const uint32_t b0 = __byte_perm(*reinterpret_cast<const uint32_t*>(c0),
                                        *reinterpret_cast<const uint32_t*>(c0 + 8), sel);
        const uint32_t b1 = __byte_perm(*reinterpret_cast<const uint32_t*>(c1),
                                        *reinterpret_cast<const uint32_t*>(c1 + 8), sel);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a[j], b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + slot);
    if (!u.last) continue;

    // ---- the tile's epilogue: the warps' sums into tile[m][n]
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mtn) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = 8 * mt + 2 * t, n = 64 * h + 8 * g + 2 * j;
          atomicAdd(tile + m * BN + n, acc[mt][j][0]);
          atomicAdd(tile + (m + 1) * BN + n, acc[mt][j][1]);
          atomicAdd(tile + m * BN + n + 1, acc[mt][j][2]);
          atomicAdd(tile + (m + 1) * BN + n + 1, acc[mt][j][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;
    }
    consumers_sync();
    // a tile of the last wave may be cut: CTAs pa..pb hold its pieces
    const long long t0 = (u.tile - W * P) * ks;
    const int pa = t0 < 0 ? p : cta_of(Trem, P, t0), pb = t0 < 0 ? p : cta_of(Trem, P, t0 + ks - 1);
    const int live = u.rows * BN, used = 8 * mtn * BN;
    const float* xse = xs + (size_t)u.e * C + u.m0;
    const float* wse = ws + (size_t)u.e * N + u.n0;
    float* oe = out + ((size_t)u.e * C + u.m0) * N + u.n0;
    bool write = pa == pb;                // the whole tile's K in this CTA
    if (!write) {
      int32_t* piece = partial + (size_t)(2 * p + (p == pa)) * TILE_INTS;
      for (int k = ct; k < live; k += CWARPS * 32) piece[k] = tile[k];
      __threadfence();
      consumers_sync();
      if (ct == 0) last_piece = atomicAdd(tickets + pa, 1) == pb - pa;
      consumers_sync();
      write = last_piece;
      if (write) {
        __threadfence();
        for (int k = ct; k < live; k += CWARPS * 32) {
          int sum = 0;
          for (int q = pa; q <= pb; ++q)
            sum += __ldcg(partial + (size_t)(2 * q + (q == pa)) * TILE_INTS + k);
          tile[k] = sum;
        }
        if (ct == 0) tickets[pa] = 0;
      }
    }
    for (int k = ct; k < used; k += CWARPS * 32) {
      if (write && k < live) {
        const int m = k / BN, n = k % BN;
        if (u.n0 + n < N)
          oe[(size_t)m * N + n] = __fmul_rn(__fmul_rn((float)tile[k], xse[m]), wse[n]);
      }
      tile[k] = 0;
    }
    consumers_sync();       // the tile is clear before the next tile's sums
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once (no link against libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 3-D int8 map over d2 x d1 x d0 bytes (d0 innermost, rows d0 bytes
// apart) read in boxes of b1 rows of b0 bytes, 128-byte swizzle, out of
// bounds zero.
bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
              uint32_t b0, uint32_t b1) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0, d0 * d1};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA>
cudaError_t launch(const CUtensorMap& wm, const CUtensorMap& xm, const int8_t* x,
                   const int8_t* w, const float* xs, const float* ws, const int32_t* counts,
                   float* out, int32_t* partial, int32_t* tickets, int E, int C, int K, int N,
                   int ctas, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_mm_grouped<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  int8_mm_grouped<TMA><<<ctas, THREADS, SMEM_BYTES, stream>>>(
      wm, xm, x, w, xs, ws, counts, out, partial, tickets, E, C, K, N);
  return cudaGetLastError();
}

bool tma_path(const void* x, int K, int N) {
  return K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// The work of one launch on ctas CTAs for these row counts (host memory):
// plan[0..9] = CTAs, passes, tiles a pass, stages a tile, stages, the most
// stages a CTA streams, full waves of tiles, tiles of the last wave cut
// between CTAs, 1 where the stages come by TMA (for a 16-byte aligned x),
// dynamic shared memory a CTA.
extern "C" void int8_matmul_grouped_plan(const int32_t* counts, int E, int C, int K, int N,
                                         int ctas, long long* plan) {
  long long V = 0;
  for (int e = 0; e < E; ++e) V += (std::min(std::max(counts[e], 0), C) + MR - 1) / MR;
  const long long n_tiles = (N + BN - 1) / BN, ks = (K + BK - 1) / BK, tiles = V * n_tiles;
  const long long W = tiles / ctas, Trem = (tiles - W * ctas) * ks;
  long long cut = 0, last_cut = -1;
  for (int q = 1; q < ctas; ++q) {
    const long long s = Trem / ctas * q + std::min((long long)q, Trem % ctas);
    if (s < Trem && s % ks != 0 && s / ks != last_cut) {
      ++cut;
      last_cut = s / ks;
    }
  }
  const long long v[10] = {ctas, V, n_tiles, ks, tiles * ks, W * ks + (Trem + ctas - 1) / ctas,
                           W, cut, K % 16 == 0 && N % 16 == 0, SMEM_BYTES};
  for (int i = 0; i < 10; ++i) plan[i] = v[i];
}

// x int8 [E,C,K], w int8 [E,K,N] (16-byte aligned), xs f32 [E,C], ws f32
// [E,N], counts int32 [E] (on the device); out f32 [E,C,N], expert e's rows
// at or past counts[e] zero.  partial: int32 scratch of 2 * ctas * 32 * 128
// elements; tickets: int32 [ctas], zero, and left zero.  One launch of
// ctas CTAs.  Returns cudaErrorInvalidValue or cudaErrorMisalignedAddress,
// launching nothing, for dimensions or an operand the kernel cannot take,
// cudaErrorNotSupported when libcuda cannot describe the operands to TMA.
extern "C" int int8_matmul_grouped_launch(const void* x, const void* w, const void* xs,
                                          const void* ws, const void* counts, void* out,
                                          void* partial, void* tickets, int E, int C, int K,
                                          int N, int ctas, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || K < 1 || N < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  CUtensorMap wm, xm;
  memset(&wm, 0, sizeof(wm));
  memset(&xm, 0, sizeof(xm));
  const bool tma = tma_path(x, K, N);
  if (tma && !(make_map(&wm, w, N, K, E, BN, BK) && make_map(&xm, x, K, C, E, BK, 8)))
    return (int)cudaErrorNotSupported;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  const auto* cp = static_cast<const int32_t*>(counts);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<int32_t*>(partial);
  auto* tp = static_cast<int32_t*>(tickets);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(tma ? launch<true>(wm, xm, xp, wp, xsp, wsp, cp, op, pp, tp, E, C, K, N, ctas, s)
                   : launch<false>(wm, xm, xp, wp, xsp, wsp, cp, op, pp, tp, E, C, K, N, ctas,
                                   s));
}
