// B5: the paper's Eq. 2 bit-serial QLC PIM MVM, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/pim_mvm/kernel.py
// (pim_mvm_pallas / _kernel).  It keeps the array's dataflow: for each tile
// of u = 128 activated rows, 8 input bit-plane passes, each dotting the 0/1
// plane with the signed high and the unsigned low QLC cells (the two
// bit-line sums), combined by the shift-adders as
// acc += wb * (16 * hi_dp + lo_dp) with wb = 2^b and the sign plane weighted
// -(1 << 7); then the f32 epilogue (float(acc) * x_s) * w_s.  Its int32 sums
// are bit for bit those of B1 (csrc/int8_matmul.cu).
//
// What bounds it on the H100: Eq. 2 is 32*M*K*N integer operations (8
// planes x 2 cells x a multiply and an add); on the int8 tensor cores
// (1,979 TOPS) that is under the time of reading the weight's K*N bytes
// (3.35 TB/s) up to about M 18, so at decode M the call is bound by bytes.
//
// What the design does about it:
// - One byte a weight: the two 4-bit cells of a weight are its int8 byte
//   (w = 16 * hi + lo), so the kernel reads the QuantizedLinear's w_q as it
//   is and splits the cells in registers (split_cells); nothing is packed
//   on the host and the weight streams once for M <= 32.
// - The plane ops on int8 mma.sync m16n8k32 with B1's swapped operands: a
//   16-column tile of the weight is the A operand, once as its hi cells and
//   once as its lo cells; the B operand's 8 columns are the 0/1 input
//   planes b = 0..7 of one x row, each built from x's staged bytes by a
//   shift and a mask.  Each warp owns 16 of the CTA's 64 columns over a
//   whole u tile (a 128-row stage: four k32 steps), so the hi-cell and
//   lo-cell bit-line sums of every plane over the tile sit in their own
//   int32 accumulators, and the shift-adders combine them once a tile.
//   The whole int8 weight is never multiplied by the whole int8 input.
// - The stream, the x staging and the reduction are B1's (sm90.cuh,
//   namespace skinny): a cp.async ring of 128 x 64 stages with 16-byte
//   chunks swizzled by (row & 2), the K order permuted inside each 16-row
//   half (slot 4t + j holds row 4j + t) for both operands, K split across
//   the CTAs of a thread block cluster whose int32 totals meet in
//   distributed shared memory; each output is reduced by one CTA, which
//   applies the epilogue.  One launch a call: no memset, no atomics in
//   device memory, no second kernel.  int32 addition is exact in any order
//   (|acc| <= K * 2^14 < 2^31 for K < 2^17).  The integer sums are written
//   only when asked.
// - Up to 32 rows of x are one pass, computed in groups of four rows whose
//   products interleave; past 32 rows the block loops over M in passes of
//   at most 32 rows, streaming its weight range once a pass.
// - The K and N tails are masked inside the kernel (zero-filled copies and
//   zero x columns).  16-byte copies need N % 16 == 0 and a 16-byte
//   aligned weight; other N take byte loads, a misaligned weight base is
//   refused.
#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace skinny;   // the stage geometry, ring, x staging and launch B1 shares

// rows of x a pass (compiled sizes): every row of a pass is computed, so
// the rows' product chains interleave; rows past M are zeros
constexpr int ROW_SIZES[] = {1, 4, 8, 16, 24, 32};
constexpr int MAX_ROWS = 32;

// The two QLC cells of four weights from their bytes (w = 16 * hi + lo):
// lo the unsigned low nibbles, hi the high nibbles sign-extended to int8
// (a set bit 3 adds 0xF0 to its byte, which cannot carry out of it)
__device__ __forceinline__ void split_cells(uint32_t u, uint32_t& hi, uint32_t& lo) {
  lo = u & 0x0F0F0F0Fu;
  const uint32_t h = (u >> 4) & 0x0F0F0F0Fu;
  hi = h + (h & 0x08080808u) * 0x1Eu;
}

// bytes 0 of a, b, c, d into even and bytes 1 into odd (each of a..d holds
// two neighbouring columns of one row in its low half)
__device__ __forceinline__ void pair_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t& even, uint32_t& odd) {
  const uint32_t ab = __byte_perm(a, b, 0x5140), cd = __byte_perm(c, d, 0x5140);
  even = __byte_perm(ab, cd, 0x5410);
  odd = __byte_perm(ab, cd, 0x7632);
}

template <int MR, bool VEC>
__global__ void __launch_bounds__(THREADS)
pim_mvm_cluster(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ ws,
                int32_t* __restrict__ acc_out, float* __restrict__ out, int M, int K, int N,
                int k_chunk, int xstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int32_t* part = reinterpret_cast<int32_t*>(smem + STAGES * STAGE_BYTES);
  int8_t* xsm = reinterpret_cast<int8_t*>(part + MR * BN);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.x * k_chunk, ke = min(K, kb + k_chunk);
  const int nst = kb < ke ? (ke - kb + BK - 1) / BK : 0;
  // the C tile's columns 2t, 2t + 1 of this thread are input planes 2t and
  // 2t + 1: the shift-adders weigh them 2^b, the sign plane -2^7
  const int wb0 = 1 << (2 * t);
  const int wb1 = t == 3 ? -(1 << 7) : 1 << (2 * t + 1);

  for (int m0 = 0; m0 < M; m0 += MR) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) load_stage<VEC>(ring + s * STAGE_BYTES, w, kb + s * BK, ke, n0, N, tid);
      cp_async_commit();
    }
    stage_x(xsm, x, m0, MR, M, K, kb, ke, nst, xstride, tid);   // rows past M are zero
    __syncthreads();

    // total[m][0] / [1]: columns 2g / 2g + 1 of the warp's 16 for x row
    // m0 + m, over planes 2t and 2t + 1
    int total[MR][2];
#pragma unroll
    for (int m = 0; m < MR; ++m) total[m][0] = total[m][1] = 0;

    for (int s = 0; s < nst; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int sn = s + STAGES - 1;
      if (sn < nst)
        load_stage<VEC>(ring + (sn % STAGES) * STAGE_BYTES, w, kb + sn * BK, ke, n0, N, tid);
      cp_async_commit();

      // one plane op over the u tile: the warp's columns are chunk `warp`
      // of every row; in k step ks thread (g, t) reads columns 2g (A row g)
      // and 2g + 1 (A row g + 8) of rows 32ks + 4i + t (slots 4t + i) and
      // 32ks + 16 + 4i + t (slots 16 + 4t + i), and splits their cells
      const int8_t* stage = ring + (s % STAGES) * STAGE_BYTES;
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 32 * ks + 16 * (i >> 2) + 4 * (i & 3) + t;
          v[i] = *reinterpret_cast<const uint16_t*>(stage + r * BN + ((warp ^ (r & 2)) << 4) +
                                                    2 * g);
        }
        uint32_t a[4];
        pair_bytes(v[0], v[1], v[2], v[3], a[0], a[1]);
        pair_bytes(v[4], v[5], v[6], v[7], a[2], a[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_cells(a[e], a_hi[ks][e], a_lo[ks][e]);
      }
      const int8_t* xo = xsm + s * BK + 4 * t;
      // x rows in groups of four, whose eight product chains interleave
#pragma unroll
      for (int m1 = 0; m1 < MR; m1 += 4) {
        constexpr int G = MR < 4 ? MR : 4;
        // the tile's bit-line sums of each row: hi and lo cells apart, B
        // column g (this thread's plane) = bit g of each input byte
        int hi_dp[G][4], lo_dp[G][4];
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) hi_dp[r][e] = lo_dp[r][e] = 0;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < G; ++r) {
            const int8_t* xr = xo + (m1 + r) * xstride + 32 * ks;
            const uint32_t b0 = (*reinterpret_cast<const uint32_t*>(xr) >> g) & 0x01010101u;
            const uint32_t b1 = (*reinterpret_cast<const uint32_t*>(xr + 16) >> g) & 0x01010101u;
            mma_s8(hi_dp[r], a_hi[ks], b0, b1);
            mma_s8(lo_dp[r], a_lo[ks], b0, b1);
          }
        // the shift-adders, once a tile
#pragma unroll
        for (int r = 0; r < G; ++r) {
          total[m1 + r][0] += wb0 * (16 * hi_dp[r][0] + lo_dp[r][0]) +
                              wb1 * (16 * hi_dp[r][1] + lo_dp[r][1]);
          total[m1 + r][1] += wb0 * (16 * hi_dp[r][2] + lo_dp[r][2]) +
                              wb1 * (16 * hi_dp[r][3] + lo_dp[r][3]);
        }
      }
    }
    cp_async_wait<0>();

    // the quad's four plane pairs summed; one thread of the quad stores the
    // two columns into the CTA's tile part[m][n] (the warps' columns are
    // disjoint: no atomics)
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      int v0 = total[m][0], v1 = total[m][1];
      v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
      v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      if (t == (m & 3))
        *reinterpret_cast<int2*>(part + m * BN + 16 * warp + 2 * g) = make_int2(v0, v1);
    }
    cluster.sync();

    // each output element summed over the cluster's tiles by one CTA
    cluster_epilogue(part, min(MR, M - m0), m0, n0, N, xs, ws, acc_out, out, tid);
    cluster.sync();      // no tile is reused or freed while another CTA reads it
  }
}

size_t smem_bytes(int rows, int xstride) {
  return (size_t)STAGES * STAGE_BYTES + (size_t)rows * BN * 4 + (size_t)rows * xstride;
}

// The launch: cluster CTAs split K into k_chunk rows each (whole u tiles;
// the last CTA may hold fewer) for each of n_tiles BN-column tiles of the
// output, rows rows of x a pass, passes passes over M.
struct Plan {
  int cluster, k_chunk, n_tiles, rows, passes;
  size_t smem;
};

// rows of x a pass: the fewest passes of at most MAX_ROWS rows, each
// rounded up to a compiled size
int rows_for(int M) {
  const int passes = (M + MAX_ROWS - 1) / MAX_ROWS, need = (M + passes - 1) / passes;
  for (int r : ROW_SIZES)
    if (r >= need) return r;
  return MAX_ROWS;
}

Plan plan_for(int M, int K, int N, int split) {
  Plan p;
  split_rows(K, split, p.k_chunk, p.cluster);
  p.n_tiles = (N + BN - 1) / BN;
  p.rows = rows_for(M);
  p.passes = (M + p.rows - 1) / p.rows;
  p.smem = smem_bytes(p.rows, p.k_chunk + 16);
  return p;
}

// the split of skinny::choose_split: two CTAs an SM, three fitting on one
Plan make_plan(int M, int K, int N, int num_sms) {
  return plan_for(M, K, N, choose_split(K, N, num_sms, [&](int split) {
                    return plan_for(M, K, N, split).smem;
                  }));
}

}  // namespace

// The plan pim_mvm_launch takes for these dimensions on a card of num_sms
// SMs: cluster, k_chunk, n_tiles, rows of x a pass, passes and the dynamic
// shared memory of a CTA, written to plan[0..5].
extern "C" void pim_mvm_plan(int M, int K, int N, int num_sms, long long* plan) {
  const Plan p = make_plan(M, K, N, num_sms);
  const long long v[6] = {p.cluster, p.k_chunk, p.n_tiles, p.rows, p.passes,
                          (long long)p.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
}

// x int8 [M,K]; w int8 [K,N] (16-byte aligned), each byte a weight's two
// QLC cells (signed high nibble, unsigned low nibble); xs f32 [M];
// ws f32 [N]; out f32 [M,N]; acc int32 [M,N] receives the integer sums when
// not null.  Returns cudaErrorInvalidValue or cudaErrorMisalignedAddress,
// launching nothing, for dimensions or an operand the kernel cannot take.
extern "C" int pim_mvm_launch(const void* x, const void* w, const void* xs, const void* ws,
                              void* acc, void* out, int M, int K, int N, int num_sms,
                              void* stream) {
  if (M < 1 || K < 1 || N < 1 || num_sms < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N, num_sms);
  if (p.n_tiles > 65535 || p.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int xstride = p.k_chunk + 16;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  auto* ap = static_cast<int32_t*>(acc);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define B5_CASE(MR)                                                                         \
  case MR:                                                                                  \
    err = N % 16 == 0                                                                       \
              ? launch_cluster<pim_mvm_cluster<MR, true>>(p.cluster, p.n_tiles, p.smem, s, xp, \
                                                          wp, xsp, wsp, ap, op, M, K, N,   \
                                                          p.k_chunk, xstride)              \
              : launch_cluster<pim_mvm_cluster<MR, false>>(p.cluster, p.n_tiles, p.smem, s,  \
                                                           xp, wp, xsp, wsp, ap, op, M, K, \
                                                           N, p.k_chunk, xstride);         \
    break;
  switch (p.rows) {
    B5_CASE(1)
    B5_CASE(4)
    B5_CASE(8)
    B5_CASE(16)
    B5_CASE(24)
    default:
      B5_CASE(32)
  }
#undef B5_CASE
  return (int)err;
}
