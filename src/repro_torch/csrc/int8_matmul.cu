// B1: W8A8 GEMM for skinny M (decode M = n_slots, verify M = n_slots * T),
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul_pallas / _kernel): out[m,n] = (float(acc[m,n]) * x_s[m]) * w_s[n]
// with acc = sum_k x_q[m,k] * w_q[k,n] accumulated in int32.
//
// What bounds it on the H100: at M <= 32 every weight byte is used at most
// 32 times, far below the int8 tensor cores' ridge point (about 590
// operations a byte), so the call is bound by the K*N bytes of weight
// (4096 x 14336 = 58.7 MB, about 17.5 us at 3.35 TB/s).
//
// What the design does about it:
// - Int8 tensor cores with the operands swapped: mma.sync m16n8k32 s8 takes
//   a 16-column tile of the weight (output columns n) as its A operand and
//   x as its 8-wide B operand, so M 4 pads to one n8 tile and M 32 to four.
// - The weight keeps its [K, N] layout and streams exactly once for any
//   M <= 32: a cp.async ring of STAGES stages (BK rows x BN columns each)
//   feeds the warps, each warp one 32-row slab of a stage.  The K-major A
//   fragments are built in registers from 8-byte N-major shared-memory
//   reads by 4x4 byte transposes (prmt).  The K order inside a 32-row slab
//   is permuted (slot 4t + j holds row 4j + t) so that the four threads of
//   a quad read four neighbouring rows; with the 16-byte chunks of a row
//   swizzled by (row & 2) the reads are free of bank conflicts.  x is
//   staged once per CTA in the same permuted order.  Past 32 rows the block
//   loops over M in 32-row passes, streaming its weight range once a pass.
// - One launch a call: K is split across the CTAs of a thread block cluster
//   (up to 16, non-portable above 8).  The warps of a CTA add their int32
//   sums into one shared-memory tile; after a cluster barrier each CTA sums
//   its share of the outputs over every CTA's tile through distributed
//   shared memory (so each output element is reduced by exactly one CTA)
//   and applies the f32 epilogue in the reference's order.  No memset, no
//   atomics in device memory, no second kernel.  int32 addition is exact in
//   any order (|acc| <= 14336 * 127^2 < 2^31), so the sums equal the plain
//   version's bit for bit.  The integer sums are written only when asked.
//   make_plan picks the split from M, K, N and the SM count: the grid holds
//   two CTAs an SM where K allows, and a CTA's staged x stays small enough
//   for three CTAs an SM.
// - The K and N tails are masked inside the kernel (zero-filled copies and
//   zero x columns), not padded.  16-byte copies need N % 16 == 0 and a
//   16-byte aligned weight; other N take byte loads, a misaligned weight
//   base is refused.
//
// The grouped products of a stack of experts have their own kernel
// (int8_matmul_grouped.cu).
#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace skinny;   // the stage geometry, ring, x staging and launch B5 shares

constexpr int MAX_M_TILES = 4;          // n8 tiles of x a pass: 32 rows

// The body: rows [0, M) of x by the CTA's (K range, BN
// columns) share of w; M may be 0 (the CTA then reads and writes nothing).
template <int MT, bool VEC>
__device__ __forceinline__ void int8_mm_body(const int8_t* __restrict__ x,
                                             const int8_t* __restrict__ w,
                                             const float* __restrict__ xs,
                                             const float* __restrict__ ws,
                                             int32_t* __restrict__ acc_out,
                                             float* __restrict__ out, int M, int K, int N,
                                             int k_chunk, int xstride) {
  constexpr int MP = 8 * MT;                     // rows of x per pass
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int32_t* part = reinterpret_cast<int32_t*>(smem + STAGES * STAGE_BYTES);
  int8_t* xsm = reinterpret_cast<int8_t*>(part + MP * BN);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.x * k_chunk, ke = min(K, kb + k_chunk);
  const int nst = kb < ke ? (ke - kb + BK - 1) / BK : 0;

  for (int m0 = 0; m0 < M; m0 += MP) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) load_stage<VEC>(ring + s * STAGE_BYTES, w, kb + s * BK, ke, n0, N, tid);
      cp_async_commit();
    }
    for (int i = tid; i < MP * BN; i += THREADS) part[i] = 0;
    stage_x(xsm, x, m0, MP, M, K, kb, ke, nst, xstride, tid);
    __syncthreads();

    int c[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][j][e] = 0;

    for (int s = 0; s < nst; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int sn = s + STAGES - 1;
      if (sn < nst)
        load_stage<VEC>(ring + (sn % STAGES) * STAGE_BYTES, w, kb + sn * BK, ke, n0, N, tid);
      cp_async_commit();

      // this warp's 32-row slab; thread (g, t) holds columns 8g..8g+7 of rows
      // 4i + t (slots 4t + i) and 16 + 4i + t (slots 16 + 4t + i)
      const int8_t* slab = ring + (s % STAGES) * STAGE_BYTES + warp * 32 * BN;
      uint2 lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = 4 * i + t, r1 = 16 + 4 * i + t;
        lo[i] = *reinterpret_cast<const uint2*>(slab + r0 * BN + (((g >> 1) ^ (r0 & 2)) << 4) +
                                                ((g & 1) << 3));
        hi[i] = *reinterpret_cast<const uint2*>(slab + r1 * BN + (((g >> 1) ^ (r1 & 2)) << 4) +
                                                ((g & 1) << 3));
      }
      // mma j: A row g is column 8g + 2j, A row g + 8 column 8g + 2j + 1
      uint32_t a[4][4], tr[4];
      transpose4(lo[0].x, lo[1].x, lo[2].x, lo[3].x, tr);
      a[0][0] = tr[0]; a[0][1] = tr[1]; a[1][0] = tr[2]; a[1][1] = tr[3];
      transpose4(lo[0].y, lo[1].y, lo[2].y, lo[3].y, tr);
      a[2][0] = tr[0]; a[2][1] = tr[1]; a[3][0] = tr[2]; a[3][1] = tr[3];
      transpose4(hi[0].x, hi[1].x, hi[2].x, hi[3].x, tr);
      a[0][2] = tr[0]; a[0][3] = tr[1]; a[1][2] = tr[2]; a[1][3] = tr[3];
      transpose4(hi[0].y, hi[1].y, hi[2].y, hi[3].y, tr);
      a[2][2] = tr[0]; a[2][3] = tr[1]; a[3][2] = tr[2]; a[3][3] = tr[3];
      const int8_t* xo = xsm + (s * WARPS + warp) * 32 + 4 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* xr = xo + (mt * 8 + g) * xstride;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(c[mt][j], a[j], b0, b1);
      }
    }
    cp_async_wait<0>();

    // the warps' sums into the CTA's tile part[m][n]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mt * 8 + 2 * t, nl = 8 * g + 2 * j;
        atomicAdd(part + m * BN + nl, c[mt][j][0]);
        atomicAdd(part + (m + 1) * BN + nl, c[mt][j][1]);
        atomicAdd(part + m * BN + nl + 1, c[mt][j][2]);
        atomicAdd(part + (m + 1) * BN + nl + 1, c[mt][j][3]);
      }
    cluster.sync();

    // each output element summed over the cluster's tiles by one CTA
    cluster_epilogue(part, min(MP, M - m0), m0, n0, N, xs, ws, acc_out, out, tid);
    cluster.sync();      // no tile is reused or freed while another CTA reads it
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_mm_cluster(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ xs, const float* __restrict__ ws,
                int32_t* __restrict__ acc_out, float* __restrict__ out, int M, int K,
                int N, int k_chunk, int xstride) {
  int8_mm_body<MT, VEC>(x, w, xs, ws, acc_out, out, M, K, N, k_chunk, xstride);
}

size_t smem_bytes(int m_tiles, int xstride) {
  return (size_t)STAGES * STAGE_BYTES + (size_t)8 * m_tiles * BN * 4 +
         (size_t)8 * m_tiles * xstride;
}

// The launch: cluster CTAs split K into k_chunk rows each (whole stages;
// the last CTA may hold fewer) for each of n_tiles BN-column tiles of the
// output, m_tiles n8 tiles of x a pass, passes passes over M.
struct Plan {
  int cluster, k_chunk, n_tiles, m_tiles, passes;
  size_t smem;
};

Plan plan_for(int M, int K, int N, int split) {
  Plan p;
  split_rows(K, split, p.k_chunk, p.cluster);
  p.n_tiles = (N + BN - 1) / BN;
  p.m_tiles = std::min(MAX_M_TILES, (M + 7) / 8);
  p.passes = (M + 8 * p.m_tiles - 1) / (8 * p.m_tiles);
  p.smem = smem_bytes(p.m_tiles, p.k_chunk + 16);
  return p;
}

// the split of skinny::choose_split: two CTAs an SM, three fitting on one
Plan make_plan(int M, int K, int N, int num_sms) {
  return plan_for(M, K, N, choose_split(K, N, num_sms, [&](int split) {
                    return plan_for(M, K, N, split).smem;
                  }));
}

template <int MT, bool VEC>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   int32_t* acc, float* out, int M, int K, int N, const Plan& p,
                   cudaStream_t stream) {
  const int xstride = p.k_chunk + 16;
  return launch_cluster<int8_mm_cluster<MT, VEC>>(p.cluster, p.n_tiles, smem_bytes(MT, xstride),
                                                  stream, x, w, xs, ws, acc, out, M, K, N,
                                                  p.k_chunk, xstride);
}

}  // namespace

// The plan int8_matmul_launch takes for these dimensions on a card of
// num_sms SMs: cluster, k_chunk, n_tiles, m_tiles, passes and the dynamic
// shared memory of a CTA, written to plan[0..5].
extern "C" void int8_matmul_plan(int M, int K, int N, int num_sms, long long* plan) {
  const Plan p = make_plan(M, K, N, num_sms);
  const long long v[6] = {p.cluster, p.k_chunk, p.n_tiles, p.m_tiles, p.passes,
                          (long long)p.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
}

// x int8 [M,K], w int8 [K,N] (16-byte aligned), xs f32 [M], ws f32 [N];
// out f32 [M,N]; acc int32 [M,N] receives the integer sums when not null.
// Returns cudaErrorInvalidValue or cudaErrorMisalignedAddress, launching
// nothing, for dimensions or an operand the kernel cannot take.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* xs,
                                  const void* ws, void* acc, void* out, int M, int K, int N,
                                  int num_sms, void* stream) {
  if (M < 1 || K < 1 || N < 1 || num_sms < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N, num_sms);
  if (p.n_tiles > 65535 || p.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const bool vec = N % 16 == 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  auto* ap = static_cast<int32_t*>(acc);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define B1_CASE(MT)                                                              \
  case MT:                                                                       \
    err = vec ? launch<MT, true>(xp, wp, xsp, wsp, ap, op, M, K, N, p, s)        \
              : launch<MT, false>(xp, wp, xsp, wsp, ap, op, M, K, N, p, s);      \
    break;
  switch (p.m_tiles) {
    B1_CASE(1)
    B1_CASE(2)
    B1_CASE(3)
    default:
      B1_CASE(4)
  }
#undef B1_CASE
  return (int)err;
}
