// Device helpers shared by the kernels (int8_matmul.cu, pim_mvm.cu,
// decode_attn.cu, ssd_chunk.cu): cp.async copies from device to shared
// memory, the int8 and tf32 mma.sync tiles, and (namespace skinny) the
// weight stream, x staging, cluster reduction and launch that B1 and B5
// share.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes; src_bytes < 16 zero-fills the rest (0: the whole copy)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b on int8 m16n8k32, int32 accumulators.  Thread (g = lane / 4,
// t = lane % 4): a[0] / a[1] hold bytes 4t..4t+3 of rows g / g + 8, a[2] /
// a[3] bytes 16 + 4t.. of the same rows; b0 / b1 bytes 4t.. / 16 + 4t.. of
// column g; c[0..1] row g, columns 2t, 2t + 1; c[2..3] row g + 8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo, each a tf32 value (cvt.rna: round to nearest, ties away); the
// 3xTF32 products lo*hi + hi*lo + hi*hi of two such pairs are about f32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a . b on tf32 m16n8k8, f32 accumulators.  Thread (g = lane / 4,
// t = lane % 4): a[0] / a[1] rows g / g + 8, column t, a[2] / a[3] the same
// rows, column t + 4; b0 / b1 rows t / t + 4 of column g; c as mma_s8's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// 4x4 byte transpose: out[i] byte j = in[j] byte i
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* o) {
  const uint32_t lo_ab = __byte_perm(a, b, 0x5140), lo_cd = __byte_perm(c, d, 0x5140);
  const uint32_t hi_ab = __byte_perm(a, b, 0x7362), hi_cd = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(lo_ab, lo_cd, 0x5410);
  o[1] = __byte_perm(lo_ab, lo_cd, 0x7632);
  o[2] = __byte_perm(hi_ab, hi_cd, 0x5410);
  o[3] = __byte_perm(hi_ab, hi_cd, 0x7632);
}

// B1 (int8_matmul.cu) and B5 (pim_mvm.cu): skinny products x [M, K] by an
// int8 weight [K, N] that stream the weight once through a cp.async ring of
// BK x BN stages, K split across the CTAs of a thread block cluster whose
// int32 partials meet in distributed shared memory.
namespace skinny {

constexpr int BN = 64;                  // output columns per CTA
constexpr int BK = 128;                 // weight rows per stage
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = BK * BN;    // 8 KB
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SMEM = 232448;
// a CTA's shared memory past which a plan splits K further, so that three
// CTAs still fit on an SM
constexpr size_t SMEM_TARGET = 76 * 1024;

// rows [k0, min(k0 + BK, ke)) x columns [n0, n0 + BN) of w into one stage;
// row r's 16-byte chunk c lands at chunk c ^ (r & 2), the rest is zero
template <bool VEC>
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* __restrict__ w,
                                           int k0, int ke, int n0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
    const int q = tid + i * THREADS, r = q >> 2, c = q & 3;
    const int k = k0 + r, n = n0 + 16 * c;
    int8_t* dst = stage + r * BN + ((c ^ (r & 2)) << 4);
    if (VEC) {
      const bool ok = k < ke && n < N;
      cp_async16(dst, ok ? w + (size_t)k * N + n : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < ke) {
        const int8_t* row = w + (size_t)k * N;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (n + b < N) v[b >> 2] |= (uint32_t)(uint8_t)__ldg(row + n + b) << (8 * (b & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// x rows [m0, m0 + mp) over [kb, kb + nst * BK) into xsm (row stride
// xstride), zero past M and ke, each 16-byte group transposed 4x4 so that
// slot 4t + j holds column 4j + t: the K order the weight's A fragments
// are read in
__device__ __forceinline__ void stage_x(int8_t* xsm, const int8_t* __restrict__ x, int m0,
                                        int mp, int M, int K, int kb, int ke, int nst,
                                        int xstride, int tid) {
  const bool x_vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int groups = nst * BK / 16;
  for (int i = tid; i < mp * groups; i += THREADS) {
    const int m = i / groups, gi = i - m * groups, k = kb + 16 * gi;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (m0 + m < M) {
      const int8_t* row = x + (size_t)(m0 + m) * K;
      if (x_vec && k + 16 <= ke) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(row + k));
        transpose4(r.x, r.y, r.z, r.w, v);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (k + b < ke)   // column 4j + tt goes to slot 4tt + j
            v[b & 3] |= (uint32_t)(uint8_t)row[k + b] << (8 * (b >> 2));
      }
    }
    *reinterpret_cast<uint4*>(xsm + m * xstride + 16 * gi) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// After a cluster barrier: each output element of rows [m0, m0 + rows) x
// columns [n0, n0 + BN) summed over the cluster's int32 tiles part[m][n]
// by one CTA, which writes the sum (when acc_out is not null) and the f32
// epilogue (float(acc) * x_s) * w_s in the reference's order
__device__ __forceinline__ void cluster_epilogue(int32_t* part, int rows, int m0, int n0,
                                                 int N, const float* __restrict__ xs,
                                                 const float* __restrict__ ws,
                                                 int32_t* __restrict__ acc_out,
                                                 float* __restrict__ out, int tid) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  for (int i = rank * THREADS + tid; i < rows * BN; i += csize * THREADS) {
    const int m = i / BN, n = n0 + (i - m * BN);
    if (n >= N) continue;
    int sum = 0;
    for (int q = 0; q < csize; ++q) sum += cluster.map_shared_rank(part, q)[i];
    const size_t o = (size_t)(m0 + m) * N + n;
    if (acc_out != nullptr) acc_out[o] = sum;
    out[o] = __fmul_rn(__fmul_rn((float)sum, xs[m0 + m]), ws[n]);
  }
}

// K cut into `split` chunks of whole stages: k_chunk rows a CTA, and the
// cluster's CTAs that hold rows (none left empty; the last may hold fewer)
inline void split_rows(int K, int split, int& k_chunk, int& cluster) {
  const int stages = (K + BK - 1) / BK;
  k_chunk = (stages + split - 1) / split * BK;
  cluster = (K + k_chunk - 1) / k_chunk;
}

// Double the split of K until the grid holds two CTAs for each SM and a
// CTA's shared memory (smem_of(split)) fits three CTAs to an SM, up to
// MAX_CLUSTER CTAs and one stage each.
template <class SmemOf>
inline int choose_split(int K, int N, int num_sms, SmemOf smem_of) {
  const int stages = (K + BK - 1) / BK, n_tiles = (N + BN - 1) / BN;
  int split = 1;
  while (split < MAX_CLUSTER && 2 * split <= stages &&
         (n_tiles * split < 2 * num_sms || smem_of(split) > SMEM_TARGET))
    split *= 2;
  return split;
}

// One launch of Kern on a grid of (cluster, n_tiles) CTAs of THREADS
// threads in clusters of `cluster` along x, with smem bytes of dynamic
// shared memory; the kernel's attributes are raised once, as needed.
template <auto Kern, class... Args>
inline cudaError_t launch_cluster(int cluster, int n_tiles, size_t smem, cudaStream_t stream,
                                  Args... args) {
  static size_t smem_set = 0;           // the largest limit asked for so far
  static bool wide_set = false;
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (cluster > 8 && !wide_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace skinny
