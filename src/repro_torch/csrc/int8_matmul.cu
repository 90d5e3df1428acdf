// B1: W8A8 GEMM for skinny M (decode: M = n_slots), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul_pallas / _kernel): out[m,n] = (float(acc[m,n]) * x_s[m]) * w_s[n]
// with acc = sum_k x_q[m,k] * w_q[k,n] accumulated in int32.
//
// What bounds it on the H100: at decode M (4) every weight byte is used M
// times, so the call moves K*N bytes of int8 weight and does 2*M*K*N integer
// operations -- far below the int8 ridge point, so it is bound by the bytes
// (4096x14336 = 58.7 MB, about 17.5 us at 3.35 TB/s).
//
// What the design does about it: the weight is streamed exactly once.
// Threads walk N in coalesced 16-byte vectors (four rows in flight per
// thread), a block covers 256 columns x a K-chunk, and the K axis is split
// across blocks (split-K) so that even N = 1024 puts about four blocks on
// each of the 132 SMs.  Partial sums meet
// in an int32 workspace through atomicAdd: integer addition is associative,
// so the sums are exact and independent of block order, bit for bit equal to
// the reference's int32 dot.  A second small kernel applies the f32
// epilogue in the reference's order.  No TPU padding: the K and N tails are
// masked inside the kernel.  Tensor cores (wgmma s8) are left for a later
// change; at M = 4 the integer units keep up with the memory stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int VEC = 16;           // columns per thread (one 16-byte load)
constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along K (interleaved rows)
constexpr int TN = TX * VEC;      // 256 columns per block
constexpr int MT = 4;             // rows of x per block
constexpr int MIN_ROWS = 64;      // fewest K rows a block streams

__global__ void __launch_bounds__(TX * TY)
int8_mm_partial(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ acc, int M, int K, int N, int k_chunk,
                bool vec_ok) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = blockIdx.x * TN + tx * VEC;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  int sum[MT][VEC];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[mi][j] = 0;

  if (n0 < N) {
    const bool full = vec_ok && n0 + VEC <= N;
#pragma unroll 4
    for (int k = k_begin + ty; k < k_end; k += TY) {
      const int8_t* wr = w + (size_t)k * N + n0;
      int wv[VEC];
      if (full) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(wr));
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          wv[j] = (int)(int8_t)(words[j / 4] >> (8 * (j % 4)));
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) wv[j] = (n0 + j < N) ? (int)wr[j] : 0;
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (m0 + mi < M) {
          const int xv = __ldg(x + (size_t)(m0 + mi) * K + k);
#pragma unroll
          for (int j = 0; j < VEC; ++j) sum[mi][j] += xv * wv[j];
        }
      }
    }
  }

  // K lanes ty and ty ^ 1 share a warp: fold them by shuffle, then the
  // remaining TY / 2 lanes through shared memory, then one atomic per
  // (m, n) per block
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      sum[mi][j] += __shfl_xor_sync(0xffffffffu, sum[mi][j], 16);
  __shared__ int red[TY / 2][MT][TN];
  if ((ty & 1) == 0) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[ty / 2][mi][tx * VEC + j] = sum[mi][j];
  }
  __syncthreads();
  for (int i = ty * TX + tx; i < MT * TN; i += TX * TY) {
    const int mi = i / TN, c = i % TN;
    const int m = m0 + mi, n = blockIdx.x * TN + c;
    if (m < M && n < N) {
      int s = 0;
#pragma unroll
      for (int t = 0; t < TY / 2; ++t) s += red[t][mi][c];
      atomicAdd(acc + (size_t)m * N + n, s);
    }
  }
}

__global__ void int8_mm_epilogue(const int32_t* __restrict__ acc,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  out[i] = __fmul_rn(__fmul_rn((float)acc[i], xs[m]), ws[n]);
}

}  // namespace

// x int8 [M,K], w int8 [K,N], xs f32 [M], ws f32 [N]; acc int32 [M,N] is
// scratch that holds the integer sums on return; out f32 [M,N].
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* xs,
                                  const void* ws, void* acc, void* out, int M,
                                  int K, int N, int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks_n = (N + TN - 1) / TN, blocks_m = (M + MT - 1) / MT;
  const int base = blocks_n * blocks_m;
  int ks = (4 * num_sms + base - 1) / base;       // about four blocks per SM
  ks = std::max(1, std::min(ks, (K + MIN_ROWS - 1) / MIN_ROWS));
  int k_chunk = ((K + ks - 1) / ks + TY - 1) / TY * TY;
  ks = (K + k_chunk - 1) / k_chunk;
  const bool vec_ok = (N % VEC == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  int8_mm_partial<<<dim3(blocks_n, ks, blocks_m), dim3(TX, TY), 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(acc), M, K, N, k_chunk, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * N;
  int8_mm_epilogue<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}
