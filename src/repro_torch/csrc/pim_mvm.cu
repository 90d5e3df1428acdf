// B5: the paper's Eq. 2 bit-serial QLC PIM MVM, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/pim_mvm/kernel.py
// (pim_mvm_pallas / _kernel).  It keeps the array's dataflow: for each tile
// of u = 128 activated rows, 8 sequential input bit-plane passes, each
// dotting the 0/1 plane with the signed high and the unsigned low QLC nibble
// planes (the two bit-line sums), combined by the shift-adders as
// acc += wb * (16 * hi_dp + lo_dp) with wb = 2^b and the sign plane weighted
// -(1 << 7); then the f32 epilogue (float(acc) * x_s) * w_s.  Its int32 sums
// are bit for bit those of B1 (csrc/int8_matmul.cu).
//
// What bounds it on the H100: it reads two nibble planes (2*K*N bytes, twice
// B1's weight bytes) once, but does 8 passes of 2 dot products over every
// tile -- about 32*M*K*N integer operations at decode M, so unlike B1 it is
// bound by the integer units, not by memory.  This kernel models the array;
// it is not the fast path (B1 is).
//
// What the design does about it: each block stages one 128 x 128 tile of
// both planes in shared memory once and runs the 8 bit passes out of shared
// memory, so device memory is still read once.  K is split across blocks and
// the partial sums meet in an int32 workspace by atomicAdd (exact, order
// free: the H-tree's in-network partial-sum role), then a small kernel
// applies the epilogue.  K and N tails are masked in the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BITS = 8;
constexpr int TK = 128;           // u: rows per plane op (activated BLS)
constexpr int TN = 128;           // columns per block
constexpr int VEC = 4;            // columns per thread
constexpr int TX = TN / VEC;      // 32 threads along N
constexpr int TY = 4;             // threads along the tile's rows
constexpr int MT = 4;             // rows of x per block

__global__ void __launch_bounds__(TX * TY)
pim_mvm_partial(const int8_t* __restrict__ x, const int8_t* __restrict__ w_hi,
                const int8_t* __restrict__ w_lo, int32_t* __restrict__ acc,
                int M, int K, int N, int k_chunk, bool vec_ok) {
  __shared__ __align__(16) int8_t hi_t[TK][TN];
  __shared__ __align__(16) int8_t lo_t[TK][TN];
  __shared__ uint8_t x_t[MT][TK];   // two's-complement bytes of the inputs
  __shared__ int red[TY][MT][TN];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int nb = blockIdx.x * TN;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  int total[MT][VEC];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) total[mi][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    // stage the plane tile (zeros past the K / N edges) and the inputs
    if (vec_ok) {
      for (int i = tid; i < TK * TN / VEC; i += TX * TY) {
        const int r = i / (TN / VEC), c = (i % (TN / VEC)) * VEC;
        const int k = k0 + r, n = nb + c;
        char4 h = make_char4(0, 0, 0, 0), l = make_char4(0, 0, 0, 0);
        if (k < k_end && n + VEC <= N) {
          h = __ldg(reinterpret_cast<const char4*>(w_hi + (size_t)k * N + n));
          l = __ldg(reinterpret_cast<const char4*>(w_lo + (size_t)k * N + n));
        }
        *reinterpret_cast<char4*>(&hi_t[r][c]) = h;
        *reinterpret_cast<char4*>(&lo_t[r][c]) = l;
      }
    } else {
      for (int i = tid; i < TK * TN; i += TX * TY) {
        const int r = i / TN, c = i % TN;
        const int k = k0 + r, n = nb + c;
        const bool in = k < k_end && n < N;
        hi_t[r][c] = in ? w_hi[(size_t)k * N + n] : 0;
        lo_t[r][c] = in ? w_lo[(size_t)k * N + n] : 0;
      }
    }
    for (int i = tid; i < MT * TK; i += TX * TY) {
      const int mi = i / TK, r = i % TK;
      const int m = m0 + mi, k = k0 + r;
      x_t[mi][r] = (m < M && k < k_end) ? (uint8_t)x[(size_t)m * K + k] : 0;
    }
    __syncthreads();

    // 8 sequential input bit-plane passes over the staged tile; this
    // thread's K lane covers rows ty, ty + TY, ...
#pragma unroll 1
    for (int b = 0; b < BITS; ++b) {
      int hi_dp[MT][VEC], lo_dp[MT][VEC];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < VEC; ++j) hi_dp[mi][j] = lo_dp[mi][j] = 0;
      for (int r = ty; r < TK; r += TY) {
        int hv[VEC], lv[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          hv[j] = hi_t[r][tx * VEC + j];
          lv[j] = lo_t[r][tx * VEC + j];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int plane = (x_t[mi][r] >> b) & 1;     // BLS on/off
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            hi_dp[mi][j] += plane * hv[j];              // hi-nibble BL sum
            lo_dp[mi][j] += plane * lv[j];              // lo-nibble BL sum
          }
        }
      }
      const int wb = (b < BITS - 1) ? (1 << b) : -(1 << b);   // sign plane
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          total[mi][j] += wb * (16 * hi_dp[mi][j] + lo_dp[mi][j]);  // shift-add
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[ty][mi][tx * VEC + j] = total[mi][j];
  __syncthreads();
  for (int i = tid; i < MT * TN; i += TX * TY) {
    const int mi = i / TN, c = i % TN;
    const int m = m0 + mi, n = nb + c;
    if (m < M && n < N) {
      int s = 0;
#pragma unroll
      for (int t = 0; t < TY; ++t) s += red[t][mi][c];
      atomicAdd(acc + (size_t)m * N + n, s);
    }
  }
}

__global__ void pim_mvm_epilogue(const int32_t* __restrict__ acc,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  out[i] = __fmul_rn(__fmul_rn((float)acc[i], xs[m]), ws[n]);
}

}  // namespace

// x int8 [M,K]; w_hi / w_lo int8 [K,N] nibble planes; xs f32 [M]; ws f32 [N];
// acc int32 [M,N] scratch (holds the integer sums on return); out f32 [M,N].
extern "C" int pim_mvm_launch(const void* x, const void* w_hi, const void* w_lo,
                              const void* xs, const void* ws, void* acc,
                              void* out, int M, int K, int N, int num_sms,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks_n = (N + TN - 1) / TN, blocks_m = (M + MT - 1) / MT;
  const int base = blocks_n * blocks_m;
  const int k_tiles = (K + TK - 1) / TK;
  int ks = (4 * num_sms + base - 1) / base;
  ks = std::max(1, std::min(ks, k_tiles));
  const int k_chunk = (k_tiles + ks - 1) / ks * TK;   // whole tiles a chunk
  ks = (K + k_chunk - 1) / k_chunk;
  const bool vec_ok = (N % VEC == 0)
      && (reinterpret_cast<uintptr_t>(w_hi) % 4 == 0)
      && (reinterpret_cast<uintptr_t>(w_lo) % 4 == 0);
  pim_mvm_partial<<<dim3(blocks_n, ks, blocks_m), dim3(TX, TY), 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_hi),
      static_cast<const int8_t*>(w_lo), static_cast<int32_t*>(acc), M, K, N,
      k_chunk, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * N;
  pim_mvm_epilogue<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}
