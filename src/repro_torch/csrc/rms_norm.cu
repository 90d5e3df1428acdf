// RMSNorm with a row-invariant reduction, CUDA C++ for sm_90a.
//
// Not the port of a TPU kernel: the reference computes the norm in jnp
// (src/repro/models/layers.py apply_norm) and leaves it to XLA.  It is a
// kernel here because a library reduction (torch's mean) sums a row in an
// order that depends on how many rows the call holds, so a verify window of
// B*T rows and a decode step of B rows normalise the same row to different
// last bits -- enough to flip an int8 activation code downstream.
//
// out[m, i] = (x[m, i] * rsqrt(sum_i(x[m, i]^2) / d + eps)) * scale[i], f32.
//
// The order: one block of NT threads per row, whatever the row count or the
// grid.  Thread t sums x[t], x[t + NT], ... in that order; each warp folds
// its 32 partial sums by a fixed xor butterfly (lane 0's result is kept);
// warp 0 adds the NT / 32 warp sums in index order.  So a row's output is a
// function of that row alone, bit for bit.
//
// What bounds it on the H100: it reads each row once and writes it once
// (8 bytes per element, 3 flops), far below the ridge point: bytes.  At the
// decode shapes (4 rows of 2560-5120) the call is a few microseconds of
// launch latency; the design aims at one launch instead of torch's six.
//
// The backward (the training path's gradient through the norm; the
// reference leaves it to XLA's autodiff of the jnp norm):
//
//   dx[m, i]   = r * (g[m, i] * scale[i]) - x[m, i] * (r^3 * dot / d),
//   dot        = sum_i g[m, i] * scale[i] * x[m, i],
//   dscale[i]  = sum_m g[m, i] * (x[m, i] * r_m),
//
// r the row's rsqrt as the forward computes it (the same sum in the same
// order: the same bits).  rms_norm_bwd_rows takes ROWS consecutive rows a
// block: for each, both row sums in the forward's fixed order, then for
// each of its columns dx of every row and the column's sum over the
// block's rows in row order, written to a [blocks, d] partial;
// rms_norm_bwd_cols adds the blocks' partials of a column in block order.
// Every sum has one fixed order for a given M, with no atomics, so the
// gradient is the same bits on every run.  Bound: bytes (x and g read,
// dx written, the partials a fraction of a row each block).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int ROWS = 8;     // rows of one backward block

// The block's sum of every thread's ``s`` (each warp by a fixed xor
// butterfly, then the warp sums in index order), the same bits in every
// thread and the bits the forward's thread 0 computes.  The leading
// barrier lets consecutive calls share ``warp_sum``.
__device__ __forceinline__ float block_sum(float s, float* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) t += warp_sum[w];
  return t;
}

__global__ void __launch_bounds__(NT)
rms_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                float* __restrict__ out, int d, float eps) {
  __shared__ float warp_sum[NT / 32];
  __shared__ float row_rstd;
  const size_t base = (size_t)blockIdx.x * d;
  const float* xr = x + base;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float v = xr[i];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) t += warp_sum[w];
    row_rstd = rsqrtf(__fdiv_rn(t, (float)d) + eps);
  }
  __syncthreads();
  const float r = row_rstd;
  float* orow = out + base;
  for (int i = threadIdx.x; i < d; i += NT)
    orow[i] = __fmul_rn(__fmul_rn(xr[i], r), scale[i]);
}

__global__ void __launch_bounds__(NT)
rms_norm_bwd_rows(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ g, float* __restrict__ dx,
                  float* __restrict__ partial, int M, int d, float eps) {
  __shared__ float warp_sum[NT / 32];
  __shared__ float row_r[ROWS], row_c[ROWS];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, M - row0);
  for (int k = 0; k < rows; ++k) {
    const float* xr = x + (size_t)(row0 + k) * d;
    const float* gr = g + (size_t)(row0 + k) * d;
    float s = 0.f, t = 0.f;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float v = xr[i];
      s = fmaf(v, v, s);
      t = fmaf(__fmul_rn(gr[i], scale[i]), v, t);
    }
    const float ss = block_sum(s, warp_sum);
    const float dot = block_sum(t, warp_sum);
    if (threadIdx.x == 0) {
      const float r = rsqrtf(__fdiv_rn(ss, (float)d) + eps);
      row_r[k] = r;
      row_c[k] = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), dot), (float)d);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += NT) {
    const float si = scale[i];
    float acc = 0.f;
    for (int k = 0; k < rows; ++k) {
      const size_t o = (size_t)(row0 + k) * d + i;
      const float gi = g[o], xi = x[o];
      dx[o] = __fsub_rn(__fmul_rn(row_r[k], __fmul_rn(gi, si)), __fmul_rn(xi, row_c[k]));
      acc = fmaf(gi, __fmul_rn(xi, row_r[k]), acc);
    }
    partial[(size_t)blockIdx.x * d + i] = acc;
  }
}

// out[i] = sum over b < nblk of partial[b, i], in block order.
__global__ void __launch_bounds__(NT)
rms_norm_bwd_cols(const float* __restrict__ partial, float* __restrict__ out, int nblk,
                  int d) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += partial[(size_t)b * d + i];
  out[i] = acc;
}

}  // namespace

// Rows of one backward block: the partial the wrapper allocates has
// ceil(M / rows) rows of d.
extern "C" int rms_norm_backward_rows() { return ROWS; }

// x, g f32 [M, d]; scale f32 [d] -> dx f32 [M, d], dscale f32 [d];
// partial f32 [ceil(M / ROWS), d] is scratch.
extern "C" int rms_norm_backward_launch(const void* x, const void* scale, const void* g,
                                        void* dx, void* dscale, void* partial, int M,
                                        int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int nblk = (M + ROWS - 1) / ROWS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rms_norm_bwd_rows<<<nblk, NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(partial),
      M, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rms_norm_bwd_cols<<<(d + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), nblk, d);
  return (int)cudaGetLastError();
}

// x f32 [M, d] -> out f32 [M, d]; scale f32 [d].
extern "C" int rms_norm_launch(const void* x, const void* scale, void* out,
                               int M, int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<<<M, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
