// LayerNorm with row-invariant reductions, CUDA C++ for sm_90a.
//
// Not the port of a TPU kernel: the reference computes the norm in jnp
// (src/repro/models/layers.py apply_norm, the "bias" branch) and leaves it
// to XLA.  It is a kernel here for the reason csrc/rms_norm.cu is one: a
// library reduction (torch's mean and var) sums a row in an order that
// depends on how many rows the call holds, so a verify window of B*T rows
// and a decode step of B rows would normalise the same row to different
// last bits -- enough to flip an int8 activation code downstream.  It has
// its own source beside rms_norm.cu so that each norm stays one short file
// with one entry point, built and loaded like every other kernel.
//
// out[m, i] = ((x[m, i] - mean) * rsqrt(var + eps)) * scale[i] + bias[i],
// f32, with mean = sum_i x[m, i] / d and var = sum_i (x[m, i] - mean)^2 / d
// (the mean of squared deviations, as jnp.var computes it).
//
// The order: one block of NT threads per row, whatever the row count or
// the grid.  For each of the two sums, thread t sums its elements t,
// t + NT, ... in that order; each warp folds its 32 partial sums by a fixed
// xor butterfly; every thread then adds the NT / 32 warp sums in index
// order.  So a row's output is a function of that row alone, bit for bit.
// Every product and sum of the output is rounded on its own (no
// contraction), as the plain version rounds it.
//
// What bounds it on the H100: it reads each row and writes it once (8 bytes
// per element; the three passes over the row after the first hit L1/L2)
// and does a handful of flops per element, far below the ridge point:
// bytes.  At the decode shapes (4 rows of 7168) a call is a few microseconds
// of launch latency; the design aims at one launch instead of torch's
// several.
//
// The backward (the training path's gradient through the norm; the
// reference leaves it to XLA's autodiff of the jnp norm), with
// xhat = (x - mean) * r and gs = g * scale:
//
//   dx[m, i]   = r * ((gs[m, i] - sum_i gs / d) - xhat[m, i] * (sum_i gs * xhat / d)),
//   dscale[i]  = sum_m g[m, i] * xhat[m, i],    dbias[i] = sum_m g[m, i],
//
// mean and r as the forward computes them (the same sums in the same
// order: the same bits).  layer_norm_bwd_rows takes ROWS consecutive rows a
// block: for each, the forward's two sums and the backward's two, each in
// the fixed order above, then for each of its columns dx of every row and
// the column's two sums over the block's rows in row order, written to a
// [2, blocks, d] partial; layer_norm_bwd_cols adds the blocks' partials of
// a column in block order.  Every sum has one fixed order for a given M,
// with no atomics, so the gradient is the same bits on every run.  Bound:
// bytes (x and g read, dx written, the partials a fraction of a row each
// block).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int ROWS = 8;     // rows of one backward block

// The block's sum of every thread's ``s``, the same bits in every thread.
// ``warp_sum`` is shared; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float s, float* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += warp_sum[w];
  return t;
}

__global__ void __launch_bounds__(NT)
layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out, int d,
                  float eps) {
  __shared__ float warp_sum[WARPS];
  const size_t base = (size_t)blockIdx.x * d;
  const float* xr = x + base;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) s += xr[i];
  const float mean = __fdiv_rn(block_sum(s, warp_sum), (float)d);
  s = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float dev = __fsub_rn(xr[i], mean);
    s = fmaf(dev, dev, s);
  }
  const float var = __fdiv_rn(block_sum(s, warp_sum), (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  float* orow = out + base;
  for (int i = threadIdx.x; i < d; i += NT)
    orow[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[i], mean), r), scale[i]), bias[i]);
}

__global__ void __launch_bounds__(NT)
layer_norm_bwd_rows(const float* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ g, float* __restrict__ dx,
                    float* __restrict__ partial, int M, int d, int nblk, float eps) {
  __shared__ float warp_sum[WARPS];
  __shared__ float row_mean[ROWS], row_r[ROWS], row_a[ROWS], row_b[ROWS];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, M - row0);
  for (int k = 0; k < rows; ++k) {
    const float* xr = x + (size_t)(row0 + k) * d;
    const float* gr = g + (size_t)(row0 + k) * d;
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += NT) s += xr[i];
    const float mean = __fdiv_rn(block_sum(s, warp_sum), (float)d);
    s = 0.f;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float dev = __fsub_rn(xr[i], mean);
      s = fmaf(dev, dev, s);
    }
    const float var = __fdiv_rn(block_sum(s, warp_sum), (float)d);
    const float r = rsqrtf(__fadd_rn(var, eps));
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float gs = __fmul_rn(gr[i], scale[i]);
      a += gs;
      b = fmaf(gs, __fmul_rn(__fsub_rn(xr[i], mean), r), b);
    }
    a = block_sum(a, warp_sum);
    b = block_sum(b, warp_sum);
    if (threadIdx.x == 0) {
      row_mean[k] = mean;
      row_r[k] = r;
      row_a[k] = __fdiv_rn(a, (float)d);
      row_b[k] = __fdiv_rn(b, (float)d);
    }
  }
  __syncthreads();
  float* part_s = partial + (size_t)blockIdx.x * d;
  float* part_b = partial + ((size_t)nblk + blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float si = scale[i];
    float acc_s = 0.f, acc_b = 0.f;
    for (int k = 0; k < rows; ++k) {
      const size_t o = (size_t)(row0 + k) * d + i;
      const float gi = g[o];
      const float xhat = __fmul_rn(__fsub_rn(x[o], row_mean[k]), row_r[k]);
      const float inner = __fsub_rn(__fsub_rn(__fmul_rn(gi, si), row_a[k]),
                                    __fmul_rn(xhat, row_b[k]));
      dx[o] = __fmul_rn(row_r[k], inner);
      acc_s = fmaf(gi, xhat, acc_s);
      acc_b += gi;
    }
    part_s[i] = acc_s;
    part_b[i] = acc_b;
  }
}

// out[j, i] = sum over b < nblk of partial[j, b, i], in block order, for
// j = blockIdx.y (0: dscale, 1: dbias).
__global__ void __launch_bounds__(NT)
layer_norm_bwd_cols(const float* __restrict__ partial, float* __restrict__ out, int nblk,
                    int d) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= d) return;
  const float* p = partial + (size_t)blockIdx.y * nblk * d;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += p[(size_t)b * d + i];
  out[(size_t)blockIdx.y * d + i] = acc;
}

}  // namespace

// Rows of one backward block: the partial the wrapper allocates is
// [2, ceil(M / rows), d].
extern "C" int layer_norm_backward_rows() { return ROWS; }

// x, g f32 [M, d]; scale f32 [d] -> dx f32 [M, d], dparams f32 [2, d]
// (dscale, then dbias); partial f32 [2, ceil(M / ROWS), d] is scratch.
extern "C" int layer_norm_backward_launch(const void* x, const void* scale, const void* g,
                                          void* dx, void* dparams, void* partial, int M,
                                          int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int nblk = (M + ROWS - 1) / ROWS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  layer_norm_bwd_rows<<<nblk, NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(partial),
      M, d, nblk, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_cols<<<dim3((d + NT - 1) / NT, 2), NT, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dparams), nblk, d);
  return (int)cudaGetLastError();
}

// x f32 [M, d] -> out f32 [M, d]; scale, bias f32 [d].
extern "C" int layer_norm_launch(const void* x, const void* scale, const void* bias,
                                 void* out, int M, int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  layer_norm_kernel<<<M, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
