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
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

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

}  // namespace

// x f32 [M, d] -> out f32 [M, d]; scale f32 [d].
extern "C" int rms_norm_launch(const void* x, const void* scale, void* out,
                               int M, int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<<<M, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
