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
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;

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

}  // namespace

// x f32 [M, d] -> out f32 [M, d]; scale, bias f32 [d].
extern "C" int layer_norm_launch(const void* x, const void* scale, const void* bias,
                                 void* out, int M, int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  layer_norm_kernel<<<M, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
