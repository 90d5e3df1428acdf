// The per-row int8 activation quantizer that the norms' fused entries
// (rms_norm.cu rms_norm_fwd, layer_norm.cu layer_norm_fwd) run over the
// rows they normalise: one block of NT threads a row, each thread holding
// its elements t, t + NT, ... of the row's output h.
//
//   s[m]    = max(amax_i |h[m, i]|, 1e-8) / 127, an IEEE division;
//   q[m, i] = clamp(rint(h[m, i] / s[m]), -127, 127) as int8, the IEEE
//             quotient rounded half to even,
//
// the bits of core/quant.py quantize_activation(h) on the card (torch's
// tensor division is IEEE and torch.round rounds half to even).  The amax is
// a max, so its order changes no bit.
#pragma once

#include <cuda_runtime.h>

// clamp(rint(h / s), -127, 127) as int8, h / s the IEEE quotient, with y
// the correctly rounded 1 / s.  Division without its per-element guard:
// q0 = h y lies within an ulp of h / s, the residual h - s q0 is exact by
// fma, and one fma step q0 + r y is then the correctly rounded quotient
// (Markstein's theorem) while h, s and the quotient stay normal, which
// holds wherever a code can be nonzero (|h / s| >= 1/2 with s >= 1e-8 /
// 127); below that both quotients round to 0 (held in exact arithmetic at
// and around every half-integer by tests/test_torch_norm_quant.py).
// __fdiv_rn's guard and slow path cost more than the rest of a fused entry
// at the decode shapes.
__device__ __forceinline__ signed char code(float h, float s, float y) {
  const float q0 = __fmul_rn(h, y);
  const float q = __fmaf_rn(__fmaf_rn(-s, q0, h), y, q0);
  return (signed char)(int)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

// The row's scale from each thread's amax of its |h|: a warp's xor
// butterfly, then the WARPS warp maxima from warp_max (one barrier), the
// same bits in every thread.
template <int WARPS>
__device__ __forceinline__ float row_scale(float amax, float* warp_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  float m = warp_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, warp_max[w]);
  return __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
}

// The block's sum of every thread's s: a warp's xor butterfly, then the
// WARPS warp sums from warp_sum added in index order (one barrier), the
// same bits in every thread.  Each call takes its own warp_sum array, so
// no barrier guards its reuse.
template <int WARPS>
__device__ __forceinline__ float row_sum(float s, float* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += warp_sum[w];
  return t;
}
