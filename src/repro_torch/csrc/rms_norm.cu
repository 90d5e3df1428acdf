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
// its 32 partial sums by a fixed xor butterfly; every thread adds the NT /
// 32 warp sums in index order.  So a row's output is a function of that row
// alone, bit for bit.
//
// What bounds it on the H100: it reads each row once and writes it once
// (8 bytes per element, 3 flops), far below the ridge point: bytes.  At the
// decode shapes (4 rows of 2560-5120) the call is a few microseconds of
// launch latency; the design aims at one launch instead of torch's six.
//
// The forward writes each row's r = rsqrt(mean(x^2) + eps) to rstd when
// the pointer is not null (the training path saves it for the backward;
// serving passes null).  The output's bits do not depend on it.
//
// The forward fused with the per-row int8 quantizer (rms_norm_quant_kernel;
// it replaces no TPU kernel: the reference quantizes every linear's input
// in jnp, core/quant.py quantize_activation; the quantizer's code lives in
// norm_quant.cuh, shared with layer_norm.cu).  On the serve path every
// quantized linear that reads a norm's output quantizes it again, eight
// torch kernels a linear (abs, amax, clamp, the division by 127, the
// division, round, clamp, the cast), five times for a SwiGLU attention
// layer's two norms.  This entry writes, one block a row as the forward:
//   h[m, i]   = (x[m, i] * r) * scale[i], the forward's bits (the same r,
//               the same products);
//   s[m]      = max(amax_i |h[m, i]|, 1e-8) / 127, an IEEE division;
//   q[m, i]   = clamp(rint(h[m, i] / s[m]), -127, 127) as int8, the IEEE
//               quotient (by one fma step from the reciprocal, see code())
//               rounded half to even,
// the bits of quantize_activation(h) on the card (torch's tensor division
// is IEEE and torch.round rounds half to even).  The amax is a max, so its
// order changes no bit: a row's h, q and s depend on that row alone.  A
// thread holds its elements and their scales in registers from one read
// (up to 72 a thread, d 18432), so the row is read once and each of the
// two reductions costs one barrier.  The unfused entry (rms_norm_kernel)
// runs the same body (rms_norm_row) with the quantizer off: one read, one
// barrier, h the same bits in both.  Bound: bytes (x read, h and q
// written, 9 bytes an element); at the decode shapes a launch's fixed
// cost, against the eight launches it removes for each linear that reads
// the row.
//
// The backward (the training path's gradient through the norm; the
// reference leaves it to XLA's autodiff of the jnp norm):
//
//   dx[m, i]   = r * (g[m, i] * scale[i]) - x[m, i] * (r^3 * dot / d),
//   dot        = sum_i g[m, i] * scale[i] * x[m, i],
//   dscale[i]  = sum_m g[m, i] * (x[m, i] * r_m),
//
// r the forward's rstd (or, without one, the row's rsqrt recomputed in the
// forward's order: the same bits).  Bound: bytes (x and g read once, dx
// written once, 12 bytes an element against about 8 flops).  One launch,
// in clusters of 8 blocks:
// - each block takes a fixed range of consecutive rows, enough blocks for
//   several on each SM; a thread keeps its elements of a row (i = t, t + 256,
//   ...) in registers while the block reduces the row's dot (and, without
//   rstd, its sum of squares, in the forward's order), then writes dx from
//   them and adds g * (x * r) to its columns' sums in row order;
// - the cluster's blocks meet in distributed shared memory: block rank k
//   adds the eight blocks' column sums of its eighth of the columns in rank
//   order and writes them as the cluster's partial;
// - the block of rank k that brings ticket k to the number of clusters (an
//   integer ticket, reset by that block) adds every cluster's partial of
//   its columns in cluster order into dscale.
// Every sum has one order for a given M and grid, with no float atomics, so
// the gradient is the same bits on every run and every graph replay.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "norm_quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int CL = 8;          // blocks of a backward cluster
constexpr int MAX_D = 49152;   // a backward block's column sums fit its shared memory

// The forward's body, one block a row, behind both entries.  V: elements
// of the row each thread holds in registers (d <= NT V), with their
// scales; 0 for wider rows, which are read again from L1 / L2.  Thread t
// sums x[t]^2, x[t + NT]^2, ... in that order, each warp folds its partial
// sums by a fixed xor butterfly and every thread adds the warp sums in
// index order (one barrier), so r, h and (QUANT) the codes and scale of a
// row depend on that row alone.  rstd receives r where not null.  QUANT
// adds the quantizer epilogue (norm_quant.cuh): the row's amax by a second
// barrier, then the codes from the h in registers.
template <int V, bool QUANT>
__device__ __forceinline__ void rms_norm_row(const float* __restrict__ x,
                                             const float* __restrict__ scale,
                                             float* __restrict__ out, float* __restrict__ rstd,
                                             signed char* __restrict__ codes,
                                             float* __restrict__ row_scale_out, int d,
                                             float eps) {
  __shared__ float warp_sum[NT / 32], warp_max[NT / 32];
  constexpr int R = V > 0 ? V : 1;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * d;
  const float* xr = x + base;
  float* orow = out + base;
  float h[R], sc[R];
  float s = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + NT * j;
      h[j] = i < d ? xr[i] : 0.f;
      sc[j] = i < d ? scale[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (tid + NT * j < d) s = fmaf(h[j], h[j], s);
  } else {
    for (int i = tid; i < d; i += NT) {
      const float v = xr[i];
      s = fmaf(v, v, s);
    }
  }
  const float r = rsqrtf(__fdiv_rn(row_sum<NT / 32>(s, warp_sum), (float)d) + eps);
  if (rstd != nullptr && tid == 0) rstd[blockIdx.x] = r;
  float amax = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + NT * j;
      if (i < d) {
        h[j] = __fmul_rn(__fmul_rn(h[j], r), sc[j]);
        orow[i] = h[j];
        amax = fmaxf(amax, fabsf(h[j]));
      }
    }
  } else {
    for (int i = tid; i < d; i += NT) {
      const float v = __fmul_rn(__fmul_rn(xr[i], r), scale[i]);
      orow[i] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  if constexpr (QUANT) {
    signed char* qrow = codes + base;
    const float qs = row_scale<NT / 32>(amax, warp_max);
    if (tid == 0) row_scale_out[blockIdx.x] = qs;
    const float y = __frcp_rn(qs);
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + NT * j;
        if (i < d) qrow[i] = code(h[j], qs, y);
      }
    } else {
      // h again from x (L1 / L2 hits, the same bits as the pass above)
      for (int i = tid; i < d; i += NT)
        qrow[i] = code(__fmul_rn(__fmul_rn(xr[i], r), scale[i]), qs, y);
    }
  }
}

// The unfused entry: h, and r where rstd is not null.
template <int V>
__global__ void __launch_bounds__(NT)
rms_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                float* __restrict__ out, float* __restrict__ rstd, int d, float eps) {
  rms_norm_row<V, false>(x, scale, out, rstd, nullptr, nullptr, d, eps);
}

// The entry fused with the quantizer: h, its codes and its row scales.
template <int V>
__global__ void __launch_bounds__(NT)
rms_norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      float* __restrict__ out, signed char* __restrict__ codes,
                      float* __restrict__ row_scale, int d, float eps) {
  rms_norm_row<V, true>(x, scale, out, nullptr, codes, row_scale, d, eps);
}

// The forward's elements a thread for rows of d (0: re-read)
int fwd_vpt(int d) {
  const int v = (d + NT - 1) / NT;
  return v <= 4 ? 4 : v <= 8 ? 8 : v <= 12 ? 12 : v <= 16 ? 16 : v <= 24 ? 24 : v <= 32 ? 32
       : v <= 48 ? 48 : v <= 64 ? 64 : v <= 72 ? 72 : 0;
}

// The block's sums of every thread's a and b (each warp by a fixed xor
// butterfly, then the warp sums in index order): the same bits in every
// thread, and for a the bits the forward's thread 0 computes.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();                     // the previous row's sums are read
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    t.x += warp_sum[w].x;
    t.y += warp_sum[w].y;
  }
  return t;
}

// Blocks of one SM a backward launch holds for VPT (the grid is one wave).
constexpr int blocks_per_sm(int vpt) { return vpt == 0 || vpt == 32 ? 1 : vpt == 16 ? 2 : 4; }

// VPT: elements of a row each thread holds in registers (d <= NT * VPT),
// the next row's loaded while this row's sums are reduced (VPT <= 16);
// 0 for wider rows, which are read twice and summed into shared memory.
template <int VPT>
__global__ void __launch_bounds__(NT, blocks_per_sm(VPT))
rms_norm_bwd(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ g, const float* __restrict__ rstd,
             float* __restrict__ dx, float* __restrict__ cluster_part,
             float* __restrict__ dscale, int* __restrict__ tickets, int M, int d, int rows,
             float eps) {
  constexpr int R = VPT > 0 ? VPT : 1;
  constexpr bool AHEAD = VPT > 0 && VPT <= 16;
  extern __shared__ float colsum[];    // [d]: the block's column sums
  __shared__ float2 warp_sum[NT / 32];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows, r1 = min(M, r0 + rows);
  const bool have_r = rstd != nullptr;
  float acc[R], xv[R], gv[R], xn[R], gn[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  if (VPT == 0)
    for (int i = tid; i < d; i += NT) colsum[i] = 0.f;
  if (AHEAD && r0 < r1) {   // the first row
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + j * NT;
      xn[j] = i < d ? x[(size_t)r0 * d + i] : 0.f;
      gn[j] = i < d ? g[(size_t)r0 * d + i] : 0.f;
    }
  }

  for (int m = r0; m < r1; ++m) {
    const float* xr = x + (size_t)m * d;
    const float* gr = g + (size_t)m * d;
    float* dxr = dx + (size_t)m * d;
    float s = 0.f, t = 0.f;
    if (VPT > 0) {
      // AHEAD: this row came with the last one's loop, and the next row's
      // loads are in flight while this one is reduced
      const int mload = AHEAD ? m + 1 : m;
      if constexpr (AHEAD) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          xv[j] = xn[j];
          gv[j] = gn[j];
        }
      }
      if (mload < r1) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = tid + j * NT;
          const float xl = i < d ? x[(size_t)mload * d + i] : 0.f;
          const float gl = i < d ? g[(size_t)mload * d + i] : 0.f;
          if constexpr (AHEAD) {
            xn[j] = xl;
            gn[j] = gl;
          } else {
            xv[j] = xl;
            gv[j] = gl;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + j * NT;
        if (i < d) {
          if (!have_r) s = fmaf(xv[j], xv[j], s);
          t = fmaf(__fmul_rn(gv[j], scale[i]), xv[j], t);
        }
      }
      const float2 st = block_sum2(s, t, warp_sum);
      const float r = have_r ? rstd[m] : rsqrtf(__fdiv_rn(st.x, (float)d) + eps);
      const float c = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), st.y), (float)d);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + j * NT;
        if (i < d) {
          dxr[i] = __fsub_rn(__fmul_rn(r, __fmul_rn(gv[j], scale[i])), __fmul_rn(xv[j], c));
          acc[j] = fmaf(gv[j], __fmul_rn(xv[j], r), acc[j]);
        }
      }
    } else {
      for (int i = tid; i < d; i += NT) {
        const float v = xr[i];
        if (!have_r) s = fmaf(v, v, s);
        t = fmaf(__fmul_rn(gr[i], scale[i]), v, t);
      }
      const float2 st = block_sum2(s, t, warp_sum);
      const float r = have_r ? rstd[m] : rsqrtf(__fdiv_rn(st.x, (float)d) + eps);
      const float c = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(r, r), r), st.y), (float)d);
      for (int i = tid; i < d; i += NT) {
        const float gi = gr[i], xi = xr[i];
        dxr[i] = __fsub_rn(__fmul_rn(r, __fmul_rn(gi, scale[i])), __fmul_rn(xi, c));
        colsum[i] = fmaf(gi, __fmul_rn(xi, r), colsum[i]);
      }
    }
  }
  if (VPT > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (tid + j * NT < d) colsum[tid + j * NT] = acc[j];
  }
  cluster.sync();

  // block rank k: columns [c0, c1) over the cluster's blocks in rank order
  const int rank = (int)cluster.block_rank(), share = (d + CL - 1) / CL;
  const int c0 = min(d, rank * share), c1 = min(d, c0 + share);
  const int cid = blockIdx.x / CL, clusters = gridDim.x / CL;
  for (int i = c0 + tid; i < c1; i += NT) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < CL; ++q) sum += cluster.map_shared_rank(colsum, q)[i];
    cluster_part[(size_t)cid * d + i] = sum;
  }
  __threadfence();
  cluster.sync();                      // no block leaves while another reads its sums
  if (tid == 0) last = atomicAdd(tickets + rank, 1) == clusters - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (d % (4 * CL) == 0) {
    // four columns a thread, every cluster's partial in flight at once
    for (int i = c0 + 4 * tid; i < c1; i += 4 * NT) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int q = 0; q < clusters; ++q) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(cluster_part + (size_t)q * d + i));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<float4*>(dscale + i) = sum;
    }
  } else {
    for (int i = c0 + tid; i < c1; i += NT) {
      float sum = 0.f;
#pragma unroll 16
      for (int q = 0; q < clusters; ++q) sum += __ldcg(cluster_part + (size_t)q * d + i);
      dscale[i] = sum;
    }
  }
  if (tid == 0) tickets[rank] = 0;
}

// The cluster launch of rms_norm_bwd<VPT> (grid blocks x NT threads, d
// floats of dynamic shared memory); the kernel's shared-memory limit is
// raised once, as needed.
template <int VPT>
cudaError_t bwd_config(int blocks, int d, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                       cudaLaunchAttribute* attr) {
  const size_t smem = (size_t)d * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rms_norm_bwd<VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int VPT>
cudaError_t launch_bwd(const float* x, const float* scale, const float* g, const float* rstd,
                       float* dx, float* part, float* dscale, int* tickets, int M, int d,
                       int blocks, int rows, float eps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = bwd_config<VPT>(blocks, d, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, rms_norm_bwd<VPT>, x, scale, g, rstd, dx, part, dscale,
                           tickets, M, d, rows, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int VPT>
int max_clusters(int d) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (bwd_config<VPT>(CL, d, nullptr, cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, rms_norm_bwd<VPT>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// rms_norm_bwd's elements a thread for rows of d: 1, 2, 4, 8, 16, 32, or 0
int vpt_of(int d) {
  const int v = (d + NT - 1) / NT;
  return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : v <= 8 ? 8 : v <= 16 ? 16 : v <= 32 ? 32 : 0;
}

}  // namespace

// The clusters of 8 backward blocks the card holds at once for rows of d
// (on the current device; -1 if it cannot tell): the grid the wrapper
// plans is one wave of them.
extern "C" int rms_norm_backward_max_clusters(int d) {
  if (d < 1 || d > MAX_D) return -1;
  switch (vpt_of(d)) {
    case 1: return max_clusters<1>(d);
    case 2: return max_clusters<2>(d);
    case 4: return max_clusters<4>(d);
    case 8: return max_clusters<8>(d);
    case 16: return max_clusters<16>(d);
    case 32: return max_clusters<32>(d);
    default: return max_clusters<0>(d);
  }
}

// x, g f32 [M, d]; scale f32 [d]; rstd f32 [M] from the forward, or null
// (then recomputed in the forward's order) -> dx f32 [M, d], dscale f32 [d].
// blocks (a multiple of 8) take rows consecutive rows each (blocks * rows
// >= M); part f32 [blocks / 8, d] is scratch; tickets int32 [8] are zero and
// left zero.  One launch.  Returns cudaErrorInvalidValue, launching nothing,
// for dimensions the kernel cannot take.
extern "C" int rms_norm_backward_launch(const void* x, const void* scale, const void* g,
                                        const void* rstd, void* dx, void* dscale, void* part,
                                        void* tickets, int M, int d, int blocks, int rows,
                                        float eps, void* stream) {
  if (M < 1 || d < 1 || d > MAX_D || rows < 1 || blocks < CL || blocks % CL != 0 ||
      (long long)blocks * rows < M)
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  const auto* gp = static_cast<const float*>(g);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<float*>(dx);
  auto* pp = static_cast<float*>(part);
  auto* dsp = static_cast<float*>(dscale);
  auto* tp = static_cast<int*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
#define BWD(V) launch_bwd<V>(xp, sp, gp, rp, dxp, pp, dsp, tp, M, d, blocks, rows, eps, st)
  cudaError_t err;
  switch (vpt_of(d)) {
    case 1: err = BWD(1); break;
    case 2: err = BWD(2); break;
    case 4: err = BWD(4); break;
    case 8: err = BWD(8); break;
    case 16: err = BWD(16); break;
    case 32: err = BWD(32); break;
    default: err = BWD(0);
  }
#undef BWD
  return (int)err;
}

#define FWD_DISPATCH(d, CALL)  \
  switch (fwd_vpt(d)) {        \
    case 4: CALL(4); break;    \
    case 8: CALL(8); break;    \
    case 12: CALL(12); break;  \
    case 16: CALL(16); break;  \
    case 24: CALL(24); break;  \
    case 32: CALL(32); break;  \
    case 48: CALL(48); break;  \
    case 64: CALL(64); break;  \
    case 72: CALL(72); break;  \
    default: CALL(0);          \
  }

// x f32 [M, d] -> h f32 [M, d] (rms_norm_launch's bits), codes int8 [M, d]
// and row_scale f32 [M]: the per-row int8 quantization of h.  One launch.
extern "C" int rms_norm_quant_launch(const void* x, const void* scale, void* out,
                                     void* codes, void* row_scale, int M, int d, float eps,
                                     void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  auto* qp = static_cast<signed char*>(codes);
  auto* rp = static_cast<float*>(row_scale);
#define QUANT(V) rms_norm_quant_kernel<V><<<M, NT, 0, st>>>(xp, sp, op, qp, rp, d, eps)
  FWD_DISPATCH(d, QUANT)
#undef QUANT
  return (int)cudaGetLastError();
}

// x f32 [M, d] -> out f32 [M, d]; scale f32 [d]; rstd f32 [M] receives each
// row's rsqrt when not null.  One launch.
extern "C" int rms_norm_launch(const void* x, const void* scale, void* out, void* rstd,
                               int M, int d, float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  auto* rp = static_cast<float*>(rstd);
#define PLAIN(V) rms_norm_kernel<V><<<M, NT, 0, st>>>(xp, sp, op, rp, d, eps)
  FWD_DISPATCH(d, PLAIN)
#undef PLAIN
  return (int)cudaGetLastError();
}
