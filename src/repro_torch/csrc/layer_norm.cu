// LayerNorm with row-invariant reductions, CUDA C++ for sm_90a.
//
// Not the port of a TPU kernel: the reference computes the norm in jnp
// (src/repro/models/layers.py apply_norm, the "bias" branch) and leaves it
// to XLA.  It is a kernel here for the reason csrc/rms_norm.cu is one: a
// library reduction (torch's mean and var) sums a row in an order that
// depends on how many rows the call holds, so a verify window of B*T rows
// and a decode step of B rows would normalise the same row to different
// last bits -- enough to flip an int8 activation code downstream.  It has
// its own source beside rms_norm.cu so that each norm stays one short file,
// built and loaded like every other kernel.
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
// contraction), as the plain version rounds it.  The forward writes each
// row's mean and r = rsqrt(var + eps) when the pointers are not null (the
// training path saves them for the backward; serving passes null); the
// output's bits do not depend on it.
//
// The forward's design (layer_norm_row): a thread loads its elements of x,
// scale and bias once, as independent loads, into registers (up to 32 a
// thread, d 8192; OPT-30B's 7168 is 28 a thread; wider rows re-read from
// L1 / L2).  The mean, the sum of squared deviations (from registers) and,
// in the fused entry, the amax each take one barrier on their own shared
// array, so a row is read from memory once and costs two barriers (three
// fused), where a block reduction that reuses one array costs two each.
// What bounds it on the H100: it reads each row and writes it once (8 bytes
// per element) and does a handful of flops per element, far below the
// ridge point: bytes.  At the decode shapes (4 rows of 7168) a call is a
// few microseconds of launch latency and one trip to memory.
//
// The forward fused with the per-row int8 quantizer (layer_norm_quant_kernel;
// it replaces no TPU kernel: the reference quantizes every linear's input
// in jnp, core/quant.py quantize_activation).  Where a LayerNorm's output
// feeds quantized linears (OPT's ln1 and ln2, whisper's decoder ln1, ln_x
// and ln2) the serve path would otherwise run the quantizer after the norm,
// eight torch kernels.  This entry runs the forward's body and then the
// quantizer of norm_quant.cuh on the h in registers: h the unfused entry's
// bits, the codes and scales quantize_activation(h)'s.  Bound: bytes (x
// read, h and q written, 9 bytes an element).
//
// The backward (the training path's gradient through the norm; the
// reference leaves it to XLA's autodiff of the jnp norm), with
// xhat = (x - mean) * r and gs = g * scale:
//
//   dx[m, i]   = r * ((gs[m, i] - sum_i gs / d) - xhat[m, i] * (sum_i gs * xhat / d)),
//   dscale[i]  = sum_m g[m, i] * xhat[m, i],    dbias[i] = sum_m g[m, i],
//
// mean and r the forward's (saved, or recomputed in the forward's order:
// the same bits).  Bound: bytes (x and g read once, dx written once).  One
// launch, in clusters of CL blocks, each block a fixed range of
// consecutive rows:
// - rows of d <= 1024 (opt-125m's and whisper's 768): a warp a row, each
//   lane holding its K = d / 32 elements (i = lane, lane + 32, ...) of x
//   and g in registers; the row's two sums fold by a fixed xor butterfly
//   with no block barrier, and the block's 8 warps take rows r0 + w,
//   r0 + w + 8, ... at once.  Without saved stats a lane splits its
//   elements by the forward's warp (i % 256 / 32) and each split folds by
//   the forward's butterfly, so mean and var come out in the forward's
//   order.  Each warp adds its rows' g * xhat and g to its columns in row
//   order in registers; the block adds its warps' column sums in warp order
//   in shared memory;
// - wider rows: a block a row, each thread holding its elements t,
//   t + 256, ... (up to 32; past d 8192 re-read from L1 / L2), the sums by
//   the forward's block reduction, the column sums in registers (past 8192
//   in shared memory);
// - the cluster's blocks meet in distributed shared memory: block rank k
//   adds the CL blocks' column sums of its share of the 2 d columns
//   (dscale's, then dbias's) in rank order into the cluster's partial;
// - the block of rank k that brings ticket k to the number of clusters (an
//   integer ticket, reset by that block) adds every cluster's partial of
//   its share in cluster order into dparams.
// Every sum has one order for a given M and grid, with no float atomics, so
// the gradient is the same bits on every run and every graph replay.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "norm_quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int CL = 8;          // blocks of a backward cluster
constexpr int MAX_D = 24576;   // a backward block's column sums fit its shared memory

// The block's sum of every thread's ``s``, the same bits in every thread
// and the forward's row_sum bits.  ``warp_sum`` is shared; the leading
// barrier lets the backward's next call (its next sum or row) reuse it.
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

// The block's sums of every thread's a and b, as block_sum folds each.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    t.x += warp_sum[w].x;
    t.y += warp_sum[w].y;
  }
  return t;
}

// A warp's sum of every lane's s by the forward's butterfly, in every lane.
__device__ __forceinline__ float warp_fold(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The forward's body, one block a row, behind both entries.  V: elements
// of the row each thread holds in registers (d <= NT V) with their scale
// and bias, loaded at once as independent loads; 0 for wider rows, which
// are read again from L1 / L2.  The mean, the sum of squared deviations
// (from registers) and (QUANT) the amax each take one barrier on their own
// shared array; h is computed and stored from registers, and the codes
// come from the same registers (norm_quant.cuh).  mean_out and rstd_out
// receive the row's statistics where not null.
template <int V, bool QUANT>
__device__ __forceinline__ void layer_norm_row(const float* __restrict__ x,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias,
                                               float* __restrict__ out,
                                               float* __restrict__ mean_out,
                                               float* __restrict__ rstd_out,
                                               signed char* __restrict__ codes,
                                               float* __restrict__ row_scale_out, int d,
                                               float eps) {
  __shared__ float warp_sum[WARPS], warp_sq[WARPS], warp_max[WARPS];
  constexpr int R = V > 0 ? V : 1;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * d;
  const float* xr = x + base;
  float* orow = out + base;
  const float fd = (float)d;
  float xv[R], sc[R], bi[R];
  float s = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + NT * j;
      xv[j] = i < d ? xr[i] : 0.f;
      sc[j] = i < d ? __ldg(scale + i) : 0.f;
      bi[j] = i < d ? __ldg(bias + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (tid + NT * j < d) s += xv[j];
  } else {
    for (int i = tid; i < d; i += NT) s += xr[i];
  }
  const float mean = __fdiv_rn(row_sum<WARPS>(s, warp_sum), fd);
  s = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (tid + NT * j < d) {
        const float dev = __fsub_rn(xv[j], mean);
        s = fmaf(dev, dev, s);
      }
    }
  } else {
    for (int i = tid; i < d; i += NT) {
      const float dev = __fsub_rn(xr[i], mean);
      s = fmaf(dev, dev, s);
    }
  }
  const float var = __fdiv_rn(row_sum<WARPS>(s, warp_sq), fd);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (mean_out != nullptr && tid == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = r;
  }
  float amax = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + NT * j;
      if (i < d) {
        xv[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv[j], mean), r), sc[j]), bi[j]);
        orow[i] = xv[j];                                   // h from here on
        amax = fmaxf(amax, fabsf(xv[j]));
      }
    }
  } else {
    for (int i = tid; i < d; i += NT) {
      const float h =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[i], mean), r), scale[i]), bias[i]);
      orow[i] = h;
      amax = fmaxf(amax, fabsf(h));
    }
  }
  if constexpr (QUANT) {
    signed char* qrow = codes + base;
    const float qs = row_scale<WARPS>(amax, warp_max);
    if (tid == 0) row_scale_out[blockIdx.x] = qs;
    const float y = __frcp_rn(qs);
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + NT * j;
        if (i < d) qrow[i] = code(xv[j], qs, y);
      }
    } else {
      // h again from x (L1 / L2 hits, the same bits as the pass above)
      for (int i = tid; i < d; i += NT)
        qrow[i] = code(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[i], mean), r), scale[i]), bias[i]),
            qs, y);
    }
  }
}

// The unfused entry: h, and each row's mean and r where the pointers are
// not null.
template <int V>
__global__ void __launch_bounds__(NT)
layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out, int d,
                  float eps) {
  layer_norm_row<V, false>(x, scale, bias, out, mean_out, rstd_out, nullptr, nullptr, d, eps);
}

// The entry fused with the quantizer: h, its codes and its row scales.
template <int V>
__global__ void __launch_bounds__(NT)
layer_norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, float* __restrict__ out,
                        signed char* __restrict__ codes, float* __restrict__ row_scales,
                        int d, float eps) {
  layer_norm_row<V, true>(x, scale, bias, out, nullptr, nullptr, codes, row_scales, d, eps);
}

// The forward's elements a thread for rows of d (0: re-read); 28 is
// OPT-30B's d 7168 with no idle slot.
int fwd_vpt(int d) {
  const int v = (d + NT - 1) / NT;
  return v <= 4 ? 4 : v <= 8 ? 8 : v <= 12 ? 12 : v <= 16 ? 16 : v <= 24 ? 24 : v <= 28 ? 28
       : v <= 32 ? 32 : 0;
}

#define LN_FWD_DISPATCH(d, CALL)  \
  switch (fwd_vpt(d)) {           \
    case 4: CALL(4); break;       \
    case 8: CALL(8); break;       \
    case 12: CALL(12); break;     \
    case 16: CALL(16); break;     \
    case 24: CALL(24); break;     \
    case 28: CALL(28); break;     \
    case 32: CALL(32); break;     \
    default: CALL(0);             \
  }

struct BwdArgs {
  const float* x;
  const float* scale;
  const float* g;
  const float* mean;   // [M] from the forward, or null
  const float* rstd;   // [M], null with mean
  float* dx;
  float* part;         // [clusters, 2 d]
  float* dparams;      // [2, d]
  int* tickets;        // [CL]
  int M, d, rows;
  float eps;
};

// A warp a row, K elements a lane (d <= 32 K); the block's column sums of
// dscale (colsum[0, d)) and dbias (colsum[d, 2 d)) land in smem[0, 2 d).
// smem holds WARPS * 2 d floats.
template <int K>
__device__ __forceinline__ void warp_rows(const BwdArgs& a, float* smem) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, d = a.d;
  const int r0 = blockIdx.x * a.rows, r1 = min(a.M, r0 + a.rows);
  const float fd = (float)d;
  float ds[K], db[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ds[k] = db[k] = 0.f;
  for (int m = r0 + warp; m < r1; m += WARPS) {
    const float* xr = a.x + (size_t)m * d;
    const float* gr = a.g + (size_t)m * d;
    float xv[K], gv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      xv[k] = i < d ? xr[i] : 0.f;
      gv[k] = i < d ? gr[i] : 0.f;
    }
    float mean, r;
    if (a.mean != nullptr) {
      mean = a.mean[m];
      r = a.rstd[m];
    } else {
      // the forward's order: element i = lane + 32 k is thread i % 256 of
      // forward warp k % 8; each warp's partial folds by the same butterfly
      float p[WARPS];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) p[w] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < d) p[k % WARPS] += xv[k];
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += warp_fold(p[w]);
      mean = __fdiv_rn(t, fd);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) p[w] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lane + 32 * k < d) {
          const float dev = __fsub_rn(xv[k], mean);
          p[k % WARPS] = fmaf(dev, dev, p[k % WARPS]);
        }
      }
      t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += warp_fold(p[w]);
      r = rsqrtf(__fadd_rn(__fdiv_rn(t, fd), a.eps));
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < d) {
        const float gs = __fmul_rn(gv[k], __ldg(a.scale + i));
        xv[k] = __fmul_rn(__fsub_rn(xv[k], mean), r);      // xhat from here on
        sa += gs;
        sb = fmaf(gs, xv[k], sb);
      }
    }
    const float ra = __fdiv_rn(warp_fold(sa), fd);
    const float rb = __fdiv_rn(warp_fold(sb), fd);
    float* dxr = a.dx + (size_t)m * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < d) {
        const float gs = __fmul_rn(gv[k], __ldg(a.scale + i));
        dxr[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(gs, ra), __fmul_rn(xv[k], rb)));
        ds[k] = fmaf(gv[k], xv[k], ds[k]);
        db[k] += gv[k];
      }
    }
  }
  float* mine = smem + (size_t)warp * 2 * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < d) {
      mine[i] = ds[k];
      mine[d + i] = db[k];
    }
  }
  __syncthreads();
  // warp by warp; thread t alone reads and writes its columns
  for (int c = threadIdx.x; c < 2 * d; c += NT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += smem[(size_t)w * 2 * d + c];
    smem[c] = v;
  }
}

// A block a row, V elements a thread (d <= NT V; V == 0: the row re-read,
// the column sums kept in shared memory); the block's column sums land in
// smem[0, 2 d).
template <int V>
__device__ __forceinline__ void block_rows(const BwdArgs& a, float* smem) {
  __shared__ float wsum[WARPS];
  __shared__ float2 wsum2[WARPS];
  constexpr int R = V > 0 ? V : 1;
  const int tid = threadIdx.x, d = a.d;
  const int r0 = blockIdx.x * a.rows, r1 = min(a.M, r0 + a.rows);
  const float fd = (float)d;
  float ds[R], db[R], xv[R], gv[R];
#pragma unroll
  for (int j = 0; j < R; ++j) ds[j] = db[j] = 0.f;
  if (V == 0) {
    for (int i = tid; i < 2 * d; i += NT) smem[i] = 0.f;
    __syncthreads();
  }
  for (int m = r0; m < r1; ++m) {
    const float* xr = a.x + (size_t)m * d;
    const float* gr = a.g + (size_t)m * d;
    float* dxr = a.dx + (size_t)m * d;
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + NT * j;
        xv[j] = i < d ? xr[i] : 0.f;
        gv[j] = i < d ? gr[i] : 0.f;
      }
    }
    float mean, r;
    if (a.mean != nullptr) {
      mean = a.mean[m];
      r = a.rstd[m];
    } else {        // the forward's order, its block_sum
      float s = 0.f;
      if constexpr (V > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (tid + NT * j < d) s += xv[j];
      } else {
        for (int i = tid; i < d; i += NT) s += xr[i];
      }
      mean = __fdiv_rn(block_sum(s, wsum), fd);
      s = 0.f;
      if constexpr (V > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (tid + NT * j < d) {
            const float dev = __fsub_rn(xv[j], mean);
            s = fmaf(dev, dev, s);
          }
        }
      } else {
        for (int i = tid; i < d; i += NT) {
          const float dev = __fsub_rn(xr[i], mean);
          s = fmaf(dev, dev, s);
        }
      }
      r = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(s, wsum), fd), a.eps));
    }
    float sa = 0.f, sb = 0.f;
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + NT * j;
        if (i < d) {
          const float gs = __fmul_rn(gv[j], __ldg(a.scale + i));
          xv[j] = __fmul_rn(__fsub_rn(xv[j], mean), r);    // xhat from here on
          sa += gs;
          sb = fmaf(gs, xv[j], sb);
        }
      }
    } else {
      for (int i = tid; i < d; i += NT) {
        const float gs = __fmul_rn(gr[i], __ldg(a.scale + i));
        sa += gs;
        sb = fmaf(gs, __fmul_rn(__fsub_rn(xr[i], mean), r), sb);
      }
    }
    const float2 ab = block_sum2(sa, sb, wsum2);
    const float ra = __fdiv_rn(ab.x, fd), rb = __fdiv_rn(ab.y, fd);
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = tid + NT * j;
        if (i < d) {
          const float gs = __fmul_rn(gv[j], __ldg(a.scale + i));
          dxr[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(gs, ra), __fmul_rn(xv[j], rb)));
          ds[j] = fmaf(gv[j], xv[j], ds[j]);
          db[j] += gv[j];
        }
      }
    } else {
      for (int i = tid; i < d; i += NT) {
        const float gi = gr[i];
        const float gs = __fmul_rn(gi, __ldg(a.scale + i));
        const float xh = __fmul_rn(__fsub_rn(xr[i], mean), r);
        dxr[i] = __fmul_rn(r, __fsub_rn(__fsub_rn(gs, ra), __fmul_rn(xh, rb)));
        smem[i] = fmaf(gi, xh, smem[i]);
        smem[d + i] += gi;
      }
    }
  }
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = tid + NT * j;
      if (i < d) {
        smem[i] = ds[j];
        smem[d + i] = db[j];
      }
    }
  }
}

// Blocks of one SM a backward launch asks room for (the grid is one wave).
constexpr int bwd_min_blocks(int k, int v) { return k == 32 || v == 32 ? 1 : 2; }

// K > 0: a warp a row (warp_rows<K>); K == 0: a block a row (block_rows<V>).
template <int K, int V>
__global__ void __launch_bounds__(NT, bwd_min_blocks(K, V))
layer_norm_bwd(BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (K > 0) {
    warp_rows<K>(a, smem);
  } else {
    block_rows<V>(a, smem);
  }
  cluster.sync();

  // block rank k: its share of the 2 d columns over the cluster's blocks in
  // rank order
  const int tid = threadIdx.x, n = 2 * a.d;
  const int rank = (int)cluster.block_rank(), share = (n + CL - 1) / CL;
  const int c0 = min(n, rank * share), c1 = min(n, c0 + share);
  const int cid = blockIdx.x / CL, clusters = gridDim.x / CL;
  for (int c = c0 + tid; c < c1; c += NT) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < CL; ++q) sum += cluster.map_shared_rank(smem, q)[c];
    a.part[(size_t)cid * n + c] = sum;
  }
  __threadfence();
  cluster.sync();                      // no block leaves while another reads its sums
  if (tid == 0) last = atomicAdd(a.tickets + rank, 1) == clusters - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (n % (4 * CL) == 0) {
    // four columns a thread, every cluster's partial in flight at once
    for (int c = c0 + 4 * tid; c < c1; c += 4 * NT) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int q = 0; q < clusters; ++q) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a.part + (size_t)q * n + c));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<float4*>(a.dparams + c) = sum;
    }
  } else {
    for (int c = c0 + tid; c < c1; c += NT) {
      float sum = 0.f;
#pragma unroll 16
      for (int q = 0; q < clusters; ++q) sum += __ldcg(a.part + (size_t)q * n + c);
      a.dparams[c] = sum;
    }
  }
  if (tid == 0) a.tickets[rank] = 0;
}

// Dynamic shared memory of a backward block: its warps' column sums, or
// the block's.
size_t bwd_smem(int k, int d) { return (size_t)(k > 0 ? WARPS : 1) * 2 * d * sizeof(float); }

// The cluster launch of layer_norm_bwd<K, V> (grid blocks x NT threads);
// the kernel's dynamic shared-memory limit is set on the first call and
// raised as needed (48 KB of dynamic memory and the static bytes beside it
// already need it).
template <int K, int V>
cudaError_t bwd_config(int blocks, int d, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                       cudaLaunchAttribute* attr) {
  const size_t smem = bwd_smem(K, d);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        layer_norm_bwd<K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <int K, int V>
cudaError_t launch_bwd(const BwdArgs& a, int blocks, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = bwd_config<K, V>(blocks, a.d, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, layer_norm_bwd<K, V>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int K, int V>
int max_clusters(int d) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (bwd_config<K, V>(CL, d, nullptr, cfg, attr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, layer_norm_bwd<K, V>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// The backward's instance for rows of d: 1-5 a warp a row (K 4, 8, 16,
// 24, 32), 6-9 a block a row (V 8, 16, 32, 0)
int plan_of(int d) {
  return d <= 128 ? 1 : d <= 256 ? 2 : d <= 512 ? 3 : d <= 768 ? 4 : d <= 1024 ? 5
       : d <= 2048 ? 6 : d <= 4096 ? 7 : d <= 8192 ? 8 : 9;
}

#define LN_BWD_DISPATCH(plan, CALL)  \
  switch (plan) {                    \
    case 1: CALL(4, 0); break;       \
    case 2: CALL(8, 0); break;       \
    case 3: CALL(16, 0); break;      \
    case 4: CALL(24, 0); break;      \
    case 5: CALL(32, 0); break;      \
    case 6: CALL(0, 8); break;       \
    case 7: CALL(0, 16); break;      \
    case 8: CALL(0, 32); break;      \
    default: CALL(0, 0);             \
  }

}  // namespace

// The clusters of CL backward blocks the card holds at once for rows of d
// (on the current device; -1 if it cannot tell): the grid the wrapper
// plans is one wave of them.
extern "C" int layer_norm_backward_max_clusters(int d) {
  if (d < 1 || d > MAX_D) return -1;
  int n = -1;
#define MAXC(K, V) n = max_clusters<K, V>(d)
  LN_BWD_DISPATCH(plan_of(d), MAXC)
#undef MAXC
  return n;
}

// x, g f32 [M, d]; scale f32 [d]; mean, rstd f32 [M] from the forward, or
// both null (then recomputed in the forward's order) -> dx f32 [M, d],
// dparams f32 [2, d] (dscale, then dbias).  blocks (a multiple of CL) take
// rows consecutive rows each (blocks * rows >= M); part f32
// [blocks / CL, 2 d] is scratch; tickets int32 [CL] are zero and left zero.
// One launch.  Returns cudaErrorInvalidValue, launching nothing, for
// dimensions the kernel cannot take.
extern "C" int layer_norm_backward_launch(const void* x, const void* scale, const void* g,
                                          const void* mean, const void* rstd, void* dx,
                                          void* dparams, void* part, void* tickets, int M,
                                          int d, int blocks, int rows, float eps,
                                          void* stream) {
  if (M < 1 || d < 1 || d > MAX_D || rows < 1 || blocks < CL || blocks % CL != 0 ||
      (long long)blocks * rows < M || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const float*>(x);
  a.scale = static_cast<const float*>(scale);
  a.g = static_cast<const float*>(g);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.dx = static_cast<float*>(dx);
  a.part = static_cast<float*>(part);
  a.dparams = static_cast<float*>(dparams);
  a.tickets = static_cast<int*>(tickets);
  a.M = M;
  a.d = d;
  a.rows = rows;
  a.eps = eps;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define LAUNCH(K, V) err = launch_bwd<K, V>(a, blocks, st)
  LN_BWD_DISPATCH(plan_of(d), LAUNCH)
#undef LAUNCH
  return (int)err;
}

// x f32 [M, d] -> out f32 [M, d]; scale, bias f32 [d]; mean and rstd f32
// [M] receive each row's mean and rsqrt(var + eps) when not null.  One
// launch.
extern "C" int layer_norm_launch(const void* x, const void* scale, const void* bias,
                                 void* out, void* mean, void* rstd, int M, int d, float eps,
                                 void* stream) {
  if (M < 1 || d < 1 || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* mp = static_cast<float*>(mean);
  auto* rp = static_cast<float*>(rstd);
#define PLAIN(V) layer_norm_kernel<V><<<M, NT, 0, st>>>(xp, sp, bp, op, mp, rp, d, eps)
  LN_FWD_DISPATCH(d, PLAIN)
#undef PLAIN
  return (int)cudaGetLastError();
}

// x f32 [M, d] -> h f32 [M, d] (layer_norm_launch's bits), codes int8
// [M, d] and row_scale f32 [M]: the per-row int8 quantization of h.  One
// launch.
extern "C" int layer_norm_quant_launch(const void* x, const void* scale, const void* bias,
                                       void* out, void* codes, void* row_scale, int M, int d,
                                       float eps, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  auto* qp = static_cast<signed char*>(codes);
  auto* rp = static_cast<float*>(row_scale);
#define QUANT(V) layer_norm_quant_kernel<V><<<M, NT, 0, st>>>(xp, sp, bp, op, qp, rp, d, eps)
  LN_FWD_DISPATCH(d, QUANT)
#undef QUANT
  return (int)cudaGetLastError();
}
