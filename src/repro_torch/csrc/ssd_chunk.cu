// B6: the Mamba2 SSD intra-chunk step, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (ssd_chunk_pallas / _kernel).  Per (n, head), over one chunk of Q steps:
//
//   cs    = cumsum(dt * A)                                   [Q]
//   xdt   = x * dt                                           [Q, dh]
//   y[q]  = sum_{k<=q} (C[q].B[k]) * exp(cs[q] - cs[k]) * xdt[k]
//           + (C[q] * exp(cs[q])) . h_in  +  D * x[q]        [Q, dh]
//   S_out = sum_k (B[k] * exp(cs[Q-1] - cs[k])) (x) xdt[k]   [dh, S]
//   decay = exp(cs[Q-1])
//
// What bounds it on the H100: at the full-width shapes (Q 128, S 128, dh 64)
// one (n, head) needs about 7.4 M flops (the products over the causal
// triangle k <= q) on about 260 KB of operands, some 28 flops a byte, above
// the f32 ridge point (67 TFLOP/s over 3.35 TB/s, 20): f32 FMA outside the
// tensor cores sets the bound.  TF32 tensor cores would be faster but keep a 10-bit mantissa,
// which cannot hold the reference's own tolerance (rtol 2e-4, atol 2e-5);
// 3xTF32 or wgmma is later work.
//
// What the design does: one block of NT threads per (n, head) holds the
// chunk's B, x*dt and h_in in shared memory (about 150 KB at the full-width
// shapes, so the launch raises the block's dynamic shared-memory limit),
// and walks the query rows in tiles of QT: a tile of C, its masked decay
// scores against every key k <= q, then its y rows.  The chunk state comes
// last, from B scaled by its decay weights in place.  Rows are padded by one
// float so that threads walking neighbouring rows hit distinct banks.
//
// The mask *selects* 0 for k > q, as the reference's jnp.where does:
// exp(cs[q] - cs[k]) there may be inf, and inf * 0 would be NaN.  The
// cumsum runs sequentially in f64 and is rounded to f32 once per step; the
// plain version sums in f64 too, so both share cs (and the decay) bit for
// bit, while the reference sums in f32 in XLA's order: within its tolerance.
// Every other stage differs from the plain version only in f32 summation
// order.  Q takes any value from 1 up (the engine prefills at exact length).
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int QT = 16;            // query rows per tile
constexpr size_t MAX_SMEM = 232448;

size_t smem_floats(int Q, int dh, int S) {
  const size_t SP = S + 1, DP = dh + 1, QP = Q + 1;
  return 4 * (size_t)Q + Q * SP + Q * DP + dh * SP + QT * SP + QT * QP;
}

__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ Bg,
                 const float* __restrict__ Cg, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Dv,
                 const float* __restrict__ h_in, float* __restrict__ y,
                 float* __restrict__ s_out, float* __restrict__ decay, int Q,
                 int H, int dh, int S) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int SP = S + 1, DP = dh + 1, QP = Q + 1;
  float* cs = sm;                 // [Q]       cumsum(dt * A)
  float* dts = cs + Q;            // [Q]       dt
  float* ecs = dts + Q;           // [Q]       exp(cs)
  float* wk = ecs + Q;            // [Q]       exp(cs[Q-1] - cs)
  float* Bs = wk + Q;             // [Q][SP]   B, later B * wk
  float* xd = Bs + Q * SP;        // [Q][DP]   x * dt
  float* hs = xd + Q * DP;        // [dh][SP]  h_in
  float* Ct = hs + dh * SP;       // [QT][SP]  a tile of C
  float* sc = Ct + QT * SP;       // [QT][QP]  the tile's masked scores

  // offset of element (n, q, h, 0) in an [N, Q, H, W] tensor
  auto at = [&](int q, int W) { return (((size_t)n * Q + q) * H + h) * W; };

  for (int q = tid; q < Q; q += NT) dts[q] = dt[((size_t)n * Q + q) * H + h];
  __syncthreads();
  if (tid == 0) {
    const float a = A[h];
    double c = 0.0;
    for (int q = 0; q < Q; ++q) {
      c += (double)__fmul_rn(dts[q], a);
      cs[q] = (float)c;
    }
  }
  for (int i = tid; i < Q * S; i += NT) {
    const int q = i / S, s = i - q * S;
    Bs[q * SP + s] = Bg[at(q, S) + s];
  }
  for (int i = tid; i < Q * dh; i += NT) {
    const int q = i / dh, d = i - q * dh;
    xd[q * DP + d] = __fmul_rn(x[at(q, dh) + d], dts[q]);
  }
  const float* hn = h_in + ((size_t)n * H + h) * dh * S;
  for (int i = tid; i < dh * S; i += NT) {
    const int d = i / S, s = i - d * S;
    hs[d * SP + s] = hn[i];
  }
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int q = tid; q < Q; q += NT) {
    ecs[q] = expf(cs[q]);
    wk[q] = expf(__fsub_rn(cl, cs[q]));
  }
  if (tid == 0) decay[(size_t)n * H + h] = expf(cl);
  __syncthreads();

  const float Dh = Dv[h];
  for (int q0 = 0; q0 < Q; q0 += QT) {
    const int qn = min(QT, Q - q0), kmax = q0 + qn;
    for (int i = tid; i < qn * S; i += NT) {
      const int r = i / S, s = i - r * S;
      Ct[r * SP + s] = Cg[at(q0 + r, S) + s];
    }
    __syncthreads();
    // scores[r][k] = (C[q].B[k]) * exp(cs[q] - cs[k]) for k <= q, else 0
    for (int i = tid; i < qn * kmax; i += NT) {
      const int r = i / kmax, k = i - r * kmax, q = q0 + r;
      float v = 0.f;
      if (k <= q) {
        const float* cr = Ct + r * SP;
        const float* br = Bs + k * SP;
        float dot = 0.f;
        for (int s = 0; s < S; ++s) dot = fmaf(cr[s], br[s], dot);
        v = __fmul_rn(dot, expf(__fsub_rn(cs[q], cs[k])));
      }
      sc[r * QP + k] = v;
    }
    __syncthreads();
    for (int i = tid; i < qn * dh; i += NT) {
      const int r = i / dh, d = i - r * dh, q = q0 + r;
      const float* sr = sc + r * QP;
      float intra = 0.f;
      for (int k = 0; k <= q; ++k) intra = fmaf(sr[k], xd[k * DP + d], intra);
      const float* cr = Ct + r * SP;
      const float* hr = hs + d * SP;
      const float e = ecs[q];
      float inter = 0.f;
      for (int s = 0; s < S; ++s) inter = fmaf(__fmul_rn(cr[s], e), hr[s], inter);
      const size_t o = at(q, dh) + d;
      y[o] = __fadd_rn(__fadd_rn(intra, inter), __fmul_rn(Dh, x[o]));
    }
    __syncthreads();
  }

  // the chunk state: S_out[d][s] = sum_k (B[k][s] * wk[k]) * xdt[k][d]
  for (int i = tid; i < Q * S; i += NT) {
    const int k = i / S, s = i - k * S;
    Bs[k * SP + s] = __fmul_rn(Bs[k * SP + s], wk[k]);
  }
  __syncthreads();
  float* so = s_out + ((size_t)n * H + h) * dh * S;
  for (int i = tid; i < dh * S; i += NT) {
    const int d = i / S, s = i - d * S;
    float acc = 0.f;
    for (int k = 0; k < Q; ++k) acc = fmaf(Bs[k * SP + s], xd[k * DP + d], acc);
    so[i] = acc;
  }
}

}  // namespace

// x f32 [N,Q,H,dh]; B, C f32 [N,Q,H,S]; dt f32 [N,Q,H]; A, D f32 [H];
// h_in f32 [N,H,dh,S] -> y f32 [N,Q,H,dh], s_out f32 [N,H,dh,S],
// decay f32 [N,H].  Returns cudaErrorInvalidValue, launching nothing, for an
// empty shape, N > 65535 or operands that overflow one block's shared memory.
extern "C" int ssd_chunk_launch(const void* x, const void* B, const void* C,
                                const void* dt, const void* A, const void* D,
                                const void* h_in, void* y, void* s_out,
                                void* decay, int N, int Q, int H, int dh, int S,
                                void* stream) {
  const size_t smem = smem_floats(Q, dh, S) * sizeof(float);
  if (N < 1 || Q < 1 || H < 1 || dh < 1 || S < 1 || N > 65535 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  static size_t smem_set = 0;     // the largest limit asked for so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  ssd_chunk_kernel<<<dim3(H, N), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_in), static_cast<float*>(y),
      static_cast<float*>(s_out), static_cast<float*>(decay), Q, H, dh, S);
  return (int)cudaGetLastError();
}
