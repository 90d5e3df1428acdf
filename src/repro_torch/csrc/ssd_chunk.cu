// B6: the Mamba2 SSD intra-chunk step, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (ssd_chunk_pallas / _kernel).  Per (n, head h of group g(h)), over one
// chunk of Q steps:
//
//   cs    = cumsum(dt * A)                                   [Q]
//   xdt   = x * dt                                           [Q, dh]
//   G     = C . B^T   (per group: the same for every head)   [Q, Q]
//   y[q]  = sum_{k<=q} G[q,k] * exp(cs[q] - cs[k]) * xdt[k]
//           + exp(cs[q]) * (C[q] . h_in)  +  D * x[q]        [Q, dh]
//   S_out = sum_k (B[k] * exp(cs[Q-1] - cs[k])) (x) xdt[k]   [dh, S]
//   decay = exp(cs[Q-1])
//
// What bounds it on the H100: at the full-width shapes (Q 128, S 128, dh 64,
// 80 heads of one group) a head needs about 7.4 M f32 operations over the
// causal triangle on about 260 KB of per-head operands, above the ridge
// point of f32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s, 20
// flops a byte): operations set the bound.  TF32 tensor cores alone keep a
// 10-bit mantissa, which cannot hold the reference's tolerance (rtol 2e-4,
// atol 2e-5).
//
// What the design does:
// - 3xTF32 on the tensor cores for all four products (scores C.B^T, intra
//   y, inter C.h_in and the state): each operand splits into hi + lo with
//   cvt.rna.tf32.f32, and mma.sync m16n8k8 takes lo*hi + hi*lo + hi*hi in
//   f32 accumulators, about f32 accuracy.  Each warp holds a register tile
//   of 2-8 mma tiles, so a fragment read from shared memory feeds two to
//   eight mma.
// - Group-shared scores: B and C come per group ([N, Q, G, S]); a y block
//   computes the tile C[q0:q0+32] . B[0:q0+32]^T once, keeps it in
//   registers, and applies it to up to four heads of that group, each with
//   its own decay.
// - Small work items: a y block covers (n, up to 4 heads, 32 query rows),
//   a state block (n, head, 64 state columns), all in one launch; a y block
//   takes fewer heads where that is needed for two y blocks an SM.  At N 4 /
//   Q 128 that is 320 y blocks and 640 state blocks, at N 1 / Q 37 160 and
//   160.  A block takes at most about 108 KB of shared memory, so two fit
//   on an SM.  Operands arrive by cp.async (16 bytes where rows allow), all
//   of a tile's copies in flight at once.  Rows and columns past Q, dh and
//   S are zero in shared memory, so every tile is whole; strides are padded
//   so that fragment reads hit 32 distinct banks.
//
// The mask *selects* 0 for k > q, as the reference's jnp.where does:
// exp(cs[q] - cs[k]) there may be inf, and inf * 0 would be NaN.  The
// cumsum runs sequentially in f64 and is rounded to f32 once per step; the
// plain version sums in f64 too, so both share cs (and the decay) bit for
// bit.  Q takes any value from 1 to 128, dh up to 64 (the engine prefills
// at exact length).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 128;           // threads per block: four warps
constexpr int QT = 32;            // query rows per y block (two m16 tiles)
constexpr int HB_MAX = 4;         // heads per y block, sharing one score tile
constexpr int SH = 64;            // state columns per state block
constexpr int DMAX = 64;          // largest head dim: four warps x 16
constexpr int QMAX = 128;         // longest chunk: four warps x 32 keys
constexpr int LDX = DMAX + 8;     // row stride of [k][d] and [k][s] tiles
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ inline int rup(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

struct Dims {
  int N, Q, H, G, dh, S;
  int hb;         // heads per y block (divides H / G)
  int nqt, nsh;   // query tiles, state-column tiles
  int n_y;        // y blocks (the rest are state blocks)
  int Qp, Sp;     // Q and S rounded up to 8
  int LS, LK;     // row strides of [.][s] and [q][k] tiles
  bool vec;       // 16-byte copies: S and dh multiples of 4, operands aligned
};

size_t y_smem_floats(const Dims& d) {
  const size_t u = (size_t)imax(d.Qp * d.LS, d.Qp * LDX + DMAX * d.LS);
  return 2 * (size_t)rup(HB_MAX * d.Q, 4) + (size_t)QT * d.LS + u + (size_t)QT * d.LK;
}

size_t s_smem_floats(const Dims& d) {
  return 3 * (size_t)rup(d.Q, 4) + 2 * (size_t)d.Qp * LDX;
}

size_t smem_bytes(const Dims& d) {
  const size_t y = y_smem_floats(d), st = s_smem_floats(d);
  return (y > st ? y : st) * sizeof(float);
}

// heads per y block: the most (up to 4, dividing H / G) that still give
// two y blocks for each of the card's SMs, else one
Dims make_dims(int N, int Q, int H, int G, int dh, int S, int num_sms) {
  Dims d;
  d.N = N; d.Q = Q; d.H = H; d.G = G; d.dh = dh; d.S = S;
  d.nqt = (Q + QT - 1) / QT;
  d.hb = 1;
  for (int hb = HB_MAX; hb > 1; --hb)
    if ((H / G) % hb == 0 && (long long)N * (H / hb) * d.nqt >= 2LL * num_sms) {
      d.hb = hb;
      break;
    }
  d.vec = false;
  d.nsh = (S + SH - 1) / SH;
  d.n_y = N * (H / d.hb) * d.nqt;
  d.Qp = rup(Q, 8);
  d.Sp = rup(S, 8);
  d.LS = rup(d.Sp, 32) + 4;
  d.LK = rup(d.Qp, 32) + 4;
  return d;
}

// an A fragment (16 x 8, element (r, k) at p[r * rs + k * ks]) as hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load(const float* p, int rs, int ks, int g, int t) {
    split_tf32(p[g * rs + t * ks], hi[0], lo[0]);
    split_tf32(p[(g + 8) * rs + t * ks], hi[1], lo[1]);
    split_tf32(p[g * rs + (t + 4) * ks], hi[2], lo[2]);
    split_tf32(p[(g + 8) * rs + (t + 4) * ks], hi[3], lo[3]);
  }
};

// a B fragment (8 x 8, element (k, n) at p[k * ks + n * ns]) as hi and lo
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void load(const float* p, int ks, int ns, int g, int t) {
    split_tf32(p[t * ks + g * ns], hi[0], lo[0]);
    split_tf32(p[(t + 4) * ks + g * ns], hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// a 4-byte asynchronous copy into shared memory, zero when !ok; every
// staging loop issues all its copies before any is waited on
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

// rows x cols (cols a multiple of 8) of dst, row stride ld, from the rows
// of src (row r at src + r * rs): rows < vr and columns < vc copied, the
// rest zero
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, size_t rs,
                                      int rows, int cols, int vr, int vc, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += NT) {
      const int r = i / c4, c = 4 * (i - r * c4);
      const bool ok = r < vr && c < vc;
      cp16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < vr && c < vc;
      cp4(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  }
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// cs[q] = cumsum(dt[q] * a) for q < n, summed in f64, one thread
__device__ void cumsum_f64(float* cs, const float* dts, float a, int n) {
  double c = 0.0;
  for (int q = 0; q < n; ++q) {
    c += (double)__fmul_rn(dts[q], a);
    cs[q] = (float)c;
  }
}

// y rows [q0, q0 + 32) of heads [h0, h0 + hb), all of one group
__device__ void y_block(const Dims& d, int bid, float* sm, const float* __restrict__ x,
                        const float* __restrict__ Bg, const float* __restrict__ Cg,
                        const float* __restrict__ dt, const float* __restrict__ A,
                        const float* __restrict__ Dv, const float* __restrict__ h_in,
                        float* __restrict__ y) {
  const int qt = d.nqt - 1 - bid % d.nqt;       // the longest tiles first
  const int rest = bid / d.nqt;
  const int h0 = (rest % (d.H / d.hb)) * d.hb, n = rest / (d.H / d.hb);
  const int grp = h0 / (d.H / d.G);
  const int q0 = qt * QT, qn = min(QT, d.Q - q0), kmax = q0 + qn, kp = rup(kmax, 8);
  const int Q = d.Q, H = d.H, G = d.G, S = d.S, Sp = d.Sp, dh = d.dh;
  const int LS = d.LS, LK = d.LK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* cs = sm;                                 // [hb][Q]
  float* dts = cs + rup(HB_MAX * Q, 4);           // [hb][Q]  dt
  float* Ct = dts + rup(HB_MAX * Q, 4);           // [QT][LS]  C rows q0..
  float* U = Ct + QT * LS;                        // B [kp][LS], then x*dt and h_in
  float* xd = U;                                  // [kp][LDX]
  float* hs = U + d.Qp * LDX;                     // [DMAX][LS]
  float* Ls = U + imax(d.Qp * LS, d.Qp * LDX + DMAX * LS);   // [QT][LK]

  for (int i = tid; i < d.hb * kmax; i += NT) {
    const int hi = i / kmax, q = i - hi * kmax;
    cp4(dts + hi * Q + q, dt + ((size_t)n * Q + q) * H + h0 + hi, true);
  }
  stage(Ct, LS, Cg + (((size_t)n * Q + q0) * G + grp) * S, (size_t)G * S, QT, Sp, qn, S,
        d.vec);
  stage(U, LS, Bg + ((size_t)n * Q * G + grp) * S, (size_t)G * S, kp, Sp, kmax, S, d.vec);
  cp_wait_all();
  if (tid < d.hb) cumsum_f64(cs + tid * Q, dts + tid * Q, A[h0 + tid], kmax);

  // the group's scores C.B^T: warp w holds rows 0..31 x keys 32w..32w+31
  float sc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mi][j][e] = 0.f;
  const bool two = qn > 16;                       // rows 16..31 hold a query
  if (32 * warp < kp) {
    for (int k0 = 0; k0 < Sp; k0 += 8) {
      FragA a[2];
      a[0].load(Ct + k0, LS, 1, g, t);
      if (two) a[1].load(Ct + 16 * LS + k0, LS, 1, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kb = 32 * warp + 8 * j;
        if (kb < kp) {
          FragB b;
          b.load(U + kb * LS + k0, 1, LS, g, t);
          mma3(sc[0][j], a[0], b);
          if (two) mma3(sc[1][j], a[1], b);
        }
      }
    }
  }
  __syncthreads();                                // B is no longer read

  for (int hi = 0; hi < d.hb; ++hi) {
    const int h = h0 + hi;
    const float* csh = cs + hi * Q;
    const int dr = rup(dh, 16);
    stage(xd, LDX, x + ((size_t)n * Q * H + h) * dh, (size_t)H * dh, kp, dr, kmax, dh, d.vec);
    stage(hs, LS, h_in + ((size_t)n * H + h) * dh * S, S, dr, Sp, dh, S, d.vec);
    // this head's masked decay scores from the shared tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kb = 32 * warp + 8 * j;
      if (kb < kp) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * mi + g + (e >> 1) * 8, k = kb + 2 * t + (e & 1), q = q0 + r;
            float v = 0.f;
            if (r < qn && k <= q) v = __fmul_rn(sc[mi][j][e], expf(__fsub_rn(csh[q], csh[k])));
            Ls[r * LK + k] = v;
          }
      }
    }
    cp_wait_all();
    for (int i = tid; i < kmax * dh; i += NT) {     // x -> x * dt
      const int k = i / dh, c = i - k * dh;
      xd[k * LDX + c] = __fmul_rn(xd[k * LDX + c], dts[hi * Q + k]);
    }
    __syncthreads();

    // warp w: y rows 0..31 x head columns 16w..16w+15
    if (16 * warp < dh) {
      float yi[2][2][4], ye[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) yi[mi][j][e] = ye[mi][j][e] = 0.f;
      const int c0 = 16 * warp;
      for (int k0 = 0; k0 < kp; k0 += 8) {
        FragB b[2];
        b[0].load(xd + k0 * LDX + c0, LDX, 1, g, t);
        b[1].load(xd + k0 * LDX + c0 + 8, LDX, 1, g, t);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (k0 <= q0 + 16 * mi + 15 && (mi == 0 || two)) {   // keys past the last row are 0
            FragA a;
            a.load(Ls + 16 * mi * LK + k0, LK, 1, g, t);
            mma3(yi[mi][0], a, b[0]);
            mma3(yi[mi][1], a, b[1]);
          }
        }
      }
      for (int k0 = 0; k0 < Sp; k0 += 8) {
        FragB b[2];
        b[0].load(hs + c0 * LS + k0, 1, LS, g, t);
        b[1].load(hs + (c0 + 8) * LS + k0, 1, LS, g, t);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi == 0 || two) {
            FragA a;
            a.load(Ct + 16 * mi * LS + k0, LS, 1, g, t);
            mma3(ye[mi][0], a, b[0]);
            mma3(ye[mi][1], a, b[1]);
          }
        }
      }
      const float Dh = Dv[h];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * mi + g + (e >> 1) * 8, c = c0 + 8 * j + 2 * t + (e & 1);
            if (r < qn && c < dh) {
              const int q = q0 + r;
              const size_t o = (((size_t)n * Q + q) * H + h) * dh + c;
              const float inter = __fmul_rn(expf(csh[q]), ye[mi][j][e]);
              y[o] = __fadd_rn(__fadd_rn(yi[mi][j][e], inter), __fmul_rn(Dh, x[o]));
            }
          }
    }
    __syncthreads();                              // x*dt, h_in and L are rewritten
  }
}

// state columns [s0, s0 + 64) of one head, and its decay
__device__ void s_block(const Dims& d, int bid, float* sm, const float* __restrict__ x,
                        const float* __restrict__ Bg, const float* __restrict__ dt,
                        const float* __restrict__ A, float* __restrict__ s_out,
                        float* __restrict__ decay) {
  const int sh = bid % d.nsh, rest = bid / d.nsh;
  const int h = rest % d.H, n = rest / d.H;
  const int grp = h / (d.H / d.G), s0 = sh * SH, sn = min(SH, d.S - s0);
  const int Q = d.Q, H = d.H, G = d.G, S = d.S, dh = d.dh, Qp = d.Qp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* cs = sm;                                 // [Q]
  float* wk = cs + rup(Q, 4);                     // [Q]  exp(cs[Q-1] - cs)
  float* dts = wk + rup(Q, 4);                    // [Q]  dt
  float* Bw = dts + rup(Q, 4);                    // [Qp][LDX]  B * wk
  float* xw = Bw + Qp * LDX;                      // [Qp][LDX]  x * dt

  const int sr = rup(sn, 8), dr = rup(dh, 16);
  for (int q = tid; q < Q; q += NT) cp4(dts + q, dt + ((size_t)n * Q + q) * H + h, true);
  stage(Bw, LDX, Bg + ((size_t)n * Q * G + grp) * S + s0, (size_t)G * S, Qp, sr, Q, sn, d.vec);
  stage(xw, LDX, x + ((size_t)n * Q * H + h) * dh, (size_t)H * dh, Qp, dr, Q, dh, d.vec);
  cp_wait_all();
  if (tid == 0) cumsum_f64(cs, dts, A[h], Q);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int q = tid; q < Q; q += NT) wk[q] = expf(__fsub_rn(cl, cs[q]));
  if (sh == 0 && tid == 0) decay[(size_t)n * H + h] = expf(cl);
  __syncthreads();
  for (int i = tid; i < Q * sn; i += NT) {         // B -> B * exp(cs[Q-1] - cs)
    const int k = i / sn, c = i - k * sn;
    Bw[k * LDX + c] = __fmul_rn(Bw[k * LDX + c], wk[k]);
  }
  for (int i = tid; i < Q * dh; i += NT) {         // x -> x * dt
    const int k = i / dh, c = i - k * dh;
    xw[k * LDX + c] = __fmul_rn(xw[k * LDX + c], dts[k]);
  }
  __syncthreads();

  // warp w: state rows (head columns) 16w..16w+15 x state columns s0..s0+63
  if (16 * warp >= dh) return;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < Qp; k0 += 8) {
    FragA a;
    a.load(xw + k0 * LDX + 16 * warp, 1, LDX, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j < sn) {
        FragB b;
        b.load(Bw + k0 * LDX + 8 * j, LDX, 1, g, t);
        mma3(acc[j], a, b);
      }
    }
  }
  float* so = s_out + ((size_t)n * H + h) * dh * S;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + (e >> 1) * 8, c = 8 * j + 2 * t + (e & 1);
      if (r < dh && c < sn) so[(size_t)r * S + s0 + c] = acc[j][e];
    }
}

__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(Dims d, const float* __restrict__ x, const float* __restrict__ Bg,
                 const float* __restrict__ Cg, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Dv,
                 const float* __restrict__ h_in, float* __restrict__ y,
                 float* __restrict__ s_out, float* __restrict__ decay) {
  extern __shared__ __align__(16) float sm[];
  const int bid = blockIdx.x;
  if (bid < d.n_y)
    y_block(d, bid, sm, x, Bg, Cg, dt, A, Dv, h_in, y);
  else
    s_block(d, bid - d.n_y, sm, x, Bg, dt, A, s_out, decay);
}

}  // namespace

// the dynamic shared memory of one block at these dimensions, in bytes
extern "C" long long ssd_chunk_smem_bytes(int Q, int H, int G, int dh, int S) {
  return (long long)smem_bytes(make_dims(1, Q, H, G, dh, S, 1));
}

// x f32 [N,Q,H,dh]; B, C f32 [N,Q,G,S] (head h reads group h / (H / G));
// dt f32 [N,Q,H]; A, D f32 [H]; h_in f32 [N,H,dh,S] -> y f32 [N,Q,H,dh],
// s_out f32 [N,H,dh,S], decay f32 [N,H].  Returns cudaErrorInvalidValue,
// launching nothing, for an empty shape, Q > 128, dh > 64, G not dividing
// H, or operands that overflow one block's shared memory.
extern "C" int ssd_chunk_launch(const void* x, const void* B, const void* C,
                                const void* dt, const void* A, const void* D,
                                const void* h_in, void* y, void* s_out,
                                void* decay, int N, int Q, int H, int G, int dh, int S,
                                void* stream) {
  if (N < 1 || Q < 1 || H < 1 || G < 1 || dh < 1 || S < 1 || Q > QMAX || dh > DMAX ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  static int num_sms = 0;
  if (num_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  Dims d = make_dims(N, Q, H, G, dh, S, num_sms);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
                        reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(h_in);
  d.vec = S % 4 == 0 && dh % 4 == 0 && any % 16 == 0;
  const long long blocks = (long long)N * (H / d.hb) * d.nqt + (long long)N * H * d.nsh;
  const size_t smem = smem_bytes(d);
  if (smem > MAX_SMEM || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 0;     // the largest limit asked for so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  ssd_chunk_kernel<<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h_in), static_cast<float*>(y),
      static_cast<float*>(s_out), static_cast<float*>(decay));
  return (int)cudaGetLastError();
}
