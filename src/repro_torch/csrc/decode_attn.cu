// B2, B3, B4: flash decoding over the int8 SLC KV pool, CUDA C++ for sm_90a.
//
// Replaces three TPU kernels of src/repro/kernels/decode_attn/kernel.py:
//   B2 decode_attn_pallas (_attn_pallas / _kernel), the plain decode step;
//   B3 verify_attn_pallas, the speculative verify window: T query tokens per
//      slot folded into the rep axis, row (t, r) keeps keys < lengths[b, t];
//   B4 verify_tree_attn_pallas (_tree_kernel), the tree verify window: row
//      (t, r) keeps keys < pos[b] plus in-window key pos[b] + j iff bit j of
//      anc[b, t] is set.
// Per (slot b, kv group g): int8 q . K^T into int32 (the dMVM's VVMs),
// descaled as ((s * q_s) * k_s) / sqrt(D), masked per row, online softmax,
// and P . (V * v_s) in f32; out = acc / max(l, 1e-30).
//
// What bounds it on the H100: the bytes of the live cache rows -- each key
// and value row (D int8 + one f32 scale) is read once per (slot, group) and
// used by the group's R = T * rep query rows, a few operations per byte, so
// memory bounds it (B = 4, G = 8, S = 512, D = 128: about 4.2 MB, 1.25 us at
// 3.35 TB/s).
//
// What the design does about it: one block per (slot, group, block of up to
// 16 query rows) loops over key tiles of 128 only up to the largest key
// limit of its own rows (pos + T for a tree window, the TPU kernel's dead
// block skip), so dead rows past it are never read.  Each tile's live K and
// V rows are staged in shared memory by all threads at once (coalesced
// 16-byte loads, all in flight together; a version that read them key by key
// was bound by load latency).  Each thread then owns one key of the tile and
// dots the staged q words with it by __dp4a (exact int32; the key tile's
// rows are padded so the threads hit distinct banks), with no cross-lane
// reduction in the way.  Scores and softmax statistics stay in shared
// memory; each thread owns one of the D output lanes for all rows.  A verify
// window of R rows takes ceil(R / 16) row blocks, each of which reads the
// live cache once: 16 rows keep the per-thread accumulators in registers and
// the score tile within 48 KB of static shared memory.  With B*G blocks per
// row block the card is only partly filled at decode sizes; splitting S
// across blocks is a later change.
//
// The three masks share one body, so a row's arithmetic does not depend on
// the mask that chose its keys: a key masked inside a tile scores -1e30 and
// weighs exactly 0, and a tile past a row's last key leaves its statistics
// and accumulator unchanged (corr = 1, p = 0).  Hence B3's row (t, r) equals
// B2 at length pos + t + 1, and B4 on a chain (anc[t] = (1 << (t+1)) - 1)
// equals B3, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;           // keys per tile = threads per block
constexpr int MAX_ROWS = 16;      // query rows per block
constexpr int MAX_D = 128;        // head dim
constexpr int KSTR = MAX_D / 4 + 1;   // padded key-tile row: conflict-free
constexpr float NEG_INF = -1e30f;

// which keys a query row sees
enum Mask : int {
  kSlotLength = 0,   // B2: keys < lengths[b]
  kRowLength = 1,    // B3: keys < lengths[b, t]
  kTree = 2,         // B4: keys < pos[b], or pos[b] + j with bit j of anc[b, t]
};

__device__ __forceinline__ float warp_sumf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_maxf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q [B,G,T*rep,D] int8, qs [B,G,T*rep] f32, k/v [B,S,G,D] int8, ks/vs
// [B,S,G] f32 -> out [B,G,T*rep,D] f32.  lim: kSlotLength lengths [B];
// kRowLength lengths [B,T]; kTree pos [B] with anc [B,T] (T <= 31).
// blockDim.x == TS; grid (G, B, ceil(T*rep / MAX_ROWS)); D % 4 == 0 and
// D <= MAX_D (vec16: D % 16 == 0 and 16-byte aligned rows).
template <int MASK>
__global__ void __launch_bounds__(TS)
attn_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs,
            const int8_t* __restrict__ k, const float* __restrict__ ks,
            const int8_t* __restrict__ v, const float* __restrict__ vs,
            const int32_t* __restrict__ lim, const int32_t* __restrict__ anc,
            float* __restrict__ out, int S, int G, int T, int rep, int D,
            float sqrt_d, bool vec16) {
  __shared__ int q_w[MAX_ROWS][MAX_D / 4];  // q rows as packed int8x4 words
  __shared__ int k_t[TS][KSTR];             // the key tile, one row per key
  __shared__ __align__(16) int v_t[TS][MAX_D / 4];   // the value tile
  __shared__ float ks_t[TS], vs_t[TS];
  __shared__ float q_sc[MAX_ROWS];
  __shared__ float p_t[MAX_ROWS][TS];       // scores, then probabilities
  __shared__ float row_m[MAX_ROWS], row_l[MAX_ROWS], row_corr[MAX_ROWS];
  __shared__ int row_lim[MAX_ROWS];         // kRowLength: the row's key limit
  __shared__ unsigned row_anc[MAX_ROWS];    // kTree: the row's ancestor bits

  const int b = blockIdx.y, g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = TS / 32;
  const int D4 = D / 4;
  const int R = T * rep, r0 = blockIdx.z * MAX_ROWS;
  const int nr = min(MAX_ROWS, R - r0);
  const size_t bg = (size_t)b * G + g;

  // the block's key walk: the largest limit among its rows
  int len, pos = 0;
  if (MASK == kSlotLength) {
    len = min(lim[b], S);
  } else if (MASK == kRowLength) {
    len = 0;
    for (int r = 0; r < nr; ++r)
      len = max(len, min(lim[(size_t)b * T + (r0 + r) / rep], S));
  } else {
    pos = lim[b];
    len = min(pos + T, S);
  }

  const int* qrow = reinterpret_cast<const int*>(q + (bg * R + r0) * D);
  for (int i = tid; i < nr * D4; i += TS) q_w[i / D4][i % D4] = qrow[i];
  if (tid < nr) {
    q_sc[tid] = qs[bg * R + r0 + tid];
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
    const size_t bt = (size_t)b * T + (r0 + tid) / rep;
    if (MASK == kRowLength) row_lim[tid] = min(lim[bt], S);
    if (MASK == kTree) row_anc[tid] = (unsigned)anc[bt];
  }
  float acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += TS) {
    const int nk = min(TS, len - s0);
    // stage the live K and V rows of this tile: every thread issues all of
    // its loads (scales, then up to MAX_D / 16 16-byte words of K and of V)
    // before it stores any, so the whole tile is in flight at once
    float ksv = 0.f, vsv = 0.f;
    if (tid < nk) {
      const size_t row = ((size_t)b * S + s0 + tid) * G + g;
      ksv = __ldg(ks + row);
      vsv = __ldg(vs + row);
    }
    if (vec16) {
      const int D16 = D / 16;
      int4 kbuf[MAX_D / 16], vbuf[MAX_D / 16];
#pragma unroll
      for (int it = 0; it < MAX_D / 16; ++it) {
        const int i = tid + it * TS, j = i / D16, c = i % D16;
        if (j < nk) {
          const size_t row = ((size_t)b * S + s0 + j) * G + g;
          kbuf[it] = __ldg(reinterpret_cast<const int4*>(k + row * D) + c);
          vbuf[it] = __ldg(reinterpret_cast<const int4*>(v + row * D) + c);
        }
      }
#pragma unroll
      for (int it = 0; it < MAX_D / 16; ++it) {
        const int i = tid + it * TS, j = i / D16, c = i % D16;
        if (j < nk) {
          k_t[j][4 * c] = kbuf[it].x;
          k_t[j][4 * c + 1] = kbuf[it].y;
          k_t[j][4 * c + 2] = kbuf[it].z;
          k_t[j][4 * c + 3] = kbuf[it].w;
          reinterpret_cast<int4*>(v_t[j])[c] = vbuf[it];
        }
      }
    } else {
      for (int i = tid; i < nk * D4; i += TS) {
        const int j = i / D4, c = i % D4;
        const size_t row = ((size_t)b * S + s0 + j) * G + g;
        k_t[j][c] = __ldg(reinterpret_cast<const int*>(k + row * D) + c);
        v_t[j][c] = __ldg(reinterpret_cast<const int*>(v + row * D) + c);
      }
    }
    if (tid < nk) {
      ks_t[tid] = ksv;
      vs_t[tid] = vsv;
    }
    __syncthreads();
    // q . K^T: thread j owns key j, int8 x int8 -> int32 by dp4a
    {
      const int j = tid, kp = s0 + j;
      if (j < nk) {
        int part[MAX_ROWS];
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) part[r] = 0;
        for (int d4 = 0; d4 < D4; ++d4) {
          const int kw = k_t[j][d4];
#pragma unroll
          for (int r = 0; r < MAX_ROWS; ++r)
            if (r < nr) part[r] = __dp4a(q_w[r][d4], kw, part[r]);
        }
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) {
          if (r < nr) {
            bool seen = true;
            if (MASK == kRowLength) seen = kp < row_lim[r];
            if (MASK == kTree) {
              const int idx = kp - pos;
              seen = idx < 0 || (idx < T && ((row_anc[r] >> idx) & 1u));
            }
            const float sc = __fdiv_rn(
                __fmul_rn(__fmul_rn((float)part[r], q_sc[r]), ks_t[j]), sqrt_d);
            p_t[r][j] = seen ? sc : NEG_INF;
          }
        }
      } else {
        for (int r = 0; r < nr; ++r) p_t[r][j] = NEG_INF;   // past the walk
      }
    }
    __syncthreads();
    // online softmax statistics, one warp per query row
    for (int r = warp; r < nr; r += nwarps) {
      float mx = NEG_INF;
      for (int j = lane; j < TS; j += 32) mx = fmaxf(mx, p_t[r][j]);
      mx = warp_maxf(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const float p = expf(p_t[r][j] - m_new);
        p_t[r][j] = p;
        psum += p;
      }
      psum = warp_sumf(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + psum;
        row_m[r] = m_new;
        row_corr[r] = corr;
      }
    }
    __syncthreads();
    // P . (V * v_s): thread d owns output lane d of every row
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < nr) acc[r] *= row_corr[r];
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const int8_t vq = reinterpret_cast<const int8_t*>(v_t[j])[tid];
        const float vf = __fmul_rn((float)vq, vs_t[j]);
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r)
          if (r < nr) acc[r] += p_t[r][j] * vf;
      }
    }
    __syncthreads();
  }

  if (tid < D) {
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < nr)
        out[(bg * R + r0 + r) * D + tid] = acc[r] / fmaxf(row_l[r], 1e-30f);
  }
}

template <int MASK>
int launch(const void* q, const void* qs, const void* k, const void* ks,
           const void* v, const void* vs, const void* lim, const void* anc,
           void* out, int B, int S, int G, int T, int rep, int D, float sqrt_d,
           void* stream) {
  if (B < 1 || S < 1 || G < 1 || T < 1 || rep < 1 || D < 4 || D > MAX_D
      || D % 4 != 0 || (MASK == kTree && T > 31))
    return (int)cudaErrorInvalidValue;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0
      && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int row_blocks = (T * rep + MAX_ROWS - 1) / MAX_ROWS;
  attn_kernel<MASK><<<dim3(G, B, row_blocks), TS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<const int32_t*>(lim), static_cast<const int32_t*>(anc),
      static_cast<float*>(out), S, G, T, rep, D, sqrt_d, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// B2: q [B,G,rep,D], lengths [B]
extern "C" int decode_attn_launch(const void* q, const void* qs, const void* k,
                                  const void* ks, const void* v, const void* vs,
                                  const void* lengths, void* out, int B, int S,
                                  int G, int rep, int D, float sqrt_d,
                                  void* stream) {
  if (rep > MAX_ROWS) return (int)cudaErrorInvalidValue;
  return launch<kSlotLength>(q, qs, k, ks, v, vs, lengths, nullptr, out, B, S,
                             G, 1, rep, D, sqrt_d, stream);
}

// B3: q [B,G,T,rep,D], lengths [B,T]
extern "C" int verify_attn_launch(const void* q, const void* qs, const void* k,
                                  const void* ks, const void* v, const void* vs,
                                  const void* lengths, void* out, int B, int S,
                                  int G, int T, int rep, int D, float sqrt_d,
                                  void* stream) {
  return launch<kRowLength>(q, qs, k, ks, v, vs, lengths, nullptr, out, B, S,
                            G, T, rep, D, sqrt_d, stream);
}

// B4: q [B,G,T,rep,D], pos [B], anc [B,T]
extern "C" int verify_tree_attn_launch(const void* q, const void* qs,
                                       const void* k, const void* ks,
                                       const void* v, const void* vs,
                                       const void* pos, const void* anc,
                                       void* out, int B, int S, int G, int T,
                                       int rep, int D, float sqrt_d,
                                       void* stream) {
  return launch<kTree>(q, qs, k, ks, v, vs, pos, anc, out, B, S, G, T, rep, D,
                       sqrt_d, stream);
}
