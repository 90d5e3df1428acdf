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
// and P . (V * v_s) in f32 precision; out = acc / max(l, 1e-30).
//
// What bounds it on the H100: the bytes of the live cache rows -- each key
// and value row (D int8 + one f32 scale) is read once per (slot, group) and
// used by the group's R = T * rep query rows, a few operations per byte, so
// memory bounds it (B = 4, G = 8, S = 512, D = 128: about 2.4 MB of live
// rows, 0.71 us at 3.35 TB/s; nemotron-4-340b's D = 192 at rep 12: 6.4 MB,
// 1.92 us).
//
// The body is instantiated on the largest head dim it takes, DM: 128 (every
// D <= 128, its stages in 44,928 bytes of static shared memory) and 192
// (128 < D <= 192: two stages of 64 x (208 + 224) + 512 bytes, 61,312 bytes
// in all, past the 48 KB a kernel may declare statically, so they come from
// dynamic shared memory).  Only the widths differ: D / 32 int8 k-steps, and
// DM / 32 tf32 n-tiles of P . V a warp.  A column's sums run the same steps
// in either instance, so a head dim <= 128 keeps its bits.
//
// What the design does about it:
// - The key axis is cut into chunks of CHUNK = 64 keys at fixed, absolute
//   positions, and the NC = 8 CTAs of a thread block cluster share the
//   chunks of one (slot, group, block of up to 16 query rows): CTA c takes
//   chunks c, c + NC, c + 2 NC, ... in ascending order, only those that
//   start below the largest key limit of the block's rows (the TPU kernel's
//   dead-block skip: rows past it are never read).  At B 4, G 8 that is 256
//   CTAs at decode, where one CTA per (slot, group) left most SMs idle.
// - Each CTA stages its chunks' K, V and scales with cp.async in a ring of
//   two stages, so the next chunk's copies are in flight while this one is
//   scored; keys past the walk are zero-filled, never read.
// - q . K^T runs on int8 mma.sync m16n8k32: the block's query rows are the
//   M side (rows past R are zero), each warp takes 16 keys of the chunk as
//   two n8 tiles.  The int32 sums are exact, then descaled per element.
// - Online softmax per chunk: row maxima and sums by a fixed butterfly over
//   a warp's keys, then over the four warps in order.
// - P . (V * v_s) runs on tf32 mma.sync m16n8k8 as (P * v_s) . V: A is
//   p * v_s in f32, split into tf32 hi + lo; B is V, whose int8 values are
//   exact in tf32, so of 3xTF32's products only hi . V and lo . V are not
//   zero, each exact, summed in f32.  Warp w owns output columns DM / 4 w
//   onward: one 4-byte V read a key gives its first four n8 tiles (columns
//   DM / 4 w + 4 gid + t), and at DM 192 one 2-byte read its other two
//   (columns DM / 4 w + 32 + 2 gid + t).  A chunk's
//   sum starts from zero and joins the running one as acc * corr + sum.
// - Bytes and int32 scores become floats by exact integer tricks, not the
//   quarter-rate I2F unit.
// - One launch a call: after a cluster barrier each CTA merges its share of
//   the outputs over the cluster's (m, l, acc) in rank order 0..NC-1
//   through distributed shared memory.  No workspace, memset or second
//   kernel.
//
// Why the partition is fixed by key position: a verify row must equal
// sequential decode bit for bit.  The spec lanes' pools hold max_len + T - 1
// rows and the plain lane's max_len, and B3's block walks to its last row's
// limit while B2 walks to the slot's own length.  Neither S, the lengths, T,
// the mask nor the SM count decides which CTA sums which key, or in what
// order.  A chunk with no live key for a row leaves that CTA's statistics
// unchanged (its keys weigh exactly 0 in every product, corr = exp(0) = 1),
// and a CTA that met no live key holds m = -1e30, l = 0, acc = 0, which the
// merge scales by exp(-1e30 - m) = 0.  A row's results do not depend on the
// other rows of its block.  Hence B3's row (t, r) equals B2 at length
// pos + t + 1 in either pool, and B4 on a chain (anc[t] = (1 << (t+1)) - 1)
// equals B3, bit for bit.  The float arithmetic uses explicit _rn
// intrinsics so the three mask instantiations round alike.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 64;         // keys per chunk: fixed, absolute positions
constexpr int NC = 8;             // CTAs of a cluster sharing the chunks
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 16;      // query rows per block: the mma M side
constexpr int MAX_D = 192;        // head dim
constexpr int PSTR = CHUNK + 4;   // probability row stride in floats: conflict-free A reads
constexpr int STAGES = 2;
constexpr int STATIC_SMEM = 48 * 1024;   // what a kernel may declare statically
constexpr float NEG_INF = -1e30f;

static_assert(THREADS == 2 * CHUNK, "one scale copy per thread");
static_assert(WARPS * 16 == CHUNK, "a warp scores 16 keys of a chunk");

// the widths of the instance for head dims up to DM
template <int DM>
struct Dims {
  static_assert(DM == 128 || DM == 192, "instances: 128 and 192");
  static constexpr int KSTEPS = DM / 32;       // int8 k-steps of q . K^T
  static constexpr int KSTR = DM + 16;         // key row stride in bytes: conflict-free B reads
  static constexpr int VSTR = DM + 32;         // value row stride in bytes: conflict-free B reads
  static constexpr int ASTR = DM + 1;          // accumulator row stride in floats
  static constexpr int CPW = DM / WARPS;       // P . V output columns a warp owns
  static constexpr int NT = CPW / 8;           // their n8 tiles: 4 from a word, 2 from a half
  static constexpr int COPIES = CHUNK * DM / 16 / THREADS;   // 16-byte copies a thread
};

// which keys a query row sees
enum Mask : int {
  kSlotLength = 0,   // B2: keys < lengths[b]
  kRowLength = 1,    // B3: keys < lengths[b, t]
  kTree = 2,         // B4: keys < pos[b], or pos[b] + j with bit j of anc[b, t]
};

template <int DM>
struct Stage {
  int8_t k[CHUNK][Dims<DM>::KSTR];
  int8_t v[CHUNK][Dims<DM>::VSTR];
  float ks[CHUNK], vs[CHUNK];
};

template <int DM>
struct Smem {
  union {
    Stage<DM> st[STAGES];
    float acc[MAX_ROWS][Dims<DM>::ASTR];   // after the walk: this CTA's accumulators
  } u;
  float p[MAX_ROWS][PSTR];        // the chunk's probabilities
  float red_m[WARPS][MAX_ROWS], red_l[WARPS][MAX_ROWS];
  float m[MAX_ROWS], l[MAX_ROWS]; // after the walk: this CTA's statistics
};

// the instance's shared memory is dynamic where it outgrows a static block
template <int DM>
__host__ __device__ constexpr size_t dynamic_smem() {
  return sizeof(Smem<DM>) > STATIC_SMEM ? sizeof(Smem<DM>) : 0;
}

// Exact int -> f32 conversions without the quarter-rate I2F unit: the value,
// biased to be non-negative, is placed in the mantissa of 2^23 (bytes) or
// 1.5 * 2^23 (|s| < 2^22), and the bias subtracted (both steps exact).
__device__ __forceinline__ float s8_to_f32(uint32_t w, int c) {   // byte c of w
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | c)) - 8388736.0f;
}
__device__ __forceinline__ float s22_to_f32(int s) {
  return __int_as_float(0x4B400000 + s) - 12582912.0f;
}

// Where a thread's 16-byte copies of a chunk land, computed once: copy n
// (i = tid + n * THREADS < CHUNK * D / 16) is key row i / (D / 16), bytes
// 16 (i % (D / 16)).
template <int DM>
struct CopyPlan {
  int key[Dims<DM>::COPIES];
  long long src[Dims<DM>::COPIES];   // from the chunk's first row
  int dst_k[Dims<DM>::COPIES], dst_v[Dims<DM>::COPIES];
};

// keys [c0, c0 + CHUNK) of one (slot, group) into a stage: key s's row is
// (slot_row + s) * G + g.  Keys at or past len are zero-filled, not read.
// vec16: D % 16 == 0 and 16-byte aligned rows, copied as the plan says.
template <int DM>
__device__ __forceinline__ void load_chunk(Stage<DM>& st, const CopyPlan<DM>& plan,
                                           const int8_t* __restrict__ k,
                                           const float* __restrict__ ks,
                                           const int8_t* __restrict__ v,
                                           const float* __restrict__ vs, size_t slot_row,
                                           int G, int g, int D, int c0, int len,
                                           bool vec16, int tid) {
  if (vec16) {
    const size_t base = ((slot_row + c0) * G + g) * D;
#pragma unroll
    for (int n = 0; n < Dims<DM>::COPIES; ++n) {
      if (plan.key[n] >= CHUNK) break;
      const bool ok = c0 + plan.key[n] < len;
      const size_t off = base + plan.src[n];
      cp_async16(reinterpret_cast<int8_t*>(&st) + plan.dst_k[n], ok ? k + off : k, ok ? 16 : 0);
      cp_async16(reinterpret_cast<int8_t*>(&st) + plan.dst_v[n], ok ? v + off : v, ok ? 16 : 0);
    }
  } else {
    const int D4 = D / 4;
    for (int i = tid; i < CHUNK * D4; i += THREADS) {
      const int j = i / D4, c = i - j * D4;
      const bool ok = c0 + j < len;
      const size_t off = ((slot_row + c0 + j) * G + g) * D + 4 * c;
      cp_async4(&st.k[j][4 * c], ok ? k + off : k, ok ? 4 : 0);
      cp_async4(&st.v[j][4 * c], ok ? v + off : v, ok ? 4 : 0);
    }
  }
  const int j = tid % CHUNK;
  const bool ok = c0 + j < len;
  const size_t off = (slot_row + c0 + j) * G + g;
  if (tid < CHUNK)
    cp_async4(&st.ks[j], ok ? ks + off : ks, ok ? 4 : 0);
  else
    cp_async4(&st.vs[j], ok ? vs + off : vs, ok ? 4 : 0);
}

// q [B,G,T*rep,D] int8, qs [B,G,T*rep] f32, k/v [B,S,G,D] int8, ks/vs
// [B,S,G] f32 -> out [B,G,T*rep,D] f32.  lim: kSlotLength lengths [B];
// kRowLength lengths [B,T]; kTree pos [B] with anc [B,T] (T <= 31).
// blockDim.x == THREADS; grid (NC, G * row_blocks, B) in clusters of
// (NC, 1, 1); D % 4 == 0 and D <= DM; dynamic_smem<DM>() bytes of dynamic
// shared memory.
template <int MASK, int DM>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs,
            const int8_t* __restrict__ k, const float* __restrict__ ks,
            const int8_t* __restrict__ v, const float* __restrict__ vs,
            const int32_t* __restrict__ lim, const int32_t* __restrict__ anc,
            float* __restrict__ out, int S, int G, int T, int rep, int D,
            float sqrt_d, bool vec16) {
  using Dm = Dims<DM>;
  Smem<DM>* smp;
  if constexpr (dynamic_smem<DM>() > 0) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    smp = reinterpret_cast<Smem<DM>*>(dyn_smem);
  } else {
    __shared__ __align__(16) Smem<DM> static_smem;
    smp = &static_smem;
  }
  Smem<DM>& sm = *smp;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z, g = blockIdx.y % G, rb = blockIdx.y / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int D4 = D / 4;
  const int R = T * rep, r0 = rb * MAX_ROWS;
  const int nr = min(MAX_ROWS, R - r0);
  const size_t bg = (size_t)b * G + g, slot_row = (size_t)b * S;

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
  len = max(len, 0);

  // this thread's two mma rows, gid and gid + 8: q fragments, scale, mask
  uint32_t a[Dm::KSTEPS][4];
  float q_sc[2] = {0.f, 0.f};
  int row_lim[2] = {0, 0};
  unsigned row_anc[2] = {0u, 0u};
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gid + 8 * h;
    row_ok[h] = r < nr;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(q + (bg * R + r0 + r) * D);
#pragma unroll
    for (int s = 0; s < Dm::KSTEPS; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = 8 * s + 4 * half + tig;
        a[s][h + 2 * half] = row_ok[h] && w < D4 ? __ldg(qrow + w) : 0u;
      }
    if (row_ok[h]) {
      q_sc[h] = __ldg(qs + bg * R + r0 + r);
      const size_t bt = (size_t)b * T + (r0 + r) / rep;
      if (MASK == kRowLength) row_lim[h] = min(lim[bt], S);
      if (MASK == kTree) row_anc[h] = (unsigned)anc[bt];
    }
  }
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  // P . V accumulators in the mma layout: n-tile t, element e is row
  // gid + 8 (e / 2), column out_col(n = 2 tig + e % 2, t)
  const int cw = Dm::CPW * warp;   // the warp's first output column
  auto out_col = [cw](int n, int t) { return t < 4 ? cw + 4 * n + t : cw + 28 + 2 * n + t; };
  float acc[Dm::NT][4];
#pragma unroll
  for (int t = 0; t < Dm::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  CopyPlan<DM> plan;
  {
    const int D16 = D / 16;
#pragma unroll
    for (int n = 0; n < Dm::COPIES; ++n) {
      const int i = tid + n * THREADS, j = vec16 ? i / D16 : CHUNK, c = i - j * D16;
      plan.key[n] = j;
      plan.src[n] = (long long)j * G * D + 16 * c;
      plan.dst_k[n] = j * Dm::KSTR + 16 * c;
      plan.dst_v[n] = CHUNK * Dm::KSTR + j * Dm::VSTR + 16 * c;
    }
  }
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  if (rank < n_chunks)
    load_chunk(sm.u.st[0], plan, k, ks, v, vs, slot_row, G, g, D, rank * CHUNK, len, vec16,
               tid);
  cp_async_commit();

  int it = 0;
  for (int ch = rank; ch < n_chunks; ch += NC, ++it) {
    cp_async_wait<0>();
    __syncthreads();   // this chunk has landed; the last one is consumed
    if (ch + NC < n_chunks)
      load_chunk(sm.u.st[(it + 1) % STAGES], plan, k, ks, v, vs, slot_row, G, g, D,
                 (ch + NC) * CHUNK, len, vec16, tid);
    cp_async_commit();
    const Stage<DM>& st = sm.u.st[it % STAGES];
    const int c0 = ch * CHUNK;

    // q . K^T: keys 16 warp .. 16 warp + 15 of the chunk, two n8 tiles
    int cc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int s = 0; s < Dm::KSTEPS; ++s)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* kr =
            reinterpret_cast<const uint32_t*>(st.k[16 * warp + 8 * nt + gid]);
        mma_s8(cc[nt], a[s], kr[8 * s + tig], kr[8 * s + 4 + tig]);
      }
    // descale and mask: sc[h][nt][e] is row gid + 8h, key 16 warp + 8 nt + 2 tig + e
    float sc[2][2][2];
    bool seen[2][2][2];
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 16 * warp + 8 * nt + 2 * tig + e, kp = c0 + j;
        const float ksj = st.ks[j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bool ok = row_ok[h] && kp < len;
          if (MASK == kRowLength) ok = ok && kp < row_lim[h];
          if (MASK == kTree) {
            const int idx = kp - pos;
            ok = ok && (idx < 0 || (idx < T && ((row_anc[h] >> idx) & 1u)));
          }
          // a masked key divides 1, not 0, off the division's slow path
          const float num = __fmul_rn(__fmul_rn(s22_to_f32(cc[nt][2 * h + e]), q_sc[h]), ksj);
          const float s = __fdiv_rn(ok ? num : 1.f, sqrt_d);
          seen[h][nt][e] = ok;
          sc[h][nt][e] = ok ? s : NEG_INF;
          mx[h] = fmaxf(mx[h], sc[h][nt][e]);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (tig == 0) sm.red_m[warp][gid + 8 * h] = mx[h];
    }
    __syncthreads();
    // probabilities against the running maximum; row sums in a fixed order
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      const float cm = fmaxf(fmaxf(sm.red_m[0][r], sm.red_m[1][r]),
                             fmaxf(sm.red_m[2][r], sm.red_m[3][r]));
      const float m_new = fmaxf(m_run[h], cm);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      float p[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) p[nt][e] = seen[h][nt][e] ? expf(sc[h][nt][e] - m_new) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<float2*>(&sm.p[r][16 * warp + 8 * nt + 2 * tig]) =
            make_float2(p[nt][0], p[nt][1]);
      float ps = __fadd_rn(__fadd_rn(__fadd_rn(p[0][0], p[0][1]), p[1][0]), p[1][1]);
      ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 1));
      ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 2));
      if (tig == 0) sm.red_l[warp][r] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      const float ps = __fadd_rn(__fadd_rn(__fadd_rn(sm.red_l[0][r], sm.red_l[1][r]),
                                           sm.red_l[2][r]), sm.red_l[3][r]);
      l_run[h] = __fmaf_rn(l_run[h], corr[h], ps);
    }

    // P . (V * v_s) on tf32 mma.sync m16n8k8: A = p * v_s split into tf32
    // hi + lo (3xTF32; V's int8 values are exact in tf32, so its lo is 0),
    // B = V; the chunk's sum in a fresh accumulator, then acc * corr + sum.
    // All eight k-steps run: past the walk p = 0 and V = 0 add exact zeros.
    {
      const bool word_ok = cw + 4 * gid < D;
      const bool half_ok = Dm::NT > 4 && cw + 32 + 2 * gid < D;
      float cpv[Dm::NT][4];
#pragma unroll
      for (int t = 0; t < Dm::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) cpv[t][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < CHUNK / 8; ++kt) {
        const int k0 = 8 * kt + tig, k1 = k0 + 4;
        const float vs0 = st.vs[k0], vs1 = st.vs[k1];
        uint32_t ahi[4], alo[4];
        split_tf32(__fmul_rn(sm.p[gid][k0], vs0), ahi[0], alo[0]);
        split_tf32(__fmul_rn(sm.p[gid + 8][k0], vs0), ahi[1], alo[1]);
        split_tf32(__fmul_rn(sm.p[gid][k1], vs1), ahi[2], alo[2]);
        split_tf32(__fmul_rn(sm.p[gid + 8][k1], vs1), ahi[3], alo[3]);
        // columns cw + 4 gid + t of the first four n-tiles: one word a key
        const uint32_t w0 =
            word_ok ? reinterpret_cast<const uint32_t*>(st.v[k0] + cw)[gid] : 0u;
        const uint32_t w1 =
            word_ok ? reinterpret_cast<const uint32_t*>(st.v[k1] + cw)[gid] : 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t b0 = __float_as_uint(s8_to_f32(w0, t));
          const uint32_t b1 = __float_as_uint(s8_to_f32(w1, t));
          mma_tf32(cpv[t], alo, b0, b1);
          mma_tf32(cpv[t], ahi, b0, b1);
        }
        if constexpr (Dm::NT > 4) {
          // columns cw + 32 + 2 gid + t - 4 of the other two: a half-word a key
          const uint32_t h0 =
              half_ok ? reinterpret_cast<const uint16_t*>(st.v[k0] + cw + 32)[gid] : 0u;
          const uint32_t h1 =
              half_ok ? reinterpret_cast<const uint16_t*>(st.v[k1] + cw + 32)[gid] : 0u;
#pragma unroll
          for (int t = 4; t < Dm::NT; ++t) {
            const uint32_t b0 = __float_as_uint(s8_to_f32(h0, t - 4));
            const uint32_t b1 = __float_as_uint(s8_to_f32(h1, t - 4));
            mma_tf32(cpv[t], alo, b0, b1);
            mma_tf32(cpv[t], ahi, b0, b1);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < Dm::NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = __fmaf_rn(acc[t][e], corr[e >> 1], cpv[t][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the accumulators take its place

#pragma unroll
  for (int t = 0; t < Dm::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = out_col(2 * tig + (e & 1), t);
      if (col < D) sm.u.acc[gid + 8 * (e >> 1)][col] = acc[t][e];
    }
  if (warp == 0 && tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm.m[gid + 8 * h] = m_run[h];
      sm.l[gid + 8 * h] = l_run[h];
    }
  }
  cluster.sync();

  // each output element merged over the cluster's CTAs in rank order
  for (int e = rank * THREADS + tid; e < nr * D; e += NC * THREADS) {
    const int r = e / D, d = e - r * D;
    float mc[NC], lc[NC], ac[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const Smem<DM>* peer = cluster.map_shared_rank(&sm, c);
      mc[c] = peer->m[r];
      lc[c] = peer->l[r];
      ac[c] = peer->u.acc[r][d];
    }
    float m = mc[0];
#pragma unroll
    for (int c = 1; c < NC; ++c) m = fmaxf(m, mc[c]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float f = expf(mc[c] - m);
      l = __fmaf_rn(lc[c], f, l);
      o = __fmaf_rn(ac[c], f, o);
    }
    out[(bg * R + r0 + r) * D + d] = __fdiv_rn(o, fmaxf(l, 1e-30f));
  }
  cluster.sync();      // no CTA leaves while another reads its shared memory
}

template <int MASK, int DM>
int launch_dm(const void* q, const void* qs, const void* k, const void* ks,
              const void* v, const void* vs, const void* lim, const void* anc,
              void* out, int B, int S, int G, int T, int rep, int D, float sqrt_d,
              void* stream) {
  constexpr size_t dyn = dynamic_smem<DM>();
  if constexpr (dyn > 0) {   // once a device: the attribute is not a stream operation
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[dev]) {
      err = cudaFuncSetAttribute(attn_kernel<MASK, DM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (err != cudaSuccess) return (int)err;
      ready[dev] = true;
    }
  }
  const int row_blocks = (T * rep + MAX_ROWS - 1) / MAX_ROWS;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0
      && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC, G * row_blocks, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, attn_kernel<MASK, DM>, static_cast<const int8_t*>(q),
      static_cast<const float*>(qs), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<const int32_t*>(lim),
      static_cast<const int32_t*>(anc), static_cast<float*>(out), S, G, T, rep, D, sqrt_d,
      vec16);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instance for D: 128 for D <= 128 (every head dim before nemotron's),
// 192 above
template <int MASK>
int launch(const void* q, const void* qs, const void* k, const void* ks,
           const void* v, const void* vs, const void* lim, const void* anc,
           void* out, int B, int S, int G, int T, int rep, int D, float sqrt_d,
           void* stream) {
  const int row_blocks = (T * rep + MAX_ROWS - 1) / MAX_ROWS;
  if (B < 1 || S < 1 || G < 1 || T < 1 || rep < 1 || D < 4 || D > MAX_D
      || D % 4 != 0 || (MASK == kTree && T > 31) || B > 65535
      || (long long)G * row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  if (D <= 128)
    return launch_dm<MASK, 128>(q, qs, k, ks, v, vs, lim, anc, out, B, S, G, T, rep, D,
                                sqrt_d, stream);
  return launch_dm<MASK, 192>(q, qs, k, ks, v, vs, lim, anc, out, B, S, G, T, rep, D,
                              sqrt_d, stream);
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

// Shared memory a CTA of the instance that takes head dim D uses, in bytes
// (static for D <= 128, dynamic above); 0 for a D the body does not take.
extern "C" int decode_attn_smem_bytes(int D) {
  if (D < 4 || D > MAX_D || D % 4 != 0) return 0;
  return D <= 128 ? (int)sizeof(Smem<128>) : (int)sizeof(Smem<192>);
}
