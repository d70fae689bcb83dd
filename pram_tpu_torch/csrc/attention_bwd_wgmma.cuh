// The Hopper pieces shared by the attention backward kernels 13
// (attention_bwd.cu) and 14 (cross_attention_bwd.cu), on top of
// attention_wgmma.cuh's tensor maps, TMA ring and wgmma products.
//
// Both kernels take the softmax gradient in two passes, with no atomics and
// a fixed order of summation:
//   1. stats_cta: 128 query rows of one (frame, head), two consumer
//      warpgroups of 64, against the key tiles each warpgroup visits: per
//      row the max m of the logits in log2 units, 1 / sum and
//      t = sum_j p_j (g . v_j), with S = Q K^T and D = G V^T by wgmma in
//      registers, into an f32 scratch [3, frames, heads, N].
//   2. a gradient pass (in each kernel's .cu): one CTA per (frame, 128
//      tokens a), the heads inside. grad_produce streams, for each head,
//      a's tiles once and the other tokens' tiles o through the TMA ring
//      with their rows' statistics and key biases; the consumers form the
//      weights p and the score gradients in the accumulator registers, pack
//      them to bf16 A fragments and sum a's gradients with mma_rs against
//      the o tiles read MN-major. One copy of a tile serves as the K-major B
//      of the scores and as the MN-major B of the gradients.
// No score, weight or score gradient reaches shared or device memory. The
// statistics pass and the gradient pass fold the same constants: logits
// t = s * (scale log2 e) + bias * log2 e by one fma, p = 2^(t - m) / sum.
//
// Each consumer warpgroup owns 64 rows (a Part). Sides are multiples of 64
// tokens, so the two warpgroups of a CTA may visit different token ranges
// (two neighbouring sides in kernel 13, the two sides in kernel 14). Those
// ranges are equal or adjacent, so the producer streams their union and a
// warpgroup skips the tiles outside its own range (it still waits for each
// tile and releases it, which keeps the ring's phases in step). A
// warpgroup past the frame's last token (N an odd multiple of 64) takes no
// part, and the barriers count only the warps that do.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

namespace wg {

constexpr int PARTS = 2;           // consumer warpgroups of a backward CTA
constexpr int BR = PARTS * TR;     // rows of a backward CTA
constexpr int GROUP_WARPS = CONSUMER_WARPS / PARTS;

struct Part {  // one consumer warpgroup's rows
  int row;     // its first token in the frame
  int lo, hi;  // the tokens it visits, [lo, hi); lo == hi: it takes no part
};

__device__ __forceinline__ bool active(const Part& p) { return p.lo < p.hi; }

__device__ __forceinline__ int active_parts(const Part (&p)[PARTS]) {
  return active(p[1]) ? 2 : 1;
}

// part g, without indexing the array by a runtime value (local memory)
__device__ __forceinline__ Part part_of(const Part (&p)[PARTS], int g) {
  return g == 0 ? p[0] : p[1];
}

// the tiles the producer streams: the union [L, H) of the parts' ranges
__device__ __forceinline__ void span(const Part (&p)[PARTS], int& L, int& H) {
  L = p[0].lo;
  H = p[0].hi;
  if (active(p[1])) {
    L = min(L, p[1].lo);
    H = max(H, p[1].hi);
  }
}

struct Bias {  // key biases of a frame's tokens: t < split at lo[t], the others at hi[t - split]
  const float* lo;
  const float* hi;
  int split;
  __device__ __forceinline__ const float* at(int t) const {
    return t < split ? lo + t : hi + (t - split);
  }
};

struct Rows {  // a consumer thread's two rows r, r + 8 of a part
  float m0, m1;  // max, log2 units
  float r0, r1;  // 1 / sum
  float t0, t1;  // sum_j p_j dp_j
  float b0, b1;  // key bias * log2 e
};

// x = A B^T over head dim 64, both K-major in shared memory; issued into
// the open group
__device__ __forceinline__ void score_issue(Acc& x, uint64_t a, uint64_t b) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
    mma_ss(x, a + k * DESC_K_STEP, b + k * DESC_K_STEP, k);
}

// c += A B for A as bf16 fragments of a [64 x 64] (rows of c by the 64
// tokens o), B a 64 x 64 tile read MN-major; issued into the open group
__device__ __forceinline__ void grad_issue(Acc& c, const uint32_t (&a)[4][4],
                                           uint64_t db) {
#pragma unroll
  for (int k = 0; k < TR / 16; ++k) mma_rs(c, a[k], db + k * DESC_ROW16_STEP);
}

// the f32 values (row r: v00, v01; row r + 8: v10, v11) of 8-column block j
// as bf16 into the A fragments of the next product
__device__ __forceinline__ void pack_block(uint32_t (&a)[4][4], int j,
                                           float v00, float v01, float v10,
                                           float v11) {
  a[j / 2][(j % 2) * 2 + 0] = pack_bf16(v00, v01);
  a[j / 2][(j % 2) * 2 + 1] = pack_bf16(v10, v11);
}

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) c.d[i] = 0.f;
}

// ---- the statistics pass

// shared memory: each part's Q and G tiles, the ring's K, V and key-bias
// tiles, barriers
constexpr size_t BWD_STATS_SMEM = 1024 + 2 * PARTS * TILE_BYTES +
                                  STAGES * (2 * TILE_BYTES + TR * sizeof(float)) +
                                  (2 * STAGES + 1) * sizeof(uint64_t);

// One CTA, THREADS threads: the parts' rows of `frame` as queries (columns
// q_col of mq, g_col of mg) against the tokens each visits (k_col of mk,
// v_col of mv; key biases kb). st: the (frame, head)'s row 0 in the first
// plane of the scratch, the planes `plane` floats apart.
__device__ __forceinline__ void stats_cta(
    const CUtensorMap* mq, int q_col, const CUtensorMap* mk, int k_col,
    const CUtensorMap* mv, int v_col, const CUtensorMap* mg, int g_col,
    int frame, const Part (&part)[PARTS], Bias kb, float scale, float* st,
    size_t plane, unsigned char* smem_raw) {
  unsigned char* sm = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Gs = Qs + PARTS * TR * HD;
  bf16* Ks = Gs + PARTS * TR * HD;
  bf16* Vs = Ks + STAGES * TR * HD;
  float* Bs = reinterpret_cast<float*>(Vs + STAGES * TR * HD);
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * TR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int np = active_parts(part);
  int L, H;
  span(part, L, H);
  const int ntiles = (H - L) / TR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], np * GROUP_WARPS);
    }
    bar_init(qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == CONSUMERS) {
      bar_expect(qbar, np * 2 * TILE_BYTES);
#pragma unroll
      for (int g = 0; g < PARTS; ++g)
        if (g < np) {
          tma_load(Qs + g * TR * HD, mq, q_col, part[g].row, frame, qbar);
          tma_load(Gs + g * TR * HD, mg, g_col, part[g].row, frame, qbar);
        }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) bar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const int k0 = L + it * TR;
        bar_expect(&full[s], 2 * TILE_BYTES + TR * sizeof(float));
        tma_load(Ks + s * TR * HD, mk, k_col, k0, frame, &full[s]);
        tma_load(Vs + s * TR * HD, mv, v_col, k0, frame, &full[s]);
        bulk_load(Bs + s * TR, kb.at(k0), TR * sizeof(float), &full[s]);
      }
    }
    return;
  }

  const int g = threadIdx.x >> 7;
  if (g >= np) return;
  const Part me = part_of(part, g);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const float sl2 = scale * LOG2E;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows r and r + 8
  float l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;  // this lane's shares

  bar_wait(qbar, 0);
  const uint64_t dq = desc(Qs + g * TR * HD), dg = desc(Gs + g * TR * HD);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    bar_wait(&full[s], (it / STAGES) & 1);
    const int k0 = L + it * TR;
    if (k0 >= me.lo && k0 < me.hi) {
      Acc sc, dp;
      mma_fence();
      score_issue(sc, dq, desc(Ks + s * TR * HD));
      score_issue(dp, dg, desc(Vs + s * TR * HD));
      mma_commit();
      mma_wait();
      reg_fence(sc);
      reg_fence(dp);
      float c0, c1, s0, s1;
      softmax_tile(sc, Bs + s * TR, sl2, m0, m1, c0, c1, s0, s1);
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d0 += sc.d[4 * j + 0] * dp.d[4 * j + 0] + sc.d[4 * j + 1] * dp.d[4 * j + 1];
        d1 += sc.d[4 * j + 2] * dp.d[4 * j + 2] + sc.d[4 * j + 3] * dp.d[4 * j + 3];
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
      u0 = u0 * c0 + d0;
      u1 = u1 * c1 + d1;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // K, V and biases of s read
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  u0 = quad_sum(u0);
  u1 = quad_sum(u1);
  if ((lane & 3) == 0) {
    const int r = me.row + warp * 16 + (lane >> 2);
    st[r] = m0;
    st[plane + r] = 1.f / l0;
    st[2 * plane + r] = u0 / l0;
    st[r + 8] = m1;
    st[plane + r + 8] = 1.f / l1;
    st[2 * plane + r + 8] = u1 / l1;
  }
}

// ---- the gradient passes' threads, shared memory and producer

// A gradient pass holds one head's gradient accumulators of 64 rows (64 or
// 96 registers a thread) beside the scores of an o tile: more than the 168
// registers a thread that 288 threads get at one CTA an SM (three warps
// share a quarter of the register file). So its producer is a warpgroup
// that gives registers back (setmaxnreg) and the consumers take them:
// 128 x 24 + 256 x 240 = 384 x 168.
constexpr int GRAD_THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a consumer warp's release of a ring stage or of the a tiles
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}

// Shared memory of a gradient pass: NA tiles of a's rows a head for each
// part; a ring of NS stages of NO tiles of the o rows; vectors of four
// rows of 64 floats (max, 1 / sum, t, key bias) for the o tiles of each
// stage and for each part's a rows; EPI bytes for each consumer warp's
// epilogue; barriers.
template <int NA, int NO, int NS, int EPI>
struct GradSmem {
  static constexpr size_t BYTES =
      1024 + (size_t)(NA * PARTS + NS * NO) * TILE_BYTES +
      (size_t)(NS + PARTS) * 4 * TR * sizeof(float) +
      (size_t)CONSUMER_WARPS * EPI + (2 * NS + 2) * sizeof(uint64_t);
  bf16* a;
  bf16* o;
  float* ov;
  float* av;
  unsigned char* epi;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* afull;
  uint64_t* aempty;

  __device__ __forceinline__ explicit GradSmem(unsigned char* raw) {
    a = reinterpret_cast<bf16*>(align1024(raw));
    o = a + NA * PARTS * TR * HD;
    ov = reinterpret_cast<float*>(o + NS * NO * TR * HD);
    av = ov + NS * 4 * TR;
    epi = reinterpret_cast<unsigned char*>(av + PARTS * 4 * TR);
    full = reinterpret_cast<uint64_t*>(epi + CONSUMER_WARPS * EPI);
    empty = full + NS;
    afull = empty + NS;
    aempty = afull + 1;
  }
  __device__ __forceinline__ bf16* a_tile(int t, int g) const {
    return a + (t * PARTS + g) * TR * HD;
  }
  __device__ __forceinline__ bf16* o_tile(int s, int t) const {
    return o + (s * NO + t) * TR * HD;
  }
  __device__ __forceinline__ float* o_vec(int s, int v) const {
    return ov + (s * 4 + v) * TR;
  }
  __device__ __forceinline__ float* a_vec(int g, int v) const {
    return av + (g * 4 + v) * TR;
  }
  // this consumer warp's epilogue bytes
  __device__ __forceinline__ unsigned char* warp_epi() const {
    return epi + (threadIdx.x >> 5) * EPI;
  }
  // thread 0, before the CTA's first __syncthreads
  __device__ __forceinline__ void init(int np) const {
    for (int s = 0; s < NS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], np * GROUP_WARPS);
    }
    bar_init(afull, 1);
    bar_init(aempty, np * GROUP_WARPS);
    bar_init_fence();
  }
  // a consumer thread's rows r, r + 8 of part g (after afull)
  __device__ __forceinline__ Rows rows(int g, int r) const {
    const float* v = a_vec(g, 0);
    return Rows{v[r],          v[r + 8],          v[TR + r],
                v[TR + r + 8], v[2 * TR + r],     v[2 * TR + r + 8],
                v[3 * TR + r] * LOG2E, v[3 * TR + r + 8] * LOG2E};
  }
  // the ring's stage of its it-th tile; waits for that tile
  static __device__ __forceinline__ int stage(int it) { return it % NS; }
  __device__ __forceinline__ void wait_tile(int it) const {
    bar_wait(&full[it % NS], (it / NS) & 1);
  }
  // lets n tiles of the ring pass (tiles outside a part's range), from the
  // it-th on
  __device__ __forceinline__ void pass_tiles(int& it, int n) const {
    for (int i = 0; i < n; ++i, ++it) {
      wait_tile(it);
      release(&empty[it % NS]);
    }
  }
};

// The producer lane of a gradient pass. For each head h: once the
// consumers release the previous head's a tiles (aempty), the NA a tiles of
// each active part (columns acol[t] + 64 h of amap[t]) with their rows'
// statistics (and, for the first head, their key biases) on afull; then
// the NO tiles of every o tile of [L, H) with their rows' statistics and
// key biases through the ring. st: the frame's head 0, row 0, in the first
// plane of the statistics scratch (head h at + h * N).
template <int NA, int NO, int NS, int EPI>
__device__ __forceinline__ void grad_produce(
    const GradSmem<NA, NO, NS, EPI>& sm, const CUtensorMap* const (&amap)[NA],
    const int (&acol)[NA], const CUtensorMap* const (&omap)[NO],
    const int (&ocol)[NO], int frame, const Part (&part)[PARTS], Bias kb,
    int heads, const float* st, int N, size_t plane) {
  const int np = active_parts(part);
  int L, H;
  span(part, L, H);
  const int ntiles = (H - L) / TR;
  constexpr uint32_t VEC = TR * sizeof(float);
  int it = 0;
  for (int h = 0; h < heads; ++h) {
    const float* sh = st + (size_t)h * N;
    if (h > 0) bar_wait(sm.aempty, (h - 1) & 1);
    bar_expect(sm.afull, np * (NA * TILE_BYTES + (h == 0 ? 4 : 3) * VEC));
#pragma unroll
    for (int g = 0; g < PARTS; ++g) {
      if (g >= np) break;
      const int row = part[g].row;
#pragma unroll
      for (int t = 0; t < NA; ++t)
        tma_load(sm.a_tile(t, g), amap[t], acol[t] + h * HD, row, frame,
                 sm.afull);
#pragma unroll
      for (int v = 0; v < 3; ++v)
        bulk_load(sm.a_vec(g, v), sh + v * plane + row, VEC, sm.afull);
      if (h == 0) bulk_load(sm.a_vec(g, 3), kb.at(row), VEC, sm.afull);
    }
    for (int i = 0; i < ntiles; ++i, ++it) {
      const int s = it % NS;
      if (it >= NS) bar_wait(&sm.empty[s], ((it / NS) - 1) & 1);
      const int o0 = L + i * TR;
      bar_expect(&sm.full[s], NO * TILE_BYTES + 4 * VEC);
#pragma unroll
      for (int t = 0; t < NO; ++t)
        tma_load(sm.o_tile(s, t), omap[t], ocol[t] + h * HD, o0, frame,
                 &sm.full[s]);
#pragma unroll
      for (int v = 0; v < 3; ++v)
        bulk_load(sm.o_vec(s, v), sh + v * plane + o0, VEC, &sm.full[s]);
      bulk_load(sm.o_vec(s, 3), kb.at(o0), VEC, &sm.full[s]);
    }
  }
}

}  // namespace wg

}  // namespace
