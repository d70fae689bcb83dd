// The two passes of the attention kernels that emit AdaGML's per-key
// received-attention statistics (attention_qkv.cu, cross_attention_packed.cu).
//
// The statistic of key k is  sum over heads h and valid queries q of
// softmax_q(k) = exp(logit_qk - max_q) / sum_q,  the NORMALIZED f32 weight.
// An online softmax knows a row's max and sum only after its last key tile,
// and its rescaling cannot be applied to a column sum afterwards; keeping S
// instead (bf16, 8 frames x 4 heads x 4096^2) would be 1.07 GB, slower to
// write and read than to recompute. So every (query, key) takes three
// products, QK and PV for the messages and QK once more for the statistic,
// in two passes, with the column sums in registers and no atomics: the
// result is the same bits on every launch (AdaGML's pruning reads it).
//   1. the message pass: one CTA per (frame, head, 128 queries) streams the
//      keys with an online softmax, writes the messages and, for the
//      statistics, each query row's final max m_q and weight
//      w_q = valid_q / sum_q (f32 [frames, heads, queries]).
//   2. the statistics pass: one CTA per (frame, 128 keys) walks every head
//      and every 64-query tile, recomputes the logits K Q^T * scale + key
//      bias, and sums w_q * exp(min(logit - m_q, 0)) over the queries into
//      its own keys. Its operations are the logits product once more plus
//      one exp per (head, query, key).
//
// bf16 (the working type): wg::message_cta (attention_wgmma.cuh) and
// wg::stats_cta below, wgmma on TMA-fed 128-byte-swizzled tiles with S and
// the sums in registers; m_q in log2 units. float (only the f32 A/B checks
// of the matcher): pass::message_block and pass::stats_block, the CUDA-core
// tiles of attention_tile.cuh through shared memory; m_q in natural units.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace {

// ---- float: CUDA-core tiles through shared memory

namespace pass {

using tile::HD;
using tile::KT;
using tile::LDF;

constexpr int QT = 128;                 // queries per message block
constexpr int NWARP = 8;                // 16 query rows per warp
constexpr int NTHREADS = NWARP * 32;
constexpr int SWARP = 4;                // stats block: 16 keys per warp
constexpr int STHREADS = SWARP * 32;
constexpr int SK = SWARP * 16;          // keys per stats block
constexpr int SQ = 64;                  // queries per stats step

// Q tile, K and V tiles, per-warp P, S and O tiles
constexpr size_t MESSAGE_SMEM =
    (size_t)(QT + 2 * KT + 3 * NWARP * 16) * LDF * sizeof(float);
// K and Q tiles, per-warp S tiles, the step's query max and weight
constexpr size_t STATS_SMEM =
    ((size_t)(SK + SQ + SWARP * 16) * LDF + 2 * SQ) * sizeof(float);

// copy `rows` rows of HD elements (global row stride ld elements, 16-byte
// aligned) into a shared tile of row stride LDF
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, size_t ld) {
  constexpr int VEC = HD * sizeof(float) / 16;  // 16-byte vectors per row
  constexpr int PER = 16 / sizeof(float);
  for (int i = threadIdx.x; i < rows * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * PER;
    *reinterpret_cast<uint4*>(dst + r * LDF + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// Pass 1 for 128 queries of one (frame, head). Q: the first query row's head
// columns (row stride ldq); K, V: key row 0's head columns; kbias: the
// frame's key biases (indexed by key); keys [lo, hi); out: the first query
// row's head columns (row stride ldo). With stats, qbias is the first query
// row's bias and row_m / row_w receive the rows' max and valid / sum.
__device__ __forceinline__ void message_block(
    const float* Q, size_t ldq, const float* K, size_t ldk, const float* V, size_t ldv,
    const float* kbias, int lo, int hi, float scale, float* out, size_t ldo,
    const float* qbias, float* row_m, float* row_w, unsigned char* smem) {
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + QT * LDF;
  float* Vs = Ks + KT * LDF;
  float* Ps = Vs + KT * LDF;
  float* Sf = reinterpret_cast<float*>(Ps + NWARP * 16 * LDF);
  float* Of = Sf + NWARP * 16 * LDF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = Sf + warp * 16 * LDF;
  float* Ow = Of + warp * 16 * LDF;
  float* Pw = Ps + warp * 16 * LDF;

  load_tile<NTHREADS>(Qs, Q, QT, ldq);
  for (int i = lane; i < 16 * LDF; i += 32) Ow[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row lane / 2 of this warp

  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<NTHREADS>(Ks, K + (size_t)k0 * ldk, KT, ldk);
    load_tile<NTHREADS>(Vs, V + (size_t)k0 * ldv, KT, ldv);
    __syncthreads();
    tile::attend(Qs + warp * 16 * LDF, Ks, Vs, kbias + k0, scale, Sw, Pw, Ow,
                 m_run, l_run);
  }

  const int row = warp * 16 + (lane >> 1);
  tile::store_row(Ow, l_run, out + (size_t)row * ldo);
  if (row_m != nullptr && (lane & 1) == 0) {
    row_m[row] = m_run;
    row_w[row] = qbias[row] > -0.5f ? 1.f / l_run : 0.f;
  }
}

// Pass 2 for 64 keys of one frame. Qf: query row 0, column 0 (row stride
// ldq); Kf: the block's first key, column 0 (row stride ldk); kbias: the
// block's first key bias; row_m / row_w: the frame's [heads][nq] rows of
// pass 1; queries [lo, hi). Writes the 64 statistics to stat.
__device__ __forceinline__ void stats_block(
    const float* Qf, size_t ldq, const float* Kf, size_t ldk, const float* kbias,
    const float* row_m, const float* row_w, int nq, int lo, int hi,
    int heads, float scale, float* stat, unsigned char* smem) {
  float* Ks = reinterpret_cast<float*>(smem);
  float* Qs = Ks + SK * LDF;
  float* Sf = reinterpret_cast<float*>(Qs + SQ * LDF);
  float* qm = Sf + SWARP * 16 * LDF;
  float* qw = qm + SQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float* Sw = Sf + warp * 16 * LDF;
  const float kb = kbias[warp * 16 + r];
  float acc = 0.f;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    load_tile<STHREADS>(Ks, Kf + h * HD, SK, ldk);
    for (int q0 = lo; q0 < hi; q0 += SQ) {
      __syncthreads();  // the previous query tile is no longer read
      load_tile<STHREADS>(Qs, Qf + (size_t)q0 * ldq + h * HD, SQ, ldq);
      for (int i = threadIdx.x; i < SQ; i += STHREADS) {
        qm[i] = row_m[(size_t)h * nq + q0 + i];
        qw[i] = row_w[(size_t)h * nq + q0 + i];
      }
      __syncthreads();
      tile::qk16(Ks + warp * 16 * LDF, Qs, Sw);  // S^T: keys x queries
      __syncwarp();
      for (int j = c0; j < c0 + 32; ++j) {
        // a masked query row has weight 0 (and its max may be -1e9, so the
        // exp is not taken); min(., 0) keeps a logit recomputed one rounding
        // above the row max from leaving [0, 1]
        if (qw[j] > 0.f)
          acc += qw[j] * expf(fminf(Sw[r * LDF + j] * scale + kb - qm[j], 0.f));
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((lane & 1) == 0) stat[warp * 16 + r] = acc;
}

}  // namespace pass

// ---- bf16: wgmma on TMA-fed tiles

namespace wg {

constexpr int SK = 2 * TR;     // keys of a statistics CTA: one 64-row tile a warpgroup
constexpr int MAX_HEADS = 4;   // the kernels' d = 256 at head dim 64

// shared memory: every head's K tiles of the CTA's keys, the ring's Q tiles
// and their rows' max and weight, barriers
constexpr size_t STATS_SMEM = 1024 + MAX_HEADS * 2 * TILE_BYTES +
                              STAGES * TILE_BYTES +
                              STAGES * 2 * TR * sizeof(float) +
                              (2 * STAGES + 1) * sizeof(uint64_t);

// One CTA, THREADS threads: keys [k_row, k_row + 128) of `frame` (rows of mk,
// head h at column h * 64) against queries [lo, hi) (rows of mq; multiples
// of 64). kbias: the CTA's first key's bias. row_m, row_w: the frame's
// pass-1 rows of head 0 at query 0 (log2-unit max and weight), head h at
// + h * nq (16-byte aligned). Writes the 128 statistics to stat.
__device__ __forceinline__ void stats_cta(
    const CUtensorMap* mq, const CUtensorMap* mk, int frame, int k_row,
    int lo, int hi, int heads, const float* kbias, const float* row_m,
    const float* row_w, size_t nq, float scale, float* stat,
    unsigned char* smem_raw) {
  unsigned char* sm = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Qs = Ks + MAX_HEADS * 2 * TR * HD;
  float* Ms = reinterpret_cast<float*>(Qs + STAGES * TR * HD);
  uint64_t* full = reinterpret_cast<uint64_t*>(Ms + STAGES * 2 * TR);
  uint64_t* empty = full + STAGES;
  uint64_t* kbar = empty + STAGES;
  const int nqt = (hi - lo) / TR;
  const int steps = heads * nqt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMER_WARPS);
    }
    bar_init(kbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == CONSUMERS) {
      bar_expect(kbar, heads * 2 * TILE_BYTES);
      for (int h = 0; h < heads; ++h)
        for (int t = 0; t < 2; ++t)
          tma_load(Ks + (h * 2 + t) * TR * HD, mk, h * HD, k_row + t * TR,
                   frame, kbar);
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) bar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const int h = it / nqt, q0 = lo + (it % nqt) * TR;
        const size_t at = (size_t)h * nq + q0;
        bar_expect(&full[s], TILE_BYTES + 2 * TR * sizeof(float));
        tma_load(Qs + s * TR * HD, mq, h * HD, q0, frame, &full[s]);
        bulk_load(Ms + s * 2 * TR, row_m + at, TR * sizeof(float), &full[s]);
        bulk_load(Ms + s * 2 * TR + TR, row_w + at, TR * sizeof(float),
                  &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup g owns keys 64 g .. 64 g + 63 (the rows of S^T)
  const int g = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);
  const int r = g * TR + warp * 16 + (lane >> 2);  // keys r and r + 8
  const float sl2 = scale * LOG2E;
  const float kb0 = kbias[r] * LOG2E, kb1 = kbias[r + 8] * LOG2E;
  float acc0 = 0.f, acc1 = 0.f;

  bar_wait(kbar, 0);
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES, h = it / nqt;
    bar_wait(&full[s], (it / STAGES) & 1);
    Acc st;  // S^T: keys x queries
    qk_issue(st, desc(Ks + (h * 2 + g) * TR * HD), desc(Qs + s * TR * HD));
    mma_wait();
    reg_fence(st);
    const float* qm = Ms + s * 2 * TR;
    const float* qw = qm + TR;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 m = *reinterpret_cast<const float2*>(qm + 8 * j + cq);
      const float2 w = *reinterpret_cast<const float2*>(qw + 8 * j + cq);
      // a masked query row has weight 0 (and its max may be -1e9 log2 e, so
      // the exp is not taken); min(., 0) keeps a logit recomputed one
      // rounding above the row max from leaving [0, 1]
      if (w.x > 0.f) {
        acc0 += w.x * ex2(fminf(fmaf(st.d[4 * j + 0], sl2, kb0) - m.x, 0.f));
        acc1 += w.x * ex2(fminf(fmaf(st.d[4 * j + 2], sl2, kb1) - m.x, 0.f));
      }
      if (w.y > 0.f) {
        acc0 += w.y * ex2(fminf(fmaf(st.d[4 * j + 1], sl2, kb0) - m.y, 0.f));
        acc1 += w.y * ex2(fminf(fmaf(st.d[4 * j + 3], sl2, kb1) - m.y, 0.f));
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // Q, max and weight of s read
  }

  acc0 = quad_sum(acc0);
  acc1 = quad_sum(acc1);
  if ((lane & 3) == 0) {
    stat[r] = acc0;
    stat[r + 8] = acc1;
  }
}

}  // namespace wg

}  // namespace
