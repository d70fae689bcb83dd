// The two passes of the attention kernels that emit AdaGML's per-key
// received-attention statistics (attention_qkv.cu, cross_attention_packed.cu),
// for element type T = bf16 (the working type) or float (the f32 A/B checks).
//
// The statistic of key k is  sum over heads h and valid queries q of
// softmax_q(k) = exp(logit_qk - max_q) / sum_q,  the NORMALIZED f32 weight.
// An online softmax knows a row's max and sum only after its last key tile,
// so no column sum can be taken as the message pass goes. Two passes, no
// atomics:
//   1. message_block: one block per (frame, head, 128 queries) streams the
//      keys in 64-key tiles with an online softmax (attention_tile.cuh),
//      writes the messages and, for the statistics, each query row's final
//      max m_q and weight w_q = valid_q / sum_q (f32 [frames, heads, queries]).
//   2. stats_block: one block per (frame, 64 keys) walks every head and every
//      64-query tile, recomputes the logits K Q^T * scale + key bias, and sums
//      w_q * exp(logit - m_q) over the queries into its own keys, in
//      registers. The statistic's operations are those of the logits
//      product once more plus one exp per (head, query, key).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

namespace pass {

using tile::HD;
using tile::KT;
using tile::LDF;
typedef __nv_bfloat16 bf16;

constexpr int QT = 128;                 // queries per message block
constexpr int NWARP = 8;                // 16 query rows per warp
constexpr int NTHREADS = NWARP * 32;
constexpr int SWARP = 4;                // stats block: 16 keys per warp
constexpr int STHREADS = SWARP * 32;
constexpr int SK = SWARP * 16;          // keys per stats block
constexpr int SQ = 64;                  // queries per stats step

template <typename T>
constexpr size_t message_smem() {
  // Q tile, K and V tiles, per-warp P tiles (T); per-warp S and O tiles (f32)
  return (size_t)(QT + 2 * KT + NWARP * 16) * tile::Ld<T>::value * sizeof(T) +
         2ull * NWARP * 16 * LDF * sizeof(float);
}

template <typename T>
constexpr size_t stats_smem() {
  // K and Q tiles (T), per-warp S tiles, the step's query max and weight (f32)
  return (size_t)(SK + SQ) * tile::Ld<T>::value * sizeof(T) +
         (size_t)SWARP * 16 * LDF * sizeof(float) + 2ull * SQ * sizeof(float);
}

// copy `rows` rows of HD elements (global row stride ld elements, 16-byte
// aligned) into a shared tile of row stride Ld<T>
template <typename T, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          size_t ld) {
  constexpr int VEC = HD * sizeof(T) / 16;  // 16-byte vectors per row
  constexpr int PER = 16 / sizeof(T);
  constexpr int LD = tile::Ld<T>::value;
  for (int i = threadIdx.x; i < rows * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * PER;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

// Pass 1 for 128 queries of one (frame, head). Q: the first query row's head
// columns (row stride ldq); K, V: key row 0's head columns; kbias: the
// frame's key biases (indexed by key); keys [lo, hi); out: the first query
// row's head columns (row stride ldo). With stats, qbias is the first query
// row's bias and row_m / row_w receive the rows' max and valid / sum.
template <typename T>
__device__ __forceinline__ void message_block(
    const T* Q, size_t ldq, const T* K, size_t ldk, const T* V, size_t ldv,
    const float* kbias, int lo, int hi, float scale, T* out, size_t ldo,
    const float* qbias, float* row_m, float* row_w, unsigned char* smem) {
  constexpr int LD = tile::Ld<T>::value;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + QT * LD;
  T* Vs = Ks + KT * LD;
  T* Ps = Vs + KT * LD;
  float* Sf = reinterpret_cast<float*>(Ps + NWARP * 16 * LD);
  float* Of = Sf + NWARP * 16 * LDF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = Sf + warp * 16 * LDF;
  float* Ow = Of + warp * 16 * LDF;
  T* Pw = Ps + warp * 16 * LD;

  load_tile<T, NTHREADS>(Qs, Q, QT, ldq);
  for (int i = lane; i < 16 * LDF; i += 32) Ow[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row lane / 2 of this warp

  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, NTHREADS>(Ks, K + (size_t)k0 * ldk, KT, ldk);
    load_tile<T, NTHREADS>(Vs, V + (size_t)k0 * ldv, KT, ldv);
    __syncthreads();
    tile::attend(Qs + warp * 16 * LD, Ks, Vs, kbias + k0, scale, Sw, Pw, Ow,
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
template <typename T>
__device__ __forceinline__ void stats_block(
    const T* Qf, size_t ldq, const T* Kf, size_t ldk, const float* kbias,
    const float* row_m, const float* row_w, int nq, int lo, int hi,
    int heads, float scale, float* stat, unsigned char* smem) {
  constexpr int LD = tile::Ld<T>::value;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Qs = Ks + SK * LD;
  float* Sf = reinterpret_cast<float*>(Qs + SQ * LD);
  float* qm = Sf + SWARP * 16 * LDF;
  float* qw = qm + SQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float* Sw = Sf + warp * 16 * LDF;
  const float kb = kbias[warp * 16 + r];
  float acc = 0.f;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    load_tile<T, STHREADS>(Ks, Kf + h * HD, SK, ldk);
    for (int q0 = lo; q0 < hi; q0 += SQ) {
      __syncthreads();  // the previous query tile is no longer read
      load_tile<T, STHREADS>(Qs, Qf + (size_t)q0 * ldq + h * HD, SQ, ldq);
      for (int i = threadIdx.x; i < SQ; i += STHREADS) {
        qm[i] = row_m[(size_t)h * nq + q0 + i];
        qw[i] = row_w[(size_t)h * nq + q0 + i];
      }
      __syncthreads();
      tile::qk16(Ks + warp * 16 * LD, Qs, Sw);  // S^T: keys x queries
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

}  // namespace
