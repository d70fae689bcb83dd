// One warp's share of a key tile in the attention kernels (attention.cu,
// cross_attention.cu): 16 query rows against 64 keys of head dim 64, with
// bf16 WMMA tiles (16x16x16, f32 accumulate) and an online softmax.
//
// Rounding follows the TPU kernels' _attn_weights: logits s * scale + bias
// in f32, the weights exp(logit - running max) rounded to bf16 for P @ V,
// the f32 running sum folded into the output at the end.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

namespace {

namespace tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int HD = 64;       // head dim
constexpr int KT = 64;       // keys per tile
constexpr int LDH = HD + 8;  // bf16 row stride of q, k, v, p tiles
constexpr int LDF = HD + 4;  // f32 row stride of per-warp score/output tiles

// Folds one key tile into this warp's running state. Qw: the warp's 16
// query rows (ld LDH); Ks, Vs: the tile's keys and values (ld LDH); kbias:
// the tile's 64 key biases; Sw, Pw, Ow: the warp's score, weight and output
// tiles; m_run, l_run: running max and sum of row lane / 2.
__device__ __forceinline__ void attend(const bf16* Qw, const bf16* Ks,
                                       const bf16* Vs, const float* kbias,
                                       float scale, float* Sw, bf16* Pw,
                                       float* Ow, float& m_run, float& l_run) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;

  // ---- S = Q K^T
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int k = 0; k < HD; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qw + k, LDH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + j * 16 * LDH + k, LDH);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Sw + j * 16, acc[j], LDF, wmma::mem_row_major);
  }
  __syncwarp();

  // ---- online softmax over this tile (2 lanes per row)
  float mx = -INFINITY;
  for (int j = c0; j < c0 + 32; ++j)
    mx = fmaxf(mx, Sw[r * LDF + j] * scale + kbias[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(m_run, mx);
  const float corr = expf(m_run - m_new);
  float sum = 0.f;
  for (int j = c0; j < c0 + 32; ++j) {
    float p = expf(Sw[r * LDF + j] * scale + kbias[j] - m_new);
    sum += p;
    Pw[r * LDH + j] = __float2bfloat16(p);
    Ow[r * LDF + j] *= corr;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_run = l_run * corr + sum;
  m_run = m_new;
  __syncwarp();

  // ---- O += P V
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(acc[j], Ow + j * 16, LDF, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < KT; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + k, LDH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, Vs + k * LDH + j * 16, LDH);
        wmma::mma_sync(acc[j], a, bv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Ow + j * 16, acc[j], LDF, wmma::mem_row_major);
  }
  __syncwarp();
}

// Writes row lane / 2 of the warp's output tile, normalized by l_run, as
// bf16 to orow (the row's 64 head columns in device memory).
__device__ __forceinline__ void store_row(const float* Ow, float l_run,
                                          bf16* orow) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const float inv = 1.f / l_run;
  for (int j = c0; j < c0 + 32; ++j)
    orow[j] = __float2bfloat16(Ow[r * LDF + j] * inv);
}

}  // namespace tile

}  // namespace
