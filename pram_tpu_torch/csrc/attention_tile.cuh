// One warp's share of a key tile in the f32 instances of the attention
// kernels (attention_stats.cuh's pass::message_block and stats_block, used
// by attention_qkv.cu and cross_attention_packed.cu for the matcher's f32
// A/B checks): 16 query rows against 64 keys of head dim 64, with an online
// softmax, multiplied on the CUDA cores in f32; and what the kernels share
// around them (head dim, the sides of a token concatenation, conversions).
// The bf16 passes are attention_wgmma.cuh's.
//
// Rounding follows the TPU kernels' _attn_weights: logits s * scale + bias
// in f32, the weights exp(logit - running max) for P @ V, the f32 running
// sum folded into the output at the end.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace {

namespace tile {

typedef __nv_bfloat16 bf16;

constexpr int HD = 64;       // head dim
constexpr int KT = 64;       // keys per tile
constexpr int LDF = HD + 4;  // f32 row stride of the q, k, v, p, score and output tiles

constexpr int MAX_SIDES = 8;

// Independent sides of a token concatenation: side s is [edge[s], edge[s+1]).
struct Sides {
  int n;
  int edge[MAX_SIDES + 1];
  // the side token t lies in
  __device__ __forceinline__ void find(int t, int& lo, int& hi) const {
    lo = edge[0];
    hi = edge[n];
    for (int s = 0; s < n; ++s)
      if (t >= edge[s] && t < edge[s + 1]) {
        lo = edge[s];
        hi = edge[s + 1];
      }
  }
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// S[16 x 64] (f32, ld LDF) = A[16 x 64] . B[64 x 64]^T; rows of B are keys;
// lane -> row lane / 2, columns (lane % 2) * 32 .. + 32
__device__ __forceinline__ void qk16(const float* A, const float* B, float* S) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float a[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) a[d] = A[r * LDF + d];
  for (int j = c0; j < c0 + 32; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(a[d], B[j * LDF + d], s);
    S[r * LDF + j] = s;
  }
}

// O[16 x 64] (f32, ld LDF) += P[16 x 64] . V[64 x 64]; lane as in qk16
__device__ __forceinline__ void pv16(const float* P, const float* V, float* O) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float o[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) o[c] = O[r * LDF + c0 + c];
  for (int j = 0; j < KT; ++j) {
    const float p = P[r * LDF + j];
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] = fmaf(p, V[j * LDF + c0 + c], o[c]);
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) O[r * LDF + c0 + c] = o[c];
}

// Folds one key tile into this warp's running state. Qw: the warp's 16
// query rows; Ks, Vs: the tile's keys and values (all ld LDF); kbias:
// the tile's 64 key biases; Sw, Pw, Ow: the warp's score, weight and output
// tiles; m_run, l_run: running max and sum of row lane / 2.
__device__ __forceinline__ void attend(const float* Qw, const float* Ks,
                                       const float* Vs, const float* kbias,
                                       float scale, float* Sw, float* Pw,
                                       float* Ow, float& m_run, float& l_run) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;

  qk16(Qw, Ks, Sw);
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
    Pw[r * LDF + j] = p;
    Ow[r * LDF + j] *= corr;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_run = l_run * corr + sum;
  m_run = m_new;
  __syncwarp();

  pv16(Pw, Vs, Ow);
  __syncwarp();
}

// Writes row lane / 2 of the warp's output tile, normalized by l_run, to
// orow (the row's 64 head columns in device memory).
__device__ __forceinline__ void store_row(const float* Ow, float l_run,
                                          float* orow) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const float inv = 1.f / l_run;
  for (int j = c0; j < c0 + 32; ++j) orow[j] = Ow[r * LDF + j] * inv;
}

}  // namespace tile

}  // namespace
