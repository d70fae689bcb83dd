// One warp's share of a key tile in the attention kernels (attention.cu,
// cross_attention.cu, attention_qkv.cu, cross_attention_packed.cu): 16 query
// rows against 64 keys of head dim 64, with an online softmax.
//
// The element type T is bf16 or float. bf16 tiles multiply on the tensor
// cores (WMMA 16x16x16, f32 accumulate); float tiles, which only the f32
// A/B checks of the matcher use, multiply on the CUDA cores in f32.
//
// Rounding follows the TPU kernels' _attn_weights: logits s * scale + bias
// in f32, the weights exp(logit - running max) rounded to T for P @ V, the
// f32 running sum folded into the output at the end.

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
constexpr int LDF = HD + 4;  // f32 row stride of score/output tiles (and of float q, k, v, p tiles)

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

template <typename T> struct Ld;  // row stride of a T tile
template <> struct Ld<bf16> { static constexpr int value = LDH; };
template <> struct Ld<float> { static constexpr int value = LDF; };

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// S[16 x 64] (f32, ld LDF) = A[16 x 64] . B[64 x 64]^T; rows of B are keys
__device__ __forceinline__ void qk16(const bf16* A, const bf16* B, float* S) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int k = 0; k < HD; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + k, LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(bk, B + j * 16 * LDH + k, LDH);
      wmma::mma_sync(acc[j], a, bk, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(S + j * 16, acc[j], LDF, wmma::mem_row_major);
}

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

// O[16 x 64] (f32, ld LDF) += P[16 x 64] . V[64 x 64]
__device__ __forceinline__ void pv16(const bf16* P, const bf16* V, float* O) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::load_matrix_sync(acc[j], O + j * 16, LDF, wmma::mem_row_major);
#pragma unroll
  for (int k = 0; k < KT; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, P + k, LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(bv, V + k * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], a, bv, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(O + j * 16, acc[j], LDF, wmma::mem_row_major);
}

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
// query rows; Ks, Vs: the tile's keys and values (all ld Ld<T>); kbias:
// the tile's 64 key biases; Sw, Pw, Ow: the warp's score, weight and output
// tiles; m_run, l_run: running max and sum of row lane / 2.
template <typename T>
__device__ __forceinline__ void attend(const T* Qw, const T* Ks, const T* Vs,
                                       const float* kbias, float scale,
                                       float* Sw, T* Pw, float* Ow,
                                       float& m_run, float& l_run) {
  constexpr int LD = Ld<T>::value;
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
    Pw[r * LD + j] = from_f32<T>(p);
    Ow[r * LDF + j] *= corr;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l_run = l_run * corr + sum;
  m_run = m_new;
  __syncwarp();

  pv16(Pw, Vs, Ow);
  __syncwarp();
}

// Writes row lane / 2 of the warp's output tile, normalized by l_run, as T
// to orow (the row's 64 head columns in device memory).
template <typename T>
__device__ __forceinline__ void store_row(const float* Ow, float l_run,
                                          T* orow) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const float inv = 1.f / l_run;
  for (int j = c0; j < c0 + 32; ++j)
    orow[j] = from_f32<T>(Ow[r * LDF + j] * inv);
}

}  // namespace tile

}  // namespace
