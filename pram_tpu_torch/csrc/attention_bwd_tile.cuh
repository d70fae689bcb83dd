// 64 x 64 tiles of the attention backward kernels (attention_bwd.cu,
// cross_attention_bwd.cu): bf16 WMMA products (16x16x16, f32 accumulate)
// by a block of 8 warps, and the per-row softmax statistics pass.
//
// Every tile is 64 tokens by 64 head columns. bf16 tiles have row stride LDH
// and f32 tiles LDF, both keeping WMMA's 32-byte pointer alignment. In a
// product, warp w owns output rows (w / 2) * 16 .. + 16 and columns
// (w % 2) * 32 .. + 32. Element-wise passes map thread t to row t / 4 and
// columns (t % 4) * 16 .. + 16, so a row's four threads are neighbouring
// lanes of one warp and reduce a row with two shuffles.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

namespace {

namespace bwd {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int T = 64;         // tokens of a tile
constexpr int HD = 64;        // head dim: the columns of a tile
constexpr int NTHREADS = 256;  // 8 warps
constexpr int LDH = HD + 8;   // bf16 row stride
constexpr int LDF = HD + 4;   // f32 row stride
constexpr size_t TILE_H = (size_t)T * LDH * sizeof(bf16);  // 9216 bytes
constexpr size_t TILE_F = (size_t)T * LDF * sizeof(float);  // 17408 bytes
constexpr size_t VEC_F = (size_t)T * sizeof(float);         // a 64-float row vector

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ int warp_r0() { return ((threadIdx.x >> 5) >> 1) * 16; }
__device__ __forceinline__ int warp_c0() { return ((threadIdx.x >> 5) & 1) * 32; }
// the element-wise mapping: row and first column of thread t
__device__ __forceinline__ int elt_row() { return threadIdx.x >> 2; }
__device__ __forceinline__ int elt_col() { return (threadIdx.x & 3) * 16; }

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// C (f32) = A . B^T; A, B 64 x 64 bf16, rows of B are C's columns
__device__ __forceinline__ void mm_abt(const bf16* A, const bf16* B, float* C) {
  const int r0 = warp_r0(), c0 = warp_c0();
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
  for (int k = 0; k < HD; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * LDH + k, LDH);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + (c0 + j * 16) * LDH + k, LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(C + r0 * LDF + c0 + j * 16, acc[j], LDF,
                            wmma::mem_row_major);
}

// this warp's part of a 64 x 64 f32 sum: acc += A . B (A, B row-major bf16)
__device__ __forceinline__ void mm_ab_acc(const bf16* A, const bf16* B,
                                          Acc* acc) {
  const int r0 = warp_r0(), c0 = warp_c0();
#pragma unroll
  for (int k = 0; k < T; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * LDH + k, LDH);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + k * LDH + c0 + j * 16, LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(Acc* acc) {
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
}

__device__ __forceinline__ void store_acc(const Acc* acc, float* C) {
  const int r0 = warp_r0(), c0 = warp_c0();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(C + r0 * LDF + c0 + j * 16, acc[j], LDF,
                            wmma::mem_row_major);
}

// Copies head columns [col, col + 64) of 64 rows (row stride ld elements) of
// a bf16 matrix into a tile, 16 bytes a thread.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld) {
  for (int v = threadIdx.x; v < T * (HD / 8); v += NTHREADS) {
    const int r = v >> 3, c = (v & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// Running softmax statistics of a 64-row query tile Qs (with its output
// cotangent Gs) over one 64-key tile (Ks, Vs, key biases kb): in each row,
// m the running max of s = (q . k) * scale + kb, l the running sum of
// exp(s - m) and u the running sum of exp(s - m) * (g . v). After the last
// tile, 1 / l and t = u / l = sum_j p_j (g . v_j) are the row's statistics.
// The four threads of a row hold equal values. Sf, Df: f32 scratch tiles.
__device__ __forceinline__ void stats_step(const bf16* Qs, const bf16* Gs,
                                           const bf16* Ks, const bf16* Vs,
                                           const float* kb, float scale,
                                           float* Sf, float* Df, float& m,
                                           float& l, float& u) {
  mm_abt(Qs, Ks, Sf);
  mm_abt(Gs, Vs, Df);
  __syncthreads();
  const int r = elt_row(), c0 = elt_col();
  float s[16];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    s[c] = Sf[r * LDF + c0 + c] * scale + kb[c0 + c];
    mx = fmaxf(mx, s[c]);
  }
  const float m_new = fmaxf(m, row_max(mx));
  const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
  float se = 0.f, sed = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float e = expf(s[c] - m_new);
    se += e;
    sed += e * Df[r * LDF + c0 + c];
  }
  l = l * corr + row_sum(se);
  u = u * corr + row_sum(sed);
  m = m_new;
  __syncthreads();  // Sf and Df are free again
}

}  // namespace bwd

}  // namespace
