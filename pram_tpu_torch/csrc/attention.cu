// Self-attention with the qkv projection, rotary encoding and key mask fused,
// for Hopper (bf16 in, f32 accumulation, f32 softmax).
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_self_attention_proj
// (_self_proj_kernel), with its block-diagonal `splits` option: the tokens
// are a concatenation of independent sides (GML runs both keypoint sets
// through one layer stack), and a query attends only to the keys of its own
// side. Every split is a multiple of the 128-row query tile, so a tile lies
// in one side and its key loop runs over [lo, hi) of that side.
//
// What bounds it: at the slice's shapes (B=32, N=512, d=256, 4 heads of 64)
// a layer moves ~17 MB (x in, message out, weights) and does ~13 GFLOP of
// useful matrix work, so the tensor cores bound it, not memory. The TPU
// kernel projects qkv for a whole frame inside one program; here a block
// owns one (batch, head, 128-query tile), so it projects its own queries
// once and re-projects the head's keys and values for each of its 64-key
// tiles (4x redundant K/V projection over the 4 query tiles of a frame, the
// price of 512 independent blocks instead of 128; with GML's splits
// (512, 1024) the 1024-token side's 8 query tiles make it 8x). The head's k and v
// weight slices (2 x 64 x 256 bf16) are staged in shared memory once per
// block, so the re-projection reads shared memory, not L2. Scores never
// reach device memory: each warp keeps 16 query rows, and an online softmax
// (running max and sum per row) folds each 64-key tile into an f32 output
// tile in shared memory. Matrix products use bf16 WMMA tensor-core tiles
// (16x16x16, f32 accumulate); a later version would move to wgmma/TMA.
//
// Rounding follows the TPU kernel: qkv = bf16(x @ W + b) with f32 bias; the
// rotary product is taken in f32 from the bf16 q/k and rounded back to
// bf16; logits = q.k * scale + key_bias in f32; the probabilities are
// rounded to bf16 for the P @ V product; the output is rounded to bf16.
//
// Layouts: x [B, N, 256] bf16; w_qkv [768, 256] bf16 (torch Linear layout
// of the flax kernel, output index (h * 64 + i) * 3 + c for c in q, k, v);
// b_qkv [768] f32; cos, sin [B, N, 64] f32; key_bias [B, N] f32 (0 or
// -1e9); out [B, N, 256] bf16 with column h * 64 + i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int DIN = 256;    // model width
constexpr int HD = tile::HD;  // head dim
constexpr int QT = 128;     // query rows per block
constexpr int KT = tile::KT;  // keys per tile
constexpr int NWARP = 8;    // 16 query rows per warp
constexpr int NTHREADS = NWARP * 32;
constexpr int LDX = DIN + 8;  // bf16 row stride of x tiles and weight slices
constexpr int LDH = tile::LDH;  // bf16 row stride of q, k, v, p tiles
constexpr int LDF = tile::LDF;  // f32 row stride of per-warp score/output tiles

constexpr size_t W_BYTES = 2ull * HD * LDX * 2;          // two weight slices
constexpr size_t X_BYTES = 64ull * LDX * 2;              // 64 x rows
constexpr size_t Q_BYTES = (size_t)QT * LDH * 2;
constexpr size_t KV_BYTES = 2ull * KT * LDH * 2;
constexpr size_t SF_BYTES = (size_t)NWARP * 16 * LDF * 4;
constexpr size_t OF_BYTES = SF_BYTES;
constexpr size_t P_BYTES = (size_t)NWARP * 16 * LDH * 2;
constexpr size_t SMEM_BYTES =
    W_BYTES + X_BYTES + Q_BYTES + KV_BYTES + SF_BYTES + OF_BYTES + P_BYTES;

typedef __nv_bfloat16 bf16;


// copy `rows` rows of DIN bf16 (global row stride src_ld elements) into smem
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows, size_t src_ld) {
  constexpr int VEC = DIN / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < rows * VEC; v += NTHREADS) {
    int r = v / VEC, c = (v % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDX + c) =
        *reinterpret_cast<const uint4*>(src + r * src_ld + c);
  }
}

// weight slice c (0 q, 1 k, 2 v) of head h: rows (h*HD + i)*3 + c of w_qkv
__device__ __forceinline__ void load_wslice(bf16* dst, const bf16* w, int h,
                                            int c) {
  load_rows(dst, w + ((size_t)h * HD * 3 + c) * DIN, HD, 3 * DIN);
}

// C[16 x 64] (f32, ld LDF) = A[16 x DIN] (bf16, ld LDX) @ Wslice^T
__device__ __forceinline__ void warp_proj(const bf16* A, const bf16* W,
                                          float* C) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k = 0; k < DIN; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + k, LDX);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, W + j * 16 * LDX + k, LDX);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(C + j * 16, acc[j], LDF, wmma::mem_row_major);
}

// bias, bf16 rounding and (for q, k) rotary on a warp's 16 x 64 f32 tile;
// lane -> row lane/2, columns (lane%2)*32 .. +32 (rotary pairs stay in-lane)
__device__ __forceinline__ void warp_epilogue(const float* C, bf16* dst,
                                              const float* b_qkv, int h, int c,
                                              const float* cos_rows,
                                              const float* sin_rows,
                                              bool rotary) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  for (int j = c0; j < c0 + 32; j += 2) {
    float v0 = __bfloat162float(__float2bfloat16(
        C[r * LDF + j] + b_qkv[(h * HD + j) * 3 + c]));
    float v1 = __bfloat162float(__float2bfloat16(
        C[r * LDF + j + 1] + b_qkv[(h * HD + j + 1) * 3 + c]));
    if (rotary) {
      const float* cs = cos_rows + (size_t)r * HD;
      const float* sn = sin_rows + (size_t)r * HD;
      float o0 = v0 * cs[j] + (-v1) * sn[j];
      float o1 = v1 * cs[j + 1] + v0 * sn[j + 1];
      v0 = o0;
      v1 = o1;
    }
    dst[r * LDH + j] = __float2bfloat16(v0);
    dst[r * LDH + j + 1] = __float2bfloat16(v1);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
self_attention_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ b_qkv,
                      const float* __restrict__ cos,
                      const float* __restrict__ sin,
                      const float* __restrict__ key_bias,
                      bf16* __restrict__ out, int N, int heads, float scale,
                      tile::Sides sp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws0 = reinterpret_cast<bf16*>(smem);
  bf16* Ws1 = Ws0 + HD * LDX;
  bf16* Xs = reinterpret_cast<bf16*>(smem + W_BYTES);
  bf16* Qs = reinterpret_cast<bf16*>(smem + W_BYTES + X_BYTES);
  bf16* Ks = reinterpret_cast<bf16*>(smem + W_BYTES + X_BYTES + Q_BYTES);
  bf16* Vs = Ks + KT * LDH;
  float* Sf = reinterpret_cast<float*>(smem + W_BYTES + X_BYTES + Q_BYTES +
                                       KV_BYTES);
  float* Of = Sf + NWARP * 16 * LDF;
  bf16* Ps = reinterpret_cast<bf16*>(Of + NWARP * 16 * LDF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;  // keys of the side this query tile lies in
  sp.find(q0, lo, hi);
  const int d_model = heads * HD;
  const bf16* xb = x + (size_t)b * N * DIN;
  const float* cosb = cos + (size_t)b * N * HD;
  const float* sinb = sin + (size_t)b * N * HD;
  const float* kbias = key_bias + (size_t)b * N;
  float* Sw = Sf + warp * 16 * LDF;
  float* Ow = Of + warp * 16 * LDF;
  bf16* Pw = Ps + warp * 16 * LDH;

  // ---- queries: project, bias, rotary (two passes of 64 rows)
  load_wslice(Ws0, w, h, 0);
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    load_rows(Xs, xb + (size_t)(q0 + pass * 64) * DIN, 64, DIN);
    __syncthreads();
    if ((warp >> 2) == pass) {
      const int lr = (warp & 3) * 16;  // row within the 64-row x tile
      warp_proj(Xs + lr * LDX, Ws0, Sw);
      __syncwarp();
      const int qr = q0 + warp * 16;  // global query row of this warp
      warp_epilogue(Sw, Qs + warp * 16 * LDH, b_qkv, h, 0,
                    cosb + (size_t)qr * HD, sinb + (size_t)qr * HD, true);
    }
  }
  __syncthreads();
  load_wslice(Ws0, w, h, 1);
  load_wslice(Ws1, w, h, 2);

  for (int i = lane; i < 16 * LDF; i += 32) Ow[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row lane/2 of this warp

  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();  // previous tile's K/V and x are no longer read
    load_rows(Xs, xb + (size_t)k0 * DIN, KT, DIN);
    __syncthreads();
    {
      // warps 0-3 project keys, warps 4-7 values; 16 rows each
      const int is_v = warp >> 2, lr = (warp & 3) * 16;
      warp_proj(Xs + lr * LDX, is_v ? Ws1 : Ws0, Sw);
      __syncwarp();
      warp_epilogue(Sw, (is_v ? Vs : Ks) + lr * LDH, b_qkv, h, 1 + is_v,
                    cosb + (size_t)(k0 + lr) * HD,
                    sinb + (size_t)(k0 + lr) * HD, !is_v);
    }
    __syncthreads();

    tile::attend(Qs + warp * 16 * LDH, Ks, Vs, kbias + k0, scale, Sw, Pw, Ow,
                 m_run, l_run);
  }

  // ---- normalize and write this warp's 16 rows of the head's columns
  const int row = q0 + warp * 16 + (lane >> 1);
  tile::store_row(Ow, l_run, out + ((size_t)b * N + row) * d_model + h * HD);
}

}  // namespace

extern "C" int pram_self_attention(const void* x, const void* w_qkv,
                                   const void* b_qkv, const void* cos,
                                   const void* sin, const void* key_bias,
                                   void* out, int B, int N, int heads,
                                   float scale, const int* splits,
                                   int n_splits, void* stream) {
  // splits: n_splits side lengths (host memory), each a multiple of QT and
  // summing to N; one side of N tokens is plain self-attention
  if (N % QT != 0 || heads * HD != DIN || n_splits < 1 ||
      n_splits > tile::MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  tile::Sides sp;
  sp.n = n_splits;
  sp.edge[0] = 0;
  for (int s = 0; s < sp.n; ++s) {
    const int len = splits[s];
    if (len <= 0 || len % QT != 0) return (int)cudaErrorInvalidValue;
    sp.edge[s + 1] = sp.edge[s] + len;
  }
  if (sp.edge[sp.n] != N) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      self_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / QT, heads, B);
  self_attention_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w_qkv, (const float*)b_qkv,
      (const float*)cos, (const float*)sin, (const float*)key_bias, (bf16*)out,
      N, heads, scale, sp);
  return (int)cudaGetLastError();
}
