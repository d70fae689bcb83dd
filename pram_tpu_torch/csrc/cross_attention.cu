// Symmetric shared-QK cross-attention with the to_qk / to_v projections,
// for Hopper (bf16 in, f32 accumulation, f32 softmax).
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_cross_attention_proj
// (_cross_proj_kernel and _symmetric_cross_attention). The tokens are the
// concatenation of two sides, x_cat = [x0 (n0 tokens) | x1 (n1 tokens)]. Both
// sides share to_qk and to_v; the similarity qk0 . qk1^T is softmaxed along
// each axis, so side 0's queries attend to side 1's keys (masked by bias1)
// and side 1's queries to side 0's keys (masked by bias0). No rotary.
//
// What bounds it: at GML's shapes (B=32, 512 + 1024 tokens, d=256, 4 heads
// of 64) the projections take 12.9 GFLOP and the two directions' QK and PV
// products 25.8 GFLOP, against ~50 MB of activations, so the tensor cores
// bound it. The TPU kernel projects qk and v for a whole frame into VMEM
// (2 x 1536 x 256 bf16 = 1.5 MB), more than a Hopper block's 227 KB. So the
// work is two kernels launched back to back on one stream:
//   1. cross_proj_kernel writes qk and v (bf16, bias added in f32 before the
//      rounding, as the TPU kernel's scratch holds them) to a scratch
//      tensor the wrapper allocates; one block per (64 tokens, 64 output
//      columns of one of the two matrices), the weight slice and the x tile
//      in shared memory.
//   2. cross_attention_kernel: one block per (frame, head, 128-query tile);
//      a tile of side 0 is direction 0 -> 1, a tile of side 1 is 1 -> 0. The
//      block streams the other side's 64-key tiles of qk and v through shared
//      memory and folds them into an f32 output tile with an online softmax
//      (running max and sum per row), so scores never reach device memory.
// The similarity is computed once per direction (twice in all), as the TPU
// kernel does. Matrix products use bf16 WMMA tiles (16x16x16, f32
// accumulate); a later version would move to wgmma/TMA.
//
// Rounding follows _attn_weights: logits = qk_q . qk_k * scale + bias in
// f32; the weights exp(logit - max) are rounded to bf16 for the P @ V
// product and 1/sum is folded into the output, so an all-masked key side
// (bias all -1e9) gives the mean of v. The output is rounded to bf16.
//
// Layouts: x [B, N, 256] bf16 with N = n0 + n1; w_qk, w_v [256, 256] bf16
// (torch Linear layout [out, in]); b_qk, b_v [256] f32; bias0 [B, n0] and
// bias1 [B, n1] f32 (0 or -1e9); scratch qk, v [B, N, 256] bf16; out
// [B, N, 256] bf16 with column h * 64 + i for head h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tile.cuh"

using namespace nvcuda;

namespace {

constexpr int DIN = 256;   // model width (input and output of the projections)
constexpr int HD = tile::HD;  // head dim
constexpr int QT = 128;    // query rows per attention block
constexpr int KT = tile::KT;  // keys per tile
constexpr int NWARP = 8;   // 16 query rows per warp
constexpr int NTHREADS = NWARP * 32;
constexpr int LDX = DIN + 8;  // bf16 row stride of x tiles and weight slices
constexpr int LDH = tile::LDH;  // bf16 row stride of q, k, v, p tiles
constexpr int LDF = tile::LDF;  // f32 row stride of per-warp score/output tiles

// projection kernel: 64 tokens x 64 output columns per block, 4 warps
constexpr int PT = 64;
constexpr int PWARP = 4;
constexpr int PTHREADS = PWARP * 32;
constexpr size_t PROJ_SMEM =
    2ull * PT * LDX * 2 + (size_t)PWARP * 16 * LDF * 4;

constexpr size_t Q_BYTES = (size_t)QT * LDH * 2;
constexpr size_t KV_BYTES = 2ull * KT * LDH * 2;
constexpr size_t SF_BYTES = (size_t)NWARP * 16 * LDF * 4;
constexpr size_t P_BYTES = (size_t)NWARP * 16 * LDH * 2;
constexpr size_t ATTN_SMEM = Q_BYTES + KV_BYTES + 2 * SF_BYTES + P_BYTES;

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(PTHREADS)
cross_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_qk,
                  const float* __restrict__ b_qk,
                  const bf16* __restrict__ w_v, const float* __restrict__ b_v,
                  bf16* __restrict__ qk, bf16* __restrict__ v) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + PT * LDX;
  float* Cf = reinterpret_cast<float*>(Ws + PT * LDX);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t t0 = (size_t)blockIdx.x * PT;  // first token of the tile
  const int is_v = blockIdx.y >> 2;           // 0: to_qk, 1: to_v
  const int c0 = (blockIdx.y & 3) * 64;       // first output column
  const bf16* w = is_v ? w_v : w_qk;
  const float* bias = is_v ? b_v : b_qk;
  bf16* dst = is_v ? v : qk;

  constexpr int VEC = DIN / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < PT * VEC; i += PTHREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(Xs + r * LDX + c) =
        *reinterpret_cast<const uint4*>(x + (t0 + r) * DIN + c);
    *reinterpret_cast<uint4*>(Ws + r * LDX + c) =
        *reinterpret_cast<const uint4*>(w + (size_t)(c0 + r) * DIN + c);
  }
  __syncthreads();

  float* Cw = Cf + warp * 16 * LDF;
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < DIN; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Xs + warp * 16 * LDX + k, LDX);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, Ws + j * 16 * LDX + k, LDX);
        wmma::mma_sync(acc[j], a, bw, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cw + j * 16, acc[j], LDF, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane >> 1, cs = (lane & 1) * 32;
  bf16* orow = dst + (t0 + warp * 16 + r) * DIN + c0;
  for (int j = cs; j < cs + 32; ++j)
    orow[j] = __float2bfloat16(Cw[r * LDF + j] + bias[c0 + j]);
}

// copy `rows` rows of head h's 64 columns (row stride DIN) into smem (LDH)
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src,
                                               int rows, int h) {
  constexpr int VEC = HD / 8;
  for (int i = threadIdx.x; i < rows * VEC; i += NTHREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * DIN + h * HD + c);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
cross_attention_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                       const float* __restrict__ bias0,
                       const float* __restrict__ bias1,
                       bf16* __restrict__ out, int N, int n0, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Q_BYTES);
  bf16* Vs = Ks + KT * LDH;
  float* Sf = reinterpret_cast<float*>(smem + Q_BYTES + KV_BYTES);
  float* Of = Sf + NWARP * 16 * LDF;
  bf16* Ps = reinterpret_cast<bf16*>(Of + NWARP * 16 * LDF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int n1 = N - n0;
  // direction 0 -> 1 for side-0 queries, 1 -> 0 for side-1 queries
  const bool side0 = q0 < n0;
  const int k_lo = side0 ? n0 : 0;
  const int k_n = side0 ? n1 : n0;
  const float* kbias = side0 ? bias1 + (size_t)b * n1 : bias0 + (size_t)b * n0;
  const bf16* qkb = qk + (size_t)b * N * DIN;
  const bf16* vb = v + (size_t)b * N * DIN;
  float* Sw = Sf + warp * 16 * LDF;
  float* Ow = Of + warp * 16 * LDF;
  bf16* Pw = Ps + warp * 16 * LDH;

  load_head_rows(Qs, qkb + (size_t)q0 * DIN, QT, h);
  for (int i = lane; i < 16 * LDF; i += 32) Ow[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row lane/2 of this warp

  for (int k0 = 0; k0 < k_n; k0 += KT) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_head_rows(Ks, qkb + (size_t)(k_lo + k0) * DIN, KT, h);
    load_head_rows(Vs, vb + (size_t)(k_lo + k0) * DIN, KT, h);
    __syncthreads();

    tile::attend(Qs + warp * 16 * LDH, Ks, Vs, kbias + k0, scale, Sw, Pw, Ow,
                 m_run, l_run);
  }

  // ---- normalize and write this warp's 16 rows of the head's columns
  const int row = q0 + warp * 16 + (lane >> 1);
  tile::store_row(Ow, l_run, out + ((size_t)b * N + row) * DIN + h * HD);
}

}  // namespace

// the attention pass alone, on projections made outside (the int8
// projections of csrc/proj_int8.cu): qk, v [B, N, 256] bf16
extern "C" int pram_cross_attention_tail(const void* qk, const void* v,
                                         const void* bias0, const void* bias1,
                                         void* out, int B, int N, int n0,
                                         int heads, float scale, void* stream) {
  if (heads * HD != DIN || n0 <= 0 || n0 >= N || n0 % QT != 0 ||
      (N - n0) % QT != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ATTN_SMEM);
  if (err != cudaSuccess) return (int)err;
  cross_attention_kernel<<<dim3(N / QT, heads, B), NTHREADS, ATTN_SMEM,
                           (cudaStream_t)stream>>>(
      (const bf16*)qk, (const bf16*)v, (const float*)bias0,
      (const float*)bias1, (bf16*)out, N, n0, scale);
  return (int)cudaGetLastError();
}

extern "C" int pram_cross_attention(const void* x, const void* w_qk,
                                    const void* b_qk, const void* w_v,
                                    const void* b_v, const void* bias0,
                                    const void* bias1, void* qk_scratch,
                                    void* v_scratch, void* out, int B, int N,
                                    int n0, int heads, float scale,
                                    void* stream) {
  if (heads * HD != DIN || n0 <= 0 || n0 >= N || n0 % QT != 0 ||
      (N - n0) % QT != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cross_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PROJ_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long tokens = (long)B * N;
  cross_proj_kernel<<<dim3((unsigned)(tokens / PT), 8), PTHREADS, PROJ_SMEM,
                      s>>>((const bf16*)x, (const bf16*)w_qk,
                           (const float*)b_qk, (const bf16*)w_v,
                           (const float*)b_v, (bf16*)qk_scratch,
                           (bf16*)v_scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return pram_cross_attention_tail(qk_scratch, v_scratch, bias0, bias1, out, B,
                                   N, n0, heads, scale, stream);
}
