// Masked self-attention from a packed qkv tensor with rotary on q and k and,
// optionally, AdaGML's per-key received-attention statistics, for Hopper.
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_self_attention_qkv (both
// regimes: _qkv_kernel up to 1024 tokens, _qkv_tiled_kernel above) and
// fused_self_attention_qkv_blocked (_qkv_blocked_kernel: independent
// `splits` of the token axis, each query attending to its own side's keys).
// The qkv projection stays outside, as in the JAX package
// (pram_tpu/models/adagml.py:_SelfAttnStats).
//
// Three launches on one stream:
//   1. rotate_kernel: q and k of every head rotated in f32 from their T
//      values, rounded back to T, into two scratch tensors the wrapper
//      allocates (the TPU kernel rotates in VMEM; here each key tile is read
//      by every query tile of its side, so it is rotated once, not per read).
//   2. message_kernel: one block per (frame, head, 128 queries),
//      attention_stats.cuh:message_block over the keys of the query tile's
//      side; v is read straight from qkv.
//   3. stats_kernel (with statistics only): one block per (frame, 64 keys),
//      attention_stats.cuh:stats_block over the queries of the key tile's side.
//
// What bounds it: at AdaGML's Aachen shape (8 frames x 4096 tokens, 4 heads
// of 64) the QK and PV products are 137 GFLOP and the statistics' second QK
// product 69 GFLOP, against ~75 MB in and out, so the tensor cores bound it.
// Scores never reach device memory. Products are bf16 WMMA tiles (16x16x16,
// f32 accumulate); wgmma and TMA are the next step.
//
// Rounding follows the TPU kernel: rotary in f32 from the T values of q and
// k, rounded to T before QK; logits q.k * scale + key_bias in f32; the
// weights rounded to T for P @ V, 1/sum folded into the f32 output, which
// is rounded to T. An all-masked side (bias -1e9 everywhere) gives the mean
// of v. The statistics use the normalized f32 weights.
//
// Layouts: qkv [B, N, 768] T in [q heads | k heads | v heads] column blocks
// (head h at h * 64 within each block); cos, sin [B, N, 64] f32; key_bias
// [B, N] f32 (0 or -1e9, also the query validity of the statistics); out
// [B, N, 256] T; stat [B, N] f32. T is bf16, or float for the f32 checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_stats.cuh"

namespace {

using pass::HD;
using tile::Sides;
typedef __nv_bfloat16 bf16;

constexpr int D = 256;  // heads * HD
constexpr int D3 = 3 * D;

// one thread per (token, rotary pair) of q and of k
template <typename T>
__global__ void rotate_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ cos,
                              const float* __restrict__ sin,
                              T* __restrict__ qr, T* __restrict__ kr,
                              size_t tokens) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tokens * D) return;  // i = token * D + (q or k) * D/2 + pair
  const size_t t = i / D;
  const int which = (int)(i % D) / (D / 2), pair = (int)(i % (D / 2));
  const int col = 2 * pair, e = col % HD;  // rotary index within the head
  const T* src = qkv + t * D3 + which * D + col;
  const float x0 = tile::to_f32(src[0]), x1 = tile::to_f32(src[1]);
  const float c0 = cos[t * HD + e], c1 = cos[t * HD + e + 1];
  const float s0 = sin[t * HD + e], s1 = sin[t * HD + e + 1];
  // x * cos + rotate_half(x) * sin, each product and the sum rounded once
  T* dst = (which ? kr : qr) + t * D + col;
  dst[0] = tile::from_f32<T>(__fadd_rn(__fmul_rn(x0, c0), __fmul_rn(-x1, s0)));
  dst[1] = tile::from_f32<T>(__fadd_rn(__fmul_rn(x1, c1), __fmul_rn(x0, s1)));
}

template <typename T>
__global__ void __launch_bounds__(pass::NTHREADS, 1)
message_kernel(const T* __restrict__ qr, const T* __restrict__ kr,
               const T* __restrict__ qkv, const float* __restrict__ key_bias,
               T* __restrict__ out, float* __restrict__ rows, int N,
               int heads, float scale, Sides sides) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * pass::QT, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  int lo, hi;
  sides.find(q0, lo, hi);
  const size_t frame = (size_t)b * N;
  const float* kb = key_bias + frame;
  float* row_m = nullptr;
  float* row_w = nullptr;
  if (rows != nullptr) {  // [2][B][heads][N]: max, then weight
    row_m = rows + ((size_t)b * heads + h) * N + q0;
    row_w = row_m + (size_t)B * heads * N;
  }
  pass::message_block<T>(
      qr + (frame + q0) * D + h * HD, D, kr + frame * D + h * HD, D,
      qkv + frame * D3 + 2 * D + h * HD, D3, kb, lo, hi, scale,
      out + (frame + q0) * D + h * HD, D, kb + q0, row_m, row_w, smem);
}

template <typename T>
__global__ void __launch_bounds__(pass::STHREADS)
stats_kernel(const T* __restrict__ qr, const T* __restrict__ kr,
             const float* __restrict__ key_bias,
             const float* __restrict__ rows, float* __restrict__ stat, int N,
             int heads, float scale, Sides sides) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * pass::SK, b = blockIdx.y;
  const int B = gridDim.y;
  int lo, hi;
  sides.find(k0, lo, hi);
  const size_t frame = (size_t)b * N;
  const float* row_m = rows + (size_t)b * heads * N;
  const float* row_w = row_m + (size_t)B * heads * N;
  pass::stats_block<T>(qr + frame * D, D, kr + (frame + k0) * D, D,
                       key_bias + frame + k0, row_m, row_w, N, lo, hi, heads,
                       scale, stat + frame + k0, smem);
}

template <typename T>
int launch(const void* qkv, const void* cos, const void* sin,
           const void* key_bias, void* qr, void* kr, void* out, void* rows,
           void* stat, int B, int N, int heads, float scale, const int* splits,
           int n_splits, cudaStream_t stream) {
  // splits: n_splits side lengths (host memory), each a multiple of the
  // 128-query tile, summing to N; one side of N tokens is plain attention
  if (heads * HD != D || N % pass::QT != 0 || n_splits < 1 ||
      n_splits > tile::MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  Sides sides;
  sides.n = n_splits;
  sides.edge[0] = 0;
  for (int s = 0; s < n_splits; ++s) {
    if (splits[s] <= 0 || splits[s] % pass::QT != 0)
      return (int)cudaErrorInvalidValue;
    sides.edge[s + 1] = sides.edge[s] + splits[s];
  }
  if (sides.edge[n_splits] != N) return (int)cudaErrorInvalidValue;
  const bool with_stats = stat != nullptr;

  const size_t work = (size_t)B * N * D;
  rotate_kernel<T><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      (const T*)qkv, (const float*)cos, (const float*)sin, (T*)qr, (T*)kr,
      (size_t)B * N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t msg_smem = pass::message_smem<T>();
  err = cudaFuncSetAttribute(message_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msg_smem);
  if (err != cudaSuccess) return (int)err;
  message_kernel<T><<<dim3(N / pass::QT, heads, B), pass::NTHREADS, msg_smem,
                      stream>>>(
      (const T*)qr, (const T*)kr, (const T*)qkv, (const float*)key_bias,
      (T*)out, with_stats ? (float*)rows : nullptr, N, heads, scale, sides);
  err = cudaGetLastError();
  if (err != cudaSuccess || !with_stats) return (int)err;

  constexpr size_t st_smem = pass::stats_smem<T>();
  err = cudaFuncSetAttribute(stats_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)st_smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<T><<<dim3(N / pass::SK, B), pass::STHREADS, st_smem, stream>>>(
      (const T*)qr, (const T*)kr, (const float*)key_bias, (const float*)rows,
      (float*)stat, N, heads, scale, sides);
  return (int)cudaGetLastError();
}

}  // namespace

// qr, kr: scratch [B, N, 256] of the element type; rows: scratch f32
// [2, B, heads, N] (only read and written with statistics); stat: f32
// [B, N] or null for no statistics. is_f32 selects float over bf16.
extern "C" int pram_self_attention_qkv(const void* qkv, const void* cos,
                                       const void* sin, const void* key_bias,
                                       void* qr, void* kr, void* out,
                                       void* rows, void* stat, int B, int N,
                                       int heads, float scale,
                                       const int* splits, int n_splits,
                                       int is_f32, void* stream) {
  auto s = (cudaStream_t)stream;
  if (is_f32)
    return launch<float>(qkv, cos, sin, key_bias, qr, kr, out, rows, stat, B,
                         N, heads, scale, splits, n_splits, s);
  return launch<bf16>(qkv, cos, sin, key_bias, qr, kr, out, rows, stat, B, N,
                      heads, scale, splits, n_splits, s);
}
