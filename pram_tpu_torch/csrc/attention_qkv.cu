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
//   2. the message pass: one CTA per (frame, head, 128 queries) over the keys
//      of the query tile's side; v is read straight from qkv.
//   3. the statistics pass (with statistics only): one CTA per (frame, 128
//      keys; 64 in f32) over the queries of the key tile's side.
// In bf16, passes 2 and 3 are wg::message_cta (attention_wgmma.cuh) and
// wg::stats_cta (attention_stats.cuh): a producer warp feeds two consumer
// warpgroups 64 x 64 tiles of qr, kr and v by TMA (three tensor maps encoded
// here per call), and the products are wgmma m64n64k16 with S, P and O in
// registers. In f32 (the matcher's A/B checks) they are pass::message_block
// and pass::stats_block on the CUDA cores. Kernels 1 (csrc/attention.cu)
// and 17 (csrc/proj_int8.cu) run pass 2 alone through
// pram_self_attention_rotated, on the qkv their projection pass
// (csrc/proj_bf16.cu, csrc/proj_int8.cu) wrote with q and k rotated.
//
// What bounds it: at AdaGML's Aachen shape (8 frames x 4096 tokens, 4 heads
// of 64) the QK and PV products are 137 GFLOP and the statistics' second QK
// product 69 GFLOP, against ~75 MB in and out, so the tensor cores bound it
// (0.21 ms at 989 TFLOP/s); the 1.07 G exponentials (one per (head, query,
// key) in each pass) are a second ceiling, 0.26 ms at 132 SMs x 16 a clock.
// Scores never reach device memory or shared memory.
//
// Rounding follows the TPU kernel: rotary in f32 from the T values of q and
// k, rounded to T before QK; logits q.k * scale + key_bias in f32 (in bf16
// folded with log2 e into one fma, exponentials by ex2); the weights
// rounded to T for P @ V, 1/sum folded into the f32 output, which is
// rounded to T. An all-masked side (bias -1e9 everywhere) gives the mean of
// v. The statistics use the normalized f32 weights.
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

// the message pass's rows (max, then weight) of (frame b, head h) from query
// q0 on, in the [2][B][heads][N] scratch; left null without statistics
__device__ __forceinline__ void row_pointers(float* rows, int b, int h, int N,
                                             int heads, int q0, float*& row_m,
                                             float*& row_w) {
  if (rows == nullptr) return;
  row_m = rows + ((size_t)b * heads + h) * N + q0;
  row_w = row_m + (size_t)gridDim.z * heads * N;
}

__global__ void __launch_bounds__(pass::NTHREADS, 1)
message_kernel_f32(const float* __restrict__ qr, const float* __restrict__ kr,
                   const float* __restrict__ qkv,
                   const float* __restrict__ key_bias, float* __restrict__ out,
                   float* __restrict__ rows, int N, int heads, float scale,
                   Sides sides) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * pass::QT, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  sides.find(q0, lo, hi);
  const size_t frame = (size_t)b * N;
  const float* kb = key_bias + frame;
  float* row_m = nullptr;
  float* row_w = nullptr;
  row_pointers(rows, b, h, N, heads, q0, row_m, row_w);
  pass::message_block(
      qr + (frame + q0) * D + h * HD, D, kr + frame * D + h * HD, D,
      qkv + frame * D3 + 2 * D + h * HD, D3, kb, lo, hi, scale,
      out + (frame + q0) * D + h * HD, D, kb + q0, row_m, row_w, smem);
}

__global__ void __launch_bounds__(pass::STHREADS)
stats_kernel_f32(const float* __restrict__ qr, const float* __restrict__ kr,
                 const float* __restrict__ key_bias,
                 const float* __restrict__ rows, float* __restrict__ stat,
                 int N, int heads, float scale, Sides sides) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * pass::SK, b = blockIdx.y;
  const int B = gridDim.y;
  int lo, hi;
  sides.find(k0, lo, hi);
  const size_t frame = (size_t)b * N;
  const float* row_m = rows + (size_t)b * heads * N;
  const float* row_w = row_m + (size_t)B * heads * N;
  pass::stats_block(qr + frame * D, D, kr + (frame + k0) * D, D,
                    key_bias + frame + k0, row_m, row_w, N, lo, hi, heads,
                    scale, stat + frame + k0, smem);
}

struct Maps {  // bf16 [B, N, cols] tensors of q, k and v
  CUtensorMap q, k, v;
};

// q_col, k_col, v_col: the first column of head 0's q, k and v in their maps
__global__ void __launch_bounds__(wg::THREADS, 2)
message_kernel_bf16(const __grid_constant__ Maps maps, int q_col, int k_col,
                    int v_col, const float* __restrict__ key_bias,
                    bf16* __restrict__ out, float* __restrict__ rows, int N,
                    int heads, float scale, Sides sides) {
  extern __shared__ unsigned char smem[];
  const int q0 = blockIdx.x * wg::MQ, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  sides.find(q0, lo, hi);
  const float* kb = key_bias + (size_t)b * N;
  float* row_m = nullptr;
  float* row_w = nullptr;
  row_pointers(rows, b, h, N, heads, q0, row_m, row_w);
  wg::message_cta(&maps.q, q_col + h * HD, &maps.k, k_col + h * HD, &maps.v,
                  v_col + h * HD, b, q0, lo, hi, kb, scale,
                  out + ((size_t)b * N + q0) * D + h * HD, D, kb + q0, row_m,
                  row_w, smem);
}

__global__ void __launch_bounds__(wg::THREADS, 2)
stats_kernel_bf16(const __grid_constant__ Maps maps,
                  const float* __restrict__ key_bias,
                  const float* __restrict__ rows, float* __restrict__ stat,
                  int N, int heads, float scale, Sides sides) {
  extern __shared__ unsigned char smem[];
  const int k0 = blockIdx.x * wg::SK, b = blockIdx.y;
  int lo, hi;
  sides.find(k0, lo, hi);
  const float* row_m = rows + (size_t)b * heads * N;
  const float* row_w = row_m + (size_t)gridDim.y * heads * N;
  const size_t at = (size_t)b * N + k0;
  wg::stats_cta(&maps.q, &maps.k, b, k0, lo, hi, heads, key_bias + at, row_m,
                row_w, N, scale, stat + at, smem);
}

// checks the splits into sides; 0 or an error code
int make_sides(int N, const int* splits, int n_splits, Sides& sides) {
  if (N % pass::QT != 0 || n_splits < 1 || n_splits > tile::MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  sides.n = n_splits;
  sides.edge[0] = 0;
  for (int s = 0; s < n_splits; ++s) {
    if (splits[s] <= 0 || splits[s] % pass::QT != 0)
      return (int)cudaErrorInvalidValue;
    sides.edge[s + 1] = sides.edge[s] + splits[s];
  }
  return sides.edge[n_splits] == N ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int rotate(const void* qkv, const void* cos, const void* sin, void* qr,
           void* kr, int B, int N, cudaStream_t stream) {
  const size_t work = (size_t)B * N * D;
  rotate_kernel<T><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      (const T*)qkv, (const float*)cos, (const float*)sin, (T*)qr, (T*)kr,
      (size_t)B * N);
  return (int)cudaGetLastError();
}

int launch_f32(const void* qkv, const void* cos, const void* sin,
               const void* key_bias, void* qr, void* kr, void* out,
               void* rows, void* stat, int B, int N, int heads, float scale,
               const Sides& sides, cudaStream_t stream) {
  int err = rotate<float>(qkv, cos, sin, qr, kr, B, N, stream);
  if (err) return err;
  err = wg::launch(message_kernel_f32, dim3(N / pass::QT, heads, B),
                   pass::NTHREADS, pass::MESSAGE_SMEM, stream,
                   (const float*)qr, (const float*)kr, (const float*)qkv,
                   (const float*)key_bias, (float*)out,
                   stat != nullptr ? (float*)rows : nullptr, N, heads,
                   scale, sides);
  if (err || stat == nullptr) return err;
  return wg::launch(stats_kernel_f32, dim3(N / pass::SK, B),
                    pass::STHREADS, pass::STATS_SMEM, stream,
                    (const float*)qr, (const float*)kr,
                    (const float*)key_bias, (const float*)rows,
                    (float*)stat, N, heads, scale, sides);
}

int launch_bf16(const void* qkv, const void* cos, const void* sin,
                const void* key_bias, void* qr, void* kr, void* out,
                void* rows, void* stat, int B, int N, int heads, float scale,
                const Sides& sides, cudaStream_t stream) {
  Maps maps;
  if (!wg::make_map(&maps.q, qr, D, N, B, D, (size_t)N * D) ||
      !wg::make_map(&maps.k, kr, D, N, B, D, (size_t)N * D) ||
      !wg::make_map(&maps.v, qkv, D3, N, B, D3, (size_t)N * D3))
    return (int)cudaErrorInvalidValue;
  int err = rotate<bf16>(qkv, cos, sin, qr, kr, B, N, stream);
  if (err) return err;
  err = wg::launch(message_kernel_bf16, dim3(N / wg::MQ, heads, B),
                   wg::THREADS, wg::MSG_SMEM, stream, maps, 0, 0, 2 * D,
                   (const float*)key_bias, (bf16*)out,
                   stat != nullptr ? (float*)rows : nullptr, N, heads,
                   scale, sides);
  if (err || stat == nullptr) return err;
  return wg::launch(stats_kernel_bf16, dim3(N / wg::SK, B), wg::THREADS,
                    wg::STATS_SMEM, stream, maps, (const float*)key_bias,
                    (const float*)rows, (float*)stat, N, heads, scale,
                    sides);
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
  if (heads * HD != D) return (int)cudaErrorInvalidValue;
  Sides sides;
  if (int err = make_sides(N, splits, n_splits, sides)) return err;
  auto launch = is_f32 ? launch_f32 : launch_bf16;
  return launch(qkv, cos, sin, key_bias, qr, kr, out, rows, stat, B, N, heads,
                scale, sides, (cudaStream_t)stream);
}

// The bf16 message pass alone on a qkv whose q and k are already rotated
// (the projection passes of kernels 1 and 17): q, k and v are read through
// one tensor map of qkv [B, N, 768] at columns h * 64, 256 + h * 64 and 512
// + h * 64. No statistics.
extern "C" int pram_self_attention_rotated(const void* qkv,
                                           const void* key_bias, void* out,
                                           int B, int N, int heads,
                                           float scale, const int* splits,
                                           int n_splits, void* stream) {
  if (heads * HD != D) return (int)cudaErrorInvalidValue;
  Sides sides;
  if (int err = make_sides(N, splits, n_splits, sides)) return err;
  Maps maps;
  if (!wg::make_map(&maps.q, qkv, D3, N, B, D3, (size_t)N * D3))
    return (int)cudaErrorInvalidValue;
  maps.k = maps.v = maps.q;
  return wg::launch(message_kernel_bf16, dim3(N / wg::MQ, heads, B),
                    wg::THREADS, wg::MSG_SMEM, (cudaStream_t)stream, maps, 0,
                    D, 2 * D, (const float*)key_bias, (bf16*)out,
                    (float*)nullptr, N, heads, scale, sides);
}
