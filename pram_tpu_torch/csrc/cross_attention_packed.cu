// Symmetric shared-QK cross-attention on packed projections with, optionally,
// AdaGML's per-token received-attention statistics, for Hopper.
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_cross_attention_packed
// (both regimes: _cross_packed_kernel up to 1024 tokens a side, and
// _cross_attention_dir / _cross_dir_kernel once per direction above). The
// to_qk and to_v projections stay outside, as in the JAX package
// (pram_tpu/models/adagml.py:_CrossAttnStats). Side 0 (qk0, v0, N tokens)
// and side 1 (qk1, v1, M tokens) share to_qk: side 0's queries attend to
// side 1's keys (masked by bias1) and side 1's to side 0's (bias0), so the
// similarity is computed once per direction, as the TPU kernels do.
//
// Two launches on one stream:
//   1. the message pass: one CTA per (frame, head, 128 queries of either
//      side) over the other side's keys; both directions in one grid.
//   2. the statistics pass (with statistics only): one CTA per (frame, 128
//      keys of either side; 64 in f32) over the other side's queries. stat0
//      is the mass side 0's keys receive from side 1's valid queries
//      (validity from bias1), stat1 the mirror.
// In bf16 they are wg::message_cta (attention_wgmma.cuh) and wg::stats_cta
// (attention_stats.cuh): a producer warp feeds two consumer warpgroups 64 x
// 64 tiles by TMA through four 3-D tensor maps (qk0, qk1, v0, v1: the sides
// may be strided views into one [B, N + M, 256] projection, so each map
// carries its frame stride), and the products are wgmma m64n64k16 with S,
// P and O in registers. In f32 (the matcher's A/B checks) they are
// pass::message_block and pass::stats_block on the CUDA cores.
//
// What bounds it: at the Aachen shape (8 frames, 4096 x 2048 tokens, 4 heads
// of 64) the two directions' QK and PV products are 137 GFLOP and the
// statistics' QK products another 69 GFLOP, against ~75 MB in and out: the
// tensor cores bound it (0.21 ms at 989 TFLOP/s); the 1.07 G exponentials
// are a second ceiling (0.26 ms). Scores never reach device memory or
// shared memory.
//
// Rounding follows _attn_weights: logits qk_q . qk_k * scale + bias in f32
// (in bf16 folded with log2 e into one fma, exponentials by ex2), the
// weights rounded to T for P @ V, 1/sum folded into the f32 output, which
// is rounded to T; an all-masked key side gives the mean of v. The
// statistics use the normalized f32 weights.
//
// Layouts: qk0, v0 [B, N, 256] and qk1, v1 [B, M, 256] of element type T
// with row stride 256 and the given frame strides (the tensors may be views
// into one [B, N + M, 256] projection); bias0 [B, N], bias1 [B, M] f32;
// m0 [B, N, 256], m1 [B, M, 256] T with row stride 256 and their own frame
// strides; stat0 [B, N], stat1 [B, M] f32. T is bf16, or float for the f32
// checks. Kernel 5 (csrc/cross_attention.cu) and kernel 17's cross
// projection (csrc/proj_int8.cu) run the bf16 message pass without
// statistics on strided views of their [B, N + M, 256] projection scratch,
// writing both sides' messages into one [B, N + M, 256] tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_stats.cuh"

namespace {

using pass::HD;
typedef __nv_bfloat16 bf16;

constexpr int D = 256;  // heads * HD

template <typename T>
struct Side {  // one side's tensors; frame strides in elements
  const T* qk;
  const T* v;
  size_t qk_stride, v_stride;
  const float* bias;
  T* msg;
  size_t msg_stride;
  float* stat;
  int n;
};

// the rows scratch is [2][B][heads][N + M]: max, then weight; side 0's
// queries, then side 1's
__device__ __forceinline__ float* side_rows(float* rows, int b, int h,
                                            int heads, int nt, int side_at) {
  return rows + ((size_t)b * heads + h) * nt + side_at;
}

__global__ void __launch_bounds__(pass::NTHREADS, 1)
message_kernel_f32(Side<float> s0, Side<float> s1, float* __restrict__ rows,
                   int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles0 = s0.n / pass::QT;
  const bool dir1 = (int)blockIdx.x >= tiles0;  // queries of side 1
  const Side<float>& q = dir1 ? s1 : s0;
  const Side<float>& k = dir1 ? s0 : s1;
  const int q0 = (dir1 ? (int)blockIdx.x - tiles0 : (int)blockIdx.x) * pass::QT;
  const int h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int nt = s0.n + s1.n;
  float* row_m = nullptr;
  float* row_w = nullptr;
  if (rows != nullptr) {
    row_m = side_rows(rows, b, h, heads, nt, (dir1 ? s0.n : 0) + q0);
    row_w = row_m + (size_t)B * heads * nt;
  }
  pass::message_block(
      q.qk + b * q.qk_stride + (size_t)q0 * D + h * HD, D,
      k.qk + b * k.qk_stride + h * HD, D, k.v + b * k.v_stride + h * HD, D,
      k.bias + (size_t)b * k.n, 0, k.n, scale,
      q.msg + b * q.msg_stride + (size_t)q0 * D + h * HD, D,
      q.bias + (size_t)b * q.n + q0, row_m, row_w, smem);
}

__global__ void __launch_bounds__(pass::STHREADS)
stats_kernel_f32(Side<float> s0, Side<float> s1,
                 const float* __restrict__ rows, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles0 = s0.n / pass::SK;
  const bool side1 = (int)blockIdx.x >= tiles0;  // keys of side 1
  const Side<float>& k = side1 ? s1 : s0;
  const Side<float>& q = side1 ? s0 : s1;
  const int k0 = (side1 ? (int)blockIdx.x - tiles0 : (int)blockIdx.x) * pass::SK;
  const int b = blockIdx.y, B = gridDim.y;
  const int nt = s0.n + s1.n;
  // the query side's rows of pass 1
  const float* row_m = rows + (size_t)b * heads * nt + (side1 ? 0 : s0.n);
  const float* row_w = row_m + (size_t)B * heads * nt;
  pass::stats_block(q.qk + b * q.qk_stride, D,
                    k.qk + b * k.qk_stride + (size_t)k0 * D, D,
                    k.bias + (size_t)b * k.n + k0, row_m, row_w, nt, 0, q.n,
                    heads, scale, k.stat + (size_t)b * k.n + k0, smem);
}

struct Maps {  // bf16 [B, n, 256] views: qk[side], v[side]
  CUtensorMap qk[2], v[2];
};

// STRIDED: the messages go to each side's msg_stride frames (kernel 5's one
// [B, N + M, 256] output); otherwise to contiguous [B, n, 256] tensors, an
// addressing that keeps the pass within 96 registers without a spill
template <bool STRIDED>
__global__ void __launch_bounds__(wg::THREADS, 2)
message_kernel_bf16(const __grid_constant__ Maps maps, Side<bf16> s0,
                    Side<bf16> s1, float* __restrict__ rows, int heads,
                    float scale) {
  extern __shared__ unsigned char smem[];
  const int tiles0 = s0.n / wg::MQ;
  const int qs = (int)blockIdx.x >= tiles0;  // the queries' side
  const int q0 = ((int)blockIdx.x - qs * tiles0) * wg::MQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qn = qs ? s1.n : s0.n, kn = qs ? s0.n : s1.n;
  const size_t qat = (size_t)b * qn + q0;
  bf16* msg = qs ? s1.msg : s0.msg;
  if constexpr (STRIDED)
    msg += b * (qs ? s1.msg_stride : s0.msg_stride) + (size_t)q0 * D;
  else
    msg += qat * D;
  float* row_m = nullptr;
  float* row_w = nullptr;
  if (rows != nullptr) {
    row_m = side_rows(rows, b, h, heads, s0.n + s1.n, qs * s0.n + q0);
    row_w = row_m + (size_t)gridDim.z * heads * (s0.n + s1.n);
  }
  wg::message_cta(&maps.qk[qs], h * HD, &maps.qk[1 - qs], h * HD,
                  &maps.v[1 - qs], h * HD, b, q0, 0, kn,
                  (qs ? s0.bias : s1.bias) + (size_t)b * kn, scale,
                  msg + h * HD, D,
                  (qs ? s1.bias : s0.bias) + qat, row_m, row_w, smem);
}

__global__ void __launch_bounds__(wg::THREADS, 2)
stats_kernel_bf16(const __grid_constant__ Maps maps, Side<bf16> s0,
                  Side<bf16> s1, const float* __restrict__ rows, int heads,
                  float scale) {
  extern __shared__ unsigned char smem[];
  const int tiles0 = s0.n / wg::SK;
  const int ks = (int)blockIdx.x >= tiles0;  // the keys' side
  const int k0 = ((int)blockIdx.x - ks * tiles0) * wg::SK;
  const int b = blockIdx.y;
  const int nt = s0.n + s1.n;
  const int kn = ks ? s1.n : s0.n, qn = ks ? s0.n : s1.n;
  // the query side's rows of pass 1
  const float* row_m = rows + (size_t)b * heads * nt + (1 - ks) * s0.n;
  const float* row_w = row_m + (size_t)gridDim.y * heads * nt;
  const size_t at = (size_t)b * kn + k0;
  wg::stats_cta(&maps.qk[1 - ks], &maps.qk[ks], b, k0, 0, qn, heads,
                (ks ? s1.bias : s0.bias) + at, row_m, row_w, nt, scale,
                (ks ? s1.stat : s0.stat) + at, smem);
}

int launch_f32(Side<float> s0, Side<float> s1, float* rows, int B, int heads,
               float scale, cudaStream_t stream) {
  const bool with_stats = s0.stat != nullptr;
  const int err = wg::launch(
      message_kernel_f32, dim3((s0.n + s1.n) / pass::QT, heads, B),
      pass::NTHREADS, pass::MESSAGE_SMEM, stream, s0, s1,
      with_stats ? rows : nullptr, heads, scale);
  if (err || !with_stats) return err;
  return wg::launch(stats_kernel_f32, dim3((s0.n + s1.n) / pass::SK, B),
                    pass::STHREADS, pass::STATS_SMEM, stream, s0, s1,
                    (const float*)rows, heads, scale);
}

int launch_bf16(Side<bf16> s0, Side<bf16> s1, float* rows, int B, int heads,
                float scale, cudaStream_t stream) {
  Maps maps;
  const Side<bf16>* sides[2] = {&s0, &s1};
  for (int i = 0; i < 2; ++i) {
    const Side<bf16>& s = *sides[i];
    if (!wg::make_map(&maps.qk[i], s.qk, D, s.n, B, D, s.qk_stride) ||
        !wg::make_map(&maps.v[i], s.v, D, s.n, B, D, s.v_stride))
      return (int)cudaErrorInvalidValue;
  }
  const bool with_stats = s0.stat != nullptr;
  const bool strided = s0.msg_stride != (size_t)s0.n * D ||
                       s1.msg_stride != (size_t)s1.n * D;
  const int err = wg::launch(
      strided ? message_kernel_bf16<true> : message_kernel_bf16<false>,
      dim3((s0.n + s1.n) / wg::MQ, heads, B),
      wg::THREADS, wg::MSG_SMEM, stream, maps, s0, s1,
      with_stats ? rows : nullptr, heads, scale);
  if (err || !with_stats) return err;
  return wg::launch(stats_kernel_bf16, dim3((s0.n + s1.n) / wg::SK, B),
                    wg::THREADS, wg::STATS_SMEM, stream, maps, s0, s1,
                    (const float*)rows, heads, scale);
}

template <typename T>
int launch_typed(const void* qk0, const void* qk1, const void* v0,
                 const void* v1, long long qk0_stride, long long qk1_stride,
                 long long v0_stride, long long v1_stride, const void* bias0,
                 const void* bias1, void* m0, void* m1, long long m0_stride,
                 long long m1_stride, void* rows,
                 void* stat0, void* stat1, int B, int N, int M, int heads,
                 float scale, cudaStream_t stream,
                 int (*launch)(Side<T>, Side<T>, float*, int, int, float,
                               cudaStream_t)) {
  if (heads * HD != D || N <= 0 || M <= 0 || N % pass::QT || M % pass::QT)
    return (int)cudaErrorInvalidValue;
  Side<T> s0{(const T*)qk0, (const T*)v0, (size_t)qk0_stride,
             (size_t)v0_stride, (const float*)bias0, (T*)m0,
             (size_t)m0_stride, (float*)stat0, N};
  Side<T> s1{(const T*)qk1, (const T*)v1, (size_t)qk1_stride,
             (size_t)v1_stride, (const float*)bias1, (T*)m1,
             (size_t)m1_stride, (float*)stat1, M};
  return launch(s0, s1, (float*)rows, B, heads, scale, stream);
}

}  // namespace

// m0, m1: rows of 256 elements with the given frame strides (elements;
// kernel 5 writes both sides into one [B, N + M, 256] tensor); rows:
// scratch f32 [2, B, heads, N + M] (only read and written with statistics);
// stat0, stat1: f32 [B, N], [B, M], or both null for no statistics. is_f32
// selects float over bf16.
extern "C" int pram_cross_attention_packed(
    const void* qk0, const void* qk1, const void* v0, const void* v1,
    long long qk0_stride, long long qk1_stride, long long v0_stride,
    long long v1_stride, const void* bias0, const void* bias1, void* m0,
    void* m1, long long m0_stride, long long m1_stride, void* rows,
    void* stat0, void* stat1, int B, int N, int M, int heads, float scale,
    int is_f32, void* stream) {
  auto s = (cudaStream_t)stream;
  if (is_f32)
    return launch_typed<float>(qk0, qk1, v0, v1, qk0_stride, qk1_stride,
                               v0_stride, v1_stride, bias0, bias1, m0, m1,
                               m0_stride, m1_stride, rows, stat0, stat1, B, N,
                               M, heads, scale, s, launch_f32);
  return launch_typed<bf16>(qk0, qk1, v0, v1, qk0_stride, qk1_stride,
                            v0_stride, v1_stride, bias0, bias1, m0, m1,
                            m0_stride, m1_stride, rows, stat0, stat1, B, N, M,
                            heads, scale, s, launch_bf16);
}
