// Residual concat-MLP (kernel 2):
//   y = x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3
// at d = 256, hidden 512. bf16 in and out: the TMA/wgmma tile of
// mlp_tile.cuh (f32 accumulation, f32 LayerNorm and GELU; its header says
// what bounds it and how it rounds). A float instance, products on the CUDA
// cores, serves the f32 A/B checks of the matcher.
//
// Replaces pram_tpu/ops/mlp_pallas.py:fused_residual_mlp (_mlp_kernel).
//
// The float instance keeps every intermediate of a 32-token tile on chip:
// the message projection, the [x, proj(msg)] concat (never built: W0's two
// column halves read x and proj(msg) from separate shared tiles), the
// 512-wide hidden layer, LayerNorm (eps from the caller) and GELU; one
// thread per output column holds its 32 accumulators in registers and reads
// its weight row through L1. Only y is written.
//
// Layouts (torch Linear, [out, in]): wp [256, 256], w0 [512, 512] whose
// input columns are [x (256) | proj(msg) (256)], w3 [256, 512], all of the
// element type of x (bf16, or float); biases and LayerNorm weight/bias f32.
// x, msg, out [tokens, 256].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

constexpr int D = 256;       // model width
constexpr int DH = 512;      // hidden width
constexpr int T = 32;        // tokens per block
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int LDC = DH + 4;  // f32 stride of the accumulator tile
constexpr int LDA = D + 4;   // of the x and msg tiles
constexpr int LDY = DH + 4;  // of the GELU tile
constexpr size_t SMEM = (2ull * T * LDA + (size_t)T * LDY + (size_t)T * LDC) * sizeof(float);

// C[T x n_out] (f32, ld LDC) = [A0 | A1] @ W^T on the CUDA cores, W global
// [n_out, k_total]; A0 covers input columns [0, k0) (ld lda0), A1 the rest
// (ld lda1). One thread per output column, its T accumulators in registers,
// W's row read through L1.
__device__ __forceinline__ void block_gemm(const float* A0, int lda0, int k0,
                                           const float* A1, int lda1,
                                           const float* __restrict__ W,
                                           int k_total, int n_out, float* C) {
  for (int c = threadIdx.x; c < n_out; c += NTHREADS) {
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
    const float* wrow = W + (size_t)c * k_total;
    for (int k = 0; k < k_total; ++k) {
      const float w = __ldg(wrow + k);
      const float* A = k < k0 ? A0 + k : A1 + (k - k0);
      const int lda = k < k0 ? lda0 : lda1;
#pragma unroll
      for (int r = 0; r < T; ++r) acc[r] = fmaf(A[r * lda], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) C[r * LDC + c] = acc[r];
  }
}

__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  constexpr int VEC = D / 4;  // 16-byte vectors of a row
  for (int v = threadIdx.x; v < T * VEC; v += NTHREADS) {
    int r = v / VEC, c = (v % VEC) * 4;
    *reinterpret_cast<uint4*>(dst + r * LDA + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
residual_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ msg,
                        const float* __restrict__ wp, const float* __restrict__ bp,
                        const float* __restrict__ w0, const float* __restrict__ b0,
                        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                        const float* __restrict__ w3, const float* __restrict__ b3,
                        float* __restrict__ out, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Ms = Xs + T * LDA;
  float* Ys = Ms + T * LDA;
  float* Cf = Ys + T * LDY;
  const size_t row0 = (size_t)blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(Xs, x + row0 * D);
  load_tile(Ms, msg + row0 * D);
  __syncthreads();

  // proj(msg) replaces msg in Ms
  block_gemm(Ms, LDA, D, Ms, LDA, wp, D, D, Cf);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += NTHREADS) {
    int r = i / D, c = i % D;
    Ms[r * LDA + c] = Cf[r * LDC + c] + bp[c];
  }
  __syncthreads();

  // hidden = W0 [x, proj(msg)] + b0
  block_gemm(Xs, LDA, D, Ms, LDA, w0, 2 * D, DH, Cf);
  __syncthreads();

  // LayerNorm + exact GELU, one warp per row (4 rows per warp)
  for (int r = warp; r < T; r += NWARP) {
    float* row = Cf + r * LDC;
    float v[DH / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      int c = lane + 32 * j;
      v[j] = row[c] + b0[c];
      s += v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s / DH;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      v[j] -= mu;
      q += v[j] * v[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    const float inv = rsqrtf(q / DH + eps);
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      int c = lane + 32 * j;
      float hn = v[j] * inv * ln_w[c] + ln_b[c];
      Ys[r * LDY + c] = hn * 0.5f * (1.f + erff(hn * 0.70710678118654752f));
    }
  }
  __syncthreads();

  // out = x + (W3 y + b3)
  block_gemm(Ys, LDY, DH, Ys, LDY, w3, DH, D, Cf);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += NTHREADS) {
    int r = i / D, c = i % D;
    out[(row0 + r) * D + c] = Xs[r * LDA + c] + (Cf[r * LDC + c] + b3[c]);
  }
}

int launch_f32(const void* x, const void* msg, const void* wp, const void* bp, const void* w0,
               const void* b0, const void* ln_w, const void* ln_b, const void* w3,
               const void* b3, void* out, int tokens, float eps, cudaStream_t stream) {
  if (tokens % T != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      residual_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  residual_mlp_f32_kernel<<<tokens / T, NTHREADS, SMEM, stream>>>(
      (const float*)x, (const float*)msg, (const float*)wp, (const float*)bp,
      (const float*)w0, (const float*)b0, (const float*)ln_w, (const float*)ln_b,
      (const float*)w3, (const float*)b3, (float*)out, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// is_f32 selects float over bf16 for x, msg, the weights and out; bf16
// tokens any count, float a multiple of 32
extern "C" int pram_residual_mlp(const void* x, const void* msg,
                                 const void* wp, const void* bp,
                                 const void* w0, const void* b0,
                                 const void* ln_w, const void* ln_b,
                                 const void* w3, const void* b3, void* out,
                                 int tokens, float eps, int is_f32,
                                 void* stream) {
  auto s = (cudaStream_t)stream;
  if (is_f32)
    return launch_f32(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, out, tokens, eps, s);
  const mlptile::Vecs v = {(const float*)bp, (const float*)b0, (const float*)ln_w,
                           (const float*)ln_b, (const float*)b3, nullptr, nullptr, nullptr,
                           eps};
  return mlptile::launch<__nv_bfloat16>(x, msg, wp, w0, w3, v, out, tokens, s);
}
