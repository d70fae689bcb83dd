// Residual concat-MLP for Hopper:
//   y = x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3
// (bf16 in and out, f32 accumulation, f32 LayerNorm and GELU; a float
// instantiation, products on the CUDA cores, serves the f32 A/B checks of
// the matcher).
//
// Replaces pram_tpu/ops/mlp_pallas.py:fused_residual_mlp (_mlp_kernel).
//
// What bounds it: per token the three products cost 0.92 MFLOP against
// 1 KB of activations in and out, so at 16384 tokens a layer is ~15 GFLOP
// over ~17 MB: tensor-core bound. The design keeps every intermediate of a
// 32-token tile on chip: the message projection, the [x, proj(msg)] concat
// (never built: W0's two column halves read x and proj(msg) from separate
// shared tiles), the 512-wide hidden layer, LayerNorm and GELU. Only y is
// written. Products use bf16 WMMA tensor-core tiles (16x16x16, f32
// accumulate). The weights (0.9 MB in bf16) are read as WMMA tiles straight
// from L2, where they stay resident across the 512 blocks; each warp walks
// output column tiles and reuses each weight tile for both 16-row halves of
// the token tile. Staging weights through shared memory with TMA and wgmma
// is the next step for speed.
//
// Rounding follows the TPU kernel: proj(msg) is rounded to bf16 before W0;
// the hidden layer, LayerNorm (eps from the caller) and GELU are f32;
// GELU's output is rounded to bf16 before W3; W3's output + b3 is rounded to
// bf16 and added to x in bf16.
//
// Layouts (torch Linear, [out, in]): wp [256, 256], w0 [512, 512] whose
// input columns are [x (256) | proj(msg) (256)], w3 [256, 512], all of the
// element type E (bf16, or float); biases and LayerNorm weight/bias f32.
// x, msg, out [tokens, 256] E. With E = float every rounding to E is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 256;       // model width
constexpr int DH = 512;      // hidden width
constexpr int T = 32;        // tokens per block
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int LDC = DH + 4;  // f32 stride of the accumulator tile

typedef __nv_bfloat16 bf16;

template <typename E> struct Tiles;  // strides of the E tiles: x / msg, GELU
template <> struct Tiles<bf16> { static constexpr int LDA = D + 8, LDY = DH + 8; };
template <> struct Tiles<float> { static constexpr int LDA = D + 4, LDY = DH + 4; };

template <typename E>
constexpr size_t smem_bytes() {
  return (2ull * T * Tiles<E>::LDA + (size_t)T * Tiles<E>::LDY) * sizeof(E) +
         (size_t)T * LDC * sizeof(float);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// C[T x n_out] (f32, ld LDC) = [A0 | A1] @ W^T, W global [n_out, k_total]
// bf16; A0 covers input columns [0, k0) (ld lda0), A1 the rest (ld lda1).
__device__ __forceinline__ void block_gemm(const bf16* A0, int lda0, int k0,
                                           const bf16* A1, int lda1,
                                           const bf16* __restrict__ W,
                                           int k_total, int n_out, float* C) {
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < n_out / 16; j += NWARP) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    wmma::fill_fragment(acc0, 0.f);
    wmma::fill_fragment(acc1, 0.f);
    const bf16* wcol = W + (size_t)j * 16 * k_total;
    for (int k = 0; k < k_total; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, wcol + k, k_total);
      const bf16* A = k < k0 ? A0 + k : A1 + (k - k0);
      const int lda = k < k0 ? lda0 : lda1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A, lda);
      wmma::mma_sync(acc0, a, b, acc0);
      wmma::load_matrix_sync(a, A + 16 * lda, lda);
      wmma::mma_sync(acc1, a, b, acc1);
    }
    wmma::store_matrix_sync(C + j * 16, acc0, LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(C + 16 * LDC + j * 16, acc1, LDC,
                            wmma::mem_row_major);
  }
}

// The same product in f32 on the CUDA cores: one thread per output column,
// its T accumulators in registers, W's row read through L1.
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

template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* src) {
  constexpr int PER = 16 / sizeof(E);  // elements per 16-byte vector
  constexpr int VEC = D / PER;
  constexpr int LDA = Tiles<E>::LDA;
  for (int v = threadIdx.x; v < T * VEC; v += NTHREADS) {
    int r = v / VEC, c = (v % VEC) * PER;
    *reinterpret_cast<uint4*>(dst + r * LDA + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

template <typename E>
__global__ void __launch_bounds__(NTHREADS, 1)
residual_mlp_kernel(const E* __restrict__ x, const E* __restrict__ msg,
                    const E* __restrict__ wp, const float* __restrict__ bp,
                    const E* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b,
                    const E* __restrict__ w3, const float* __restrict__ b3,
                    E* __restrict__ out, float eps) {
  constexpr int LDA = Tiles<E>::LDA, LDY = Tiles<E>::LDY;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Xs = reinterpret_cast<E*>(smem);
  E* Ms = Xs + T * LDA;
  E* Ys = Ms + T * LDA;
  float* Cf = reinterpret_cast<float*>(Ys + T * LDY);
  const size_t row0 = (size_t)blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile(Xs, x + row0 * D);
  load_tile(Ms, msg + row0 * D);
  __syncthreads();

  // proj(msg), rounded to bf16, replaces msg in Ms
  block_gemm(Ms, LDA, D, Ms, LDA, wp, D, D, Cf);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += NTHREADS) {
    int r = i / D, c = i % D;
    Ms[r * LDA + c] = from_f32<E>(Cf[r * LDC + c] + bp[c]);
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
      float g = hn * 0.5f * (1.f + erff(hn * 0.70710678118654752f));
      Ys[r * LDY + c] = from_f32<E>(g);
    }
  }
  __syncthreads();

  // out = x + bf16(W3 y + b3)
  block_gemm(Ys, LDY, DH, Ys, LDY, w3, DH, D, Cf);
  __syncthreads();
  for (int i = threadIdx.x; i < T * D; i += NTHREADS) {
    int r = i / D, c = i % D;
    float o = to_f32(from_f32<E>(Cf[r * LDC + c] + b3[c]));
    float xr = to_f32(Xs[r * LDA + c]);
    out[(row0 + r) * D + c] = from_f32<E>(xr + o);
  }
}

template <typename E>
int launch(const void* x, const void* msg, const void* wp, const void* bp,
           const void* w0, const void* b0, const void* ln_w, const void* ln_b,
           const void* w3, const void* b3, void* out, int tokens, float eps,
           cudaStream_t stream) {
  if (tokens % T != 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(
      residual_mlp_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  residual_mlp_kernel<E><<<tokens / T, NTHREADS, smem, stream>>>(
      (const E*)x, (const E*)msg, (const E*)wp, (const float*)bp,
      (const E*)w0, (const float*)b0, (const float*)ln_w, (const float*)ln_b,
      (const E*)w3, (const float*)b3, (E*)out, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// is_f32 selects float over bf16 for x, msg, the weights and out
extern "C" int pram_residual_mlp(const void* x, const void* msg,
                                 const void* wp, const void* bp,
                                 const void* w0, const void* b0,
                                 const void* ln_w, const void* ln_b,
                                 const void* w3, const void* b3, void* out,
                                 int tokens, float eps, int is_f32,
                                 void* stream) {
  auto s = (cudaStream_t)stream;
  if (is_f32)
    return launch<float>(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, out,
                         tokens, eps, s);
  return launch<bf16>(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, out, tokens,
                      eps, s);
}
