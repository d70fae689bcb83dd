// int8 residual concat-MLP for Hopper (kernel 16):
//   y = x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3
// with every product s8 x s8 -> s32: weights per output column (quantized
// once by the wrapper), activations per row (quantized here).
//
// Replaces pram_tpu/ops/mlp_pallas.py:fused_residual_mlp_int8
// (_mlp_kernel_i8). Quantization follows _quant_rows: rs = max(max|a|,
// 1e-6) / 127, q = round-half-even(a * (1 / rs)), no clip; msg, x, proj(msg)
// (after its rounding to bf16) and the f32 GELU output are quantized
// separately. The products are exact in s32 and dequantized in f32 in the
// TPU kernel's order, each product and sum rounded once (no FMA):
//   pm  = bf16((acc * rs_msg) * wps + bp)
//   h   = ((acc_x * rs_x) + (acc_pm * rs_pm)) * w0s + b0
//   out = bf16(x + bf16((acc * rs_y) * w3s + b3)).
// LayerNorm (eps from the caller) and the exact GELU run in f32, as in the
// bf16 kernel (csrc/mlp.cu); the GELU output is quantized from f32, not
// rounded to bf16 first.
//
// What bounds it: per token 0.92 M s8 operations against 1 KB of bf16 in and
// out; at 49152 tokens (GML's 32 x 1536) 45 G operations (0.023 ms at 1979
// TOP/s) against 50 MB (0.015 ms): the tensor cores, by a little. The design
// keeps a 32-token tile's every intermediate on chip (the two row-quantized
// s8 tiles of x and proj(msg), the f32 hidden layer, the s8 GELU output) and
// writes only y. Products are mma.sync m16n8k32 with the weights' fragments
// read from L2, where the 0.46 MB of s8 weights stay across the blocks; warp
// w owns the 8-column output tiles w, w + 8, ... of a product and both of
// its 16-row halves, so W0's x half and proj(msg) half meet in registers.
//
// Layouts (torch Linear, [out, in]): wpq [256, 256], w0q [512, 512] whose
// input columns are [x (256) | proj(msg) (256)], w3q [256, 512], all s8;
// wps [256], w0s [512], w3s [256] f32 per output feature; biases and the
// LayerNorm weight and bias f32; x, msg, out [tokens, 256] bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 256;    // model width
constexpr int DH = 512;   // hidden width
constexpr int T = 32;     // tokens per block
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int LDX = D + 8;    // bf16 elements, x and msg / proj(msg) tiles
constexpr int LDQ = D + 16;   // bytes, s8 tiles of width 256
constexpr int LDQH = DH + 16; // bytes, the s8 GELU tile
constexpr int LDH = DH + 4;   // f32 elements, the hidden tile

constexpr size_t SMEM_BYTES =
    2ull * T * LDX * sizeof(bf16) + 2ull * T * LDQ + (size_t)T * LDQH +
    (size_t)T * LDH * sizeof(float) + 4ull * T * sizeof(float);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// quantize the T bf16 rows of `src` (ld LDX) into s8 `dst` (ld LDQ); row
// scales into rs[T]. One warp per row.
__device__ __forceinline__ void quant_tile(const bf16* src, unsigned char* dst, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < T; r += NWARP) {
    const float s = mma8::quant_row256(src + r * LDX, dst + r * LDQ);
    if (lane == 0) rs[r] = s;
  }
}

// acc[mt][i] += A[T x K] (s8 smem, ld lda bytes) @ W[n0 .. n0 + 8][k_off ..
// k_off + K]^T (s8 global, row length ldk): one 8-column tile, both 16-row
// halves (mt), the mma C fragment layout.
__device__ __forceinline__ void tile_product(int (&acc)[2][4], const unsigned char* A, int lda,
                                             const int8_t* __restrict__ W, int ldk, int k_off,
                                             int K, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* wrow = reinterpret_cast<const unsigned char*>(W) +
                              (size_t)(n0 + g) * ldk + k_off + 4 * t;
  for (int kc = 0; kc < K; kc += 32) {
    const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wrow + kc));
    const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wrow + kc + 16));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      mma8::load_a(a, A + (size_t)(mt * 16 + g) * lda + 4 * t, lda, kc);
      mma8::mma(acc[mt], a, b0, b1);
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0;
}

__global__ void __launch_bounds__(NTHREADS, 1)
residual_mlp_int8_kernel(const bf16* __restrict__ x, const bf16* __restrict__ msg,
                         const int8_t* __restrict__ wpq, const float* __restrict__ wps,
                         const float* __restrict__ bp, const int8_t* __restrict__ w0q,
                         const float* __restrict__ w0s, const float* __restrict__ b0,
                         const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                         const int8_t* __restrict__ w3q, const float* __restrict__ w3s,
                         const float* __restrict__ b3, bf16* __restrict__ out, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ps = Xs + T * LDX;  // msg, then proj(msg)
  unsigned char* Aq = reinterpret_cast<unsigned char*>(Ps + T * LDX);
  unsigned char* Bq = Aq + T * LDQ;
  unsigned char* Yq = Bq + T * LDQ;
  float* Hf = reinterpret_cast<float*>(Yq + T * LDQH);
  float* rs = Hf + T * LDH;  // row scales: msg, x, proj(msg), GELU output
  const size_t row0 = (size_t)blockIdx.x * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int v = threadIdx.x; v < T * (D / 8); v += NTHREADS) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(Xs + r * LDX + c) =
        *reinterpret_cast<const uint4*>(x + (row0 + r) * D + c);
    *reinterpret_cast<uint4*>(Ps + r * LDX + c) =
        *reinterpret_cast<const uint4*>(msg + (row0 + r) * D + c);
  }
  __syncthreads();
  quant_tile(Ps, Aq, rs);
  quant_tile(Xs, Bq, rs + T);
  __syncthreads();

  // proj(msg) = bf16((acc * rs_msg) * wps + bp), over msg in Ps
  for (int j = warp; j < D / 8; j += NWARP) {
    int acc[2][4];
    zero(acc);
    tile_product(acc, Aq, LDQ, wpq, D, 0, D, j * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >> 1) * 8, c = j * 8 + 2 * t + (i & 1);
        const float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][i]), rs[r]), wps[c]), bp[c]);
        Ps[r * LDX + c] = __float2bfloat16_rn(v);
      }
  }
  __syncthreads();
  quant_tile(Ps, Aq, rs + 2 * T);
  __syncthreads();

  // h = ((acc_x * rs_x) + (acc_pm * rs_pm)) * w0s + b0
  for (int j = warp; j < DH / 8; j += NWARP) {
    int ax[2][4], ap[2][4];
    zero(ax);
    zero(ap);
    tile_product(ax, Bq, LDQ, w0q, 2 * D, 0, D, j * 8);
    tile_product(ap, Aq, LDQ, w0q, 2 * D, D, D, j * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >> 1) * 8, c = j * 8 + 2 * t + (i & 1);
        const float s = __fadd_rn(__fmul_rn(__int2float_rn(ax[mt][i]), rs[T + r]),
                                  __fmul_rn(__int2float_rn(ap[mt][i]), rs[2 * T + r]));
        Hf[r * LDH + c] = __fadd_rn(__fmul_rn(s, w0s[c]), b0[c]);
      }
  }
  __syncthreads();

  // LayerNorm + exact GELU in f32, one warp per row, then _quant_rows of it
  for (int r = warp; r < T; r += NWARP) {
    const float* row = Hf + r * LDH;
    float v[DH / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      v[j] = row[lane + 32 * j];
      s += v[j];
    }
    const float mu = warp_sum(s) / DH;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      v[j] -= mu;
      q += v[j] * v[j];
    }
    const float inv = rsqrtf(warp_sum(q) / DH + eps);
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      const int c = lane + 32 * j;
      const float hn = v[j] * inv * ln_w[c] + ln_b[c];
      v[j] = hn * 0.5f * (1.f + erff(hn * 0.70710678118654752f));
    }
    int8_t qv[DH / 32];
    const float ys = mma8::quant_row<DH / 32>(v, qv);
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) Yq[r * LDQH + lane + 32 * j] = (unsigned char)qv[j];
    if (lane == 0) rs[3 * T + r] = ys;
  }
  __syncthreads();

  // out = bf16(x + bf16((acc * rs_y) * w3s + b3))
  for (int j = warp; j < D / 8; j += NWARP) {
    int acc[2][4];
    zero(acc);
    tile_product(acc, Yq, LDQH, w3q, DH, 0, DH, j * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >> 1) * 8, c = j * 8 + 2 * t + (i & 1);
        const float o = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][i]), rs[3 * T + r]), w3s[c]), b3[c])));
        out[(row0 + r) * D + c] =
            __float2bfloat16_rn(__bfloat162float(Xs[r * LDX + c]) + o);
      }
  }
}

}  // namespace

extern "C" int pram_residual_mlp_int8(const void* x, const void* msg, const void* wpq,
                                      const void* wps, const void* bp, const void* w0q,
                                      const void* w0s, const void* b0, const void* ln_w,
                                      const void* ln_b, const void* w3q, const void* w3s,
                                      const void* b3, void* out, int tokens, float eps,
                                      void* stream) {
  if (tokens <= 0 || tokens % T != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(residual_mlp_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  residual_mlp_int8_kernel<<<tokens / T, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)msg, (const int8_t*)wpq, (const float*)wps,
      (const float*)bp, (const int8_t*)w0q, (const float*)w0s, (const float*)b0,
      (const float*)ln_w, (const float*)ln_b, (const int8_t*)w3q, (const float*)w3s,
      (const float*)b3, (bf16*)out, eps);
  return (int)cudaGetLastError();
}
