// Backward of the residual concat-MLP (kernel 2) for Hopper: bf16 in, f32
// accumulation, f32 LayerNorm and GELU.
//
// Replaces pram_tpu/ops/mlp_bwd_pallas.py:fused_residual_mlp_bwd
// (_mlp_bwd_kernel). Forward: h = W0 [x, pm] + b0, hn = LN(h) (gamma,
// beta), y = gelu_erf(hn), out = x + W3 y + b3, with pm = proj(msg) made
// outside. Given x, pm and the output's cotangent ct it returns
//   dy = ct W3,  dz = dy (Phi(hn) + hn phi(hn)),  dhhat = dz gamma,
//   dh = (dhhat - mean(dhhat) - hhat mean(dhhat hhat)) / sigma,
//   dx = ct + dh W0x,  dpm = dh W0m,
//   dW0 = dh^T [x, pm],  dW3 = ct^T y,  db0 = sum dh,  dgamma = sum dz hhat,
//   dbeta = sum dz,  db3 = sum ct   (the sums over every token).
//
// What bounds it: at the training slice's 16384 tokens (d=256, hidden 512)
// the five products take 34.4 GFLOP against ~42 MB of inputs and outputs,
// so the tensor cores bound it (0.035 ms). The TPU kernel runs its token
// tiles in order and adds the weight gradients into VMEM accumulators
// across them; Hopper's blocks run in no order. So three kernels, with no
// atomics and a fixed order of summation:
//   1. token_kernel, one block per 32 tokens: recomputes h, LayerNorm and
//      GELU on chip, computes dy, dz, dh, then dx and dpm; it writes y and
//      dh (bf16) to scratch for the weight gradients, and the tile's column
//      sums of dz hhat, dz, dh and ct to an f32 scratch.
//   2. weight_kernel, one block per 64 x 64 tile of dW0 or dW3 and per
//      split of the tokens: sums its tile of dh^T [x, pm] or ct^T y over
//      every `splits`-th 32-token chunk in registers, into an f32 scratch
//      [splits, 512 * 512 + 256 * 512].
//   3. reduce_kernel adds the splits and the tiles' column sums in order.
// Products are bf16 WMMA tiles (16x16x16, f32 accumulate); the weights are
// read as WMMA tiles from L2. wgmma, TMA and fusing the splits are later
// work.
//
// Rounding follows the TPU kernel: y and dh are rounded to bf16 before
// their products (y as the forward rounds it); the LayerNorm and GELU
// chains, the column sums and the weight gradients are f32; dx (ct added in
// f32) and dpm are rounded to bf16.
//
// Layouts (torch Linear, [out, in]): w0 [512, 512] bf16 whose input columns
// are [x (256) | pm (256)], w3 [256, 512] bf16; b0, gamma, beta [512] f32;
// x, pm, ct, dx, dpm [tokens, 256] bf16; dw0 [512, 512], dw3 [256, 512],
// db0, dgamma, dbeta [512], db3 [256] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 256;       // model width
constexpr int DH = 512;      // hidden width
constexpr int TT = 32;       // tokens per block of the token pass
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int LDA = D + 8;   // bf16 stride of the x, pm, ct tiles
constexpr int LDD = DH + 8;  // bf16 stride of the dh tile
constexpr int LDC = DH + 4;  // f32 stride of the accumulator tiles
constexpr int NCOL = 3 * DH + D;  // column sums of a tile: dz hhat, dz, dh, ct
constexpr int W0_ELEMS = DH * 2 * D;
constexpr int W3_ELEMS = D * DH;
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

constexpr size_t TOKEN_SMEM =
    3ull * TT * LDA * sizeof(bf16) + 2ull * TT * LDC * sizeof(float);
static_assert((size_t)TT * LDD * sizeof(bf16) <= 2ull * TT * LDA * sizeof(bf16),
              "the dh tile overlays the x and pm tiles");
static_assert((size_t)NWARP * 3 * DH * sizeof(float) <= (size_t)TT * LDC * sizeof(float) * 2,
              "the warps' column sums overlay the accumulators");

// C[TT x n_out] (f32, ld LDC) = [A0 | A1] W^T: W global [n_out, k_total]
// bf16 (torch layout); A0 covers input columns [0, k0), A1 the rest.
__device__ __forceinline__ void gemm_nt(const bf16* A0, int lda0, int k0,
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

// C[TT x n_out] (f32, ld LDC) = A W: A [TT, k_total] bf16 (ld lda), W global
// [k_total, n_out] bf16 row-major with row stride ldw.
__device__ __forceinline__ void gemm_nn(const bf16* A, int lda,
                                        const bf16* __restrict__ W, int ldw,
                                        int k_total, int n_out, float* C) {
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < n_out / 16; j += NWARP) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    wmma::fill_fragment(acc0, 0.f);
    wmma::fill_fragment(acc1, 0.f);
    for (int k = 0; k < k_total; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + (size_t)k * ldw + j * 16, ldw);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + k, lda);
      wmma::mma_sync(acc0, a, b, acc0);
      wmma::load_matrix_sync(a, A + 16 * lda + k, lda);
      wmma::mma_sync(acc1, a, b, acc1);
    }
    wmma::store_matrix_sync(C + j * 16, acc0, LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(C + 16 * LDC + j * 16, acc1, LDC,
                            wmma::mem_row_major);
  }
}

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src) {
  constexpr int VEC = D / 8;
  for (int v = threadIdx.x; v < TT * VEC; v += NTHREADS) {
    const int r = v / VEC, c = (v % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDA + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
token_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pm,
             const bf16* __restrict__ ct, const bf16* __restrict__ w0,
             const float* __restrict__ b0, const float* __restrict__ ln_w,
             const float* __restrict__ ln_b, const bf16* __restrict__ w3,
             bf16* __restrict__ dx, bf16* __restrict__ dpm,
             bf16* __restrict__ y_out, bf16* __restrict__ dh_out,
             float* __restrict__ colsums, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ps = Xs + TT * LDA;
  bf16* Cs = Ps + TT * LDA;
  bf16* Dh = Xs;  // over x and pm once h is computed
  float* C = reinterpret_cast<float*>(smem + 3ull * TT * LDA * sizeof(bf16));
  float* C2 = C + TT * LDC;
  float* red = C;  // the warps' column sums, once C and C2 are read
  const size_t row0 = (size_t)blockIdx.x * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows(Xs, x + row0 * D);
  load_rows(Ps, pm + row0 * D);
  load_rows(Cs, ct + row0 * D);
  __syncthreads();
  gemm_nt(Xs, LDA, D, Ps, LDA, w0, 2 * D, DH, C);  // h - b0
  gemm_nn(Cs, LDA, w3, DH, D, DH, C2);             // dy
  __syncthreads();

  // one warp per row (4 rows a warp); lane holds columns lane + 32 j
  constexpr int PER = DH / 32;
  float sg[PER], sb[PER], sd[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) sg[j] = sb[j] = sd[j] = 0.f;
  for (int r = warp; r < TT; r += NWARP) {
    float hh[PER], dz[PER];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      hh[j] = C[r * LDC + c] + b0[c];
      s += hh[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s / DH;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      hh[j] -= mu;
      q += hh[j] * hh[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    const float rstd = rsqrtf(q / DH + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      hh[j] *= rstd;  // hhat
      const float z = hh[j] * ln_w[c] + ln_b[c];
      const float phi = expf(-0.5f * z * z) * INV_SQRT_2PI;
      const float Phi = 0.5f * (1.f + erff(z * INV_SQRT2));
      y_out[(row0 + r) * DH + c] = __float2bfloat16(z * Phi);
      dz[j] = C2[r * LDC + c] * (Phi + z * phi);
      sg[j] += dz[j] * hh[j];
      sb[j] += dz[j];
      const float dhh = dz[j] * ln_w[c];
      m1 += dhh;
      m2 += dhh * hh[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    m1 /= DH;
    m2 /= DH;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      const float dh = (dz[j] * ln_w[c] - m1 - hh[j] * m2) * rstd;
      sd[j] += dh;
      const bf16 dhb = __float2bfloat16(dh);
      Dh[r * LDD + c] = dhb;
      dh_out[(row0 + r) * DH + c] = dhb;
    }
  }
  __syncthreads();  // C and C2 are read: the warps' sums go there

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    red[(warp * 3 + 0) * DH + c] = sg[j];
    red[(warp * 3 + 1) * DH + c] = sb[j];
    red[(warp * 3 + 2) * DH + c] = sd[j];
  }
  __syncthreads();
  float* cs_out = colsums + (size_t)blockIdx.x * NCOL;
  for (int c = threadIdx.x; c < 3 * DH; c += NTHREADS) {
    const int which = c / DH, col = c % DH;
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[(w * 3 + which) * DH + col];
    cs_out[c] = s;
  }
  for (int c = threadIdx.x; c < D; c += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < TT; ++r) s += __bfloat162float(Cs[r * LDA + c]);
    cs_out[3 * DH + c] = s;
  }
  __syncthreads();  // red is read: C takes [dx | dpm] - ct

  gemm_nn(Dh, LDD, w0, 2 * D, DH, 2 * D, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TT * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dx[(row0 + r) * D + c] =
        __float2bfloat16(__bfloat162float(Cs[r * LDA + c]) + C[r * LDC + c]);
    dpm[(row0 + r) * D + c] = __float2bfloat16(C[r * LDC + D + c]);
  }
}

// One 64 x 64 tile of dW0 = dh^T [x, pm] (tiles 0-63) or dW3 = ct^T y
// (tiles 64-95), summed over the 32-token chunks s, s + splits, ...
constexpr int WT = 64;
constexpr int LDW = WT + 8;
constexpr int W_TILES = (DH / WT) * (2 * D / WT) + (D / WT) * (DH / WT);

__global__ void __launch_bounds__(NTHREADS, 1)
weight_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pm,
              const bf16* __restrict__ ct, const bf16* __restrict__ y,
              const bf16* __restrict__ dh, float* __restrict__ partial,
              int tokens) {
  __shared__ __align__(128) bf16 As[TT * LDW];
  __shared__ __align__(128) bf16 Bs[TT * LDW];
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const bf16* A;  // [tokens, lda], columns a_col .. + 64 are the tile's rows
  const bf16* Bm;  // [tokens, ldb], columns b_col .. + 64 its columns
  int lda, ldb;
  float* out;  // the tile's corner in this split's partial, row stride ldo
  int ldo;
  float* part = partial + (size_t)split * (W0_ELEMS + W3_ELEMS);
  if (tile < 64) {
    const int mt = tile / 8, nt = tile % 8;
    A = dh + mt * WT;
    lda = DH;
    Bm = nt < 4 ? x + nt * WT : pm + (nt - 4) * WT;
    ldb = D;
    ldo = 2 * D;
    out = part + (size_t)mt * WT * ldo + nt * WT;
  } else {
    const int mt = (tile - 64) / 8, nt = (tile - 64) % 8;
    A = ct + mt * WT;
    lda = D;
    Bm = y + nt * WT;
    ldb = DH;
    ldo = DH;
    out = part + W0_ELEMS + (size_t)mt * WT * ldo + nt * WT;
  }
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp >> 1) * 16, c0 = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int chunks = tokens / TT;
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 8;  // 32 rows x 8 vectors
  for (int ch = split; ch < chunks; ch += splits) {
    const size_t t = (size_t)ch * TT + r;
    *reinterpret_cast<uint4*>(As + r * LDW + c) =
        *reinterpret_cast<const uint4*>(A + t * lda + c);
    *reinterpret_cast<uint4*>(Bs + r * LDW + c) =
        *reinterpret_cast<const uint4*>(Bm + t * ldb + c);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TT; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, As + k * LDW + r0, LDW);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + k * LDW + c0 + j * 16, LDW);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + (size_t)r0 * ldo + c0 + j * 16, acc[j], ldo,
                            wmma::mem_row_major);
}

__global__ void reduce_kernel(const float* __restrict__ partial, int splits,
                              const float* __restrict__ colsums, int tiles,
                              float* __restrict__ dw0, float* __restrict__ dw3,
                              float* __restrict__ dgamma,
                              float* __restrict__ dbeta,
                              float* __restrict__ db0,
                              float* __restrict__ db3) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int W = W0_ELEMS + W3_ELEMS;
  if (i < W) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * W + i];
    if (i < W0_ELEMS)
      dw0[i] = s;
    else
      dw3[i - W0_ELEMS] = s;
  } else if (i < W + NCOL) {
    const int c = i - W;
    float s = 0.f;
    for (int k = 0; k < tiles; ++k) s += colsums[(size_t)k * NCOL + c];
    if (c < DH)
      dgamma[c] = s;
    else if (c < 2 * DH)
      dbeta[c - DH] = s;
    else if (c < 3 * DH)
      db0[c - 2 * DH] = s;
    else
      db3[c - 3 * DH] = s;
  }
}

}  // namespace

// Scratch the caller allocates: y, dh [tokens, 512] bf16; colsums
// [tokens / 32, 3 * 512 + 256] f32; partial [splits, 512 * 512 + 256 * 512]
// f32.
extern "C" int pram_residual_mlp_bwd(
    const void* x, const void* pm, const void* ct, const void* w0,
    const void* b0, const void* ln_w, const void* ln_b, const void* w3,
    void* dx, void* dpm, void* dw0, void* db0, void* dln_w, void* dln_b,
    void* dw3, void* db3, void* y, void* dh, void* colsums, void* partial,
    int tokens, int splits, float eps, void* stream) {
  if (tokens <= 0 || tokens % TT != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      token_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TOKEN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = tokens / TT;
  token_kernel<<<tiles, NTHREADS, TOKEN_SMEM, s>>>(
      (const bf16*)x, (const bf16*)pm, (const bf16*)ct, (const bf16*)w0,
      (const float*)b0, (const float*)ln_w, (const float*)ln_b,
      (const bf16*)w3, (bf16*)dx, (bf16*)dpm, (bf16*)y, (bf16*)dh,
      (float*)colsums, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  weight_kernel<<<dim3(W_TILES, splits), NTHREADS, 0, s>>>(
      (const bf16*)x, (const bf16*)pm, (const bf16*)ct, (const bf16*)y,
      (const bf16*)dh, (float*)partial, tokens);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = W0_ELEMS + W3_ELEMS + NCOL;
  reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const float*)partial, splits, (const float*)colsums, tiles,
      (float*)dw0, (float*)dw3, (float*)dln_w, (float*)dln_b, (float*)db0,
      (float*)db3);
  return (int)cudaGetLastError();
}
