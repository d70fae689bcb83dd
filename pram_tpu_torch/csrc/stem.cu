// SFD2 stem, for Hopper: conv1a (3 -> 64, 3x3, stride 1) + BN + ReLU, then
// conv1b (64 -> 64, 3x3, stride 2) + BN + ReLU, both with SAME padding of 1,
// in one kernel. BN is folded into the weights and biases by the wrapper (in
// f32); the weights arrive rounded to the working type T (bf16 or f32).
//
// Replaces pram_tpu/ops/stem_pallas.py:fused_stem (_stem_kernel). Like the
// TPU kernel it keeps conv1a's full-resolution 64-channel output on chip; it
// does not copy the TPU kernel's parity-split planar layout of the image or
// its block-diagonal conv1a matrix, which exist for the TPU's vector lanes.
//
// What bounds it: at 32 x 480 x 640 the two convolutions take ~215 GFLOP
// (conv1a 2 * 27 * 64 per pixel, conv1b 2 * 576 * 64 per output pixel), 0.22
// ms at the bf16 tensor-core peak, against ~0.11 ms for its bytes (the image
// read once, the [B, H/2, W/2, 64] output written once): operations. The
// design: a persistent block walks over (image, 8 x 16 output-pixel) tiles.
// For each tile it
//   1. loads the (2*8+3) x (2*16+3) x 3 input patch into shared memory as
//      f32, zero outside the image (conv1a's padding);
//   2. computes conv1a on the (2*8+1) x (2*16+1) intermediate patch with f32
//      FMAs (a warp a position, a lane two channels), adds the bias, applies
//      ReLU, rounds to T and keeps it in shared memory, in two planes by
//      column parity so that a stride-2 tap reads consecutive positions;
//   3. sets every intermediate position outside the image to zero: that is
//      conv1b's padding, not conv1a evaluated there (which would give
//      ReLU(bias));
//   4. computes conv1b as a 128 x 64 x 576 implicit GEMM: in bf16 with WMMA
//      tiles accumulated in f32 (a warp one output row of 16 pixels, all 64
//      channels; the folded conv1b weights stay in shared memory for the
//      whole run), in f32 with FMAs (for holding the kernel to its plain
//      version tightly); adds the bias, applies ReLU and writes NHWC, which is
//      channels_last memory for the next convolution.
// Any H and W: ragged tiles are bounds-checked, not gated.
//
// Layouts: image [B, H, W, 3] T; w1 [27, 64] f32 (row (dy*3+dx)*3+c) holding
// T-rounded values; b1 [64] f32; w2 [576, 64] T (row (dy*3+dx)*64+c); b2 [64]
// f32; out [B, (H+1)/2, (W+1)/2, 64] T. All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TH = 8;             // output rows of a tile
constexpr int TW = 16;            // output columns of a tile
constexpr int C = 64;             // channels of both convolutions
constexpr int NWARP = 8;          // a warp per output row in the WMMA pass
constexpr int NTHREADS = NWARP * 32;
constexpr int IR = 2 * TH + 1;    // intermediate rows of a tile
constexpr int IQ = 2 * TW + 1;    // intermediate columns of a tile
constexpr int PE = TW + 1;        // even-column plane width
constexpr int PO = TW;            // odd-column plane width
constexpr int PR = 2 * TH + 3;    // input rows of a tile
constexpr int PC = 2 * TW + 3;    // input columns of a tile
constexpr int K2 = 9 * C;         // conv1b's reduction depth
constexpr int LDB = C + 8;        // bf16 row stride of the conv1b weights
constexpr int LDS = C + 4;        // f32 row stride of the epilogue staging

typedef __nv_bfloat16 bf16;

// channel stride of one intermediate position: in bf16 80 keeps WMMA rows
// 32-byte aligned and spreads them over the banks; in f32 the FMA pass reads
// by broadcast and needs no padding
template <typename T> struct Stride;
template <> struct Stride<bf16> { static constexpr int S = 80; };
template <> struct Stride<float> { static constexpr int S = 64; };

constexpr size_t INPUT_BYTES = ((size_t)PR * PC * 3 * 4 + 127) / 128 * 128;

template <typename T>
__host__ __device__ constexpr size_t plane_bytes() {
  return ((size_t)IR * (PE + PO) * Stride<T>::S * sizeof(T) + 127) / 128 * 128;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return plane_bytes<T>() + INPUT_BYTES +
         (sizeof(T) == 2 ? (size_t)K2 * LDB * 2 : 0);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_f(float v, float*) { return v; }
__device__ __forceinline__ bf16 from_f(float v, bf16*) { return __float2bfloat16(v); }

// steps 1-3 for one tile: the input patch and the conv1a planes
template <typename T>
__device__ __forceinline__ void conv1a_tile(const T* __restrict__ img, float* inp, T* E, T* O,
                            const float* wa, const float* wb, float ba,
                            float bb, int b, int oy0, int ox0, int H, int W) {
  constexpr int S = Stride<T>::S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < PR * PC * 3; i += NTHREADS) {
    const int r = i / (PC * 3), rem = i % (PC * 3);
    const int q = rem / 3, c = rem % 3;
    const int iy = 2 * oy0 - 2 + r, ix = 2 * ox0 - 2 + q;
    inp[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? to_f(img[(((size_t)b * H + iy) * W + ix) * 3 + c])
                 : 0.f;
  }
  __syncthreads();
  for (int p = warp; p < IR * IQ; p += NWARP) {
    const int r = p / IQ, q = p % IQ;
    const int y = 2 * oy0 - 1 + r, x = 2 * ox0 - 1 + q;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = inp[((r + dy) * PC + q + dx) * 3 + c];
          const int t = (dy * 3 + dx) * 3 + c;
          acc0 = fmaf(v, wa[t], acc0);
          acc1 = fmaf(v, wb[t], acc1);
        }
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    T* dst = (q & 1) ? O + (r * PO + q / 2) * S : E + (r * PE + q / 2) * S;
    dst[lane] = from_f(in ? fmaxf(acc0 + ba, 0.f) : 0.f, dst);
    dst[lane + 32] = from_f(in ? fmaxf(acc1 + bb, 0.f) : 0.f, dst);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
stem_kernel_bf16(const bf16* __restrict__ img, const float* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int B,
                 int H, int W) {
  constexpr int S = Stride<bf16>::S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* E = reinterpret_cast<bf16*>(smem);
  bf16* O = E + IR * PE * S;
  float* stage = reinterpret_cast<float*>(smem);  // aliases the planes
  float* inp = reinterpret_cast<float*>(smem + plane_bytes<bf16>());
  bf16* w2s = reinterpret_cast<bf16*>(smem + plane_bytes<bf16>() + INPUT_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float wa[27], wb[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    wa[t] = w1[t * C + lane];
    wb[t] = w1[t * C + lane + 32];
  }
  const float ba = b1[lane], bb = b1[lane + 32];
  const float c0b = b2[2 * lane], c1b = b2[2 * lane + 1];
  for (int i = tid; i < K2 * (C / 8); i += NTHREADS) {
    const int k = i / (C / 8), n = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(w2s + k * LDB + n) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)k * C + n);
  }

  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int ty_n = (Ho + TH - 1) / TH, tx_n = (Wo + TW - 1) / TW;
  const int tiles = B * ty_n * tx_n;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (ty_n * tx_n), rem = tile % (ty_n * tx_n);
    const int oy0 = (rem / tx_n) * TH, ox0 = (rem % tx_n) * TW;
    conv1a_tile<bf16>(img, inp, E, O, wa, wb, ba, bb, b, oy0, ox0, H, W);

    // conv1b: warp = output row; A rows are the row's 16 pixels
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int r = 2 * warp + dy;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // column 2 px + dx of the patch: even plane px (dx 0), px + 1 (dx 2),
        // odd plane px (dx 1)
        const bf16* arow = dx == 1 ? O + r * PO * S : E + (r * PE + dx / 2) * S;
        const bf16* wrow = w2s + (dy * 3 + dx) * C * LDB;
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 16) {
          wmma::load_matrix_sync(a, arow + c0, S);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::load_matrix_sync(bw, wrow + c0 * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], a, bw, acc[j]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the planes the staging reuses
    float* st = stage + warp * 16 * LDS;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(st + j * 16, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    const int oy = oy0 + warp;
    if (oy < Ho) {
      for (int px = 0; px < TW; ++px) {
        const int ox = ox0 + px;
        if (ox >= Wo) break;
        const float v0 = fmaxf(st[px * LDS + 2 * lane] + c0b, 0.f);
        const float v1 = fmaxf(st[px * LDS + 2 * lane + 1] + c1b, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * Ho + oy) * Wo + ox) * C + 2 * lane) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();  // the staging is read before the next tile's planes
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
stem_kernel_f32(const float* __restrict__ img, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int B,
                int H, int W) {
  constexpr int S = Stride<float>::S;
  constexpr int NPIX = TH * TW / 4;  // output pixels of a thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* E = reinterpret_cast<float*>(smem);
  float* O = E + IR * PE * S;
  float* inp = reinterpret_cast<float*>(smem + plane_bytes<float>());

  const int tid = threadIdx.x, lane = tid % 32;
  float wa[27], wb[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    wa[t] = w1[t * C + lane];
    wb[t] = w1[t * C + lane + 32];
  }
  const float ba = b1[lane], bb = b1[lane + 32];
  const int f = tid % C, g = tid / C;  // a channel, a quarter of the pixels
  const float bias2 = b2[f];

  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int ty_n = (Ho + TH - 1) / TH, tx_n = (Wo + TW - 1) / TW;
  const int tiles = B * ty_n * tx_n;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (ty_n * tx_n), rem = tile % (ty_n * tx_n);
    const int oy0 = (rem / tx_n) * TH, ox0 = (rem % tx_n) * TW;
    conv1a_tile<float>(img, inp, E, O, wa, wb, ba, bb, b, oy0, ox0, H, W);

    float acc[NPIX];
#pragma unroll
    for (int i = 0; i < NPIX; ++i) acc[i] = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        for (int c = 0; c < C; ++c) {
          const float w = __ldg(w2 + ((dy * 3 + dx) * C + c) * C + f);
#pragma unroll
          for (int i = 0; i < NPIX; ++i) {
            const int p = g + 4 * i, py = p / TW, px = p % TW;
            const int r = 2 * py + dy;
            const float* src = dx == 1 ? O + (r * PO + px) * S
                                       : E + (r * PE + px + dx / 2) * S;
            acc[i] = fmaf(src[c], w, acc[i]);
          }
        }
#pragma unroll
    for (int i = 0; i < NPIX; ++i) {
      const int p = g + 4 * i, oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy < Ho && ox < Wo)
        out[(((size_t)b * Ho + oy) * Wo + ox) * C + f] = fmaxf(acc[i] + bias2, 0.f);
    }
    __syncthreads();  // the planes are read before the next tile writes them
  }
}

}  // namespace

extern "C" int pram_stem(const void* img, const float* w1, const float* b1,
                         const void* w2, const float* b2, void* out, int B,
                         int H, int W, int is_bf16, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = is_bf16 ? smem_bytes<bf16>() : smem_bytes<float>();
  cudaError_t err = is_bf16
      ? cudaFuncSetAttribute(stem_kernel_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
      : cudaFuncSetAttribute(stem_kernel_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long tiles = (long)B * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (is_bf16)
    stem_kernel_bf16<<<grid, NTHREADS, smem, s>>>(
        static_cast<const bf16*>(img), w1, b1, static_cast<const bf16*>(w2), b2,
        static_cast<bf16*>(out), B, H, W);
  else
    stem_kernel_f32<<<grid, NTHREADS, smem, s>>>(
        static_cast<const float*>(img), w1, b1, static_cast<const float*>(w2),
        b2, static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}
