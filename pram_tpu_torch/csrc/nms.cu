// Score-map non-maximum suppression, for Hopper (f32 or bf16 maps).
//
// Replaces pram_tpu/ops/nms_pallas.py:simple_nms_pallas (_nms_kernel): the
// whole simple_nms chain of pram_tpu/ops/nms.py in one pass over the map,
//     max_mask = s == maxpool(s)
//     repeat num_iters times:
//         supp     = maxpool(max_mask) > 0
//         supp_s   = where(supp, 0, s)
//         max_mask |= (supp_s == maxpool(supp_s)) & ~supp
//     out = where(max_mask, s, 0)
// with maxpool a (2R+1) x (2R+1) window, stride 1, and positions outside the
// image counting as -inf (the plain max_pool_2d's padding; the TPU kernel pads
// with zeros, which is the same only for non-negative maps).
//
// What bounds it: at 32 x 480 x 640 the map is read once and written once
// (39 MB in bf16), 0.012 ms at 3.35 TB/s; the 1 + 2 * num_iters pools are a
// few hundred comparisons a pixel on data in shared memory. As in the TPU
// kernel, no intermediate reaches device memory. A block owns one (image,
// TH x TW output tile) and loads it with a halo of (1 + 2 * num_iters) * R
// pixels on all four sides: each pool leaves R more pixels of the border
// of the loaded region wrong, so after the chain exactly the tile is right.
// (The TPU kernel tiles rows only, since a whole 640-wide row fits in VMEM.)
// Each pool is separable: a column pass in which a thread keeps a window of
// CH + 2R values in registers and emits CH maxima, then a row pass the same
// way, which also applies the chain's next elementwise step (the equality
// tests and masks) as it emits each maximum; the row stride of the shared
// buffers is odd, so neither pass has bank conflicts. Values are held as f32,
// which holds bf16 exactly: maxima and equalities are exact, and the result
// agrees with the plain version bit for bit.
//
// Layouts: scores [B, H, W] and out [B, H, W], f32 or bf16, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;       // output rows of a block
constexpr int TW = 128;      // output columns of a block
constexpr int CH = 8;        // outputs a thread emits per window pass
constexpr int NTHREADS = 512;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) { *p = __float2bfloat16(v); }

// A = epi(maxpool(A)) over the whole region [LH, LW] (row stride LD);
// positions beyond the region count as -inf. Tm holds the column pass; the
// row pass hands each pooled value m at region position (y, x) to
// epi(y, x, m), which writes A there (and may read and write any other
// per-position state at (y, x): only one thread owns it).
template <int R, typename Epi>
__device__ __forceinline__ void pool(float* A, float* Tm, int LH, int LW, int LD,
                                     Epi epi) {
  constexpr int NW = CH + 2 * R;
  const int nyc = (LH + CH - 1) / CH;
  // column pass: consecutive threads take consecutive columns
  for (int it = threadIdx.x; it < nyc * LW; it += blockDim.x) {
    const int x = it % LW, y0 = (it / LW) * CH;
    float v[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int y = y0 - R + i;
      v[i] = (y >= 0 && y < LH) ? A[y * LD + x] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float m = v[j];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) m = fmaxf(m, v[j + k]);
      if (y0 + j < LH) Tm[(y0 + j) * LD + x] = m;
    }
  }
  __syncthreads();
  // row pass: consecutive threads take consecutive rows (LD is odd)
  const int nxc = (LW + CH - 1) / CH;
  for (int it = threadIdx.x; it < nxc * LH; it += blockDim.x) {
    const int y = it % LH, x0 = (it / LH) * CH;
    float v[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int x = x0 - R + i;
      v[i] = (x >= 0 && x < LW) ? Tm[y * LD + x] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float m = v[j];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) m = fmaxf(m, v[j + k]);
      if (x0 + j < LW) epi(y, x0 + j, m);
    }
  }
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(NTHREADS)
nms_kernel(const T* __restrict__ scores, T* __restrict__ out, int H, int W,
           int num_iters, int halo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LH = TH + 2 * halo, LW = TW + 2 * halo, LD = LW | 1;
  const int n = LH * LD;
  float* S = reinterpret_cast<float*>(smem);  // the scores, -inf outside
  float* A = S + n;                           // the pool's operand
  float* Tm = A + n;                          // the column pass
  uint8_t* M = reinterpret_cast<uint8_t*>(Tm + n);  // bit 0 max_mask, bit 1 supp

  const int b = blockIdx.z;
  const int gy0 = blockIdx.y * TH - halo, gx0 = blockIdx.x * TW - halo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto inside = [&](int ly, int lx) {
    const int gy = gy0 + ly, gx = gx0 + lx;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  const T* src = scores + (size_t)b * H * W;
  for (int ly = warp; ly < LH; ly += NTHREADS / 32) {
    for (int lx = lane; lx < LW; lx += 32) {
      const float s = inside(ly, lx)
          ? to_f(src[(size_t)(gy0 + ly) * W + gx0 + lx]) : -INFINITY;
      S[ly * LD + lx] = s;
      A[ly * LD + lx] = s;
    }
  }
  __syncthreads();

  // detection: max_mask = s == maxpool(s); the next operand is max_mask
  pool<R>(A, Tm, LH, LW, LD, [&](int y, int x, float m) {
    const int k = y * LD + x;
    const bool mm = inside(y, x) && S[k] == m;
    M[k] = mm;
    A[k] = mm ? 1.f : 0.f;  // off the image: 0, as -inf for a test of > 0
  });
  for (int iter = 0; iter < num_iters; ++iter) {
    // suppression: supp = maxpool(max_mask) > 0; next operand supp_s
    pool<R>(A, Tm, LH, LW, LD, [&](int y, int x, float m) {
      const int k = y * LD + x;
      const bool in = inside(y, x);
      const bool supp = in && m > 0.f;
      M[k] = (M[k] & 1) | (supp ? 2 : 0);
      A[k] = in ? (supp ? 0.f : S[k]) : -INFINITY;
    });
    // re-detection: max_mask |= (supp_s == maxpool(supp_s)) & ~supp
    pool<R>(A, Tm, LH, LW, LD, [&](int y, int x, float m) {
      const int k = y * LD + x;
      const bool supp = M[k] & 2;
      const float supp_s = supp ? 0.f : S[k];
      const bool mm = (M[k] & 1) || (inside(y, x) && !supp && supp_s == m);
      M[k] = mm;
      A[k] = mm ? 1.f : 0.f;
    });
  }

  T* dst = out + (size_t)b * H * W;
  for (int ty = warp; ty < TH; ty += NTHREADS / 32) {
    const int gy = blockIdx.y * TH + ty;
    if (gy >= H) break;
    for (int tx = lane; tx < TW; tx += 32) {
      const int gx = blockIdx.x * TW + tx;
      if (gx >= W) break;
      const int k = (ty + halo) * LD + tx + halo;
      from_f(dst + (size_t)gy * W + gx, (M[k] & 1) ? S[k] : 0.f);
    }
  }
}

template <typename T, int R>
int launch(const void* scores, void* out, int B, int H, int W, int num_iters,
           cudaStream_t stream) {
  const int halo = (1 + 2 * num_iters) * R;
  const int LH = TH + 2 * halo, LD = (TW + 2 * halo) | 1;
  const size_t smem = (size_t)LH * LD * (3 * sizeof(float) + 1);
  auto kern = nms_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(scores),
                                         static_cast<T*>(out), H, W,
                                         num_iters, halo);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* scores, void* out, int B, int H, int W, int radius,
             int num_iters, cudaStream_t s) {
  switch (radius) {
    // SFD2's radius 4, and 2 for the tests' smaller maps
    case 2: return launch<T, 2>(scores, out, B, H, W, num_iters, s);
    case 4: return launch<T, 4>(scores, out, B, H, W, num_iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pram_nms(const void* scores, void* out, int B, int H, int W,
                        int radius, int num_iters, int is_bf16, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(scores, out, B, H, W, radius, num_iters, s)
                 : dispatch<float>(scores, out, B, H, W, radius, num_iters, s);
}
