// Sinkhorn optimal transport with a dustbin row and column, for Hopper (f32).
//
// Replaces pram_tpu/ops/sinkhorn_pallas.py:sinkhorn_matching_pallas
// (_sinkhorn_kernel). For each problem: the similarity [n, m] is augmented
// with the learned dustbin score as row n and column m, softmaxed along
// rows into P [n+1, m+1], then num_iters Sinkhorn updates
//     u = r / (P v + 1e-8),   v = c / (P^T u + 1e-8)
// run from u = v = 1, and the plan is P * u * v (rows, then columns). r and
// c are the masked marginals: 1 for a valid row or column, 0 for a padded
// one, and count_valid + 1 for the dustbin entry, so padded rows and
// columns end with zero mass.
//
// What bounds it: the TPU kernel keeps the [513, 1025] f32 plan (2.1 MB) in
// VMEM for all iterations, reading the similarity once and writing the plan
// once (134 MB for 32 problems, 0.040 ms at 3.35 TB/s). On Hopper the plan
// fits neither a block's 227 KB of shared memory nor, for 32 problems
// (67 MB), the 50 MB L2. This first version gives each problem one block of
// 16 warps and keeps the softmaxed plan in the output tensor: the softmax
// pass writes it, each iteration reads it once, and the last pass rewrites
// it as the plan. One read per iteration suffices because the row and
// column updates are fused: a warp loads a row into registers, takes its
// dot product with v to get u_i, and adds P_ij u_i into its own column
// accumulators in shared memory; after all rows a block-wide sum of the 16
// warps' accumulators gives P^T u, hence v. So a problem reads its plan
// num_iters + 1 times from L2 or device memory, and only 32 of the 132 SMs
// work. A later version holds the plan in the distributed shared memory of
// a 16-block cluster.
//
// Numerics: the update order and the 1e-8 are ops/sinkhorn.py's; sums run
// in another order than XLA's, which the dustbin entries amplify (see
// pram_tpu/ops/sinkhorn_pallas.py).
//
// Layouts: sim [B, n, m] f32; r [B, n+1] f32; c [B, m+1] f32; bin [1] f32
// (on the device); out [B, n+1, m+1] f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int CPL = 48;  // columns held per lane: m + 1 <= 32 * CPL
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One row pass: u_i = r_i / (P_i . v + eps) for this warp's rows, and
// acc[warp][j] += P_ij u_i. With `softmax` the row is first built from sim
// and the dustbin score, softmaxed and stored to P.
template <bool SOFTMAX>
__device__ __forceinline__ void row_pass(const float* S, float* P,
                                         const float* rb, float bin,
                                         const float* vs, float* us,
                                         float* acc, int n, int m,
                                         bool iterate) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m1 = m + 1;
  float* accw = acc + (size_t)warp * m1;
  for (int i = warp; i <= n; i += WARPS) {
    float pr[CPL];
    if (SOFTMAX) {
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        float x = -INFINITY;
        if (j < m1) x = (i < n && j < m) ? S[(size_t)i * m + j] : bin;
        pr[k] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        pr[k] = j < m1 ? expf(pr[k] - mx) : 0.f;
        sum += pr[k];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        if (j < m1) {
          pr[k] = pr[k] / sum;
          P[(size_t)i * m1 + j] = pr[k];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        pr[k] = j < m1 ? P[(size_t)i * m1 + j] : 0.f;
      }
    }
    if (!iterate) continue;
    float pv = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < m1) pv += pr[k] * vs[j];
    }
    pv = warp_sum(pv);
    const float u = rb[i] / (pv + EPS);
    if (lane == 0) us[i] = u;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < m1) accw[j] += pr[k] * u;
    }
  }
}

// v_j = c_j / (sum over warps of acc[w][j] + eps); clears acc
__device__ __forceinline__ void column_pass(const float* cb, float* vs,
                                            float* acc, int m1) {
  for (int j = threadIdx.x; j < m1; j += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      s += acc[(size_t)w * m1 + j];
      acc[(size_t)w * m1 + j] = 0.f;
    }
    vs[j] = cb[j] / (s + EPS);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
sinkhorn_kernel(const float* __restrict__ sim, const float* __restrict__ r,
                const float* __restrict__ c, const float* __restrict__ bin_ptr,
                float* out, int n, int m, int iters) {
  extern __shared__ __align__(16) float sm[];
  const int n1 = n + 1, m1 = m + 1;
  float* vs = sm;             // [m1]
  float* us = vs + m1;        // [n1]
  float* acc = us + n1;       // [WARPS, m1]
  const int b = blockIdx.x;
  const float* S = sim + (size_t)b * n * m;
  float* P = out + (size_t)b * n1 * m1;
  const float* rb = r + (size_t)b * n1;
  const float* cb = c + (size_t)b * m1;
  const float bin = *bin_ptr;

  for (int j = threadIdx.x; j < m1; j += THREADS) vs[j] = 1.f;
  for (int i = threadIdx.x; i < n1; i += THREADS) us[i] = 1.f;
  for (int j = threadIdx.x; j < WARPS * m1; j += THREADS) acc[j] = 0.f;
  __syncthreads();

  // softmax, fused with the first iteration's row pass (v = 1)
  row_pass<true>(S, P, rb, bin, vs, us, acc, n, m, iters > 0);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      row_pass<false>(S, P, rb, bin, vs, us, acc, n, m, true);
      __syncthreads();
    }
    column_pass(cb, vs, acc, m1);
    __syncthreads();
  }

  // plan = P * u * v, in place
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n1; i += WARPS) {
    const float u = us[i];
    for (int j = lane; j < m1; j += 32) {
      float* p = P + (size_t)i * m1 + j;
      *p = (*p * u) * vs[j];
    }
  }
}

}  // namespace

extern "C" int pram_sinkhorn(const void* sim, const void* r, const void* c,
                             const void* bin, void* out, int B, int n, int m,
                             int iters, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || m + 1 > 32 * CPL || iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(WARPS + 1) * (m + 1) + (n + 1)) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)sim, (const float*)r, (const float*)c, (const float*)bin,
      (float*)out, n, m, iters);
  return (int)cudaGetLastError();
}
