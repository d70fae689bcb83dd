// Sinkhorn optimal transport with a dustbin row and column, for Hopper (f32).
//
// Replaces pram_tpu/ops/sinkhorn_pallas.py:70 sinkhorn_matching_pallas
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
// once (134 MB for 32 problems, 0.040 ms at 3.35 TB/s). One SM's 227 KB
// cannot hold a plan, and 32 plans (67 MB) do not fit the 50 MB L2, so a
// design that streams the plan through device memory on every iteration
// moves 21 plans a problem.
//
// Two instances behind one entry, chosen by the caller by shape before the
// launch (pram_sinkhorn_plan says which; nothing falls back after a
// failure):
//
// The cluster instance: every shape whose rows fit a cluster, i.e. m + 1
// <= 1152 and ceil((n + 1) / 16) rows of m + 1 floats (rounded up to 4),
// with v and the exchange's scratch, within a block's 227 KB (n <= 863 at
// m = 1024, n <= 767 at m = 1151); GML's 512 x 1024 and the tests' 100 x 200 and 512 x 1024.
// One cluster of CS = 16 blocks (a non-portable size) per problem keeps
// the softmaxed plan in the cluster's shared memory for all iterations:
// block k owns rows [k rb, (k + 1) rb), rb = ceil((n + 1) / 16), at GML's
// shape 33 rows x 1028 floats = 135 KB of 141 KB, so one block an SM, 544
// threads (a thread a column pair). The similarity is read once (16-byte
// cp.async where m % 4 == 0), softmaxed a warp a row; the plan is written
// once, P * u * v. An iteration runs on shared memory, with no atomics and
// every sum in a fixed order (two launches give the same bits):
//   - row pass: a warp a row, two rows at once, a lane's float4 columns
//     against v in registers (four partial sums, then the warp's
//     shuffles); lane 0 writes u_i = r_i / (P_i . v + eps);
//   - column pass: a thread a column pair sums P_ij u_i over the block's
//     rows in order, and pushes the pair into the shared memory of the
//     block that owns its column slice (slice k, even-sized, to block k);
//   - block k sums the 16 partials of its slice in rank order, computes
//     that slice of v and pushes it into every block's v.
// The pushes are st.async stores into the other block's shared memory,
// each counted in bytes on that block's mbarrier (one for its slice of the
// partials, one for v, a phase an iteration), so no cluster-wide barrier
// runs inside the loop: a block waits for its v, then later for its
// slice. Neither buffer is overwritten early: a block pushes the next
// partials only once it has all of v, hence once every owner has read its
// slice, and an owner pushes the next v only once every block's next
// partial has arrived. The card places 7 clusters of 16 at once (its
// cudaOccupancyMaxActiveClusters), so 32 problems run in 5 waves. Before
// its first launch the caller asks that count (pram_sinkhorn_plan); where
// no cluster of 16 can be placed it takes the smallest size whose rows fit
// (the cluster_kernel<0> instance, any size), else the wide one.
//
// The wide instance (every other shape: GML at the Aachen operating point,
// 4096 query x 2048 frame tokens, a plan of 4097 x 2049 floats = 33.6 MB a
// problem): no block holds a row's columns or a problem's rows, so the
// softmaxed plan stays in the output tensor in device memory, written once
// by the softmax pass, and only the two scaling vectors iterate, in a
// scratch of B (n + m + 2) floats. A launch a pass, on the caller's stream:
//   - softmax: a warp a row builds the augmented row, softmaxes it into P
//     and, fused, takes the first row pass (v = 1);
//   - column pass: a block of 16 warps takes 32 columns of a problem, lane
//     l column 32 x + l; warp w sums P_ij u_i over the rows w, w + 16, ...
//     in order (four rows' loads in flight), and warp 0 sums the 16
//     partials in warp order: v_j = c_j / (sum + 1e-8);
//   - row pass: a warp a row, four lane-strided partial sums of P_ij v_j,
//     then the warp's shuffles: u_i = r_i / (sum + 1e-8);
//   - the plan P * u * v, in place.
// 2 num_iters + 1 launches; no atomics, every sum in a fixed order, so two
// calls give the same bits. Each pass reads the plan once: at 8 Aachen
// problems 269 MB, ~0.08 ms at 3.35 TB/s, ~41 passes a call.
//
// Numerics: the update order and the 1e-8 are ops/sinkhorn.py's; sums run
// in another order than XLA's, which the dustbin entries amplify (see
// pram_tpu/ops/sinkhorn_pallas.py).
//
// Layouts: sim [B, n, m] f32; r [B, n+1] f32; c [B, m+1] f32; bin [1] f32
// (on the device); out [B, n+1, m+1] f32; the wide instance's scratch
// [B (n+1)] u then [B (m+1)] v, f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr float EPS = 1e-8f;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on Hopper
constexpr int MAX_CLUSTER = 16;      // the largest (non-portable) cluster

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

// ---- the cluster instance

constexpr int CMAX_THREADS = 576;  // a cluster block: a thread a column pair
constexpr int CMAX_LD = 2 * CMAX_THREADS;  // m + 1 <= 1152
constexpr int JMAX = CMAX_LD / 128;        // float4 of v a lane holds in the row pass

// A cluster block's shared memory, in floats: two mbarriers (4 floats), P
// [rb, ld], v [ld], gath [cs, slice] (column slice `rank` of every block's
// partial), us [rb], rs [rb], each rounded up to 4 floats; slice is even, so
// that a column pair has one owner.
struct Layout {
  int rb, ld, slice;
  int v, gath, us, rs, floats;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout cluster_layout(int n, int m, int cs) {
  Layout L;
  L.rb = (n + 1 + cs - 1) / cs;
  L.ld = up4(m + 1);
  L.slice = ((m + 1 + cs - 1) / cs + 1) & ~1;
  L.v = 4 + L.rb * L.ld;
  L.gath = L.v + L.ld;
  L.us = L.gath + up4(cs * L.slice);
  L.rs = L.us + up4(L.rb);
  L.floats = L.rs + up4(L.rb);
  return L;
}

// threads of a cluster block: a warp per 64 columns
__host__ __device__ inline int cluster_threads(int m) { return 32 * ((up4(m + 1) / 2 + 31) / 32); }

inline bool cluster_fits(int n, int m, int cs) {
  return up4(m + 1) <= CMAX_LD &&
         (size_t)cluster_layout(n, m, cs).floats * sizeof(float) <= MAX_SMEM;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(smem)), "l"(gmem));
}

// the address of shared-memory address a in cluster block `rank`
__device__ __forceinline__ uint32_t remote(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

// x into another block's shared memory (cluster address dst), counted in
// bytes on that block's mbarrier (cluster address bar)
__device__ __forceinline__ void push(uint32_t dst, float x, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(dst), "f"(x), "r"(bar) : "memory");
}

__device__ __forceinline__ void push2(uint32_t dst, float x, float y, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               ::"r"(dst), "f"(x), "f"(y), "r"(bar) : "memory");
}

// one arrival on a local mbarrier that announces `bytes` to come
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(saddr(bar)), "r"(bytes) : "memory");
}

// waits for the phase of this parity, the pushes of other blocks visible
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One problem per cluster of `cs` blocks (see the header): CS = 16, or 0
// for any other size (the cluster's own). vec: the rows of sim can be
// copied in 16-byte pieces (m % 4 == 0, sim 16-byte aligned).
template <int CS>
__global__ void __launch_bounds__(CMAX_THREADS, 1)
cluster_kernel(const float* __restrict__ sim, const float* __restrict__ r,
               const float* __restrict__ c, const float* __restrict__ bin_ptr,
               float* __restrict__ out, int n, int m, int iters, int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = CS > 0 ? CS : (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int n1 = n + 1, m1 = m + 1;
  const Layout L = cluster_layout(n, m, cs);
  const int ld = L.ld, ld2 = ld >> 1, ld4 = ld >> 2;
  extern __shared__ __align__(16) float sm[];
  uint64_t* gbar = reinterpret_cast<uint64_t*>(sm);  // this block's slice of the partials
  uint64_t* vbar = gbar + 1;                         // v, from every slice's owner
  float* P = sm + 4;
  float* v = sm + L.v;
  float* gath = sm + L.gath;
  float* us = sm + L.us;
  float* rs = sm + L.rs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = blockDim.x, nw = nt >> 5;
  const int row0 = rank * L.rb;
  const int R = max(0, min(L.rb, n1 - row0));          // this block's rows
  const int col0 = rank * L.slice;
  const int sw = max(0, min(L.slice, m1 - col0));      // its column slice
  const float bin = *bin_ptr;

  // this block's rows of the similarity, read once; the dustbin entries
  const int nr = max(0, min(R, n - row0));  // rows of sim (the rest: the dustbin row)
  if (vec) {
    const int q4 = m >> 2;
    const float* src = sim + ((size_t)b * n + row0) * m;
    for (int idx = tid; idx < nr * q4; idx += nt) {
      const int i = idx / q4, q = idx - i * q4;
      cp_async16(P + (size_t)i * ld + 4 * q, src + (size_t)i * m + 4 * q);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int idx = tid; idx < nr * m; idx += nt) {
      const int i = idx / m, j = idx - i * m;
      P[(size_t)i * ld + j] = __ldg(sim + ((size_t)b * n + row0 + i) * m + j);
    }
  }
  for (int idx = tid; idx < R * (ld - m); idx += nt) {
    const int i = idx / (ld - m), j = m + idx - i * (ld - m);
    P[(size_t)i * ld + j] = j == m ? bin : 0.f;
  }
  for (int i = nr; i < R; ++i)
    for (int j = tid; j < m; j += nt) P[(size_t)i * ld + j] = bin;
  for (int j = tid; j < ld; j += nt) v[j] = j < m1 ? 1.f : 0.f;
  for (int i = tid; i < L.rb; i += nt) {
    us[i] = 1.f;
    rs[i] = i < R ? r[(size_t)b * n1 + row0 + i] : 0.f;
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(gbar)), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(vbar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // row softmax, a warp a row
  for (int i = warp; i < R; i += nw) {
    float* pr = P + (size_t)i * ld;
    float mx = -INFINITY;
    for (int j = lane; j < m1; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m1; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < m1; j += 32) pr[j] *= inv;
  }
  // where this thread's column pair's partials go: slice q = 2 tid / slice
  // of block q's gath, at this block's rank, counted on its gbar
  const int own = min(2 * tid, m1 - 1) / L.slice;
  const uint32_t pdst = remote(saddr(gath + rank * L.slice + min(2 * tid, m1 - 1) - own * L.slice), own);
  const uint32_t pbar = remote(saddr(gbar), own);
  cluster.sync();  // the barriers initialised, every block running, before any push

  const float4* P4 = reinterpret_cast<const float4*>(P);
  const float2* P2 = reinterpret_cast<const float2*>(P);
  const float4* us4 = reinterpret_cast<const float4*>(us);
  // No cluster-wide barrier in the loop: a block's partial slices arrive on
  // the owner's gbar, the owners' v slices on every block's vbar (phase it
  // of each). Neither buffer is written again before its reader is done:
  // a block pushes the next partials only after it has all of v, hence
  // after every owner has read its slices, and an owner pushes the next v
  // only after it has every block's next partial.
  for (int it = 0; it < iters; ++it) {
    if (it > 0) bar_wait(vbar, (it - 1) & 1);
    if (tid == 0) {
      bar_expect(gbar, (uint32_t)(cs * sw * sizeof(float)));
      bar_expect(vbar, (uint32_t)(m1 * sizeof(float)));
    }
    // row pass, a warp a row: u_i = r_i / (P_i . v + eps)
    float4 vv[JMAX];
#pragma unroll
    for (int k = 0; k < JMAX; ++k) {
      const int q = lane + 32 * k;
      vv[k] = q < ld4 ? reinterpret_cast<const float4*>(v)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // rows i and i + nw together (at GML's shape every warp has two)
    for (int i = warp; i < R; i += 2 * nw) {
      const int i2 = i + nw < R ? i + nw : i;
      const float4* pa = P4 + (size_t)i * ld4;
      const float4* pb = P4 + (size_t)i2 * ld4;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, bq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < JMAX; ++k) {
        const int q = lane + 32 * k;
        if (q < ld4) {
          const float4 x = pa[q], y = pb[q];
          a[0] = fmaf(x.x, vv[k].x, a[0]);
          a[1] = fmaf(x.y, vv[k].y, a[1]);
          a[2] = fmaf(x.z, vv[k].z, a[2]);
          a[3] = fmaf(x.w, vv[k].w, a[3]);
          bq[0] = fmaf(y.x, vv[k].x, bq[0]);
          bq[1] = fmaf(y.y, vv[k].y, bq[1]);
          bq[2] = fmaf(y.z, vv[k].z, bq[2]);
          bq[3] = fmaf(y.w, vv[k].w, bq[3]);
        }
      }
      float ta = (a[0] + a[1]) + (a[2] + a[3]), tb = (bq[0] + bq[1]) + (bq[2] + bq[3]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ta += __shfl_xor_sync(0xffffffffu, ta, o);
        tb += __shfl_xor_sync(0xffffffffu, tb, o);
      }
      if (lane == 0) {
        us[i] = rs[i] / (ta + EPS);
        if (i2 != i) us[i2] = rs[i2] / (tb + EPS);
      }
    }
    __syncthreads();
    // column pass, a thread a column pair: this block's partial of P^T u,
    // rows in order, pushed to the slices' owners
    if (tid < ld2) {
      float ax = 0.f, ay = 0.f;
      int i = 0;
      for (; i + 8 <= R; i += 8) {
        const float4 u0 = us4[i >> 2], u1 = us4[(i >> 2) + 1];
        const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        float2 x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = P2[(size_t)(i + k) * ld2 + tid];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ax = fmaf(x[k].x, u[k], ax);
          ay = fmaf(x[k].y, u[k], ay);
        }
      }
      for (; i < R; ++i) {
        const float u = us[i];
        const float2 x = P2[(size_t)i * ld2 + tid];
        ax = fmaf(x.x, u, ax);
        ay = fmaf(x.y, u, ay);
      }
      if (2 * tid + 1 < m1)
        push2(pdst, ax, ay, pbar);
      else if (2 * tid < m1)
        push(pdst, ax, pbar);
    }
    // v for column slice `rank`: the partials summed in rank order, pushed
    // into every block's v
    if (tid < sw) bar_wait(gbar, it & 1);
    for (int jj = tid; jj < sw; jj += nt) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < cs; ++q) t += gath[q * L.slice + jj];
      const float vj = __ldg(c + (size_t)b * m1 + col0 + jj) / (t + EPS);
      const uint32_t a = saddr(v + col0 + jj), bv = saddr(vbar);
#pragma unroll
      for (int q = 0; q < cs; ++q) push(remote(a, q), vj, remote(bv, q));
    }
  }
  if (iters > 0) bar_wait(vbar, (iters - 1) & 1);

  // the plan P * u * v, written once
  for (int i = warp; i < R; i += nw) {
    const float u = us[i];
    const float* pr = P + (size_t)i * ld;
    float* orow = out + ((size_t)b * n1 + row0 + i) * m1;
    for (int j = lane; j < m1; j += 32) orow[j] = (pr[j] * u) * v[j];
  }
  cluster.sync();  // no block leaves while its pushes may be in flight
}

typedef void (*ClusterKernel)(const float*, const float*, const float*, const float*, float*,
                              int, int, int, int);

// the instance for clusters of cs blocks
ClusterKernel cluster_instance(int cs) {
  return cs == MAX_CLUSTER ? cluster_kernel<MAX_CLUSTER> : cluster_kernel<0>;
}

cudaError_t cluster_config(int n, int m, int cs, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr) {
  const size_t smem = (size_t)cluster_layout(n, m, cs).floats * sizeof(float);
  const ClusterKernel kernel = cluster_instance(cs);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(cluster_threads(m));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// ---- the wide instance (see the header)

// the augmented row i softmaxed into P, and u_i of the first row pass
// (v = 1), or u_i = 1 without iterations
__global__ void __launch_bounds__(THREADS)
wide_softmax_kernel(const float* __restrict__ sim, const float* __restrict__ r,
                    const float* __restrict__ bin_ptr, float* __restrict__ out,
                    float* __restrict__ u, int n, int m, int iterate) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int n1 = n + 1, m1 = m + 1;
  if (i >= n1) return;
  const float bin = *bin_ptr;
  const bool real = i < n;
  const float* S = sim + ((size_t)b * n + (real ? i : 0)) * m;
  float* P = out + ((size_t)b * n1 + i) * m1;
  float mx = -INFINITY;
  for (int j = lane; j < m1; j += 32) mx = fmaxf(mx, real && j < m ? S[j] : bin);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < m1; j += 32) {
    const float e = expf((real && j < m ? S[j] : bin) - mx);
    P[j] = e;
    sum += e;
  }
  const float inv = 1.f / warp_sum(sum);
  float tot = 0.f;
  for (int j = lane; j < m1; j += 32) {
    const float p = P[j] * inv;
    P[j] = p;
    tot += p;
  }
  tot = warp_sum(tot);
  if (lane == 0) u[(size_t)b * n1 + i] = iterate ? r[(size_t)b * n1 + i] / (tot + EPS) : 1.f;
}

// v_j = c_j / (sum_i P_ij u_i + eps) for 32 columns of one problem
__global__ void __launch_bounds__(THREADS)
wide_column_kernel(const float* __restrict__ out, const float* __restrict__ u,
                   const float* __restrict__ c, float* __restrict__ v, int n, int m) {
  __shared__ float part[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, j = blockIdx.x * 32 + lane;
  const int n1 = n + 1, m1 = m + 1;
  const float* P = out + (size_t)b * n1 * m1 + j;
  const float* ub = u + (size_t)b * n1;
  float acc = 0.f;
  if (j < m1) {
    int i = warp;
    for (; i + 3 * WARPS < n1; i += 4 * WARPS) {
      const float x0 = P[(size_t)i * m1], x1 = P[(size_t)(i + WARPS) * m1];
      const float x2 = P[(size_t)(i + 2 * WARPS) * m1], x3 = P[(size_t)(i + 3 * WARPS) * m1];
      acc = fmaf(x0, ub[i], acc);
      acc = fmaf(x1, ub[i + WARPS], acc);
      acc = fmaf(x2, ub[i + 2 * WARPS], acc);
      acc = fmaf(x3, ub[i + 3 * WARPS], acc);
    }
    for (; i < n1; i += WARPS) acc = fmaf(P[(size_t)i * m1], ub[i], acc);
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j < m1) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][lane];
    v[(size_t)b * m1 + j] = c[(size_t)b * m1 + j] / (s + EPS);
  }
}

// u_i = r_i / (sum_j P_ij v_j + eps), a warp a row
__global__ void __launch_bounds__(THREADS)
wide_row_kernel(const float* __restrict__ out, const float* __restrict__ r,
                const float* __restrict__ v, float* __restrict__ u, int n, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int n1 = n + 1, m1 = m + 1;
  if (i >= n1) return;
  const float* P = out + ((size_t)b * n1 + i) * m1;
  const float* vb = v + (size_t)b * m1;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = lane;
  for (; j + 96 < m1; j += 128) {
    a0 = fmaf(P[j], vb[j], a0);
    a1 = fmaf(P[j + 32], vb[j + 32], a1);
    a2 = fmaf(P[j + 64], vb[j + 64], a2);
    a3 = fmaf(P[j + 96], vb[j + 96], a3);
  }
  for (; j < m1; j += 32) a0 = fmaf(P[j], vb[j], a0);
  const float t = warp_sum((a0 + a1) + (a2 + a3));
  if (lane == 0) u[(size_t)b * n1 + i] = r[(size_t)b * n1 + i] / (t + EPS);
}

// the plan P * u * v in place (v == nullptr: v = 1)
__global__ void __launch_bounds__(THREADS)
wide_plan_kernel(float* __restrict__ out, const float* __restrict__ u,
                 const float* __restrict__ v, int n, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, i = blockIdx.x * WARPS + warp;
  const int n1 = n + 1, m1 = m + 1;
  if (i >= n1) return;
  float* P = out + ((size_t)b * n1 + i) * m1;
  const float ui = u[(size_t)b * n1 + i];
  const float* vb = v ? v + (size_t)b * m1 : nullptr;
  for (int j = lane; j < m1; j += 32) P[j] = (P[j] * ui) * (vb ? vb[j] : 1.f);
}

cudaError_t wide_launch(const float* sim, const float* r, const float* c, const float* bin,
                        float* out, float* work, int B, int n, int m, int iters,
                        cudaStream_t stream) {
  const int n1 = n + 1, m1 = m + 1;
  float* u = work;
  float* v = work + (size_t)B * n1;
  const dim3 rows((n1 + WARPS - 1) / WARPS, B), cols((m1 + 31) / 32, B);
  wide_softmax_kernel<<<rows, THREADS, 0, stream>>>(sim, r, bin, out, u, n, m, iters > 0);
  cudaError_t err = cudaGetLastError();
  for (int it = 0; it < iters && err == cudaSuccess; ++it) {
    if (it > 0) {
      wide_row_kernel<<<rows, THREADS, 0, stream>>>(out, r, v, u, n, m);
      err = cudaGetLastError();
      if (err != cudaSuccess) break;
    }
    wide_column_kernel<<<cols, THREADS, 0, stream>>>(out, u, c, v, n, m);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  wide_plan_kernel<<<rows, THREADS, 0, stream>>>(out, u, iters > 0 ? v : nullptr, n, m);
  return cudaGetLastError();
}

}  // namespace

// The instance that takes [n, m] problems, chosen before the first launch:
// *cluster = 16 if a 16-block cluster holds the rows and the card places
// one (*active: how many at once), else the smallest size whose rows fit
// and that the card places, else -1 (the wide instance, *active = 0).
extern "C" int pram_sinkhorn_plan(int n, int m, int* cluster, int* active) {
  *cluster = 0;
  *active = 0;
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  for (int pass = 0; pass < 2; ++pass) {
    for (int cs = pass == 0 ? MAX_CLUSTER : 1; cs <= MAX_CLUSTER; ++cs) {
      if (!cluster_fits(n, m, cs)) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr[1];
      cudaError_t err = cluster_config(n, m, cs, cfg, attr);
      if (err != cudaSuccess) return (int)err;
      int placed = 0;
      err = cudaOccupancyMaxActiveClusters(&placed, cluster_instance(cs), &cfg);
      if (err != cudaSuccess) return (int)err;
      if (placed > 0) {
        *cluster = cs;
        *active = placed;
        return 0;
      }
      if (pass == 0) break;
    }
  }
  *cluster = -1;
  return 0;
}

// cluster > 0: the cluster instance with clusters of that many blocks;
// -1: the wide instance, on the scratch `work` of B (n + m + 2) floats.
extern "C" int pram_sinkhorn(const void* sim, const void* r, const void* c,
                             const void* bin, void* out, int B, int n, int m,
                             int iters, int cluster, void* work, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (cluster < 0) {
    if (cluster != -1 || work == nullptr || B > 65535) return (int)cudaErrorInvalidValue;
    return (int)wide_launch((const float*)sim, (const float*)r, (const float*)c,
                            (const float*)bin, (float*)out, (float*)work, B, n, m, iters,
                            (cudaStream_t)stream);
  }
  if (cluster > 0) {
    if (cluster > MAX_CLUSTER || !cluster_fits(n, m, cluster)) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = cluster_config(n, m, cluster, cfg, attr);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = dim3(B * cluster);
    cfg.stream = (cudaStream_t)stream;
    const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(sim) % 16 == 0;
    err = cudaLaunchKernelEx(&cfg, cluster_instance(cluster), (const float*)sim, (const float*)r,
                             (const float*)c, (const float*)bin, (float*)out, n, m, iters, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
