// Backward of the symmetric shared-QK cross-attention (kernel 5) for Hopper:
// bf16 in, f32 accumulation.
//
// Replaces pram_tpu/ops/attention_bwd_pallas.py:fused_cross_attention_bwd
// (_cross_bwd_kernel). The tokens are the concatenation of side 0 (n0
// tokens) and side 1; both share qk and v. One similarity
// sim = qk0 qk1^T * scale serves both directions: 0 -> 1 softmaxes its rows
// over side 1 (key bias bias1), 1 -> 0 its columns over side 0 (bias0).
// Given the recomputed qk, v and the messages' cotangent g it returns
//   dsim = a01 (dp01 - t01) + a10 (dp10 - t10),
//   dqk0 = dsim qk1 * scale,  dqk1 = dsim^T qk0 * scale,
//   dv1 = a01^T g0,  dv0 = a10 g1,
//   db0 = sum_h,j a10 (dp10 - t10),  db1 = sum_h,i a01 (dp01 - t01),
// with dp01 = g0 v1^T, dp10 = v0 g1^T and t the softmax-weighted sums of dp.
//
// What bounds it: at GML's shapes (B=32, 512 x 1024 tokens, 4 heads of 64)
// the seven N0 x N1 products take 60.1 GFLOP against ~40 MB of inputs and
// outputs: the tensor cores bound it (0.061 ms). The TPU kernel holds a
// head's [N0, N1] f32 blocks of a frame in VMEM (2 MB each); a Hopper block
// cannot. Every token is a query in one direction and a key in the other,
// so the work is two kernels with no atomics:
//   1. stats_kernel, one block per (frame, head, 64-token tile of either
//      side): the row statistics of the tile's tokens as queries against
//      the other side (max, 1/sum, t), into an f32 scratch [3, B, H, N].
//   2. grad_kernel, one block per (frame, 64-token tile a of either side),
//      looping over the heads and the other side's tiles o: one product for
//      sim[a][o], two for dp in both directions, then dqk_a and dv_a; a's
//      bias gradient sums the direction in which a is the key side.
// Products are bf16 WMMA tiles; wgmma and TMA are later work.
//
// Rounding follows the TPU kernel: sim, the softmax and dsim are f32; the
// two directions' dsim are added in f32 and rounded to bf16 before the
// products with qk; the weights are rounded to bf16 before the products
// with g; dqk, dv are rounded to bf16, db0, db1 are f32.
//
// Layouts: qk, v, g, dqk, dv [B, N, 256] bf16 with N = n0 + n1 and column
// h * 64 + i; bias0, db0 [B, n0] and bias1, db1 [B, n1] f32. n0 and n1 are
// multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"

namespace {

using namespace bwd;

constexpr int D = 256;  // model width: 4 heads of 64

// the other side of tile a0: tokens [olo, ohi) and their key biases
struct Other {
  int olo, ohi;
  const float* bias;      // key biases of [olo, ohi)
  const float* own_bias;  // key biases of a's side, from its first token
  int own_lo;
};

__device__ __forceinline__ Other other_side(int a0, int b, int N, int n0,
                                            const float* bias0,
                                            const float* bias1) {
  const int n1 = N - n0;
  Other o;
  if (a0 < n0) {
    o.olo = n0;
    o.ohi = N;
    o.bias = bias1 + (size_t)b * n1;
    o.own_bias = bias0 + (size_t)b * n0;
    o.own_lo = 0;
  } else {
    o.olo = 0;
    o.ohi = n0;
    o.bias = bias0 + (size_t)b * n0;
    o.own_bias = bias1 + (size_t)b * n1;
    o.own_lo = n0;
  }
  return o;
}

__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if (threadIdx.x < T) dst[threadIdx.x] = src[threadIdx.x];
}

constexpr size_t STATS_SMEM = 4 * TILE_H + 2 * TILE_F + VEC_F;

__global__ void __launch_bounds__(NTHREADS, 1)
stats_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
             const float* __restrict__ bias0, const float* __restrict__ bias1,
             const bf16* __restrict__ g, float* __restrict__ stats, int B,
             int N, int n0, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + T * LDH;
  bf16* Ks = Gs + T * LDH;
  bf16* Vs = Ks + T * LDH;
  float* Sf = reinterpret_cast<float*>(smem + 4 * TILE_H);
  float* Df = Sf + T * LDF;
  float* kb = Df + T * LDF;

  const int a0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const Other os = other_side(a0, b, N, n0, bias0, bias1);
  const size_t frame = (size_t)b * N;
  load_tile(Qs, qk + (frame + a0) * D + h * HD, D);
  load_tile(Gs, g + (frame + a0) * D + h * HD, D);

  float m = -INFINITY, l = 0.f, u = 0.f;
  for (int o0 = os.olo; o0 < os.ohi; o0 += T) {
    load_tile(Ks, qk + (frame + o0) * D + h * HD, D);
    load_tile(Vs, v + (frame + o0) * D + h * HD, D);
    load_vec(kb, os.bias + (o0 - os.olo));
    __syncthreads();
    stats_step(Qs, Gs, Ks, Vs, kb, scale, Sf, Df, m, l, u);
  }
  if ((threadIdx.x & 3) == 0) {
    const size_t i = ((size_t)b * heads + h) * N + a0 + elt_row();
    const size_t plane = (size_t)B * heads * N;
    stats[i] = m;
    stats[plane + i] = 1.f / l;
    stats[2 * plane + i] = u / l;
  }
}

constexpr size_t GRAD_SMEM = 8 * TILE_H + 3 * TILE_F + 7 * VEC_F;

__global__ void __launch_bounds__(NTHREADS, 1)
grad_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
            const float* __restrict__ bias0, const float* __restrict__ bias1,
            const bf16* __restrict__ g, const float* __restrict__ stats,
            bf16* __restrict__ dqk, bf16* __restrict__ dv,
            float* __restrict__ db0, float* __restrict__ db1, int B, int N,
            int n0, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qa = reinterpret_cast<bf16*>(smem);
  bf16* Va = Qa + T * LDH;
  bf16* Ga = Va + T * LDH;
  bf16* Qo = Ga + T * LDH;
  bf16* Vo = Qo + T * LDH;
  bf16* Go = Vo + T * LDH;
  bf16* Ds = Go + T * LDH;  // dsim of both directions, [a][o] (bf16)
  bf16* Pb = Ds + T * LDH;  // weights of o -> a, [a][o] (bf16)
  float* S = reinterpret_cast<float*>(smem + 8 * TILE_H);
  float* D1 = S + T * LDF;  // dp with a as queries: g_a . v_o
  float* D2 = D1 + T * LDF;  // dp with a as keys: v_a . g_o
  float* ma = D2 + T * LDF;
  float* ra = ma + T;
  float* ta = ra + T;
  float* mo = ta + T;
  float* ro = mo + T;
  float* to = ro + T;
  float* bo = to + T;

  const int a0 = blockIdx.x * T, b = blockIdx.y;
  const Other os = other_side(a0, b, N, n0, bias0, bias1);
  const size_t frame = (size_t)b * N;
  const size_t plane = (size_t)B * heads * N;
  const int r = elt_row(), c0 = elt_col();
  const float b_own = os.own_bias[a0 - os.own_lo + r];
  float db_r = 0.f;

  for (int h = 0; h < heads; ++h) {
    const float* st = stats + ((size_t)b * heads + h) * N;
    __syncthreads();  // the previous head's tiles are no longer read
    load_tile(Qa, qk + (frame + a0) * D + h * HD, D);
    load_tile(Va, v + (frame + a0) * D + h * HD, D);
    load_tile(Ga, g + (frame + a0) * D + h * HD, D);
    load_vec(ma, st + a0);
    load_vec(ra, st + plane + a0);
    load_vec(ta, st + 2 * plane + a0);
    Acc dq[2], dvv[2];
    zero_acc(dq);
    zero_acc(dvv);

    for (int o0 = os.olo; o0 < os.ohi; o0 += T) {
      load_tile(Qo, qk + (frame + o0) * D + h * HD, D);
      load_tile(Vo, v + (frame + o0) * D + h * HD, D);
      load_tile(Go, g + (frame + o0) * D + h * HD, D);
      load_vec(mo, st + o0);
      load_vec(ro, st + plane + o0);
      load_vec(to, st + 2 * plane + o0);
      load_vec(bo, os.bias + (o0 - os.olo));
      __syncthreads();

      mm_abt(Qa, Qo, S);
      mm_abt(Ga, Vo, D1);
      mm_abt(Va, Go, D2);
      __syncthreads();
      {
        const float m_ = ma[r], r_ = ra[r], t_ = ta[r];
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int j = c0 + c;
          const float s = S[r * LDF + j] * scale;
          const float p1 = expf(s + bo[j] - m_) * r_;  // a queries o
          const float p2 = expf(s + b_own - mo[j]) * ro[j];  // o queries a
          const float ds1 = p1 * (D1[r * LDF + j] - t_);
          const float ds2 = p2 * (D2[r * LDF + j] - to[j]);
          rs += ds2;
          Ds[r * LDH + j] = __float2bfloat16(ds1 + ds2);
          Pb[r * LDH + j] = __float2bfloat16(p2);
        }
        db_r += row_sum(rs);
      }
      __syncthreads();

      mm_ab_acc(Ds, Qo, dq);
      mm_ab_acc(Pb, Go, dvv);
      __syncthreads();  // before the next o tile overwrites its inputs
    }

    store_acc(dq, S);
    store_acc(dvv, D1);
    __syncthreads();
    {
      const size_t row = (frame + a0 + r) * D + h * HD + c0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        dqk[row + c] = __float2bfloat16(S[r * LDF + c0 + c] * scale);
        dv[row + c] = __float2bfloat16(D1[r * LDF + c0 + c]);
      }
    }
  }

  if ((threadIdx.x & 3) == 0) {
    const int t = a0 + r;
    if (t < n0)
      db0[(size_t)b * n0 + t] = db_r;
    else
      db1[(size_t)b * (N - n0) + t - n0] = db_r;
  }
}

}  // namespace

extern "C" int pram_cross_attention_bwd(const void* qk, const void* v,
                                        const void* bias0, const void* bias1,
                                        const void* g, void* dqk, void* dv,
                                        void* db0, void* db1, void* stats,
                                        int B, int N, int n0, int heads,
                                        float scale, void* stream) {
  // stats: f32 scratch [3, B, heads, N]
  if (n0 <= 0 || n0 >= N || n0 % T != 0 || (N - n0) % T != 0 ||
      heads * HD != D)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STATS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<dim3(N / T, heads, B), NTHREADS, STATS_SMEM, s>>>(
      (const bf16*)qk, (const bf16*)v, (const float*)bias0,
      (const float*)bias1, (const bf16*)g, (float*)stats, B, N, n0, heads,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_kernel<<<dim3(N / T, B), NTHREADS, GRAD_SMEM, s>>>(
      (const bf16*)qk, (const bf16*)v, (const float*)bias0,
      (const float*)bias1, (const bf16*)g, (const float*)stats, (bf16*)dqk,
      (bf16*)dv, (float*)db0, (float*)db1, B, N, n0, heads, scale);
  return (int)cudaGetLastError();
}
