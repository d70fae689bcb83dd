// Backward of the fused self-attention (kernel 1: qkv projection, rotary,
// masked block-diagonal attention) for Hopper: bf16 in, f32 accumulation.
//
// Replaces pram_tpu/ops/attention_bwd_pallas.py:fused_self_attention_bwd
// (_bwd_kernel). Given the recomputed projection qkv, the rotary tables,
// the key bias and the messages' cotangent g, it returns dqkv, dcos, dsin
// (summed over heads) and dbias (summed over heads and query rows):
//   p      = softmax(rot(q) rot(k)^T * scale + bias)   (f32, recomputed)
//   dp     = g v^T,  dlogit = p (dp - sum_j dp p)
//   dq_rot = dlogit k_rot * scale,  dk_rot = dlogit^T q_rot * scale,
//   dv     = p^T g,  dq = dq_rot cos - rot_half(dq_rot sin) (and dk),
//   dcos   = sum_h dq_rot q + dk_rot k,
//   dsin   = sum_h dq_rot rot_half(q) + dk_rot rot_half(k).
//
// What bounds it: at the training slice's shapes (B=32, N=512, 4 heads of
// 64) the five N x N products take 21.5 GFLOP against ~76 MB of inputs and
// outputs, 0.022 ms of tensor-core time and 0.023 ms of memory time, so
// both bound it about equally. The TPU kernel keeps a whole head's [N, N]
// f32 probabilities of a frame in VMEM; a Hopper block cannot (1 MB at
// N=512). So two kernels run back to back, with no atomics and in a fixed
// order of summation:
//   1. stats_kernel, one block per (frame, head, 64-query tile): the row
//      max, 1/sum and t = sum_j p dp of each query row, streaming the side's
//      64-key tiles (2 of the 5 products), into an f32 scratch [3, B, H, N].
//   2. grad_kernel, one block per (frame, 64-token tile a), looping over the
//      heads and the other tiles o of a's side: with a as queries against o
//      as keys it sums dq; with o as queries against a as keys it sums dk,
//      dv and dbias. 7 products per tile pair: a's tokens get all their
//      gradients in one block, so the query and key halves of dcos and dsin
//      add up in registers and every output is written once.
// Scores never reach device memory. Products are bf16 WMMA tiles; wgmma and
// TMA are later work.
//
// Rounding follows the TPU kernel: rot(q) and rot(k) are taken in f32 from
// the bf16 q, k and rounded to bf16; logits and p are f32; dlogit and p are
// rounded to bf16 before their products with k, q and g; dq, dk, dv are
// rounded to bf16; dcos, dsin, dbias are f32.
//
// Layouts: qkv and dqkv [B, N, 768] bf16 in the torch Linear layout of the
// flax kernel (column (h * 64 + i) * 3 + c for c in q, k, v, so head h's
// q, k, v are the 192 columns from h * 192, interleaved); cos, sin, dcos,
// dsin [B, N, 64] f32; key_bias, dbias [B, N] f32; g [B, N, 256] bf16 with
// column h * 64 + i. Sides (splits) are multiples of 64 tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "attention_tile.cuh"

namespace {

using namespace bwd;

constexpr int D = 256;       // model width: 4 heads of 64
constexpr int D3 = 3 * D;    // qkv row

// Loads head h of 64 tokens from qkv (rows from `rows`): q and k rotated by
// the tokens' cos/sin and rounded to bf16, v as it is. Null tiles are
// skipped.
__device__ __forceinline__ void load_qkv(const bf16* __restrict__ rows,
                                         const float* __restrict__ cos,
                                         const float* __restrict__ sin, int h,
                                         bf16* Qs, bf16* Ks, bf16* Vs) {
  for (int it = threadIdx.x; it < T * (HD / 2); it += NTHREADS) {
    const int r = it / (HD / 2), j = 2 * (it % (HD / 2));
    const bf16* src = rows + (size_t)r * D3 + h * 3 * HD + 3 * j;
    const float* cs = cos + (size_t)r * HD + j;
    const float* sn = sin + (size_t)r * HD + j;
    if (Qs) {
      const float a = __bfloat162float(src[0]), b = __bfloat162float(src[3]);
      Qs[r * LDH + j] = __float2bfloat16(a * cs[0] - b * sn[0]);
      Qs[r * LDH + j + 1] = __float2bfloat16(b * cs[1] + a * sn[1]);
    }
    if (Ks) {
      const float a = __bfloat162float(src[1]), b = __bfloat162float(src[4]);
      Ks[r * LDH + j] = __float2bfloat16(a * cs[0] - b * sn[0]);
      Ks[r * LDH + j + 1] = __float2bfloat16(b * cs[1] + a * sn[1]);
    }
    if (Vs) {
      Vs[r * LDH + j] = src[2];
      Vs[r * LDH + j + 1] = src[5];
    }
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if (threadIdx.x < T) dst[threadIdx.x] = src[threadIdx.x];
}

constexpr size_t STATS_SMEM = 4 * TILE_H + 2 * TILE_F + VEC_F;

__global__ void __launch_bounds__(NTHREADS, 1)
stats_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos,
             const float* __restrict__ sin, const float* __restrict__ key_bias,
             const bf16* __restrict__ g, float* __restrict__ stats, int B,
             int N, int heads, float scale, tile::Sides sp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + T * LDH;
  bf16* Ks = Gs + T * LDH;
  bf16* Vs = Ks + T * LDH;
  float* Sf = reinterpret_cast<float*>(smem + 4 * TILE_H);
  float* Df = Sf + T * LDF;
  float* kb = Df + T * LDF;

  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  sp.find(q0, lo, hi);
  const bf16* qkvb = qkv + (size_t)b * N * D3;
  const float* cosb = cos + (size_t)b * N * HD;
  const float* sinb = sin + (size_t)b * N * HD;
  load_qkv(qkvb + (size_t)q0 * D3, cosb + (size_t)q0 * HD,
           sinb + (size_t)q0 * HD, h, Qs, nullptr, nullptr);
  load_tile(Gs, g + ((size_t)b * N + q0) * D + h * HD, D);

  float m = -INFINITY, l = 0.f, u = 0.f;
  for (int k0 = lo; k0 < hi; k0 += T) {
    load_qkv(qkvb + (size_t)k0 * D3, cosb + (size_t)k0 * HD,
             sinb + (size_t)k0 * HD, h, nullptr, Ks, Vs);
    load_vec(kb, key_bias + (size_t)b * N + k0);
    __syncthreads();
    stats_step(Qs, Gs, Ks, Vs, kb, scale, Sf, Df, m, l, u);
  }
  if ((threadIdx.x & 3) == 0) {
    const size_t i = ((size_t)b * heads + h) * N + q0 + elt_row();
    const size_t plane = (size_t)B * heads * N;
    stats[i] = m;
    stats[plane + i] = 1.f / l;
    stats[2 * plane + i] = u / l;
  }
}

constexpr size_t GRAD_SMEM = 11 * TILE_H + 2 * TILE_F + 8 * VEC_F;

__global__ void __launch_bounds__(NTHREADS, 1)
grad_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cos,
            const float* __restrict__ sin, const float* __restrict__ key_bias,
            const bf16* __restrict__ g, const float* __restrict__ stats,
            bf16* __restrict__ dqkv, float* __restrict__ dcos,
            float* __restrict__ dsin, float* __restrict__ dbias, int B, int N,
            int heads, float scale, tile::Sides sp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qa = reinterpret_cast<bf16*>(smem);
  bf16* Ka = Qa + T * LDH;
  bf16* Va = Ka + T * LDH;
  bf16* Ga = Va + T * LDH;
  bf16* Qo = Ga + T * LDH;
  bf16* Ko = Qo + T * LDH;
  bf16* Vo = Ko + T * LDH;
  bf16* Go = Vo + T * LDH;
  bf16* Ds1 = Go + T * LDH;  // dlogit, a as queries (bf16)
  bf16* Ds2 = Ds1 + T * LDH;  // dlogit, a as keys, [a][o] (bf16)
  bf16* Pb = Ds2 + T * LDH;   // p, a as keys, [a][o] (bf16)
  float* F0 = reinterpret_cast<float*>(smem + 11 * TILE_H);
  float* F1 = F0 + T * LDF;
  float* ma = F1 + T * LDF;  // row statistics of a (queries) ...
  float* ra = ma + T;
  float* ta = ra + T;
  float* mo = ta + T;  // ... and of o
  float* ro = mo + T;
  float* to = ro + T;
  float* ba = to + T;  // key biases of a and o
  float* bo = ba + T;

  const int a0 = blockIdx.x * T, b = blockIdx.y;
  int lo, hi;
  sp.find(a0, lo, hi);
  const size_t plane = (size_t)B * heads * N;
  const bf16* qkvb = qkv + (size_t)b * N * D3;
  const float* cosb = cos + (size_t)b * N * HD;
  const float* sinb = sin + (size_t)b * N * HD;
  const bf16* gb = g + (size_t)b * N * D;
  const float* kbias = key_bias + (size_t)b * N;
  const int r = elt_row(), c0 = elt_col();
  float dcos_r[16], dsin_r[16], dbias_r = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) dcos_r[c] = dsin_r[c] = 0.f;
  load_vec(ba, kbias + a0);

  for (int h = 0; h < heads; ++h) {
    const float* st = stats + ((size_t)b * heads + h) * N;
    __syncthreads();  // the previous head's tiles are no longer read
    load_qkv(qkvb + (size_t)a0 * D3, cosb + (size_t)a0 * HD,
             sinb + (size_t)a0 * HD, h, Qa, Ka, Va);
    load_tile(Ga, gb + (size_t)a0 * D + h * HD, D);
    load_vec(ma, st + a0);
    load_vec(ra, st + plane + a0);
    load_vec(ta, st + 2 * plane + a0);
    Acc dq[2], dk[2], dv[2];
    zero_acc(dq);
    zero_acc(dk);
    zero_acc(dv);

    for (int o0 = lo; o0 < hi; o0 += T) {
      load_qkv(qkvb + (size_t)o0 * D3, cosb + (size_t)o0 * HD,
               sinb + (size_t)o0 * HD, h, Qo, Ko, Vo);
      load_tile(Go, gb + (size_t)o0 * D + h * HD, D);
      load_vec(mo, st + o0);
      load_vec(ro, st + plane + o0);
      load_vec(to, st + 2 * plane + o0);
      load_vec(bo, kbias + o0);
      __syncthreads();

      // a as queries, o as keys: dlogit[a][o]
      mm_abt(Qa, Ko, F0);
      mm_abt(Ga, Vo, F1);
      __syncthreads();
      {
        const float m_ = ma[r], r_ = ra[r], t_ = ta[r];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int j = c0 + c;
          const float p = expf(F0[r * LDF + j] * scale + bo[j] - m_) * r_;
          Ds1[r * LDH + j] = __float2bfloat16(p * (F1[r * LDF + j] - t_));
        }
      }
      __syncthreads();

      // o as queries, a as keys, held as [a][o]
      mm_abt(Ka, Qo, F0);
      mm_abt(Va, Go, F1);
      __syncthreads();
      {
        const float b_ = ba[r];
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int j = c0 + c;
          const float p = expf(F0[r * LDF + j] * scale + b_ - mo[j]) * ro[j];
          const float ds = p * (F1[r * LDF + j] - to[j]);
          rs += ds;
          Ds2[r * LDH + j] = __float2bfloat16(ds);
          Pb[r * LDH + j] = __float2bfloat16(p);
        }
        dbias_r += row_sum(rs);
      }
      __syncthreads();

      mm_ab_acc(Ds1, Ko, dq);
      mm_ab_acc(Ds2, Qo, dk);
      mm_ab_acc(Pb, Go, dv);
      __syncthreads();  // before the next o tile overwrites its inputs
    }

    // this head's dq, dk (transposed rotation), dcos, dsin and dv
    store_acc(dq, F0);
    store_acc(dk, F1);
    __syncthreads();
    {
      const int row = a0 + r;
      const bf16* src = qkvb + (size_t)row * D3 + h * 3 * HD;
      bf16* dst = dqkv + ((size_t)b * N + row) * D3 + h * 3 * HD;
      const float* cs = cosb + (size_t)row * HD;
      const float* sn = sinb + (size_t)row * HD;
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        const int j = c0 + c;
        const float dq0 = F0[r * LDF + j] * scale, dq1 = F0[r * LDF + j + 1] * scale;
        const float dk0 = F1[r * LDF + j] * scale, dk1 = F1[r * LDF + j + 1] * scale;
        const float q0 = __bfloat162float(src[3 * j]), q1 = __bfloat162float(src[3 * j + 3]);
        const float k0 = __bfloat162float(src[3 * j + 1]), k1 = __bfloat162float(src[3 * j + 4]);
        dst[3 * j] = __float2bfloat16(dq0 * cs[j] + dq1 * sn[j + 1]);
        dst[3 * j + 3] = __float2bfloat16(dq1 * cs[j + 1] - dq0 * sn[j]);
        dst[3 * j + 1] = __float2bfloat16(dk0 * cs[j] + dk1 * sn[j + 1]);
        dst[3 * j + 4] = __float2bfloat16(dk1 * cs[j + 1] - dk0 * sn[j]);
        dcos_r[c] += dq0 * q0 + dk0 * k0;
        dcos_r[c + 1] += dq1 * q1 + dk1 * k1;
        dsin_r[c] += dq0 * -q1 + dk0 * -k1;
        dsin_r[c + 1] += dq1 * q0 + dk1 * k0;
      }
    }
    __syncthreads();
    store_acc(dv, F0);
    __syncthreads();
    {
      bf16* dst = dqkv + ((size_t)b * N + a0 + r) * D3 + h * 3 * HD;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        dst[3 * (c0 + c) + 2] = __float2bfloat16(F0[r * LDF + c0 + c]);
    }
  }

  const size_t row = (size_t)b * N + a0 + r;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    dcos[row * HD + c0 + c] = dcos_r[c];
    dsin[row * HD + c0 + c] = dsin_r[c];
  }
  if ((threadIdx.x & 3) == 0) dbias[row] = dbias_r;
}

}  // namespace

extern "C" int pram_self_attention_bwd(
    const void* qkv, const void* cos, const void* sin, const void* key_bias,
    const void* g, void* dqkv, void* dcos, void* dsin, void* dbias,
    void* stats, int B, int N, int heads, float scale, const int* splits,
    int n_splits, void* stream) {
  // stats: f32 scratch [3, B, heads, N]; splits: n_splits side lengths (host
  // memory), each a multiple of 64 and summing to N
  if (N % T != 0 || heads * HD != D || n_splits < 1 ||
      n_splits > tile::MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  tile::Sides sp;
  sp.n = n_splits;
  sp.edge[0] = 0;
  for (int s = 0; s < sp.n; ++s) {
    const int len = splits[s];
    if (len <= 0 || len % T != 0) return (int)cudaErrorInvalidValue;
    sp.edge[s + 1] = sp.edge[s] + len;
  }
  if (sp.edge[sp.n] != N) return (int)cudaErrorInvalidValue;
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
      (const bf16*)qkv, (const float*)cos, (const float*)sin,
      (const float*)key_bias, (const bf16*)g, (float*)stats, B, N, heads,
      scale, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_kernel<<<dim3(N / T, B), NTHREADS, GRAD_SMEM, s>>>(
      (const bf16*)qkv, (const float*)cos, (const float*)sin,
      (const float*)key_bias, (const bf16*)g, (const float*)stats,
      (bf16*)dqkv, (float*)dcos, (float*)dsin, (float*)dbias, B, N, heads,
      scale, sp);
  return (int)cudaGetLastError();
}
