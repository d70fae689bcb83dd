// Backward of the symmetric shared-QK cross-attention (kernel 5) for Hopper:
// bf16 in, f32 accumulation.
//
// Replaces pram_tpu/ops/attention_bwd_pallas.py:274 fused_cross_attention_bwd
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
// the function's seven n0 x n1 products take 60.1 GFLOP against ~40 MB in
// and out: the tensor cores, 0.061 ms. The kernel runs 14 (each unordered
// pair of tiles is visited from both sides, and the statistics take 2 a
// direction), 120 GFLOP, 0.12 ms. Its exponentials are a second ceiling:
// 2 a direction in the statistics and 2 a visit in the gradient pass, 6
// per (head, pair), 0.40 G, 0.10 ms at 4.18 T/s.
//
// Design: two launches on one stream, no atomics, a fixed order of sums.
// Every token is a query in one direction and a key in the other.
//   1. stats_kernel, one CTA per (128 tokens, head, frame):
//      wg::stats_cta (attention_bwd_wgmma.cuh), each 64-token warpgroup
//      against the other side, into an f32 scratch [3, B, H, N].
//   2. grad_kernel, one CTA per (frame, 128 tokens a), the heads inside: the
//      other side's tiles o stream through the TMA ring (qk, v, g: three
//      8 KB boxes a stage). Per o tile and 64-row warpgroup, wgmma computes
//      sim[a][o] = qk_a qk_o^T, dp with a as queries (g_a v_o^T) and with a
//      as keys (v_a g_o^T) from shared memory into registers; both
//      directions' weights and dsim are formed there, rounded to bf16 A
//      fragments, and mma_rs sums dqk += dsim qk_o and dv += P_{o->a} g_o
//      against the o tiles read MN-major. a's bias gradient sums the
//      direction in which a is the key side. The epilogue of each head
//      writes dqk and dv once.
//   One CTA an SM: a producer warpgroup and two consumer warpgroups (240
//   registers a consumer thread, setmaxnreg), 151 KB of shared memory (a
//   ring of four stages).
//
// Rounding follows the TPU kernel: sim, the softmax and dsim are f32 (the
// logits one fma with log2 e folded in, ex2); the two directions' dsim are
// added in f32 and rounded to bf16 before the products with qk; the weights
// are rounded to bf16 before the products with g; dqk, dv are rounded to
// bf16, db0, db1 are f32.
//
// Layouts: qk, v, g, dqk, dv [B, N, 256] bf16 with N = n0 + n1 and column
// h * 64 + i; bias0, db0 [B, n0] and bias1, db1 [B, n1] f32. n0 and n1 are
// multiples of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_wgmma.cuh"

namespace {

using namespace wg;

constexpr int D = 256;  // model width: 4 heads of 64

// the two parts of the CTA whose first token is a0: each visits the other
// side
__device__ __forceinline__ void cross_parts(int a0, int N, int n0,
                                            Part (&part)[PARTS]) {
#pragma unroll
  for (int g = 0; g < PARTS; ++g) {
    const int row = a0 + g * TR;
    part[g].row = row;
    part[g].lo = row >= N ? 0 : row < n0 ? n0 : 0;
    part[g].hi = row >= N ? 0 : row < n0 ? N : n0;
  }
}

struct Maps {  // qk, v, g [B, N, 256]
  CUtensorMap qk, v, g;
};

__global__ void __launch_bounds__(THREADS, 2)
stats_kernel(const __grid_constant__ Maps maps, Bias kb0,
             float* __restrict__ stats, int N, int n0, int heads,
             float scale) {
  extern __shared__ unsigned char smem[];
  const int a0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  Part part[PARTS];
  cross_parts(a0, N, n0, part);
  const Bias kb{kb0.lo + (size_t)b * n0, kb0.hi + (size_t)b * (N - n0), n0};
  stats_cta(&maps.qk, h * HD, &maps.qk, h * HD, &maps.v, h * HD, &maps.g,
            h * HD, b, part, kb, scale, stats + ((size_t)b * heads + h) * N,
            (size_t)gridDim.z * heads * N, smem);
}

// tiles qk, v, g of a and of o; four stages; no epilogue staging
typedef GradSmem<3, 3, 4, 0> Smem;
enum { TQ, TV, TG };

// dsim of a against o tile s ([a][o]; x = qk_a . qk_o, y = g_a . v_o with a
// as queries, z = v_a . g_o with o as queries) and the weights of o -> a,
// rounded to bf16 A fragments; the f32 dsim of o -> a summed into this
// lane's share of a's key-bias gradient
__device__ __forceinline__ void pair_grads(const Smem& sm, int s,
                                           const Rows& ra, float sl2,
                                           const Acc& x, const Acc& y,
                                           const Acc& z, uint32_t (&f)[4][4],
                                           uint32_t (&w)[4][4], float& db0,
                                           float& db1) {
  const int cq = 2 * (threadIdx.x & 3);
  const float* mo = sm.o_vec(s, 0);
  const float* ro = sm.o_vec(s, 1);
  const float* to = sm.o_vec(s, 2);
  const float* bo = sm.o_vec(s, 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + cq;
    const float2 b = *reinterpret_cast<const float2*>(bo + c);
    const float2 m = *reinterpret_cast<const float2*>(mo + c);
    const float2 r = *reinterpret_cast<const float2*>(ro + c);
    const float2 t = *reinterpret_cast<const float2*>(to + c);
    const float b0 = b.x * LOG2E, b1 = b.y * LOG2E;
    float v[4], e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float sim = x.d[4 * j + q];
      const bool hi = q >= 2, odd = q & 1;
      // a queries o (a's row statistics, o's key bias)
      const float p1 = ex2(fmaf(sim, sl2, odd ? b1 : b0) - (hi ? ra.m1 : ra.m0)) *
                       (hi ? ra.r1 : ra.r0);
      // o queries a (o's row statistics, a's key bias)
      const float p2 = ex2(fmaf(sim, sl2, hi ? ra.b1 : ra.b0) - (odd ? m.y : m.x)) *
                       (odd ? r.y : r.x);
      const float d2 = p2 * (z.d[4 * j + q] - (odd ? t.y : t.x));
      v[q] = p1 * (y.d[4 * j + q] - (hi ? ra.t1 : ra.t0)) + d2;
      e[q] = p2;
      if (hi)
        db1 += d2;
      else
        db0 += d2;
    }
    pack_block(f, j, v[0], v[1], v[2], v[3]);
    pack_block(w, j, e[0], e[1], e[2], e[3]);
  }
}

// issues the three score products of a (part g) against the it-th tile
__device__ __forceinline__ void pair_scores(const Smem& sm, int g, int it,
                                            Acc& x, Acc& y, Acc& z) {
  const int s = Smem::stage(it);
  score_issue(x, desc(sm.a_tile(TQ, g)), desc(sm.o_tile(s, TQ)));
  score_issue(y, desc(sm.a_tile(TG, g)), desc(sm.o_tile(s, TV)));
  score_issue(z, desc(sm.a_tile(TV, g)), desc(sm.o_tile(s, TG)));
}

// One head's dqk, dv of a warpgroup's 64 rows a (part g, rows ra) against
// the o tiles of the other side, the ring's it-th tile on, and their
// contribution to a's key-bias gradient
__device__ __forceinline__ void cross_head(const Smem& sm, int g, int& it,
                                           int n, const Rows& ra, float sl2,
                                           Acc& dqk, Acc& dv, float& db0,
                                           float& db1) {
  for (int i = 0; i < n; ++i, ++it) {
    const int s = Smem::stage(it);
    Acc x, y, z;
    uint32_t f[4][4], w[4][4];
    sm.wait_tile(it);
    mma_fence();
    pair_scores(sm, g, it, x, y, z);
    mma_commit();
    mma_wait();
    reg_fence(x);
    reg_fence(y);
    reg_fence(z);
    pair_grads(sm, s, ra, sl2, x, y, z, f, w, db0, db1);
    mma_fence();
    grad_issue(dqk, f, desc(sm.o_tile(s, TQ)));
    grad_issue(dv, w, desc(sm.o_tile(s, TG)));
    mma_commit();
    mma_wait();
    reg_fence(dqk);
    reg_fence(dv);
    release(&sm.empty[s]);
  }
}

__global__ void __launch_bounds__(GRAD_THREADS, 1)
grad_kernel(const __grid_constant__ Maps maps, Bias kb0,
            const float* __restrict__ stats, bf16* __restrict__ dqk,
            bf16* __restrict__ dv, float* __restrict__ db0,
            float* __restrict__ db1, int N, int n0, int heads, float scale) {
  extern __shared__ unsigned char smem[];
  const Smem sm(smem);
  const int a0 = blockIdx.x * BR, b = blockIdx.y;
  const int n1 = N - n0;
  Part part[PARTS];
  cross_parts(a0, N, n0, part);
  const int np = active_parts(part);
  const Bias kb{kb0.lo + (size_t)b * n0, kb0.hi + (size_t)b * n1, n0};
  if (threadIdx.x == 0) sm.init(np);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one lane issues
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const m[3] = {&maps.qk, &maps.v, &maps.g};
      const int col[3] = {0, 0, 0};
      grad_produce(sm, m, col, m, col, b, part, kb, heads,
                   stats + (size_t)b * heads * N, N,
                   (size_t)gridDim.y * heads * N);
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int g = threadIdx.x >> 7;
  if (g >= np) return;
  const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r, r + 8
  const Part me = part_of(part, g);
  int L, H;
  span(part, L, H);
  const float sl2 = scale * LOG2E;
  const size_t tok0 = (size_t)b * N + me.row + r;
  float bs0 = 0.f, bs1 = 0.f;
  int it = 0;
  for (int h = 0; h < heads; ++h) {
    bar_wait(sm.afull, h & 1);
    const Rows ra = sm.rows(g, r);
    Acc aq, av;
    zero(aq);
    zero(av);
    sm.pass_tiles(it, (me.lo - L) / TR);
    cross_head(sm, g, it, (me.hi - me.lo) / TR, ra, sl2, aq, av, bs0, bs1);
    sm.pass_tiles(it, (H - me.hi) / TR);
    release(sm.aempty);  // a's tiles and statistics of head h read
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t at = (tok0 + 8 * half) * D + h * HD + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dqk + at + 8 * j) =
            __floats2bfloat162_rn(aq.d[i] * scale, aq.d[i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(av.d[i], av.d[i + 1]);
      }
    }
  }
  bs0 = quad_sum(bs0);
  bs1 = quad_sum(bs1);
  if ((lane & 3) == 0) {
    const int t = me.row + r;  // t and t + 8 lie on one side
    float* out = t < n0 ? db0 + (size_t)b * n0 + t : db1 + (size_t)b * n1 + (t - n0);
    out[0] = bs0;
    out[8] = bs1;
  }
}

}  // namespace

extern "C" int pram_cross_attention_bwd(const void* qk, const void* v,
                                        const void* bias0, const void* bias1,
                                        const void* g, void* dqk, void* dv,
                                        void* db0, void* db1, void* stats,
                                        int B, int N, int n0, int heads,
                                        float scale, void* stream) {
  // stats: f32 scratch [3, B, heads, N]; qk, v, g 16-byte aligned
  if (n0 <= 0 || n0 >= N || n0 % TR != 0 || (N - n0) % TR != 0 ||
      heads * HD != D)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!make_map(&maps.qk, qk, D, N, B, D, (size_t)N * D) ||
      !make_map(&maps.v, v, D, N, B, D, (size_t)N * D) ||
      !make_map(&maps.g, g, D, N, B, D, (size_t)N * D))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const Bias kb{(const float*)bias0, (const float*)bias1, n0};
  const int tiles = (N + BR - 1) / BR;
  int err = launch(stats_kernel, dim3(tiles, heads, B), THREADS,
                   BWD_STATS_SMEM, s, maps, kb, (float*)stats, N, n0, heads,
                   scale);
  if (err) return err;
  return launch(grad_kernel, dim3(tiles, B), GRAD_THREADS, Smem::BYTES, s, maps, kb,
                (const float*)stats, (bf16*)dqk, (bf16*)dv, (float*)db0,
                (float*)db1, N, n0, heads, scale);
}
