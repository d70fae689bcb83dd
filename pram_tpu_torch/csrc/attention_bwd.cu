// Backward of the fused self-attention (kernel 1: qkv projection, rotary,
// masked block-diagonal attention) for Hopper: bf16 in, f32 accumulation.
//
// Replaces pram_tpu/ops/attention_bwd_pallas.py:330 fused_self_attention_bwd
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
// 64) the function's five N x N products take 21.5 GFLOP, 0.022 ms of
// tensor-core time, against ~76 MB in and out, 0.023 ms; the kernel runs 9
// products (2 in the statistics pass, 7 in the gradient pass, 38.7 GFLOP,
// 0.039 ms) and 2 exponentials per (head, query, key) in the gradient pass
// and 1 in the statistics pass. The TPU kernel keeps a head's [N, N] f32
// probabilities of a frame in VMEM; a Hopper CTA cannot (1 MB at N=512).
//
// Design: three launches on one stream, no atomics, a fixed order of sums.
//   1. pack_kernel: rot(q), rot(k) rounded to bf16 and v into a [B, N, 768]
//      scratch in [q heads | k heads | v heads] column blocks, once (the
//      interleaved qkv cannot be loaded as a TMA box, and every tile is
//      read by every tile of its side in both passes).
//   2. stats_kernel, one CTA per (128 query rows, head, frame):
//      wg::stats_cta (attention_bwd_wgmma.cuh) over the rows' side, into
//      an f32 scratch [3, B, H, N] (max in log2 units, 1 / sum, t).
//   3. grad_kernel, one CTA per (frame, 128 tokens a), the heads inside:
//      the o tiles of a's side stream through the TMA ring (q, k, v and g:
//      four 8 KB boxes a stage). Per o tile and 64-row warpgroup, wgmma
//      computes S_ao = Q_a K_o^T and dP_ao = G_a V_o^T, then S_oa and dP_oa
//      held as [a][o] (K_a Q_o^T, V_a G_o^T), all from shared memory; p and
//      dlogit are formed in the accumulator registers, rounded to bf16 A
//      fragments, and mma_rs sums dq += dS_ao K_o, dk += dS_oa Q_o and
//      dv += P_oa G_o against the o tiles read MN-major. dq, dk and dv of
//      one head (96 registers) stay in registers; the epilogue un-rotates
//      dq and dk against the rows' own q and k from qkv and writes dqkv
//      once; dcos and dsin sum over the heads in order in their outputs
//      (each element read and written by one thread), dbias in registers.
//      The epilogue goes through 5 KB of shared memory a warp, so that it
//      walks rows with lane = rotary pair and every global access is a
//      contiguous row segment (in the accumulator layout its scattered
//      8- and 4-byte accesses took half the pass).
//   One CTA an SM: a producer warpgroup and two consumer warpgroups (240
//   registers a consumer thread, setmaxnreg), 211 KB of shared memory (a
//   ring of three stages); at the training shape 128 CTAs, one wave on 132
//   SMs.
//
// Rounding follows the TPU kernel: rot(q) and rot(k) in f32 from the bf16
// q, k, each product and the sum rounded once (__fmul_rn / __fadd_rn, the
// plain version's order), rounded to bf16; logits and p are f32 (one fma
// with log2 e folded in, ex2); dlogit and p are rounded to bf16 before
// their products with k, q and g; dq, dk, dv are rounded to bf16; dcos,
// dsin, dbias are f32.
//
// Layouts: qkv and dqkv [B, N, 768] bf16 in the torch Linear layout of the
// flax kernel (column (h * 64 + i) * 3 + c for c in q, k, v, so head h's
// q, k, v are the 192 columns from h * 192, interleaved); cos, sin, dcos,
// dsin [B, N, 64] f32; key_bias, dbias [B, N] f32; g [B, N, 256] bf16 with
// column h * 64 + i. Sides (splits) are multiples of 64 tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_wgmma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace wg;
using tile::Sides;

constexpr int D = 256;     // model width: 4 heads of 64
constexpr int D3 = 3 * D;  // qkv row

// one thread per (token, head, rotary pair): q, k and v of the pair are six
// neighbouring bf16 of qkv
__global__ void pack_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ cos,
                            const float* __restrict__ sin,
                            bf16* __restrict__ packed, size_t tokens) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tokens * (D / 2)) return;
  const size_t t = i / (D / 2);
  const int col = 2 * (int)(i % (D / 2));  // head h * 64 + 2 * pair
  const int e = col % HD;                  // rotary index within the head
  const __nv_bfloat162* src =
      reinterpret_cast<const __nv_bfloat162*>(qkv + t * D3 + 3 * col);
  const float2 qk0 = __bfloat1622float2(src[0]);  // q0, k0
  const float2 vq = __bfloat1622float2(src[1]);   // v0, q1
  const float2 kv = __bfloat1622float2(src[2]);   // k1, v1
  const float2 c = *reinterpret_cast<const float2*>(cos + t * HD + e);
  const float2 s = *reinterpret_cast<const float2*>(sin + t * HD + e);
  // x * cos + rotate_half(x) * sin, each product and the sum rounded once
  bf16* dst = packed + t * D3 + col;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(qk0.x, c.x), __fmul_rn(-vq.y, s.x)),
      __fadd_rn(__fmul_rn(vq.y, c.y), __fmul_rn(qk0.x, s.y)));
  *reinterpret_cast<__nv_bfloat162*>(dst + D) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(qk0.y, c.x), __fmul_rn(-kv.x, s.x)),
      __fadd_rn(__fmul_rn(kv.x, c.y), __fmul_rn(qk0.y, s.y)));
  *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D) =
      __floats2bfloat162_rn(vq.x, kv.y);
}

// the two parts of the CTA whose first token is a0: each visits its side
__device__ __forceinline__ void side_parts(const Sides& sides, int a0, int N,
                                           Part (&part)[PARTS]) {
#pragma unroll
  for (int g = 0; g < PARTS; ++g) {
    part[g].row = a0 + g * TR;
    part[g].lo = part[g].hi = 0;
    if (part[g].row < N) sides.find(part[g].row, part[g].lo, part[g].hi);
  }
}

struct Maps {  // the packed [B, N, 768] scratch and g [B, N, 256]
  CUtensorMap p, g;
};

__global__ void __launch_bounds__(THREADS, 2)
stats_kernel(const __grid_constant__ Maps maps,
             const float* __restrict__ key_bias, float* __restrict__ stats,
             int N, int heads, float scale, Sides sides) {
  extern __shared__ unsigned char smem[];
  const int a0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  Part part[PARTS];
  side_parts(sides, a0, N, part);
  const Bias kb{key_bias + (size_t)b * N, nullptr, N};
  stats_cta(&maps.p, h * HD, &maps.p, D + h * HD, &maps.p, 2 * D + h * HD,
            &maps.g, h * HD, b, part, kb, scale,
            stats + ((size_t)b * heads + h) * N, (size_t)gridDim.z * heads * N,
            smem);
}

// Epilogue bytes of a consumer warp: 8 of its rows at a time, dq_rot and
// dk_rot (f32, scaled) and dv (bf16 pairs)
constexpr int EPI_BYTES = 8 * HD * sizeof(float) * 2 + 8 * (HD / 2) * sizeof(uint32_t);
// tiles q, k, v, g of a and of o; three stages (the epilogue takes the
// fourth's room)
typedef GradSmem<4, 4, 3, EPI_BYTES> Smem;
enum { TQ, TK, TV, TG };

// dlogit of a as queries against o tile s as keys ([a][o]: x = q_a . k_o,
// y = g_a . v_o), rounded to bf16 A fragments
__device__ __forceinline__ void query_grads(const Smem& sm, int s,
                                            const Rows& ra, float sl2,
                                            const Acc& x, const Acc& y,
                                            uint32_t (&f)[4][4]) {
  const int cq = 2 * (threadIdx.x & 3);
  const float* bo = sm.o_vec(s, 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bo + 8 * j + cq);
    const float b0 = b.x * LOG2E, b1 = b.y * LOG2E;
    const float p00 = ex2(fmaf(x.d[4 * j + 0], sl2, b0) - ra.m0) * ra.r0;
    const float p01 = ex2(fmaf(x.d[4 * j + 1], sl2, b1) - ra.m0) * ra.r0;
    const float p10 = ex2(fmaf(x.d[4 * j + 2], sl2, b0) - ra.m1) * ra.r1;
    const float p11 = ex2(fmaf(x.d[4 * j + 3], sl2, b1) - ra.m1) * ra.r1;
    pack_block(f, j, p00 * (y.d[4 * j + 0] - ra.t0),
               p01 * (y.d[4 * j + 1] - ra.t0), p10 * (y.d[4 * j + 2] - ra.t1),
               p11 * (y.d[4 * j + 3] - ra.t1));
  }
}

// the weights and dlogit of o tile s as queries against a as keys, held as
// [a][o] (x = k_a . q_o, y = v_a . g_o), rounded to bf16 A fragments; the
// f32 dlogit summed into this lane's share of a's key-bias gradient
__device__ __forceinline__ void key_grads(const Smem& sm, int s,
                                          const Rows& ra, float sl2,
                                          const Acc& x, const Acc& y,
                                          uint32_t (&f)[4][4],
                                          uint32_t (&w)[4][4], float& db0,
                                          float& db1) {
  const int cq = 2 * (threadIdx.x & 3);
  const float* mo = sm.o_vec(s, 0);
  const float* ro = sm.o_vec(s, 1);
  const float* to = sm.o_vec(s, 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + cq;
    const float2 m = *reinterpret_cast<const float2*>(mo + c);
    const float2 r = *reinterpret_cast<const float2*>(ro + c);
    const float2 t = *reinterpret_cast<const float2*>(to + c);
    const float p00 = ex2(fmaf(x.d[4 * j + 0], sl2, ra.b0) - m.x) * r.x;
    const float p01 = ex2(fmaf(x.d[4 * j + 1], sl2, ra.b0) - m.y) * r.y;
    const float p10 = ex2(fmaf(x.d[4 * j + 2], sl2, ra.b1) - m.x) * r.x;
    const float p11 = ex2(fmaf(x.d[4 * j + 3], sl2, ra.b1) - m.y) * r.y;
    const float d00 = p00 * (y.d[4 * j + 0] - t.x);
    const float d01 = p01 * (y.d[4 * j + 1] - t.y);
    const float d10 = p10 * (y.d[4 * j + 2] - t.x);
    const float d11 = p11 * (y.d[4 * j + 3] - t.y);
    db0 += d00 + d01;
    db1 += d10 + d11;
    pack_block(f, j, d00, d01, d10, d11);
    pack_block(w, j, p00, p01, p10, p11);
  }
}

// One head's dq, dk, dv of a warpgroup's 64 rows a (part g, rows ra)
// against the o tiles of its range, the ring's it-th tile on, and their
// contribution to a's key-bias gradient
__device__ __forceinline__ void self_head(const Smem& sm, int g, int& it,
                                          int n, const Rows& ra, float sl2,
                                          Acc& dq, Acc& dk, Acc& dv,
                                          float& db0, float& db1) {
  const uint64_t dQa = desc(sm.a_tile(TQ, g)), dKa = desc(sm.a_tile(TK, g));
  const uint64_t dVa = desc(sm.a_tile(TV, g)), dGa = desc(sm.a_tile(TG, g));
  for (int i = 0; i < n; ++i, ++it) {
    const int s = Smem::stage(it);
    const uint64_t dQo = desc(sm.o_tile(s, TQ)), dKo = desc(sm.o_tile(s, TK));
    const uint64_t dVo = desc(sm.o_tile(s, TV)), dGo = desc(sm.o_tile(s, TG));
    Acc x, y;
    uint32_t f[4][4], w[4][4];
    sm.wait_tile(it);
    // a as queries, o as keys
    mma_fence();
    score_issue(x, dQa, dKo);
    score_issue(y, dGa, dVo);
    mma_commit();
    mma_wait();
    reg_fence(x);
    reg_fence(y);
    query_grads(sm, s, ra, sl2, x, y, f);
    // dq's product in one group with the scores of o as queries, a as
    // keys, held as [a][o]
    mma_fence();
    grad_issue(dq, f, dKo);
    score_issue(x, dKa, dQo);
    score_issue(y, dVa, dGo);
    mma_commit();
    mma_wait();
    reg_fence(dq);
    reg_fence(x);
    reg_fence(y);
    key_grads(sm, s, ra, sl2, x, y, f, w, db0, db1);
    mma_fence();
    grad_issue(dk, f, dQo);
    grad_issue(dv, w, dGo);
    mma_commit();
    mma_wait();
    reg_fence(dk);
    reg_fence(dv);
    release(&sm.empty[s]);
  }
}

// Head h's gradients of a consumer warp's 16 rows (tokens from tok_w) into
// dqkv, and their rotary terms added to dcos and dsin. The accumulators go
// through the warp's epilogue bytes, 8 rows at a time, so that every global
// access is a row's contiguous segment: lane i takes rotary pair i. The
// bytes' rows are swizzled (column ^ 8 (row % 4), pair ^ 4 row) so that the
// accumulator-layout writes and the row-wise reads are free of bank
// conflicts. A lane takes the same (token, pair) for every head, so it adds
// to its own earlier sums in dcos and dsin.
__device__ __forceinline__ void self_epilogue(
    const Acc& dq, const Acc& dk, const Acc& dv, int h, size_t tok_w,
    unsigned char* epi, const bf16* __restrict__ qkv,
    const float* __restrict__ cos, const float* __restrict__ sin,
    bf16* __restrict__ dqkv, float* __restrict__ dcos,
    float* __restrict__ dsin, float scale) {
  float* sq = reinterpret_cast<float*>(epi);
  float* sk = sq + 8 * HD;
  uint32_t* sv = reinterpret_cast<uint32_t*>(sk + 8 * HD);
  const int lane = threadIdx.x & 31, rw = lane >> 2, cq = 2 * (lane & 3);
  const int c = 2 * lane;  // the pair this lane takes in the row-wise pass
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + cq, i = 4 * j + 2 * half;
      const int at = rw * HD + (col ^ (8 * (rw & 3)));
      *reinterpret_cast<float2*>(sq + at) =
          make_float2(dq.d[i] * scale, dq.d[i + 1] * scale);
      *reinterpret_cast<float2*>(sk + at) =
          make_float2(dk.d[i] * scale, dk.d[i + 1] * scale);
      sv[rw * (HD / 2) + ((col >> 1) ^ (4 * rw))] = pack_bf16(dv.d[i], dv.d[i + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const size_t tok = tok_w + 8 * half + r;
      const int at = r * HD + (c ^ (8 * (r & 3)));
      const float2 gq = *reinterpret_cast<const float2*>(sq + at);
      const float2 gk = *reinterpret_cast<const float2*>(sk + at);
      const uint32_t vv = sv[r * (HD / 2) + (lane ^ (4 * r))];
      const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(&vv);
      const float2 co = *reinterpret_cast<const float2*>(cos + tok * HD + c);
      const float2 si = *reinterpret_cast<const float2*>(sin + tok * HD + c);
      const __nv_bfloat162* s2 =
          reinterpret_cast<const __nv_bfloat162*>(qkv + tok * D3 + h * 3 * HD + 3 * c);
      const float2 qk0 = __bfloat1622float2(s2[0]);  // q0, k0
      const float q1 = __high2float(s2[1]), k1 = __low2float(s2[2]);
      __nv_bfloat162* d2 =
          reinterpret_cast<__nv_bfloat162*>(dqkv + tok * D3 + h * 3 * HD + 3 * c);
      d2[0] = __floats2bfloat162_rn(gq.x * co.x + gq.y * si.y,
                                    gk.x * co.x + gk.y * si.y);
      d2[1] = __halves2bfloat162(gv.x, __float2bfloat16_rn(gq.y * co.y - gq.x * si.x));
      d2[2] = __halves2bfloat162(__float2bfloat16_rn(gk.y * co.y - gk.x * si.x), gv.y);
      float2 pc = make_float2(gq.x * qk0.x + gk.x * qk0.y, gq.y * q1 + gk.y * k1);
      float2 ps = make_float2(-(gq.x * q1) - gk.x * k1, gq.y * qk0.x + gk.y * qk0.y);
      float2* dc = reinterpret_cast<float2*>(dcos + tok * HD + c);
      float2* ds = reinterpret_cast<float2*>(dsin + tok * HD + c);
      if (h > 0) {  // this lane wrote the earlier heads' sums
        const float2 c0 = *dc, s0 = *ds;
        pc = make_float2(c0.x + pc.x, c0.y + pc.y);
        ps = make_float2(s0.x + ps.x, s0.y + ps.y);
      }
      *dc = pc;
      *ds = ps;
    }
    __syncwarp();  // the bytes are free for the next 8 rows
  }
}

__global__ void __launch_bounds__(GRAD_THREADS, 1)
grad_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ qkv,
            const float* __restrict__ cos, const float* __restrict__ sin,
            const float* __restrict__ key_bias,
            const float* __restrict__ stats, bf16* __restrict__ dqkv,
            float* __restrict__ dcos, float* __restrict__ dsin,
            float* __restrict__ dbias, int N, int heads, float scale,
            Sides sides) {
  extern __shared__ unsigned char smem[];
  const Smem sm(smem);
  const int a0 = blockIdx.x * BR, b = blockIdx.y;
  Part part[PARTS];
  side_parts(sides, a0, N, part);
  const int np = active_parts(part);
  const Bias kb{key_bias + (size_t)b * N, nullptr, N};
  if (threadIdx.x == 0) sm.init(np);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one lane issues
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const m[4] = {&maps.p, &maps.p, &maps.p, &maps.g};
      const int col[4] = {0, D, 2 * D, 0};
      grad_produce(sm, m, col, m, col, b, part, kb, heads,
                   stats + (size_t)b * heads * N, N,
                   (size_t)gridDim.y * heads * N);
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int g = threadIdx.x >> 7;
  if (g >= np) return;
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r, r + 8
  const Part me = part_of(part, g);
  int L, H;
  span(part, L, H);
  const float sl2 = scale * LOG2E;
  const size_t tok0 = (size_t)b * N + me.row + r;
  float db0 = 0.f, db1 = 0.f;
  int it = 0;
  for (int h = 0; h < heads; ++h) {
    bar_wait(sm.afull, h & 1);
    const Rows ra = sm.rows(g, r);
    Acc dq, dk, dv;
    zero(dq);
    zero(dk);
    zero(dv);
    sm.pass_tiles(it, (me.lo - L) / TR);
    self_head(sm, g, it, (me.hi - me.lo) / TR, ra, sl2, dq, dk, dv, db0, db1);
    sm.pass_tiles(it, (H - me.hi) / TR);
    release(sm.aempty);  // a's tiles and statistics of head h read
    self_epilogue(dq, dk, dv, h, tok0 - (lane >> 2), sm.warp_epi(), qkv, cos, sin,
                  dqkv, dcos, dsin, scale);
  }
  db0 = quad_sum(db0);
  db1 = quad_sum(db1);
  if ((lane & 3) == 0) {
    dbias[tok0] = db0;
    dbias[tok0 + 8] = db1;
  }
}

}  // namespace

extern "C" int pram_self_attention_bwd(
    const void* qkv, const void* cos, const void* sin, const void* key_bias,
    const void* g, void* packed, void* dqkv, void* dcos, void* dsin,
    void* dbias, void* stats, int B, int N, int heads, float scale,
    const int* splits, int n_splits, void* stream) {
  // packed: bf16 scratch [B, N, 768]; stats: f32 scratch [3, B, heads, N];
  // splits: n_splits side lengths (host memory), each a multiple of 64 and
  // summing to N; qkv, g and packed 16-byte aligned
  if (N % TR != 0 || heads * HD != D || n_splits < 1 ||
      n_splits > tile::MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  Sides sides;
  sides.n = n_splits;
  sides.edge[0] = 0;
  for (int s = 0; s < n_splits; ++s) {
    if (splits[s] <= 0 || splits[s] % TR != 0) return (int)cudaErrorInvalidValue;
    sides.edge[s + 1] = sides.edge[s] + splits[s];
  }
  if (sides.edge[n_splits] != N) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!make_map(&maps.p, packed, D3, N, B, D3, (size_t)N * D3) ||
      !make_map(&maps.g, g, D, N, B, D, (size_t)N * D))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const size_t work = (size_t)B * N * (D / 2);
  pack_kernel<<<(unsigned)((work + 255) / 256), 256, 0, s>>>(
      (const bf16*)qkv, (const float*)cos, (const float*)sin, (bf16*)packed,
      (size_t)B * N);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int tiles = (N + BR - 1) / BR;
  err = launch(stats_kernel, dim3(tiles, heads, B), THREADS, BWD_STATS_SMEM, s,
               maps, (const float*)key_bias, (float*)stats, N, heads, scale,
               sides);
  if (err) return err;
  return launch(grad_kernel, dim3(tiles, B), GRAD_THREADS, Smem::BYTES, s, maps,
                (const bf16*)qkv, (const float*)cos, (const float*)sin,
                (const float*)key_bias, (const float*)stats, (bf16*)dqkv,
                (float*)dcos, (float*)dsin, (float*)dbias, N, heads, scale,
                sides);
}
