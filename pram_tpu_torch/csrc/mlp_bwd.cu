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
// across them; Hopper's CTAs run in no order. So three launches, with no
// float atomics and a fixed order of summation:
//   1. token_kernel, the token pass (three products a 64-token tile, the
//      LayerNorm and GELU chains between them): a persistent TMA/wgmma CTA
//      an SM on mlp_tile.cuh's skeleton (kernel 2's tile), in clusters of
//      two that multicast each weight slot. It writes dx, dpm, y and dh
//      (bf16; y and dh for the weight gradients) and each tile's f32
//      column sums of dz hhat, dz and dh (by warp) and of ct.
//   2. weight_kernel, the weight-gradient pass: dW0 = dh^T [x, pm] (512 x
//      512) and dW3 = ct^T y (256 x 512) as 12 output tiles of 128 x 256,
//      each summed over `splits` contiguous ranges of the tokens (split-K,
//      12 x 11 = 132 CTAs on the H100), A and B MN-major wgmma operands
//      loaded by TMA four 64-token stages ahead, into an f32 scratch
//      [splits, 512 * 512 + 256 * 512].
//   3. reduce_kernel adds the splits in split order and the column sums in
//      a fixed order (a tile's four warps, then tiles w, w + 8, ... for
//      each w < 8, then the eight): two launches give the same bits.
//
// The token pass. 384 threads: warpgroups 0 and 1 (240 registers each by
// setmaxnreg; 24 bytes a thread spill, in the quarter loop) own hidden
// columns 256 g .. 256 g + 255 of every product;
// warp 8 lane 0 streams the weights through a ring of three 32 KB slots
// (40 a tile: W0 for h, W3 for dy, W0 again for dx / dpm), each slot
// loaded half by each CTA of the cluster and multicast to both; warp 9
// lane 0 loads the tile's x, pm and ct (64 x 64 boxes, zero-filled past
// the last token). A tile:
//   - h = [x | pm] W0^T + b0: m64n256k16 over K = 512 (16 slots of 32 K
//     columns x 512 rows of W0, K-major, 64-byte swizzle: kernel 2's slot);
//   - LayerNorm: each warpgroup sums its half of each row, the halves meet
//     behind a named barrier (mlp_tile.cuh's row_sum); hhat is f32, 128
//     values a thread. The f32 dy of the same columns is another 128, and
//     both do not fit in 240, so each thread keeps 32 of its hhat values
//     in registers, 64 in the x / pm space (free once both warpgroups' h
//     products are done) and 32 in the staging boxes, one value every 128
//     floats (thread-private, conflict-free), and dy is computed once;
//   - dy = ct W3: m64n256k16 over K = 256 (8 slots of 32 rows of W3 x all
//     512 columns, MN-major: wgmma's transpose bit, 128-byte swizzle,
//     eight boxes of 32 rows x 64 columns a slot). Then four quarters of
//     64 columns by one loop whose quarters rotate through dy.d[0 .. 31]
//     (as two unrolled halves the code was twice as long and the phase
//     half as slow again; as a loop over swapped halves it spilled 220
//     bytes and took 26 us a tile against 19): z = hhat gamma + beta, Phi
//     and phi once (gelu_parts) for y = z Phi (bf16, stored to the y
//     scratch from registers) and dz = dy (Phi + z phi); dhhat = dz gamma
//     in place of dy; the row sums of dhhat and dhhat hhat; the column
//     sums of dz hhat and dz;
//   - dh = (dhhat - mean dhhat - hhat mean(dhhat hhat)) rstd, f32, then
//     rounded to bf16 into the dh tile (K-major, 128-byte swizzle) over
//     the x / pm space (the hhat there read first), which a TMA store
//     sends to the dh scratch; the column sums of dh;
//   - [dx | dpm] = dh W0 (warpgroup 0 dx, 1 dpm): m64n256k16 over K = 512
//     (16 slots of 32 rows of W0 x 512 columns, MN-major, the same box as
//     for W3); x's space goes back to the producer once the first 8 slots'
//     products are done, pm's after the last, so the next tile's x and pm
//     arrive during the rest; dx = bf16(ct + acc) in place of ct, dpm =
//     bf16(acc) into the staging boxes, both stored by TMA.
// The column sums: each thread adds its two rows, three shuffle exchanges
// that halve what a lane holds fold a warp's 16 rows, and each warp's sums
// go to the colsums scratch for the reduction.
//
// Shared memory of the token pass (bytes from the 1024-aligned base; boxes
// are 64 rows x 128 bytes, 8 KB):
//   0       x (4 boxes), pm (4): then hhat's 64 values a thread, then dh (8)
//   65536   ct (4): then dx
//   98304   staging (4): hhat's other 32 values a thread, then dpm
//   131072  the weight ring, 3 x 32 KB
//   229376  the row-sum exchange arrays [2][64] f32 x 2, the barriers
// 231,520 bytes with the alignment's slack, of 232,448.
//
// Rounding follows the TPU kernel: y and dh are rounded to bf16 before
// their products (y as the forward rounds it); the LayerNorm and GELU
// chains, the column sums and the weight gradients are f32; dx (ct added in
// f32) and dpm are rounded to bf16.
//
// Layouts (torch Linear, [out, in]): w0 [512, 512] bf16 whose input columns
// are [x (256) | pm (256)], w3 [256, 512] bf16; b0, gamma, beta [512], all
// three f32 or all three bf16 (widened as they are read); x, pm, ct, dx,
// dpm [tokens, 256] bf16; dw0 [512, 512], dw3 [256, 512], db0, dgamma,
// dbeta [512], db3 [256] f32. Every pointer 16-byte aligned; tokens a
// multiple of 32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_tile.cuh"

namespace {

namespace mlpbwd {

typedef __nv_bfloat16 bf16;
using mlptile::ABOX;
using mlptile::BOTH;
using mlptile::CONSUMER_REGS;
using mlptile::CONSUMER_WARPS;
using mlptile::CONSUMERS;
using mlptile::D;
using mlptile::DH;
using mlptile::INV_DH;
using mlptile::PRODUCER_REGS;
using mlptile::Ring;
using mlptile::SLOT;
using mlptile::THREADS;
using mlptile::WBOX;
using mlptile::desc_a;
using mlptile::desc_w;
using mlptile::opaque;
using mlptile::release;
using mlptile::swz;
using mlptile::zero;
using proj::bar_sync;
using proj::fence_async_shared;
using proj::group_sync;
using wg::TR;
using wgw::Acc;
using wgw::mma;
using wgw::mma_t;
using wgw::reg_fence;

constexpr int NCOL = 3 * DH + D;  // the column sums: dz hhat, dz, dh, ct
// a tile's share of them, [4 warps][3 * 512] (each warp's 16 rows) and ct's [256]
constexpr int TILE_SUMS = 4 * 3 * DH + D;
constexpr int W0_ELEMS = DH * 2 * D;
constexpr int W3_ELEMS = D * DH;
constexpr uint32_t MBOX = 32 * 128;  // an MN-major weight box: 32 rows x 64 columns
constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float NEG_HALF_LOG2E = -0.72134752044448170f;  // -log2(e) / 2
// erf by Abramowitz & Stegun 7.1.26
constexpr float AS_P = 0.3275911f, AS_A1 = 0.254829592f, AS_A2 = -0.284496736f,
                AS_A3 = 1.421413741f, AS_A4 = -1.453152027f, AS_A5 = 1.061405429f;

// the token pass's configuration for mlptile::Layout and its ring
struct TokCfg {
  static constexpr int ESZ = 2;
  static constexpr int NS_0 = 16, NS_3 = 8, NS_T = 16;  // slots a tile: h, dy, dx / dpm
  static constexpr int NS = NS_0 + NS_3 + NS_T;
  static constexpr int XP = 0, CT = 8, ST = 12, BOXES = 16, SLOTS = 3, RS = 0;
  static constexpr int CLUSTER = 2;
};
typedef mlptile::Layout<TokCfg> TL;
typedef mlptile::Tile<TokCfg> Tile;
constexpr uint32_t C_FULL = TL::M_EMPTY + 8;  // ct's barriers, after the tile's own
constexpr uint32_t C_EMPTY = C_FULL + 8;
constexpr size_t TOKEN_SMEM = TL::BYTES + 16;
static_assert(TOKEN_SMEM <= 232448, "shared memory of one CTA");

// x, pm, ct, dx, dpm [tokens, 256] and dh [tokens, 512] bf16 in 64 x 64
// boxes; w0k: W0 in K-major 128-row x 32-column boxes (kernel 2's); w0n,
// w3n: W0 and W3 in MN-major 32-row x 64-column boxes
struct TokMaps {
  CUtensorMap x, pm, ct, dx, dpm, dh, w0k, w0n, w3n;
};

struct TokVecs {
  const void *b0, *ln_w, *ln_b;  // [512], f32 or (bf) bf16
  int bf;
  float eps;
  bf16* y;         // [tokens, 512] scratch
  float* colsums;  // [tiles, TILE_SUMS] scratch
  int tokens;
};

// ---- device

// elements i and i + 1 of an f32 or bf16 vector, as f32
__device__ __forceinline__ float2 vpair(const void* p, int i, int bf) {
  if (bf) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(static_cast<const bf16*>(p) + i);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

// Phi(z) and phi(z) of the exact GELU's derivative, sharing one exponential
// E = exp(-z^2 / 2) (ex2.approx, ~2 ulp): phi = E / sqrt(2 pi), and Phi by
// erf's Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7): with x = |z| / sqrt 2,
// t = 1 / (1 + p x), erfc(x) = t (a1 + t (a2 + t (a3 + t (a4 + t a5)))) E,
// Phi = 1 - erfc / 2 for z >= 0, erfc / 2 below; Horner's rule in fmas.
// Branch-free and ~15 instructions where erff and expf took ~50, in the
// phase that bounds the token pass.
__device__ __forceinline__ void gelu_parts(float z, float& Phi, float& phi) {
  const float E = wg::ex2(__fmul_rn(__fmul_rn(z, z), NEG_HALF_LOG2E));
  const float t = __fdividef(1.f, __fmaf_rn(AS_P * INV_SQRT2, fabsf(z), 1.f));
  float q = __fmaf_rn(AS_A5, t, AS_A4);
  q = __fmaf_rn(q, t, AS_A3);
  q = __fmaf_rn(q, t, AS_A2);
  q = __fmaf_rn(q, t, AS_A1);
  const float half_erfc = __fmul_rn(__fmul_rn(q, t), __fmul_rn(E, 0.5f));
  Phi = z >= 0.f ? __fsub_rn(1.f, half_erfc) : half_erfc;
  phi = __fmul_rn(E, INV_SQRT_2PI);
}

// Rotates h by a quarter: h[0 .. 31] <- h[32 .. 63], ..., h[96 .. 127] <-
// h[0 .. 31], so a loop over quarters works on h[0 .. 31] (its body, and
// the instruction cache, holds a quarter of the code).
__device__ __forceinline__ void rotate_quarter(float (&h)[128]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = h[i];
    h[i] = h[32 + i];
    h[32 + i] = h[64 + i];
    h[64 + i] = h[96 + i];
    h[96 + i] = x;
  }
}

// an MN-major operand: boxes of K rows x 64 columns, 128-byte swizzle
// (8-row groups 1024 bytes apart), the next 64 columns `box` bytes further
// (the token pass's weight slots: MBOX; the weight-gradient pass's 64-token
// stages: ABOX)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(box >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}
constexpr uint64_t ROW16 = (16 * 128) >> 4;  // the next 16 K rows of an MN-major box

// A warp's column sums of N values a lane (each the sum of the lane's two
// rows, for N (column, quantity) pairs that the 8 lanes with the same lane
// & 3 share): three exchanges that each halve what a lane holds, with the
// lanes 4, 8 and 16 apart. Lane l ends with the sums of pairs k N / 8 ..
// k N / 8 + N / 8 - 1 in v[0 ..], k = bits 2-4 of l (bit 2 the highest).
template <int N>
__device__ __forceinline__ void fold(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int n = N >> (s + 1);
    const bool up = (lane >> (2 + s)) & 1;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[n + i];
      const float keep = up ? v[n + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << s);
    }
  }
}

// Rows r0 and r0 + 8: two per-row values summed over the quad, then as
// warpgroup 0's + warpgroup 1's, through red and red2 ([2][64] each) behind
// one barrier.
__device__ __forceinline__ void row_sum2(float (&a)[2], float (&b)[2], float* red, float* red2,
                                         int g, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = __fadd_rn(a[h], __shfl_xor_sync(0xffffffffu, a[h], 1));
    a[h] = __fadd_rn(a[h], __shfl_xor_sync(0xffffffffu, a[h], 2));
    b[h] = __fadd_rn(b[h], __shfl_xor_sync(0xffffffffu, b[h], 1));
    b[h] = __fadd_rn(b[h], __shfl_xor_sync(0xffffffffu, b[h], 2));
  }
  if ((threadIdx.x & 3) == 0) {
    red[g * TR + r0] = a[0];
    red[g * TR + r0 + 8] = a[1];
    red2[g * TR + r0] = b[0];
    red2[g * TR + r0 + 8] = b[1];
  }
  bar_sync(BOTH, CONSUMERS);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = __fadd_rn(red[r0 + 8 * h], red[TR + r0 + 8 * h]);
    b[h] = __fadd_rn(red2[r0 + 8 * h], red2[TR + r0 + 8 * h]);
  }
}

// Warpgroup g's weight products over one slot of the ring: A (K-major,
// 128-byte swizzle) at K byte kb of `a`, B the slot; W0 for h is K-major,
// W3 and W0 for dx / dpm MN-major.
__device__ __forceinline__ void issue_k(Acc<float, 256>& c, uint32_t a, int kb, uint32_t slot,
                                        int g, bool first) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
    mma(c, desc_a(a, kb + 32 * e), desc_w(slot + 2 * g * WBOX) + 2 * e, !(first && e == 0));
}
__device__ __forceinline__ void issue_mn(Acc<float, 256>& c, uint32_t a, int kb, uint32_t slot,
                                         int g, bool first) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
    mma_t<0, 1>(c, desc_a(a, kb + 32 * e), desc_mn(slot + 4 * g * MBOX, MBOX) + e * ROW16,
                !(first && e == 0));
}

// One 64-token tile of the token pass (tile `tile`, its it-th of this CTA;
// nothing leaves for a tile past the end).
template <int CL>
__device__ __forceinline__ void consume(const Tile& t, Ring& ring, const TokMaps& maps,
                                        const TokVecs& v, int it, int tile, bool live) {
  typedef TokCfg C;
  const int g = t.g, r0 = t.r0, cq = t.cq;
  const int warp = (threadIdx.x >> 5) & 3;
  const int t0 = tile * TR;
  const uint32_t a_x = wg::saddr(t.box(C::XP)), a_pm = wg::saddr(t.box(C::XP + 4)),
                 a_ct = wg::saddr(t.box(C::CT));
  // hhat's 128 values of a thread (hb.d's order): 0-31 in registers, 32-95
  // in its warpgroup's x / pm boxes, 96-127 in its staging boxes, one value
  // every 128 floats (thread-private, conflict-free)
  float* sx = t.at<float>(C::XP * ABOX) + g * 64 * 128 + (threadIdx.x & 127);
  float* ss = t.at<float>(C::ST * ABOX) + g * 32 * 128 + (threadIdx.x & 127);
  float* part = v.colsums + (size_t)tile * TILE_SUMS + warp * 3 * DH;  // this warp's column sums

  // the last tile's dx has left ct's boxes (back to the producer) and its
  // dpm the staging boxes (free after the next barrier of both)
  if (it > 0) {
    if (t.leader) proj::store_wait_read();
    if (g == 0) release(t.bar(C_EMPTY));
  }

  // h - b0, 256 columns a warpgroup: x's half of W0, then pm's
  Acc<float, 256> hb;
  zero(hb);
  wg::bar_wait(t.bar(TL::X_FULL), it & 1);
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const uint32_t slot = mlptile::next_slot(t, ring);
    issue_k(hb, a_x, 64 * k, slot, g, k == 0);
    mlptile::slot_issued<C, CL>(t, ring);
  }
  wg::bar_wait(t.bar(TL::M_FULL), it & 1);
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const uint32_t slot = mlptile::next_slot(t, ring);
    issue_k(hb, a_pm, 64 * k, slot, g, false);
    mlptile::slot_issued<C, CL>(t, ring);
  }
  mlptile::drain<C, CL>(t, ring);
  reg_fence(hb);

  // LayerNorm's statistics; hb becomes hhat
  float inv[2];
  {
    const void* b0 = opaque(v.b0);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 b = vpair(b0, 256 * g + 8 * j + cq, v.bf);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& h0 = hb.d[4 * j + 2 * half];
        float& h1 = hb.d[4 * j + 2 * half + 1];
        h0 = __fadd_rn(h0, b.x);
        h1 = __fadd_rn(h1, b.y);
        s[half] = __fadd_rn(__fadd_rn(s[half], h0), h1);
      }
    }
    mlptile::row_sum(s, t.red(), g, r0);  // also: x and pm read by both warpgroups
    const float mu[2] = {__fmul_rn(s[0], INV_DH), __fmul_rn(s[1], INV_DH)};
    float q[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& h = hb.d[4 * j + 2 * half + e];
          h = __fsub_rn(h, mu[half]);
          q[half] = __fadd_rn(q[half], __fmul_rn(h, h));
        }
    mlptile::row_sum(q, t.red2(), g, r0);
    inv[0] = __frsqrt_rn(__fadd_rn(__fmul_rn(q[0], INV_DH), v.eps));
    inv[1] = __frsqrt_rn(__fadd_rn(__fmul_rn(q[1], INV_DH), v.eps));
  }
  float hh[32];  // hhat of columns 256 g + 8 j + cq + e, j < 8; the rest spilled
#pragma unroll
  for (int i = 0; i < 32; ++i) hh[i] = __fmul_rn(hb.d[i], inv[(i >> 1) & 1]);
#pragma unroll
  for (int i = 0; i < 64; ++i) sx[i * 128] = __fmul_rn(hb.d[32 + i], inv[(i >> 1) & 1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) ss[i * 128] = __fmul_rn(hb.d[96 + i], inv[(i >> 1) & 1]);

  // the tile's column sums of ct: a thread a column, rows in order
  wg::bar_wait(t.bar(C_FULL), it & 1);
  {
    const int c = threadIdx.x;  // 0 .. 255
    const unsigned char* box = t.box(C::CT + (c >> 6));
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < TR; ++r)
      s = __fadd_rn(s, __bfloat162float(*reinterpret_cast<const bf16*>(box + swz(r, 2 * (c & 63)))));
    if (live) v.colsums[(size_t)tile * TILE_SUMS + 4 * 3 * DH + c] = s;
  }

  // dy = ct W3, 256 columns a warpgroup
  Acc<float, 256> dy;
  zero(dy);
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const uint32_t slot = mlptile::next_slot(t, ring);
    issue_mn(dy, a_ct, 64 * k, slot, g, k == 0);
    mlptile::slot_issued<C, CL>(t, ring);
  }
  mlptile::drain<C, CL>(t, ring);
  reg_fence(dy);

  // y, dz and dhhat (in place of dy) in four quarters of 64 columns, one
  // loop whose quarters rotate (quarter k in dy.d[0 .. 31])
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int cb = 256 * g + 64 * k + opaque(cq);  // this thread's first column of the quarter
    const void* lw = opaque(v.ln_w);
    const void* lb = opaque(v.ln_b);
    const float* src = k == 3 ? ss : sx + (k == 2 ? 32 * 128 : 0);  // hhat of quarters 1-3
    bf16* yrow = v.y + (size_t)(t0 + r0) * DH + cb;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {  // two 8-column blocks a round
      float p[8];                       // [jj][q: dz hhat, dz][e], both rows
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * jb + jj;
        const float2 gw = vpair(lw, cb + 8 * j, v.bf);
        const float2 gb = vpair(lb, cb + 8 * j, v.bf);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float yv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            float hv = hh[i];
            if (k) hv = src[i * 128];
            const float gam = e ? gw.y : gw.x;
            const float z = __fmaf_rn(hv, gam, e ? gb.y : gb.x);
            float Phi, phi;
            gelu_parts(z, Phi, phi);
            yv[e] = __fmul_rn(z, Phi);
            const float dz = __fmul_rn(dy.d[i], __fmaf_rn(z, phi, Phi));
            p[4 * jj + e] = __fmaf_rn(dz, hv, p[4 * jj + e]);
            p[4 * jj + 2 + e] = __fadd_rn(p[4 * jj + 2 + e], dz);
            const float dhh = __fmul_rn(dz, gam);
            dy.d[i] = dhh;
            m1[half] = __fadd_rn(m1[half], dhh);
            m2[half] = __fmaf_rn(dhh, hv, m2[half]);
          }
          if (live && t0 + r0 + 8 * half < v.tokens)
            *reinterpret_cast<uint32_t*>(yrow + (size_t)8 * half * DH + 8 * j) =
                proj::pack_bf16_rn(yv[0], yv[1]);
        }
      }
      fold(p);  // lane: block 2 jb + b2, quantity b3, column e = b4
      const int lane = threadIdx.x & 31;
      const int bj = 2 * jb + ((lane >> 2) & 1), q = (lane >> 3) & 1, e = (lane >> 4) & 1;
      if (live) part[q * DH + cb + 8 * bj + e] = p[0];
    }
    rotate_quarter(dy.d);
  }
  row_sum2(m1, m2, t.red(), t.red2(), g, r0);
  const float mean1[2] = {__fmul_rn(m1[0], INV_DH), __fmul_rn(m1[1], INV_DH)};
  const float mean2[2] = {__fmul_rn(m2[0], INV_DH), __fmul_rn(m2[1], INV_DH)};

  // dh, f32, and its column sums; bf16 into the dh tile over x / pm: the
  // blocks whose hhat lies there first (packed), then, once every thread of
  // the warpgroup has read its share, the rest
  {
    const int cg = opaque(cq), rg = opaque(r0);
    uint32_t pk[32];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jb = n < 4 ? 2 + n : (n < 6 ? n - 4 : n);  // blocks 8-23, then 0-7, 24-31
      if (n == 4) {
        group_sync(g);  // the x / pm share of hhat is read: dh goes over it
#pragma unroll
        for (int j = 8; j < 24; ++j) {
          const int c = 256 * g + 8 * j + cg;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(t.box(C::XP + (c >> 6)) + swz(rg + 8 * half, 2 * (c & 63))) =
                pk[2 * (j - 8) + half];
        }
      }
      float p[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jb + jj;
        float d[2][2];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const float hv = i < 32 ? hh[i] : i < 96 ? sx[(i - 32) * 128] : ss[(i - 96) * 128];
            d[half][e] = __fmul_rn(
                __fsub_rn(__fsub_rn(dy.d[i], mean1[half]), __fmul_rn(hv, mean2[half])), inv[half]);
          }
        p[2 * jj] = __fadd_rn(d[0][0], d[1][0]);
        p[2 * jj + 1] = __fadd_rn(d[0][1], d[1][1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t w = proj::pack_bf16_rn(d[half][0], d[half][1]);
          if (n < 4) {
            pk[2 * (j - 8) + half] = w;
          } else {
            const int c = 256 * g + 8 * j + cg;
            *reinterpret_cast<uint32_t*>(t.box(C::XP + (c >> 6)) + swz(rg + 8 * half, 2 * (c & 63))) = w;
          }
        }
      }
      fold(p);  // lane: block 4 jb + 2 b2 + b3, column e = b4
      const int lane = threadIdx.x & 31;
      const int bj = 4 * jb + 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1), e = (lane >> 4) & 1;
      if (live) part[2 * DH + 256 * g + 8 * bj + cg + e] = p[0];
    }
  }
  fence_async_shared();
  group_sync(g);  // this warpgroup's dh complete
  if (t.leader) {
    if (live) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        proj::tma_store(&maps.dh, t.box(C::XP + 4 * g + b), 256 * g + 64 * b, t0);
    }
    proj::store_commit();
  }
  bar_sync(BOTH, CONSUMERS);  // dh complete, the spilled hhat read

  // [dx | dpm] - [ct | 0] = dh W0: warpgroup 0 dx's columns, 1 dpm's
  Acc<float, 256> o;
  zero(o);
#pragma unroll 1
  for (int k = 0; k < 16; ++k) {
    const uint32_t slot = mlptile::next_slot(t, ring);
    issue_mn(o, a_x, 64 * k, slot, g, k == 0);
    mlptile::slot_issued<C, CL>(t, ring);
    if (k == 8) {  // slot 7's products are done: dh's first 256 columns (x's boxes) read
      if (g == 0 && t.leader) proj::store_wait_read();
      release(t.bar(TL::X_EMPTY));
    }
  }
  mlptile::drain<C, CL>(t, ring);
  reg_fence(o);
  if (g == 1 && t.leader) proj::store_wait_read();
  release(t.bar(TL::M_EMPTY));

  // dx = bf16(ct + acc) over ct, dpm = bf16(acc) into the staging boxes
  {
    const int rg = opaque(r0), cg = opaque(cq);
    unsigned char* dst = t.box(g == 0 ? C::CT : C::ST);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + cg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t* p = reinterpret_cast<uint32_t*>(dst + (c >> 6) * ABOX + swz(rg + 8 * half, 2 * (c & 63)));
        float a0 = o.d[4 * j + 2 * half], a1 = o.d[4 * j + 2 * half + 1];
        if (g == 0) {
          const uint32_t u = *p;
          a0 = __fadd_rn(__uint_as_float(u << 16), a0);
          a1 = __fadd_rn(__uint_as_float(u & 0xffff0000u), a1);
        }
        *p = proj::pack_bf16_rn(a0, a1);
      }
    }
  }
  fence_async_shared();
  group_sync(g);
  if (t.leader) {
    if (live) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        proj::tma_store(g == 0 ? &maps.dx : &maps.dpm, t.box((g == 0 ? C::CT : C::ST) + b), 64 * b,
                        t0);
    }
    proj::store_commit();
  }
}

// The token pass: one CTA an SM; the CL CTAs of a cluster walk tile groups
// cluster, + clusters, ... (CL consecutive tiles each, one a CTA).
template <int CL>
__global__ void __launch_bounds__(THREADS, 1)
token_kernel(const __grid_constant__ TokMaps maps, const TokVecs v, int tiles) {
  typedef TokCfg C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = wg::align1024(smem_raw);
  unsigned char* ws = as + TL::WS;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(as + TL::W_FULL);
  uint64_t* w_empty = reinterpret_cast<uint64_t*>(as + TL::W_EMPTY);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(as + TL::X_FULL);
  uint64_t* x_empty = reinterpret_cast<uint64_t*>(as + TL::X_EMPTY);
  uint64_t* m_full = reinterpret_cast<uint64_t*>(as + TL::M_FULL);
  uint64_t* m_empty = reinterpret_cast<uint64_t*>(as + TL::M_EMPTY);
  uint64_t* c_full = reinterpret_cast<uint64_t*>(as + C_FULL);
  uint64_t* c_empty = reinterpret_cast<uint64_t*>(as + C_EMPTY);
  const int groups = (tiles + CL - 1) / CL;
  const int cluster = blockIdx.x / CL, rank = blockIdx.x % CL, clusters = gridDim.x / CL;
  const int n_local = (groups - cluster + clusters - 1) / clusters;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      wg::bar_init(&w_full[s], 1);
      wg::bar_init(&w_empty[s], CONSUMER_WARPS * CL);
    }
    wg::bar_init(x_full, 1);
    wg::bar_init(x_empty, CONSUMER_WARPS);
    wg::bar_init(m_full, 1);
    wg::bar_init(m_empty, CONSUMER_WARPS);
    wg::bar_init(c_full, 1);
    wg::bar_init(c_empty, CONSUMER_WARPS / 2);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (CL > 1) mlptile::cluster_sync();  // every CTA's barriers ready for the others

  if (threadIdx.x >= CONSUMERS) {
    wgw::reg_dealloc<PRODUCER_REGS>();
    if (lane != 0) return;
    if (warp == CONSUMER_WARPS) {  // the weight stream: this CTA's half of each slot's boxes
      int i = 0;
      for (int it = 0; it < n_local; ++it) {
#pragma unroll 1
        for (int s = 0; s < C::NS; ++s, ++i) {
          const int slot = i % C::SLOTS;
          if (i >= C::SLOTS) wg::bar_wait(&w_empty[slot], ((i / C::SLOTS) - 1) & 1);
          wg::bar_expect(&w_full[slot], SLOT);
          unsigned char* dst = ws + slot * SLOT;
          if (s < C::NS_0) {  // h: W0's K columns 32 s .., rows 128 b ..
            for (int b = rank * (4 / CL); b < (rank + 1) * (4 / CL); ++b)
              mlptile::load_box<CL>(dst + b * WBOX, &maps.w0k, 32 * s, 128 * b, &w_full[slot]);
          } else {  // dy: W3's rows, then dx / dpm: W0's, 32 a slot; columns 64 b ..
            const bool w3 = s < C::NS_0 + C::NS_3;
            const int row = 32 * (w3 ? s - C::NS_0 : s - C::NS_0 - C::NS_3);
            for (int b = rank * (8 / CL); b < (rank + 1) * (8 / CL); ++b)
              mlptile::load_box<CL>(dst + b * MBOX, w3 ? &maps.w3n : &maps.w0n, 64 * b, row,
                                    &w_full[slot]);
          }
        }
      }
      // every slot's last hand-back, from each CTA of the cluster, has
      // arrived before this CTA may exit
      for (int k = i > C::SLOTS ? i - C::SLOTS : 0; k < i; ++k)
        wg::bar_wait(&w_empty[k % C::SLOTS], (k / C::SLOTS) & 1);
    } else if (warp == CONSUMER_WARPS + 1) {  // x, pm and ct
      for (int it = 0; it < n_local; ++it) {
        const int tile = (cluster + it * clusters) * CL + rank;
        const int t0 = tile * TR;
        const CUtensorMap* map[3] = {&maps.x, &maps.pm, &maps.ct};
        uint64_t* full[3] = {x_full, m_full, c_full};
        uint64_t* empty[3] = {x_empty, m_empty, c_empty};
        const int first[3] = {C::XP, C::XP + 4, C::CT};
        for (int a = 0; a < 3; ++a) {
          if (it > 0) wg::bar_wait(empty[a], (it - 1) & 1);
          if (tile < tiles) {
            wg::bar_expect(full[a], 4 * ABOX);
            for (int b = 0; b < 4; ++b)
              wg::tma_load(as + (first[a] + b) * ABOX, map[a], 64 * b, t0, 0, full[a]);
          } else {
            wg::bar_arrive(full[a]);
          }
        }
      }
    }
    return;
  }

  wgw::reg_alloc<CONSUMER_REGS>();
  Tile t;
  t.as = as;
  t.g = threadIdx.x >> 7;
  t.r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  t.cq = 2 * (lane & 3);
  t.leader = (threadIdx.x & 127) == 0;
  Ring ring = {0, -1};
  for (int it = 0; it < n_local; ++it) {
    const int tile = (cluster + it * clusters) * CL + rank;
    consume<CL>(t, ring, maps, v, it, tile, tile < tiles);
  }
  if (t.leader) proj::store_wait_all();
}

// ---- the weight-gradient pass

constexpr int WG_THREADS = 288;            // two consumer warpgroups and a producer warp
constexpr int WG_TILES = 12;               // 128 x 256 output tiles: dW0 8, dW3 4
constexpr uint32_t WG_A = 2 * ABOX;        // A stage: 64 tokens x 128 rows of the tile
constexpr uint32_t WG_STAGE = 6 * ABOX;    // and B: 64 tokens x 256 columns
constexpr int WG_STAGES = 4;
constexpr size_t WG_SMEM = 1024 + WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8;

// dh, y [tokens, 512] and x, pm, ct [tokens, 256] bf16 in 64 x 64 boxes
struct GradMaps {
  CUtensorMap dh, x, pm, ct, y;
};

// CTA (tile, split): rows 128 mt .. of dW0 (tiles 0-7: mt = tile / 2, its
// columns x's (nt 0) or pm's (nt 1)) or of dW3 (tiles 8-11), columns 256
// nt .., summed over the tokens of 64-token blocks [lo, hi) of the split.
__global__ void __launch_bounds__(WG_THREADS, 1)
weight_kernel(const __grid_constant__ GradMaps maps, float* __restrict__ partial, int tokens,
              int splits) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st = wg::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(st + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int tile = blockIdx.x % WG_TILES, split = blockIdx.x / WG_TILES;
  const bool w0 = tile < 8;
  const int mt = (w0 ? tile : tile - 8) >> 1, nt = tile & 1;
  const CUtensorMap* ma = w0 ? &maps.dh : &maps.ct;
  const CUtensorMap* mb = w0 ? (nt ? &maps.pm : &maps.x) : &maps.y;
  const int b_col = w0 ? 0 : 256 * nt;
  const int nb = (tokens + TR - 1) / TR;
  const int lo = (int)((long long)split * nb / splits), hi = (int)((long long)(split + 1) * nb / splits);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one lane issues
    if (lane != 0) return;
    for (int i = 0, kb = lo; kb < hi; ++i, ++kb) {
      const int s = i % WG_STAGES;
      if (i >= WG_STAGES) wg::bar_wait(&empty[s], ((i / WG_STAGES) - 1) & 1);
      unsigned char* dst = st + s * WG_STAGE;
      wg::bar_expect(&full[s], WG_STAGE);
      for (int b = 0; b < 2; ++b) wg::tma_load(dst + b * ABOX, ma, 128 * mt + 64 * b, TR * kb, 0, &full[s]);
      for (int b = 0; b < 4; ++b)
        wg::tma_load(dst + WG_A + b * ABOX, mb, b_col + 64 * b, TR * kb, 0, &full[s]);
    }
    return;
  }

  // consumers: warpgroup g owns rows 64 g .. 64 g + 63 of the tile
  const int g = threadIdx.x >> 7;
  Acc<float, 256> acc;
  zero(acc);
  wg::mma_fence();
  int held = -1;
  const uint32_t base = wg::saddr(st);
  for (int i = 0, kb = lo; kb < hi; ++i, ++kb) {
    const int s = i % WG_STAGES;
    wg::bar_wait(&full[s], (i / WG_STAGES) & 1);
    wg::mma_fence();
    const uint32_t a = base + s * WG_STAGE;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mma_t<1, 1>(acc, desc_mn(a + g * ABOX, ABOX) + e * ROW16, desc_mn(a + WG_A, ABOX) + e * ROW16, 1);
    wg::mma_commit();
    wgw::mma_wait_group<1>();
    if (held >= 0) release(&empty[held]);
    held = s;
  }
  wgw::mma_wait_group<0>();
  reg_fence(acc);
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float* out = partial + (size_t)split * (W0_ELEMS + W3_ELEMS) + (w0 ? 0 : W0_ELEMS) +
               (size_t)(128 * mt + 64 * g + r0) * 512 + 256 * nt + cq;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (size_t)8 * half * 512 + 8 * j) =
          make_float2(acc.d[4 * j + 2 * half], acc.d[4 * j + 2 * half + 1]);
}

// The weight gradients' splits added in split order (a thread an element,
// blocks 0 .. WB - 1), and the column sums (the blocks after, 32 columns a
// block): warp w adds tiles w, w + 8, ... in order (each tile's four warps
// first), then thread c of warp 0 adds the eight warps' sums in order.
constexpr int RED_THREADS = 256;
constexpr int WB = (W0_ELEMS + W3_ELEMS + RED_THREADS - 1) / RED_THREADS;

__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ colsums,
              int tiles, float* __restrict__ dw0, float* __restrict__ dw3,
              float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ db0,
              float* __restrict__ db3) {
  constexpr int W = W0_ELEMS + W3_ELEMS;
  if (blockIdx.x < WB) {
    const int i = blockIdx.x * RED_THREADS + threadIdx.x;
    if (i >= W) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * W + i];
    if (i < W0_ELEMS)
      dw0[i] = s;
    else
      dw3[i - W0_ELEMS] = s;
    return;
  }
  __shared__ float warp_sums[RED_THREADS / 32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = (blockIdx.x - WB) * 32 + lane;
  float s = 0.f;
  if (c < NCOL) {
    for (int k = w; k < tiles; k += RED_THREADS / 32) {
      const float* p = colsums + (size_t)k * TILE_SUMS;
      s += c < 3 * DH ? ((p[c] + p[3 * DH + c]) + p[6 * DH + c]) + p[9 * DH + c] : p[9 * DH + c];
    }
  }
  warp_sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || c >= NCOL) return;
  s = warp_sums[0][lane];
#pragma unroll
  for (int k = 1; k < RED_THREADS / 32; ++k) s += warp_sums[k][lane];
  if (c < DH)
    dgamma[c] = s;
  else if (c < 2 * DH)
    dbeta[c - DH] = s;
  else if (c < 3 * DH)
    db0[c - 2 * DH] = s;
  else
    db3[c - 3 * DH] = s;
}

// ---- host

// a map over the weight [rows, cols] bf16 whose box is 32 rows of 64
// columns, 128-byte swizzled: the MN-major B boxes
inline bool make_mn_map(CUtensorMap* map, const void* w, int rows, int cols) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 32};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mlpbwd

}  // namespace

// Scratch the caller allocates: y, dh [tokens, 512] bf16; colsums
// [ceil(tokens / 64), 4 * 3 * 512 + 256] f32 (each tile's column sums by
// warp, then ct's); partial [splits, 512 * 512 + 256 *
// 512] f32. vec_bf16: b0, ln_w, ln_b are bf16 (else f32).
extern "C" int pram_residual_mlp_bwd(
    const void* x, const void* pm, const void* ct, const void* w0,
    const void* b0, const void* ln_w, const void* ln_b, const void* w3,
    void* dx, void* dpm, void* dw0, void* db0, void* dln_w, void* dln_b,
    void* dw3, void* db3, void* y, void* dh, void* colsums, void* partial,
    int tokens, int splits, int vec_bf16, float eps, void* stream) {
  using namespace mlpbwd;
  if (tokens <= 0 || tokens % 32 != 0 || splits < 1 ||
      ((uintptr_t)x | (uintptr_t)pm | (uintptr_t)ct | (uintptr_t)w0 | (uintptr_t)w3 |
       (uintptr_t)dx | (uintptr_t)dpm | (uintptr_t)y | (uintptr_t)dh) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const size_t n = (size_t)tokens;
  TokMaps tm;
  GradMaps gm;
  if (!wg::make_map(&tm.x, x, D, tokens, 1, D, n * D) ||
      !wg::make_map(&tm.pm, pm, D, tokens, 1, D, n * D) ||
      !wg::make_map(&tm.ct, ct, D, tokens, 1, D, n * D) ||
      !wg::make_map(&tm.dx, dx, D, tokens, 1, D, n * D) ||
      !wg::make_map(&tm.dpm, dpm, D, tokens, 1, D, n * D) ||
      !wg::make_map(&tm.dh, dh, DH, tokens, 1, DH, n * DH) ||
      !wg::make_map(&gm.y, y, DH, tokens, 1, DH, n * DH) ||
      !mlptile::make_weight_map(&tm.w0k, w0, DH, DH, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2) ||
      !make_mn_map(&tm.w0n, w0, DH, DH) || !make_mn_map(&tm.w3n, w3, D, DH))
    return (int)cudaErrorInvalidValue;
  gm.dh = tm.dh;
  gm.x = tm.x;
  gm.pm = tm.pm;
  gm.ct = tm.ct;
  const int tiles = (tokens + TR - 1) / TR;
  const TokVecs v = {b0, ln_w, ln_b, vec_bf16, eps, (bf16*)y, (float*)colsums, tokens};
  constexpr int CL = TokCfg::CLUSTER;
  static int resident = 0;  // clusters of the token pass resident on the card at once
  int err = mlptile::launch_persistent<CL>(token_kernel<CL>, TOKEN_SMEM, (tiles + CL - 1) / CL,
                                           resident, s, tm, v, tiles);
  if (err != 0) return err;
  err = wg::launch(weight_kernel, dim3(WG_TILES * splits), WG_THREADS, WG_SMEM, s, gm,
                   (float*)partial, tokens, splits);
  if (err != 0) return err;
  reduce_kernel<<<WB + (NCOL + 31) / 32, RED_THREADS, 0, s>>>(
      (const float*)partial, splits, (const float*)colsums, tiles, (float*)dw0, (float*)dw3,
      (float*)dln_w, (float*)dln_b, (float*)db0, (float*)db3);
  return (int)cudaGetLastError();
}
