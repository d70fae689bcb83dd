// The residual concat-MLP tile for Hopper, shared by kernel 2 (csrc/mlp.cu:
// bf16 x bf16 -> f32) and kernel 16 (csrc/mlp_int8.cu: s8 x s8 -> s32):
//   y = x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3
// at d = 256, hidden 512. It replaces pram_tpu/ops/mlp_pallas.py:
// _mlp_kernel (fused_residual_mlp) and _mlp_kernel_i8
// (fused_residual_mlp_int8).
//
// What bounds it: in principle the tensor cores (0.92 M operations a token
// against 1 KB of activations: 45 G at 49152 tokens, 0.046 ms in bf16 at
// 989 TFLOP/s, 0.023 ms in s8), in practice the weights' way from L2 into
// shared memory. A 64-token tile needs every weight (0.92 MB in bf16, 0.46
// MB in s8), and a 64 x 512 f32 hidden row block is all the registers two
// warpgroups can hold, so no CTA can take more tokens at once. The design
// therefore streams the weights through a ring of shared-memory slots by
// TMA, uses each slot once for a whole tile, and in bf16 lets the two CTAs
// of a cluster share each slot: each loads two of a slot's four boxes and
// multicasts them to both (Cfg::CLUSTER). L2 bytes a call: tokens / 64 /
// CLUSTER x 917,504 (bf16) or 458,752 (s8) of weights, plus x and msg read
// once and y written once (1.5 KB a token): at GML's 49152 tokens 352 MB of
// weights in either type against 75.5 MB of activations. In s8 a cluster
// did not pay: its tile spends more of its time in epilogues.
//
// A CTA (384 threads, one an SM, persistent) walks 64-token tiles. Every
// intermediate stays in shared memory, in the 128-byte-swizzled K-major
// layout the wgmma descriptors read (64-row boxes of 128 bytes): x (TMA;
// W0's first input half and the residual), msg (TMA), proj(msg) (over msg
// once both warpgroups have read it; the concat [x, proj(msg)] is never
// built: W0's two input halves accumulate into the same registers) and the
// GELU tile that feeds W3. In s8, msg and x are quantized per row into s8
// tiles (q8::quant_tile_rows, kernel 17's quantizer), proj(msg) and the
// GELU output in the epilogues from registers. Only y leaves, by TMA store.
//   - Warp 8, one lane: the weight stream. A slot is four boxes of 128
//     weight rows x 64 bytes of K (torch's [out, in] layout is the K-major B
//     operand), 64-byte swizzled, 32 KB: Wp's and W3's slots hold two K
//     slices of both 128-row halves, W0's one K slice of its 512 rows (s8:
//     two K slices of the 256 rows of one of its two passes, below).
//   - Warp 9, one lane: the tile's x and msg (64 x 64 boxes), each as soon
//     as the last tile's copy is free, so they arrive during the products.
//   - Warpgroups 0 and 1 (240 registers each by setmaxnreg, the producer
//     warpgroup keeps 24: 256 x 240 + 128 x 24 = 384 x 168) split every
//     product's N: proj(msg) and y 128 columns each (m64n128), the hidden
//     layer 256 columns each (bf16: m64n256k16, 128 f32 accumulators a
//     thread; s8: its x and proj(msg) halves need their own s32
//     accumulators, (acc_x * rs_x) + (acc_pm * rs_pm), so two passes of 128
//     columns, m64n128k32). One product group stays in flight while the next
//     slot is awaited; a slot goes back to every CTA of the cluster once the
//     group that read it has completed. 0 bytes spilled takes two habits:
//     every accumulator is zeroed before its first product (else the asm's
//     read of it keeps the last tile's registers live across the tile
//     loop), and the parameter vectors and the shared-memory offsets are
//     taken from opaque copies where they are used (else they are hoisted
//     out of the tile loop). The GELU runs as a loop over two halves of
//     the row block, which halves its code: unrolled, the s8 kernel
//     outgrew the instruction cache and its LayerNorm took twice the bf16
//     one's time.
//   - LayerNorm needs whole 512-wide rows: each warpgroup sums its 256
//     columns of a row (a thread's 64 values in column order, then over its
//     quad by xor 1, 2), the two halves meet in shared memory behind a named
//     barrier (warpgroup 0's + warpgroup 1's), mu = sum / 512; the centred
//     squares the same way; s8's row maxima of |proj(msg)| and |GELU| too.
//
// Rounding follows the TPU kernels, every product and sum rounded once (no
// FMA): bf16 proj(msg) = bf16(acc + bp); h = acc + b0; LayerNorm in f32,
// inv = RN(1 / sqrt(var + eps)); hn = ((h - mu) * inv) * ln_w + ln_b; GELU =
// (hn * 0.5) * (1 + erf(hn * sqrt(1/2))), to bf16 (s8: quantized from f32);
// out = bf16(x + bf16(acc + b3)). s8 dequantizes in csrc/mlp_int8.cu's
// order: pm = bf16((acc * rs_msg) * wps + bp), h = ((acc_x * rs_x) + (acc_pm
// * rs_pm)) * w0s + b0, out = bf16(x + bf16((acc * rs_y) * w3s + b3)).
// No atomics: two launches on the same inputs give the same bits.
//
// Tokens need not fill the last tile: TMA zero-fills its missing rows and
// the store drops them. The cluster's CTAs walk tiles in lockstep (the
// weight stream is shared), so a CTA whose last tile is past the end runs
// it on stale data and stores nothing.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "proj_epilogue.cuh"
#include "quant_rows.cuh"
#include "wgmma_wide.cuh"

namespace {

namespace mlptile {

typedef __nv_bfloat16 bf16;
using wg::TR;  // tokens of a tile
using wgw::Acc;
using wgw::mma;
using wgw::mma_wait_group;
using wgw::reg_alloc;
using wgw::reg_dealloc;
using wgw::reg_fence;

constexpr int D = 256;   // model width
constexpr int DH = 512;  // hidden width
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
static_assert(CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS == THREADS * 168,
              "setmaxnreg hands registers only within the CTA's launch allocation");
constexpr uint32_t ABOX = TR * 128;  // an activation box: 64 rows of 128 bytes
constexpr uint32_t WBOX = 128 * 64;  // a weight box: 128 rows of 64 bytes
constexpr uint32_t SLOT = 4 * WBOX;  // a ring slot
constexpr int BOTH = 3;              // named barrier of both warpgroups (1, 2: each)
constexpr float INV_DH = 1.f / DH;

// Shared memory in activation boxes, then the ring: bf16 x (4 boxes), msg
// and then proj(msg) (4), the GELU tile (8), 3 slots; s8: bf16 x and msg,
// then one region for the s8 x and msg / proj(msg) tiles (2 + 2 boxes) or
// the s8 GELU tile (4), 4 slots. The output is staged in the GELU region.
template <typename In> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int ESZ = 2;
  static constexpr int NS_P = 4, NS_0 = 16, NS_3 = 8;  // slots of Wp, W0, W3 a tile
  static constexpr int NS = NS_P + NS_0 + NS_3;
  static constexpr int X = 0, M = 4, G = 8, BOXES = 16, SLOTS = 3, RS = 0;
  static constexpr int CLUSTER = 2;  // CTAs sharing each weight slot
};
template <> struct Cfg<int8_t> {
  static constexpr int ESZ = 1;
  static constexpr int NS_P = 2, NS_0 = 8, NS_3 = 4;
  static constexpr int NS = NS_P + NS_0 + NS_3;
  static constexpr int X = 0, M = 4, XQ = 8, MQ = 10, G = 8, BOXES = 12, SLOTS = 4;
  static constexpr int RS = 2 * TR;  // row scales of msg and x
  static constexpr int CLUSTER = 1;
};

// byte offsets from the 1024-aligned base of shared memory: the activation
// boxes, the ring, the exchange arrays red and red2 ([2][64] f32 each), the
// s8 row scales of msg and x, the barriers
template <typename C>
struct Layout {
  static constexpr uint32_t WS = C::BOXES * ABOX;
  static constexpr uint32_t RED = WS + C::SLOTS * SLOT;
  static constexpr uint32_t RED2 = RED + 2 * TR * 4;
  static constexpr uint32_t RS = RED2 + 2 * TR * 4;
  static constexpr uint32_t W_FULL = RS + C::RS * 4;
  static constexpr uint32_t W_EMPTY = W_FULL + C::SLOTS * 8;
  static constexpr uint32_t X_FULL = W_EMPTY + C::SLOTS * 8;
  static constexpr uint32_t X_EMPTY = X_FULL + 8;
  static constexpr uint32_t M_FULL = X_FULL + 16;
  static constexpr uint32_t M_EMPTY = X_FULL + 24;
  static constexpr size_t BYTES = 1024 + M_EMPTY + 8;  // with the alignment's slack
};
static_assert(Layout<Cfg<bf16>>::BYTES <= 232448 && Layout<Cfg<int8_t>>::BYTES <= 232448,
              "shared memory of one CTA");

// what a consumer thread keeps of its CTA: the aligned base (every buffer
// and barrier is a constant offset from it, so none holds a register) and
// its place in the accumulators (warpgroup g, rows r0 and r0 + 8, columns
// cq and cq + 1 of each 8-column block)
template <typename C>
struct Tile {
  unsigned char* as;
  int g, r0, cq;
  bool leader;
  template <typename T>
  __device__ __forceinline__ T* at(uint32_t off) const {
    return reinterpret_cast<T*>(as + off);
  }
  __device__ __forceinline__ uint64_t* bar(uint32_t off) const { return at<uint64_t>(off); }
  __device__ __forceinline__ unsigned char* box(int b) const { return as + b * ABOX; }
  __device__ __forceinline__ float* red() const { return at<float>(Layout<C>::RED); }
  __device__ __forceinline__ float* red2() const { return at<float>(Layout<C>::RED2); }
  __device__ __forceinline__ float* rs() const { return at<float>(Layout<C>::RS); }
};

// x, msg, out: [1, tokens, 256] bf16 in 64 x 64 boxes; wp, w0, w3: [rows, K]
// weights in 128-row x 64-byte boxes
struct Maps {
  CUtensorMap x, msg, out, w[3];
};

// f32 vectors (the scales only in s8) and LayerNorm's eps
struct Vecs {
  const float *bp, *b0, *ln_w, *ln_b, *b3, *wps, *w0s, *w3s;
  float eps;
};

// ---- device: the weight stream

// Box b (0..3) of slot s of a tile (Wp's slots, then W0's, then W3's): its
// weight (0 wp, 1 w0, 2 w3), first row and first K byte. Wp and W3: K slice
// kk = b / 2 of the slot, rows 128 (b % 2) (warpgroup b % 2's); W0 in bf16:
// one K slice, rows 128 b (warpgroup b / 2's); W0 in s8: pass s / 4 takes
// rows 256 h + 128 (s / 4), h = b % 2 (warpgroup h's), slot s % 4 of the
// pass two K slices.
template <typename C>
__device__ __forceinline__ void box_of(int s, int b, int& w, int& row, int& kb) {
  const int kk = b >> 1, h = b & 1;
  w = 0;
  if (s >= C::NS_P) {
    s -= C::NS_P;
    w = 1;
    if (s >= C::NS_0) {
      s -= C::NS_0;
      w = 2;
    }
  }
  if (w == 1 && C::ESZ == 2) {
    row = 128 * b;
    kb = 64 * s;
  } else if (w == 1) {
    row = 256 * h + 128 * (s >> 2);
    kb = 128 * (s & 3) + 64 * kk;
  } else {
    row = 128 * h;
    kb = 128 * s + 64 * kk;
  }
}

// one weight box at {K element c0, row c1} into every CTA of the cluster
template <int CL>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  if (CL == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(wg::saddr(dst)),
        "l"((uint64_t)map), "r"(wg::saddr(bar)), "r"(c0), "r"(c1)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(wg::saddr(dst)),
        "l"((uint64_t)map), "r"(wg::saddr(bar)), "r"(c0), "r"(c1),
        "h"((uint16_t)((1u << CL) - 1))
        : "memory");
  }
}

// An arrival on the barrier at the same offset in CTA `cta` of the cluster.
// It hands back a slot that only the products read (complete once their
// group is waited for), so it publishes nothing and needs no cluster-scope
// release; with .release.cluster the kernel took twice as long.
__device__ __forceinline__ void arrive_at(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [a];\n}" ::"r"(wg::saddr(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// a warp's hand-back of a slot to every CTA of the cluster
template <int CL>
__device__ __forceinline__ void hand_back(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    if (CL == 1) {
      wg::bar_arrive(bar);
    } else {
#pragma unroll
      for (int c = 0; c < CL; ++c) arrive_at(bar, c);
    }
  }
}

// a warp's hand-back of a local buffer (x, msg)
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wg::bar_arrive(bar);
}

// ---- device: the products

// B: a weight box, K-major, 64-byte swizzle (8-row groups 512 bytes apart)
__device__ __forceinline__ uint64_t desc_w(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// A: K byte kb of an activation tile of 128-byte boxes starting at `tile`
// (128-byte swizzle, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int kb) {
  const uint32_t addr = tile + (uint32_t)(kb >> 7) * ABOX;
  return ((uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62)) +
         (uint64_t)((kb & 127) >> 4);
}

// the consumers' walk over the ring: slots taken, the one still read by the
// group in flight (-1: none)
struct Ring {
  int i, held;
};

// Waits for the ring's next slot and fences the products about to read it;
// returns the slot's shared address.
template <typename C>
__device__ __forceinline__ uint32_t next_slot(const Tile<C>& t, Ring& r) {
  typedef Layout<C> L;
  wg::bar_wait(t.bar(L::W_FULL) + r.i % C::SLOTS, (r.i / C::SLOTS) & 1);
  wg::mma_fence();
  return wg::saddr(t.as + L::WS) + (r.i % C::SLOTS) * SLOT;
}

// Commits the products issued on the slot as one group and hands the
// previous slot back once its group has completed: one group stays in
// flight while the next slot is awaited.
template <typename C, int CL>
__device__ __forceinline__ void slot_issued(const Tile<C>& t, Ring& r) {
  wg::mma_commit();
  mma_wait_group<1>();
  if (r.held >= 0) hand_back<CL>(t.bar(Layout<C>::W_EMPTY) + r.held);
  r.held = r.i % C::SLOTS;
  ++r.i;
}

template <typename C, int CL>
__device__ __forceinline__ void drain(const Tile<C>& t, Ring& r) {
  mma_wait_group<0>();
  hand_back<CL>(t.bar(Layout<C>::W_EMPTY) + r.held);
  r.held = -1;
}

// Zeroes an accumulator before its first product. The first product
// overwrites it anyway, but an accumulator declared in the tile loop and
// never written before would otherwise carry the last tile's registers into
// the next (the asm reads its operands), and all of them would stay live
// across the whole loop.
template <typename T, int N>
__device__ __forceinline__ void zero(Acc<T, N>& c) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c.d[i] = 0;
}

// Wp's or W3's products over a slot: warpgroup g's 128 rows of both K
// slices, A from `tile` at the slot's K bytes 128 k ..
template <typename T>
__device__ __forceinline__ void issue_half(Acc<T, 128>& acc, uint32_t tile, uint32_t slot,
                                           int k, int g, bool first) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      mma(acc, desc_a(tile, 128 * k + 64 * kk + 32 * t),
          desc_w(slot + (2 * kk + g) * WBOX) + 2 * t, !(first && kk == 0 && t == 0));
}

// ---- device: the epilogues

// A pointer or an int as a value the compiler cannot see through. The
// parameter vectors and a thread's shared-memory offsets do not change
// across tiles: loads from the plain pointers, and the offsets and
// addresses computed from them, would be hoisted out of the tile loop and
// held in registers (or spilled), more of them than a thread has. Taken
// from an opaque copy at the start of an epilogue, they are computed where
// they are used.
__device__ __forceinline__ const float* opaque(const float* p) {
  asm volatile("" : "+l"(p));
  return p;
}
__device__ __forceinline__ const void* opaque(const void* p) {
  asm volatile("" : "+l"(p));
  return p;
}
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// elements i and i + 1 of a vector (8-byte aligned)
__device__ __forceinline__ float2 pair(const float* p, int i) {
  return *reinterpret_cast<const float2*>(p + i);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// byte offset of byte b of row r in a 64-row box, 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return (uint32_t)(r * 128 + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15));
}

// the low bytes of two s8 words (round(v) + MAGIC's bits) as 16 bits
__device__ __forceinline__ uint16_t pack2(uint32_t b0, uint32_t b1) {
  return (uint16_t)__byte_perm(b0, b1, 0x0040);
}

__device__ __forceinline__ uint32_t quant_bits(float v, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv), q8::MAGIC));
}

// Rows r0 and r0 + 8 of the thread: its per-row values s summed over its
// quad, then warpgroup 0's + warpgroup 1's (through red [2][64]).
__device__ __forceinline__ void row_sum(float (&s)[2], float* red, int g, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 1));
    s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 2));
  }
  if ((threadIdx.x & 3) == 0) {
    red[g * TR + r0] = s[0];
    red[g * TR + r0 + 8] = s[1];
  }
  proj::bar_sync(BOTH, CONSUMERS);
  s[0] = __fadd_rn(red[r0], red[TR + r0]);
  s[1] = __fadd_rn(red[r0 + 8], red[TR + r0 + 8]);
}

// the same with max
__device__ __forceinline__ void row_max(float (&m)[2], float* red, int g, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  if ((threadIdx.x & 3) == 0) {
    red[g * TR + r0] = m[0];
    red[g * TR + r0 + 8] = m[1];
  }
  proj::bar_sync(BOTH, CONSUMERS);
  m[0] = fmaxf(red[r0], red[TR + r0]);
  m[1] = fmaxf(red[r0 + 8], red[TR + r0 + 8]);
}

// _quant_rows' scale of a row whose max |v| is m, and its reciprocal
__device__ __forceinline__ float2 row_scale(float m) {
  const float rs = __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
  return make_float2(rs, __fdiv_rn(1.0f, rs));
}

// Swaps the two 64-value halves of h: a loop that is not unrolled works on
// h[0 .. 63] and swaps at the end of each of its two rounds, so its body
// (and the instruction cache) holds half the code of an unrolled one.
__device__ __forceinline__ void swap_halves(float (&h)[128]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float x = h[i];
    h[i] = h[64 + i];
    h[64 + i] = x;
  }
}

// LayerNorm over the 512 hidden columns and the exact GELU, in place:
// h[4 j + 2 half + e] is hidden column 256 g + 8 j + cq + e of row r0 + 8
// half (j < 32). red, red2: [2][64] f32 exchange arrays.
__device__ __forceinline__ void layer_norm_gelu(float (&h)[128], int g, int r0, int cq,
                                                const Vecs& v, float* red, float* red2) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s[half] = __fadd_rn(s[half], h[4 * j + 2 * half]);
      s[half] = __fadd_rn(s[half], h[4 * j + 2 * half + 1]);
    }
  row_sum(s, red, g, r0);
  const float mu[2] = {__fmul_rn(s[0], INV_DH), __fmul_rn(s[1], INV_DH)};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = __fsub_rn(h[4 * j + 2 * half + e], mu[half]);
        h[4 * j + 2 * half + e] = d;
        q[half] = __fadd_rn(q[half], __fmul_rn(d, d));
      }
  row_sum(q, red2, g, r0);
  const float inv[2] = {__frsqrt_rn(__fadd_rn(__fmul_rn(q[0], INV_DH), v.eps)),
                        __frsqrt_rn(__fadd_rn(__fmul_rn(q[1], INV_DH), v.eps))};
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {  // columns 256 g + 128 k .., in h[0 .. 63]
    const float* ln_w = opaque(v.ln_w) + 256 * g + 128 * k + cq;
    const float* ln_b = opaque(v.ln_b) + 256 * g + 128 * k + cq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 lw = pair(ln_w, 8 * j);
      const float2 lb = pair(ln_b, 8 * j);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = h[4 * j + 2 * half + e];
          const float hn = __fadd_rn(__fmul_rn(__fmul_rn(x, inv[half]), e ? lw.y : lw.x),
                                     e ? lb.y : lb.x);
          x = __fmul_rn(__fmul_rn(hn, 0.5f),
                        __fadd_rn(1.f, erff(__fmul_rn(hn, 0.70710678118654752f))));
        }
    }
    swap_halves(h);
  }
}

// The output of rows r0, r0 + 8 and warpgroup g's 128 columns: o[4 j + 2
// half + e] is the f32 of bf16(W3's sum + b3) of column 128 g + 8 j + cq +
// e; bf16(x + it) is staged in boxes `stage`, `stage` + 1 and stored by TMA
// (nothing for a tile past the end). Hands x back.
__device__ __forceinline__ void store_out(const float (&o)[64], const unsigned char* xs,
                                          unsigned char* stage, uint64_t* x_empty,
                                          const CUtensorMap* out, int g, int r0, int cq,
                                          int t0, bool live) {
  r0 = opaque(r0);
  cq = opaque(cq);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 128 * g + 8 * j + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const uint32_t xb = *reinterpret_cast<const uint32_t*>(xs + (c >> 6) * ABOX +
                                                               swz(r, 2 * (c & 63)));
      const float x0 = __uint_as_float(xb << 16), x1 = __uint_as_float(xb & 0xffff0000u);
      *reinterpret_cast<uint32_t*>(stage + (j >> 3) * ABOX + swz(r, 2 * (c & 63))) =
          proj::pack_bf16_rn(__fadd_rn(x0, o[4 * j + 2 * half]),
                             __fadd_rn(x1, o[4 * j + 2 * half + 1]));
    }
  }
  release(x_empty);
  proj::fence_async_shared();
  proj::group_sync(g);
  if ((threadIdx.x & 127) == 0) {
    if (live) {
#pragma unroll
      for (int n = 0; n < 2; ++n) proj::tma_store(out, stage + n * ABOX, 128 * g + 64 * n, t0);
    }
    proj::store_commit();
  }
}

// ---- the consumers


// bf16: proj(msg) over msg, the hidden layer, GELU, y
template <int CL>
__device__ __forceinline__ void consume(const Tile<Cfg<bf16>>& t, Ring& ring, const Maps& maps,
                                        const Vecs& v, int it, int t0, bool live) {
  typedef Cfg<bf16> C;
  typedef Layout<C> L;
  const uint32_t a_x = wg::saddr(t.box(C::X)), a_m = wg::saddr(t.box(C::M)),
                 a_g = wg::saddr(t.box(C::G));
  const int g = t.g, r0 = t.r0, cq = t.cq;

  // proj(msg), 128 columns a warpgroup
  Acc<float, 128> pa;
  zero(pa);
  wg::bar_wait(t.bar(L::M_FULL), it & 1);
#pragma unroll 1
  for (int k = 0; k < C::NS_P; ++k) {
    const uint32_t slot = next_slot(t, ring);
    issue_half(pa, a_m, slot, k, g, k == 0);
    slot_issued<C, CL>(t, ring);
  }
  drain<C, CL>(t, ring);
  reg_fence(pa);
  proj::bar_sync(BOTH, CONSUMERS);  // msg read by both: proj(msg) goes over it
  const float* bp = opaque(v.bp) + 128 * g + cq;
  const int rp = opaque(r0), cp = opaque(cq);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 128 * g + 8 * j + cp;
    const float2 b = pair(bp, 8 * j);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(t.box(C::M + (c >> 6)) +
                                   swz(rp + 8 * half, 2 * (c & 63))) =
          proj::pack_bf16_rn(__fadd_rn(pa.d[4 * j + 2 * half], b.x),
                             __fadd_rn(pa.d[4 * j + 2 * half + 1], b.y));
  }
  proj::fence_async_shared();

  // the hidden layer, 256 columns a warpgroup: x's half, then proj(msg)'s
  Acc<float, 256> hb;
  zero(hb);
  wg::bar_wait(t.bar(L::X_FULL), it & 1);
#pragma unroll 1
  for (int k = 0; k < C::NS_0 / 2; ++k) {
    const uint32_t slot = next_slot(t, ring);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mma(hb, desc_a(a_x, 64 * k + 32 * e), desc_w(slot + 2 * g * WBOX) + 2 * e, k | e);
    slot_issued<C, CL>(t, ring);
  }
  proj::bar_sync(BOTH, CONSUMERS);  // proj(msg) complete
#pragma unroll 1
  for (int k = 0; k < C::NS_0 / 2; ++k) {
    const uint32_t slot = next_slot(t, ring);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mma(hb, desc_a(a_m, 64 * k + 32 * e), desc_w(slot + 2 * g * WBOX) + 2 * e, 1);
    slot_issued<C, CL>(t, ring);
  }
  drain<C, CL>(t, ring);
  reg_fence(hb);
  release(t.bar(L::M_EMPTY));  // msg / proj(msg) free for the next tile's msg
  const float* b0 = opaque(v.b0) + 256 * g + cq;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 b = pair(b0, 8 * j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      hb.d[4 * j + 2 * half] = __fadd_rn(hb.d[4 * j + 2 * half], b.x);
      hb.d[4 * j + 2 * half + 1] = __fadd_rn(hb.d[4 * j + 2 * half + 1], b.y);
    }
  }
  layer_norm_gelu(hb.d, g, r0, cq, v, t.red(), t.red2());
  if (t.leader) proj::store_wait_read();  // this warpgroup's last output has left
  proj::group_sync(g);
  const int rg = opaque(r0), cg = opaque(cq);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 256 * g + 8 * j + cg;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(t.box(C::G + (c >> 6)) +
                                   swz(rg + 8 * half, 2 * (c & 63))) =
          proj::pack_bf16_rn(hb.d[4 * j + 2 * half], hb.d[4 * j + 2 * half + 1]);
  }
  proj::fence_async_shared();
  proj::bar_sync(BOTH, CONSUMERS);  // the GELU tile complete

  // y, 128 columns a warpgroup
  Acc<float, 128> ya;
  zero(ya);
#pragma unroll 1
  for (int k = 0; k < C::NS_3; ++k) {
    const uint32_t slot = next_slot(t, ring);
    issue_half(ya, a_g, slot, k, g, k == 0);
    slot_issued<C, CL>(t, ring);
  }
  drain<C, CL>(t, ring);
  reg_fence(ya);
  proj::bar_sync(BOTH, CONSUMERS);  // the GELU tile read by both: the output goes over it
  const float* b3 = opaque(v.b3) + 128 * g + cq;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = pair(b3, 8 * j);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ya.d[4 * j + 2 * half] = bf16_round(__fadd_rn(ya.d[4 * j + 2 * half], b.x));
      ya.d[4 * j + 2 * half + 1] = bf16_round(__fadd_rn(ya.d[4 * j + 2 * half + 1], b.y));
    }
  }
  store_out(ya.d, t.box(C::X), t.box(C::G + 4 * g), t.bar(L::X_EMPTY), &maps.out, g,
            r0, cq, t0, live);
}

// s8: msg and x quantized per row, proj(msg) over msg's s8 tile, the hidden
// layer in two passes, the s8 GELU tile over both s8 tiles, y
template <int CL>
__device__ __forceinline__ void consume(const Tile<Cfg<int8_t>>& t, Ring& ring, const Maps& maps,
                                        const Vecs& v, int it, int t0, bool live) {
  typedef Cfg<int8_t> C;
  typedef Layout<C> L;
  const uint32_t a_xq = wg::saddr(t.box(C::XQ)), a_mq = wg::saddr(t.box(C::MQ)),
                 a_g = wg::saddr(t.box(C::G));
  const int g = t.g, r0 = t.r0, cq = t.cq;
  const int warp = threadIdx.x >> 5;

  if (t.leader) proj::store_wait_read();  // the last output has left the s8 region
  proj::bar_sync(BOTH, CONSUMERS);
  wg::bar_wait(t.bar(L::M_FULL), it & 1);
  q8::quant_tile_rows(t.box(C::M), t.box(C::MQ), t.rs(), warp);
  release(t.bar(L::M_EMPTY));  // msg free for the next tile's
  proj::fence_async_shared();
  proj::bar_sync(BOTH, CONSUMERS);

  // proj(msg), 128 columns a warpgroup; x is quantized meanwhile
  Acc<int, 128> pa;
  zero(pa);
#pragma unroll 1
  for (int k = 0; k < C::NS_P; ++k) {
    const uint32_t slot = next_slot(t, ring);
    issue_half(pa, a_mq, slot, k, g, k == 0);
    slot_issued<C, CL>(t, ring);
  }
  wg::bar_wait(t.bar(L::X_FULL), it & 1);
  q8::quant_tile_rows(t.box(C::X), t.box(C::XQ), t.rs() + TR, warp);
  proj::fence_async_shared();
  drain<C, CL>(t, ring);
  reg_fence(pa);
  float pm[64], m[2] = {0.f, 0.f};
  {
    const float rs[2] = {t.rs()[r0], t.rs()[r0 + 8]};
    const float* wps = opaque(v.wps) + 128 * g + cq;
    const float* bp = opaque(v.bp) + 128 * g + cq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 w = pair(wps, 8 * j);
      const float2 b = pair(bp, 8 * j);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          pm[i] = bf16_round(q8::dequant(pa.d[i], rs[half], e ? w.y : w.x, e ? b.y : b.x));
          m[half] = fmaxf(m[half], fabsf(pm[i]));
        }
    }
  }
  row_max(m, t.red(), g, r0);  // also: msg's s8 tile read by both, x's complete
  const float2 sp[2] = {row_scale(m[0]), row_scale(m[1])};
  const int rp = opaque(r0), cp = opaque(cq);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 128 * g + 8 * j + cp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<uint16_t*>(t.box(C::MQ + (c >> 7)) + swz(rp + 8 * half, c & 127)) =
          pack2(quant_bits(pm[i], sp[half].y), quant_bits(pm[i + 1], sp[half].y));
    }
  }
  proj::fence_async_shared();
  const float rx[2] = {t.rs()[TR + r0], t.rs()[TR + r0 + 8]};

  // the hidden layer: pass q takes columns 256 g + 128 q .. + 127, into
  // h[0 .. 63], then swaps it into h[64 .. 127] (unrolled: as a loop, the
  // pass-0 values and both accumulators spill)
  float h[128];
  Acc<int, 128> ax, ap;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    zero(ax);
    zero(ap);
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const uint32_t slot = next_slot(t, ring);
      issue_half(ax, a_xq, slot, k, g, k == 0);
      slot_issued<C, CL>(t, ring);
    }
    if (q == 0) proj::bar_sync(BOTH, CONSUMERS);  // proj(msg)'s s8 tile complete
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const uint32_t slot = next_slot(t, ring);
      issue_half(ap, a_mq, slot, k, g, k == 0);
      slot_issued<C, CL>(t, ring);
    }
    drain<C, CL>(t, ring);
    reg_fence(ax);
    reg_fence(ap);
    const float* w0s = opaque(v.w0s) + 256 * g + 128 * q + cq;
    const float* b0 = opaque(v.b0) + 256 * g + 128 * q + cq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 w = pair(w0s, 8 * j);
      const float2 b = pair(b0, 8 * j);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float s = __fadd_rn(
              __fmul_rn(q8::int_to_f32(ax.d[i]), rx[half]),
              __fmul_rn(q8::int_to_f32(ap.d[i]), sp[half].x));
          h[i] = __fadd_rn(__fmul_rn(s, e ? w.y : w.x), e ? b.y : b.x);
        }
    }
    swap_halves(h);
  }
  layer_norm_gelu(h, g, r0, cq, v, t.red(), t.red2());
  m[0] = m[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], fabsf(h[i]));
  row_max(m, t.red(), g, r0);  // also: both s8 tiles read by both
  const float2 sy[2] = {row_scale(m[0]), row_scale(m[1])};
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {  // columns 256 g + 128 k .., in h[0 .. 63]
    const int rg = opaque(r0), cg = opaque(cq);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 256 * g + 128 * k + 8 * j + cg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<uint16_t*>(t.box(C::G + (c >> 7)) + swz(rg + 8 * half, c & 127)) =
            pack2(quant_bits(h[i], sy[half].y), quant_bits(h[i + 1], sy[half].y));
      }
    }
    swap_halves(h);
  }
  proj::fence_async_shared();
  proj::bar_sync(BOTH, CONSUMERS);  // the s8 GELU tile complete

  // y, 128 columns a warpgroup
  Acc<int, 128> ya;
  zero(ya);
#pragma unroll 1
  for (int k = 0; k < C::NS_3; ++k) {
    const uint32_t slot = next_slot(t, ring);
    issue_half(ya, a_g, slot, k, g, k == 0);
    slot_issued<C, CL>(t, ring);
  }
  drain<C, CL>(t, ring);
  reg_fence(ya);
  proj::bar_sync(BOTH, CONSUMERS);  // the s8 GELU tile read by both: the output goes over it
  float o[64];
  const float* w3s = opaque(v.w3s) + 128 * g + cq;
  const float* b3 = opaque(v.b3) + 128 * g + cq;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 w = pair(w3s, 8 * j);
    const float2 b = pair(b3, 8 * j);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * half + e;
        o[i] = bf16_round(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(ya.d[i]), sy[half].x), e ? w.y : w.x),
            e ? b.y : b.x));
      }
  }
  store_out(o, t.box(C::X), t.box(C::G + 2 * g), t.bar(L::X_EMPTY), &maps.out, g, r0,
            cq, t0, live);
}

// ---- the kernel

// One CTA an SM; the CL CTAs of a cluster walk tile groups cluster, +
// clusters, ... (CL consecutive tiles each, one a CTA).
template <typename In, int CL>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const __grid_constant__ Maps maps, const Vecs v, int tiles) {
  typedef Cfg<In> C;
  typedef Layout<C> L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = wg::align1024(smem_raw);
  unsigned char* ws = as + L::WS;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(as + L::W_FULL);
  uint64_t* w_empty = reinterpret_cast<uint64_t*>(as + L::W_EMPTY);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(as + L::X_FULL);
  uint64_t* x_empty = reinterpret_cast<uint64_t*>(as + L::X_EMPTY);
  uint64_t* m_full = reinterpret_cast<uint64_t*>(as + L::M_FULL);
  uint64_t* m_empty = reinterpret_cast<uint64_t*>(as + L::M_EMPTY);
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
    wg::bar_init_fence();
  }
  __syncthreads();
  if (CL > 1) cluster_sync();  // every CTA's barriers ready for the others

  if (threadIdx.x >= CONSUMERS) {
    reg_dealloc<PRODUCER_REGS>();
    if (lane != 0) return;
    if (warp == CONSUMER_WARPS) {  // the weight stream
      int i = 0;
      for (int it = 0; it < n_local; ++it) {
#pragma unroll 1
        for (int s = 0; s < C::NS; ++s, ++i) {
          const int slot = i % C::SLOTS;
          if (i >= C::SLOTS) wg::bar_wait(&w_empty[slot], ((i / C::SLOTS) - 1) & 1);
          wg::bar_expect(&w_full[slot], SLOT);
#pragma unroll
          for (int b = rank * (4 / CL); b < (rank + 1) * (4 / CL); ++b) {
            int w, row, kb;
            box_of<C>(s, b, w, row, kb);
            load_box<CL>(ws + slot * SLOT + b * WBOX, &maps.w[w], kb / C::ESZ, row, &w_full[slot]);
          }
        }
      }
      // every slot's last hand-back, from each CTA of the cluster, has
      // arrived before this CTA may exit
      for (int k = i > C::SLOTS ? i - C::SLOTS : 0; k < i; ++k)
        wg::bar_wait(&w_empty[k % C::SLOTS], (k / C::SLOTS) & 1);
    } else if (warp == CONSUMER_WARPS + 1) {  // msg and x
      for (int it = 0; it < n_local; ++it) {
        const int tile = (cluster + it * clusters) * CL + rank;
        const int t0 = tile * TR;
        if (it > 0) wg::bar_wait(m_empty, (it - 1) & 1);
        if (tile < tiles) {
          wg::bar_expect(m_full, 4 * ABOX);
          for (int b = 0; b < 4; ++b)
            wg::tma_load(as + (C::M + b) * ABOX, &maps.msg, 64 * b, t0, 0, m_full);
        } else {
          wg::bar_arrive(m_full);
        }
        if (it > 0) wg::bar_wait(x_empty, (it - 1) & 1);
        if (tile < tiles) {
          wg::bar_expect(x_full, 4 * ABOX);
          for (int b = 0; b < 4; ++b)
            wg::tma_load(as + (C::X + b) * ABOX, &maps.x, 64 * b, t0, 0, x_full);
        } else {
          wg::bar_arrive(x_full);
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  Tile<C> t;
  t.as = as;
  t.g = threadIdx.x >> 7;
  t.r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  t.cq = 2 * (lane & 3);
  t.leader = (threadIdx.x & 127) == 0;
  Ring ring = {0, -1};
  for (int it = 0; it < n_local; ++it) {
    const int tile = (cluster + it * clusters) * CL + rank;
    consume<CL>(t, ring, maps, v, it, tile * TR, tile < tiles);
  }
  if (t.leader) proj::store_wait_all();
}

// ---- host

// a map over the weight [rows, k] (element type `type`, esz bytes) whose box
// is 128 rows of 64 bytes, 64-byte swizzled
inline bool make_weight_map(CUtensorMap* map, const void* w, int rows, int k,
                            CUtensorMapDataType type, int esz) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(64 / esz), 128};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(w), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A persistent grid of clusters of CL CTAs of THREADS threads and `smem`
// bytes over `groups` groups of CL tiles: as many clusters as fit on the
// card at once (`resident`, the caller's, found at its first launch), at
// most one a group. Shared with the residual-MLP backward (mlp_bwd.cu).
template <int CL, typename... P, typename... A>
int launch_persistent(void (*kernel)(P...), size_t smem, int groups, int& resident,
                      cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident == 0) {
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(CL * (groups < resident ? groups : resident));
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the persistent grid of clusters of CL CTAs over `tiles` 64-token tiles
template <typename In, int CL>
int launch_tiles(const Maps& maps, const Vecs& v, int tiles, cudaStream_t stream) {
  static int resident = 0;  // clusters resident on the card at once
  return launch_persistent<CL>(mlp_kernel<In, CL>, Layout<Cfg<In>>::BYTES, (tiles + CL - 1) / CL,
                               resident, stream, maps, v, tiles);
}

// x, msg, out [tokens, 256] bf16; wp [256, 256], w0 [512, 512] (input
// columns [x | proj(msg)]), w3 [256, 512] of type In; every pointer 16-byte
// aligned. Launches on `stream`; 0 or a CUDA error.
template <typename In>
int launch(const void* x, const void* msg, const void* wp, const void* w0, const void* w3,
           const Vecs& v, void* out, int tokens, cudaStream_t stream) {
  typedef Cfg<In> C;
  if (tokens <= 0 || ((uintptr_t)x | (uintptr_t)msg | (uintptr_t)out | (uintptr_t)wp |
                      (uintptr_t)w0 | (uintptr_t)w3) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType wt =
      C::ESZ == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const size_t n = (size_t)tokens;
  Maps maps;
  if (!wg::make_map(&maps.x, x, D, tokens, 1, D, n * D) ||
      !wg::make_map(&maps.msg, msg, D, tokens, 1, D, n * D) ||
      !wg::make_map(&maps.out, out, D, tokens, 1, D, n * D) ||
      !make_weight_map(&maps.w[0], wp, D, D, wt, C::ESZ) ||
      !make_weight_map(&maps.w[1], w0, DH, DH, wt, C::ESZ) ||
      !make_weight_map(&maps.w[2], w3, D, DH, wt, C::ESZ))
    return (int)cudaErrorInvalidValue;
  return launch_tiles<In, C::CLUSTER>(maps, v, (tokens + TR - 1) / TR, stream);
}

}  // namespace mlptile

}  // namespace
