// Per-row int8 quantization of a 64-token tile in shared memory, for
// Hopper: _quant_rows (pram_tpu/ops/mlp_pallas.py) of a bf16 tile held as
// TMA's 128-byte-swizzled boxes, into the 128-byte-swizzled K-major s8
// layout that wgmma reads, with the f32 <-> integer roundings done by the
// magic-number trick. Shared by kernel 17's s8 projection pass
// (proj_int8.cu) and the s8 residual-MLP tile (mlp_tile.cuh, kernel 16).

#pragma once

#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

namespace q8 {

using wg::TILE_BYTES;                   // a 64 x 64 bf16 box of the input
constexpr uint32_t QBOX = wg::TR * 128;  // 64 s8 rows of 128 bytes, 8 KB

// 1.5 * 2^23: x + MAGIC, rounded to nearest even, holds round(x) in its low
// mantissa bits for |x| < 2^22, and MAGIC's bits plus such an integer are
// the float MAGIC + it: conversions between f32 and integers in the FMA and
// integer units (the conversion unit issues a quarter as fast)
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// float(acc), exact for |acc| < 2^22 (an s32 sum over a depth of 256:
// |acc| <= 127^2 * 256)
__device__ __forceinline__ float int_to_f32(int acc) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + acc), MAGIC);
}

// float((acc * rs) * ws + b), each product and the sum rounded once
__device__ __forceinline__ float dequant(int acc, float rs, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(int_to_f32(acc), rs), ws), b);
}

// _quant_rows of the tile's rows w + 8 i (i = 0..7) by warp w (0..7),
// four rows a pass: 8 lanes a row, lane p of them holding the row's 32
// columns 32 p .. 32 p + 31 (half p % 2 of x's 64-column box p / 2). rs =
// max(max|x|, 1e-6) / 127 and 1 / rs by true divisions, q =
// round-half-even(x * (1 / rs)) (ops/quant.py:quant_rows' arithmetic), the
// row's max over its 8 lanes by three shuffles. x comes from the bf16 tile `xs`
// (four 64-column swizzled boxes), the s8 rows go to `q` (two 128-byte
// swizzled boxes), rs to `rs_out`. Each lane walks its four 16-byte chunks
// starting at chunk i % 4, so that one load (or store) of the warp spreads
// over every bank: without it all rows of a warp (r % 8 == w) would hit the
// same chunk.
__device__ __forceinline__ void quant_tile_rows(const unsigned char* xs,
                                                unsigned char* q,
                                                float* rs_out, int w) {
  const int lane = threadIdx.x & 31;
  const int p = lane & 7, box = p >> 1, hb = 4 * (p & 1);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int i = pass * 4 + (lane >> 3);
    const int r = w + 8 * i;
    const unsigned char* src = xs + box * TILE_BYTES + r * 128;
    float v[4][8], m = 0.f;
    int ch[4];  // bf16 chunk (8 columns) of the box row
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ch[c] = hb + ((c + i) & 3);
      const uint4 raw = *reinterpret_cast<const uint4*>(src + ((ch[c] ^ w) << 4));
      const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bf16 -> f32 is a shift
        v[c][2 * e] = __uint_as_float(h[e] << 16);
        v[c][2 * e + 1] = __uint_as_float(h[e] & 0xffff0000u);
        m = fmaxf(m, fmaxf(fabsf(v[c][2 * e]), fabsf(v[c][2 * e + 1])));
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float rs = __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
    const float inv = __fdiv_rn(1.0f, rs);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t b[8];  // round(v * inv) + MAGIC's bits: q in the low byte
#pragma unroll
      for (int e = 0; e < 8; ++e)
        b[e] = __float_as_uint(__fadd_rn(__fmul_rn(v[c][e], inv), MAGIC));
      const int at = 64 * box + 8 * ch[c];  // byte of the s8 row
      *reinterpret_cast<uint2*>(q + (at >> 7) * QBOX + r * 128 +
                                ((((at >> 4) & 7) ^ w) << 4) + (at & 8)) =
          make_uint2(__byte_perm(__byte_perm(b[0], b[1], 0x0040),
                                 __byte_perm(b[2], b[3], 0x0040), 0x5410),
                     __byte_perm(__byte_perm(b[4], b[5], 0x0040),
                                 __byte_perm(b[6], b[7], 0x0040), 0x5410));
    }
    if (p == 0) rs_out[r] = rs;
  }
}

}  // namespace q8

}  // namespace
