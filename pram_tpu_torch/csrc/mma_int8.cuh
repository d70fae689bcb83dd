// Warp-level pieces of the int8 MLP kernel (16): the s8 mma.sync
// instruction and the per-row quantizer.
//
// s8 m16n8k32 reads its operands in 32-byte K chunks: lane (g = lane / 4,
// t = lane % 4) holds bytes 4t and 16 + 4t of a chunk of A's rows g and
// g + 8 and of B's column g, and the accumulator's rows g and g + 8,
// columns 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma8 {

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r and r + 8 (ld bytes apart) at K byte offset k
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* row,
                                       int ld, int k) {
  a[0] = ld32(row + k);
  a[1] = ld32(row + 8 * ld + k);
  a[2] = ld32(row + k + 16);
  a[3] = ld32(row + 8 * ld + k + 16);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// _quant_rows (pram_tpu/ops/mlp_pallas.py) of one row whose PER values each
// lane holds: rs = max(max|v|, 1e-6) / 127, q = round-half-even(v * (1 /
// rs)), no clip; every division a true f32 division. Returns rs.
template <int PER>
__device__ __forceinline__ float quant_row(const float (&v)[PER], int8_t (&q)[PER]) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) m = fmaxf(m, fabsf(v[i]));
  const float rs = __fdiv_rn(fmaxf(warp_max(m), 1e-6f), 127.0f);
  const float inv = __fdiv_rn(1.0f, rs);
#pragma unroll
  for (int i = 0; i < PER; ++i) q[i] = (int8_t)__float2int_rn(__fmul_rn(v[i], inv));
  return rs;
}

// _quant_rows of a 256-wide bf16 row `src` (16-byte aligned) by one warp,
// 8 values a lane, into 256 s8 at `dst` (8-byte aligned). Returns rs.
__device__ __forceinline__ float quant_row256(const __nv_bfloat16* src, unsigned char* dst) {
  const int lane = threadIdx.x & 31;
  const uint4 raw = *reinterpret_cast<const uint4*>(src + lane * 8);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  int8_t q[8];
  const float rs = quant_row<8>(v, q);
  uint2 packed = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    packed.x |= (uint32_t)(uint8_t)q[i] << (8 * i);
    packed.y |= (uint32_t)(uint8_t)q[4 + i] << (8 * i);
  }
  *reinterpret_cast<uint2*>(dst + lane * 8) = packed;
  return rs;
}

}  // namespace mma8
