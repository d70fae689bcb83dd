// The epilogue of the projection passes, for Hopper: shared by the bf16 pass
// of kernels 1 and 5 (csrc/proj_bf16.cu) and the s8 pass of kernel 17
// (csrc/proj_int8.cu).
//
// Both passes hold a 64-token tile's projection as wgmma accumulators of
// 64 x 64 column blocks (attention_wgmma.cuh: lane l of warp w holds rows
// 16 w + l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1 of each 8-column
// block j). The epilogue turns a block's f32 values (the pass's own
// dequantization and bias, given as a functor) into bf16 in registers: one
// rounding to bf16 and, on the q and k columns, the rotary in f32 from that
// bf16 value, each product and sum rounded once (__fmul_rn / __fadd_rn, no
// fma: the arithmetic of attention_qkv.cu:rotate_kernel and of the plain
// version). The rotation pairs columns (2t, 2t + 1), which one thread
// holds, so it needs no shuffle; one conversion instruction rounds a pair.
// A block of 64 columns is one head: its
// rotary index is the column within the block. cos and sin come with the
// tile by TMA, f32 in 128-byte-swizzled boxes of 32 columns. The bf16
// block goes to a 64 x 64 staging box in shared memory, 128-byte swizzled
// (conflict-free), and out by a TMA store of whole 128-byte rows.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

namespace proj {

using wg::HD;
using wg::TR;

constexpr int D = 256;                    // input width of both passes
constexpr int CW = 32;                    // f32 columns of a cos / sin box
constexpr uint32_t CS_BOX = CW * TR * 4;  // 32 x 64 f32, 8 KB
constexpr uint32_t CS_BYTES = 4 * CS_BOX; // cos, sin of a 64-token tile

// A map over [1, rows, 64] f32 (cos or sin) whose box is 64 rows of 32
// columns (128 bytes), 128-byte swizzled.
inline bool make_map_f32(CUtensorMap* map, const void* base, int rows) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {HD * sizeof(float),
                                 (cuuint64_t)rows * HD * sizeof(float)};
  const cuuint32_t box[3] = {CW, TR, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps a pass shares (its Maps holds x, out0, out1, cos, sin): x
// [rows, 256] bf16, out0 [rows, split] and out1 [rows, n_out - split] bf16
// (out1 only when split < n_out), cos and sin [rows, 64] f32 (only with
// rotary; else x stands in). False if a map cannot be encoded.
template <typename Maps>
inline bool make_io_maps(Maps& maps, const void* x, const void* cos,
                         const void* sin, void* out0, void* out1, int rows,
                         int n_out, int split, int rot_cols) {
  const size_t n = (size_t)rows;
  if (!wg::make_map(&maps.x, x, D, rows, 1, D, n * D) ||
      !wg::make_map(&maps.out0, out0, split, rows, 1, split, n * split))
    return false;
  maps.out1 = maps.out0;
  maps.cos = maps.sin = maps.x;
  if (rot_cols > 0 &&
      (!make_map_f32(&maps.cos, cos, rows) || !make_map_f32(&maps.sin, sin, rows)))
    return false;
  return split == n_out ||
         wg::make_map(&maps.out1, out1, n_out - split, rows, 1, n_out - split,
                      n * (n_out - split));
}

// The persistent grid: `slices` column slices, each walked by *step CTAs
// (the SMs shared out, at most one a tile); *step is set on success.
inline cudaError_t persistent_grid(int slices, int tiles, int* step) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int per_slice = sms / slices < 1 ? 1 : sms / slices;
  *step = per_slice < tiles ? per_slice : tiles;
  return cudaSuccess;
}

// one 64 x 64 box of src (shared, swizzled) to {col, row} of map
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"((uint64_t)map),
      "r"(wg::saddr(src)), "r"(col), "r"(row), "r"(0)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// waits until the committed stores have read their shared memory
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// waits until the committed stores are complete
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// makes this thread's shared-memory writes visible to the async proxy (TMA
// stores, wgmma operands)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` (0 is __syncthreads') over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// barrier over the 128 threads of consumer warpgroup g (ids 1 and 2)
__device__ __forceinline__ void group_sync(int g) { bar_sync(g + 1, 128); }

// (lo, hi) rounded to bf16 (ties to even), packed as __nv_bfloat162's bits:
// one conversion instruction for the pair
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of element (r, c) in a 64 x 64 bf16 box, 128-byte swizzle
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2);
}

// byte offset of f32 element (r, e) of a 64-row tile held as two 32-column
// boxes, 128-byte swizzle
__device__ __forceinline__ uint32_t swizzled_f32(int r, int e) {
  const int c = e & (CW - 1);
  return (uint32_t)((e / CW) * CS_BOX + r * 128 + (((c >> 2) ^ (r & 7)) << 4) +
                    (c & 3) * 4);
}

// NB 64 x 64 output blocks of a consumer warpgroup into the staging boxes
// out + n * TILE_BYTES: value(n, half, j) is block n's f32 pair (columns 8 j
// + 2 (l % 4) and + 1, row 16 w + l / 4 + 8 half) before the rounding; with
// rotary it is rotated by the tile's cos / sin `cs` (CS_BYTES: cos boxes,
// then sin), which every block (head) shares: each pair of them is read
// once for the NB blocks.
template <int NB, typename Value>
__device__ __forceinline__ void stage_blocks(Value value, bool rotary,
                                             const unsigned char* cs,
                                             unsigned char* out) {
  const int lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 c = make_float2(0.f, 0.f), sv = c;
      if (rotary) {
        const uint32_t at = swizzled_f32(r, 8 * j + cq);
        c = *reinterpret_cast<const float2*>(cs + at);
        sv = *reinterpret_cast<const float2*>(cs + 2 * CS_BOX + at);
      }
      const uint32_t o = swizzled(r, 8 * j + cq);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float2 v = value(n, half, j);
        if (rotary) {  // from the rounded projection
          const uint32_t pr = pack_bf16_rn(v.x, v.y);
          const float v0 = __uint_as_float(pr << 16);
          const float v1 = __uint_as_float(pr & 0xffff0000u);
          v.x = __fadd_rn(__fmul_rn(v0, c.x), __fmul_rn(-v1, sv.x));
          v.y = __fadd_rn(__fmul_rn(v1, c.y), __fmul_rn(v0, sv.y));
        }
        *reinterpret_cast<uint32_t*>(out + n * wg::TILE_BYTES + o) =
            pack_bf16_rn(v.x, v.y);
      }
    }
  }
}

// sends the staged block of output column c (a multiple of 64) and the
// tile's first token t0 to out0 (c < split) or out1 (at c - split)
__device__ __forceinline__ void store_block(const CUtensorMap* out0,
                                            const CUtensorMap* out1,
                                            const void* src, int c, int t0,
                                            int split) {
  if (c < split)
    tma_store(out0, src, c, t0);
  else
    tma_store(out1, src, c - split, t0);
}

}  // namespace proj

}  // namespace
