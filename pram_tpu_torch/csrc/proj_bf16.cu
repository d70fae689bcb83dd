// The bf16 projection pass of kernels 1 and 5, for Hopper: out = bf16(x W^T
// + b), with the rotary encoding of q and k in its epilogue for kernel 1.
//
// Replaces the projection half of pram_tpu/ops/attention_pallas.py:
// fused_self_attention_proj (_self_proj_kernel: the qkv scratch, then the
// rotary of q and k) and fused_cross_attention_proj (_cross_proj_kernel:
// the qk and v scratch). The TPU kernels project a whole frame into VMEM
// inside the attention program; a Hopper CTA cannot hold a frame's
// projection (GML: 1536 x 768 bf16 = 2.4 MB), so the projection is its own
// launch into a scratch tensor that the wgmma message pass
// (attention_wgmma.cuh:message_cta) reads next on the same stream.
//
// What bounds it: bytes. Kernel 1 at GML's 32 x 1536 tokens reads x (25.2
// MB) and cos / sin (25.2 MB) and writes qkv (75.5 MB): 0.038 ms at 3.35
// TB/s, against 19.3 GFLOP, 0.020 ms on the tensor cores. Kernel 5 reads x
// and writes qk and v: 75.5 MB, 0.023 ms.
//
// Design: one persistent CTA a SM. A CTA owns a slice of 128 output
// columns, whose weight rows (64 KB) it loads once by TMA and keeps in
// shared memory, and walks over 64-token tiles, which a producer warp
// streams in by TMA through a ring of two stages: the x tile (32 KB) and,
// on the q and k columns, the tile's cos and sin rows (32 KB, f32 in
// 128-byte-swizzled 32-column boxes). The two consumer warpgroups share
// every tile, one 64-column block each: wgmma m64n64k16 over sixteen
// k-steps, x and W both K-major in 128-byte-swizzled 64 x 64 boxes. The
// epilogue (proj_epilogue.cuh, shared with kernel 17's s8 pass) stays in
// registers: the bias (the slice's, kept in shared memory) in f32, one
// rounding to bf16 and, on the q and k columns, the rotary in f32 from
// that bf16 value. cos and sin (twice x's bytes) come by TMA with x: read
// by 8-byte loads in the epilogue instead, they kept the warpgroups
// waiting on the load unit. The bf16 blocks go to shared memory in the
// swizzled layout and out by TMA stores. The CTAs of one tile index and
// different slices are neighbours in blockIdx, so they read the same x
// tiles at about the same time and all but the first read hit L2.
//
// Layouts: x [tokens, 256] bf16; w [n_out, 256] bf16 (torch Linear layout,
// its rows already in the order the consumer reads: kernel 1's [q heads |
// k heads | v heads] blocks, kernel 5's [to_qk | to_v]); b [n_out] f32;
// cos, sin [tokens, 64] f32 (read only with rotary). Output column c goes to
// out0[token, c] for c < split (row length split) and to out1[token, c -
// split] otherwise (row length n_out - split). Columns c < rot_cols are
// rotated, pair index c % 64 within the head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "proj_epilogue.cuh"

namespace {

using proj::CS_BOX;
using proj::CS_BYTES;
using proj::CW;
using proj::D;
using wg::HD;
using wg::TILE_BYTES;
using wg::TR;
typedef __nv_bfloat16 bf16;

constexpr int KB = D / HD;               // 64-column boxes along the input
constexpr int NC = 2 * HD;               // output columns of a CTA
constexpr int STAGES = 2;                // ring of x (and cos / sin) tiles
constexpr int WG_THREADS = 128;
constexpr uint32_t X_BYTES = KB * TILE_BYTES;       // one 64-token x tile
constexpr uint32_t W_BYTES = 2 * KB * TILE_BYTES;   // the CTA's weight slice
constexpr size_t SMEM = 1024 + W_BYTES + STAGES * (X_BYTES + CS_BYTES) +
                        2 * TILE_BYTES + NC * sizeof(float) +
                        (2 * STAGES + 1) * sizeof(uint64_t);

struct Maps {  // [1, rows, cols] views: x, w, out0, out1 (bf16), cos, sin (f32)
  CUtensorMap x, w, out0, out1, cos, sin;
};

__global__ void __launch_bounds__(wg::THREADS, 1)
proj_kernel(const __grid_constant__ Maps maps, const float* __restrict__ bias,
            int tiles, int slices, int split, int rot_cols) {
  extern __shared__ unsigned char smem_raw[];
  const int slice = blockIdx.x % slices;
  const int first = blockIdx.x / slices, step = gridDim.x / slices;
  const int n_local = first < tiles ? (tiles - first + step - 1) / step : 0;
  if (n_local == 0) return;
  const int col0 = slice * NC;
  const bool rotary = col0 < rot_cols;

  unsigned char* sm = wg::align1024(smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(sm);
  bf16* Xs = reinterpret_cast<bf16*>(sm + W_BYTES);
  unsigned char* CSs = sm + W_BYTES + STAGES * X_BYTES;
  unsigned char* Os = CSs + STAGES * CS_BYTES;
  float* Bs = reinterpret_cast<float*>(Os + 2 * TILE_BYTES);  // the slice's bias
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + NC);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], wg::CONSUMER_WARPS);
    }
    wg::bar_init(wbar, 1);
    wg::bar_init_fence();
  }
  for (int i = threadIdx.x; i < NC; i += blockDim.x) Bs[i] = bias[col0 + i];
  __syncthreads();

  if (threadIdx.x >= wg::CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == wg::CONSUMERS) {
      wg::bar_expect(wbar, W_BYTES);
      for (int nb = 0; nb < NC / HD; ++nb)
        for (int kb = 0; kb < KB; ++kb)
          wg::tma_load(Ws + (nb * KB + kb) * TR * HD, &maps.w, kb * HD,
                       col0 + nb * HD, 0, wbar);
      for (int it = 0; it < n_local; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) wg::bar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const int t0 = (first + it * step) * TR;
        wg::bar_expect(&full[s], X_BYTES + (rotary ? CS_BYTES : 0));
        for (int kb = 0; kb < KB; ++kb)
          wg::tma_load(Xs + (s * KB + kb) * TR * HD, &maps.x, kb * HD, t0, 0,
                       &full[s]);
        if (rotary) {
          unsigned char* cs = CSs + s * CS_BYTES;
          for (int b = 0; b < HD / CW; ++b) {
            wg::tma_load(cs + b * CS_BOX, &maps.cos, b * CW, t0, 0, &full[s]);
            wg::tma_load(cs + (2 + b) * CS_BOX, &maps.sin, b * CW, t0, 0,
                         &full[s]);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup g takes the slice's 64-column block g of every tile
  const int g = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);
  const bool leader = (threadIdx.x & (WG_THREADS - 1)) == 0;
  unsigned char* Og = Os + g * TILE_BYTES;
  const bf16* Wg = Ws + g * KB * TR * HD;
  const float* Bg = Bs + g * HD;

  wg::bar_wait(wbar, 0);
  for (int it = 0; it < n_local; ++it) {
    const int s = it % STAGES;
    const int t0 = (first + it * step) * TR;
    wg::bar_wait(&full[s], (it / STAGES) & 1);
    wg::Acc acc;
    wg::mma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint64_t da = wg::desc(Xs + (s * KB + kb) * TR * HD);
      const uint64_t db = wg::desc(Wg + kb * TR * HD);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        wg::mma_ss(acc, da + k * wg::DESC_K_STEP, db + k * wg::DESC_K_STEP,
                   kb | k);
    }
    wg::mma_commit();
    wg::mma_wait();
    wg::reg_fence(acc);

    if (leader) proj::store_wait_read();  // the last tile's block has left
    proj::group_sync(g);
    proj::stage_blocks<1>(
        [&](int, int half, int j) {
          const float2 bb = *reinterpret_cast<const float2*>(Bg + 8 * j + cq);
          return make_float2(acc.d[4 * j + 2 * half] + bb.x,
                             acc.d[4 * j + 2 * half + 1] + bb.y);
        },
        rotary, CSs + s * CS_BYTES, Og);
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[s]);  // x, cos and sin of s read
    proj::fence_async_shared();
    proj::group_sync(g);
    if (leader) {
      proj::store_block(&maps.out0, &maps.out1, Og, col0 + g * HD, t0, split);
      proj::store_commit();
    }
  }
  if (leader) proj::store_wait_all();
}

}  // namespace

// x [tokens, 256] bf16; w [n_out, 256] bf16; b [n_out] f32; cos, sin
// [tokens, 64] f32 or null without rotary; out0 [tokens, split] and out1
// [tokens, n_out - split] bf16 (out1 unused when split == n_out). tokens a
// multiple of 64, n_out and rot_cols of 128, split of 64; every pointer
// 16-byte aligned.
extern "C" int pram_project_bf16(const void* x, const void* w, const void* b,
                                 const void* cos, const void* sin, void* out0,
                                 void* out1, long long tokens, int n_out,
                                 int split, int rot_cols, void* stream) {
  if (tokens <= 0 || tokens % TR || tokens > 0x7fffffffll || n_out <= 0 ||
      n_out % NC || split <= 0 || split % HD || split > n_out ||
      rot_cols < 0 || rot_cols % NC || rot_cols > n_out ||
      (rot_cols > 0 && (cos == nullptr || sin == nullptr)) ||
      (split < n_out && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const int tiles = (int)(tokens / TR), slices = n_out / NC;
  int step = 0;
  if (!proj::make_io_maps(maps, x, cos, sin, out0, out1, (int)tokens, n_out,
                          split, rot_cols) ||
      !wg::make_map(&maps.w, w, D, n_out, 1, D, (size_t)n_out * D))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = proj::persistent_grid(slices, tiles, &step))
    return (int)err;
  return wg::launch(proj_kernel, dim3(slices * step), wg::THREADS, SMEM,
                    (cudaStream_t)stream, maps, (const float*)b, tiles, slices,
                    split, rot_cols);
}
