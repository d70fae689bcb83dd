// The s8 projection pass of kernel 17, for Hopper: out = bf16((acc * rs) *
// ws + b), acc the exact s32 product of x quantized per row and the weights
// quantized per output column, with the rotary encoding of q and k in its
// epilogue for the self-attention form.
//
// Replaces the projection half of pram_tpu/ops/attention_pallas.py:
// _self_proj_kernel_i8 and _cross_proj_kernel_i8 (fused_self_attention_proj
// / fused_cross_attention_proj with int8=True): x is quantized per row
// (_quant_rows: rs = max(max|x|, 1e-6) / 127 by a true f32 division, q =
// round-half-even(x * (1 / rs)), no clip), the weights per output column
// (once, by the wrapper), the product is exact in s32 (|acc| <= 127^2 * 256
// < 2^22, so float(acc) is exact too), and bf16((acc * rs) * ws + b), each
// product and sum rounded once, goes to the projection scratch; the
// self-attention's q and k are then rotated as the bf16 pass rotates them
// (proj_epilogue.cuh). The TPU kernels project a whole frame into VMEM
// inside the attention program; here the projection is its own launch into
// a scratch tensor, followed on the same stream by the wgmma message pass:
// kernel 12's rotated pass for the self-attention
// (attention_qkv.cu:pram_self_attention_rotated, as kernel 1 runs it), kernel
// 11's for the cross-attention (cross_attention.cu:pram_cross_attention_tail).
//
// What bounds it: bytes. The self-attention's projection at GML's 32 x 1536
// tokens reads x (25.2 MB) and cos / sin (25.2 MB) and writes qkv (75.5
// MB): 0.038 ms at 3.35 TB/s, against 19.3 G s8 operations, 0.010 ms at
// 1979 TOP/s. The cross-attention's reads x and writes qk and v: 75.5 MB,
// 0.023 ms.
//
// Design: the bf16 pass's (proj_bf16.cu), with the quantization inside.
// One persistent CTA a SM owns a slice of 256 output columns, whose s8
// weight rows (64 KB, the bytes of the bf16 pass's 128-column slice) it
// loads once by TMA and keeps in shared memory with their scales and
// biases, and walks over 64-token tiles. The slice's width halves the
// times each x tile is read from L2 and quantized (3 for the
// self-attention's 768 columns, 2 for the cross-attention's 512; 128
// columns a CTA, with twice the quantization, was slower). A producer warp
// streams the tiles in by TMA: the bf16 x tile (32 KB, one buffer, freed
// as soon as it is quantized, so the next tile's comes during this one's
// products and epilogue) and, on the q and k columns, the tile's cos and
// sin rows (32 KB, a ring of two, freed after the epilogue). The two
// consumer warpgroups quantize the tile once, each warp eight rows, 8 lanes
// a row, into the 128-byte-swizzled K-major layout wgmma reads (two
// 128-byte boxes along the input), with rs beside it; the roundings between
// f32 and integers are done in the FMA and integer units (the conversion
// unit is left to the epilogue's bf16 packing). A named barrier, then each
// warpgroup takes 128 of the slice's columns: wgmma m64n64k32.s32.s8.s8
// over eight k-steps into two 64 x 64 s32 accumulators, both operands
// K-major (the only layout s8 wgmma takes; the weights are K-major as
// torch's Linear keeps them). The s8 tile and the row scales are single
// (a second s8 tile does not fit), so a second barrier after the products
// frees them for the next tile. The epilogue stays in registers: float(acc)
// (exact, by the magic-number trick), the two rounded products and the
// rounded bias sum, then proj_epilogue.cuh's bf16 rounding and rotary (each
// cos / sin pair read once for the warpgroup's two heads); its bf16 blocks
// are staged in 32 KB of shared memory and leave by TMA stores. 0 bytes
// spilled at 168 registers, the cap of 288 threads at one CTA an SM.
//
// Layouts: x [tokens, 256] bf16; wq [n_out, 256] s8 (torch Linear layout,
// its rows already in the order the consumer reads: the self-attention's
// [q heads | k heads | v heads] blocks of kernel 12, the cross-attention's
// [to_qk | to_v]); ws, b [n_out] f32; cos, sin [tokens, 64] f32 (read only
// with rotary). Output column c goes to out0[token, c] for c < split (row
// length split) and to out1[token, c - split] otherwise (row length n_out -
// split). Columns c < rot_cols are rotated, pair index c % 64 within the
// head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "proj_epilogue.cuh"
#include "quant_rows.cuh"

extern "C" int pram_self_attention_rotated(const void* qkv,
                                           const void* key_bias, void* out,
                                           int B, int N, int heads,
                                           float scale, const int* splits,
                                           int n_splits, void* stream);
extern "C" int pram_cross_attention_tail(const void* qk, const void* v,
                                         const void* bias0, const void* bias1,
                                         void* out, int B, int N, int n0,
                                         int heads, float scale, void* stream);

namespace {

using proj::CS_BOX;
using proj::CS_BYTES;
using proj::CW;
using proj::D;
using wg::HD;
using wg::TILE_BYTES;
using wg::TR;
using q8::dequant;
using q8::quant_tile_rows;

constexpr int NC = 256;                 // output columns of a CTA (its slice)
constexpr int NB = NC / 2 / HD;         // 64-column blocks of a warpgroup
constexpr int KB = D / HD;              // 64-column bf16 boxes of an x tile
constexpr int KQ = D / 128;             // 128-byte s8 boxes along the input
constexpr int STAGES = 2;               // ring of cos / sin tiles
constexpr uint32_t X_BYTES = KB * TILE_BYTES;  // a bf16 x tile
constexpr uint32_t O_BYTES = NC * TR * 2;      // the tile's bf16 output
constexpr uint32_t Q_BOX = TR * 128;           // 64 s8 rows of a k-box, 8 KB
constexpr uint32_t Q_BYTES = KQ * Q_BOX;       // the s8 tile
constexpr uint32_t W_BOX = NC * 128;           // the slice's rows of a k-box
constexpr uint32_t W_BYTES = KQ * W_BOX;       // the slice's s8 weights
constexpr int CONSUMER_BAR = 3;  // named barrier of both warpgroups (1, 2: each)
constexpr size_t SMEM = 1024 + W_BYTES + X_BYTES + STAGES * CS_BYTES +
                        Q_BYTES + O_BYTES + (TR + 2 * NC) * sizeof(float) +
                        (2 * STAGES + 3) * sizeof(uint64_t);
static_assert(SMEM <= 232448, "shared memory of one CTA");

struct Maps {  // [1, rows, cols] views: x, out0, out1 (bf16), w (s8), cos, sin (f32)
  CUtensorMap x, w, out0, out1, cos, sin;
};

// A map over the s8 weights [1, n_out, 256] whose box is a slice's NC rows
// of 128 bytes, 128-byte swizzled.
inline bool make_map_s8(CUtensorMap* map, const void* base, int rows) {
  const wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {D, (cuuint64_t)rows * D};
  const cuuint32_t box[3] = {128, NC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct AccS32 {  // a 64 x 64 s32 accumulator over a warpgroup (wg::Acc's layout)
  int d[32];
};

#define WG_ACC32_S32(c)                                                      \
  "+r"(c.d[0]), "+r"(c.d[1]), "+r"(c.d[2]), "+r"(c.d[3]), "+r"(c.d[4]),      \
      "+r"(c.d[5]), "+r"(c.d[6]), "+r"(c.d[7]), "+r"(c.d[8]), "+r"(c.d[9]),  \
      "+r"(c.d[10]), "+r"(c.d[11]), "+r"(c.d[12]), "+r"(c.d[13]),            \
      "+r"(c.d[14]), "+r"(c.d[15]), "+r"(c.d[16]), "+r"(c.d[17]),            \
      "+r"(c.d[18]), "+r"(c.d[19]), "+r"(c.d[20]), "+r"(c.d[21]),            \
      "+r"(c.d[22]), "+r"(c.d[23]), "+r"(c.d[24]), "+r"(c.d[25]),            \
      "+r"(c.d[26]), "+r"(c.d[27]), "+r"(c.d[28]), "+r"(c.d[29]),            \
      "+r"(c.d[30]), "+r"(c.d[31])

// c (+)= A B^T: A [64 x 32] and B [64 x 32] s8, both K-major in shared
// memory; accumulate 0 overwrites c
__device__ __forceinline__ void mma_s8(AccS32& c, uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_D32
      ", %32, %33, p;\n}\n"
      : WG_ACC32_S32(c)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void reg_fence(AccS32& c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(c.d[i])::"memory");
}

__global__ void __launch_bounds__(wg::THREADS, 1)
proj_s8_kernel(const __grid_constant__ Maps maps, const float* __restrict__ ws,
               const float* __restrict__ bias, int tiles, int slices,
               int split, int rot_cols) {
  extern __shared__ unsigned char smem_raw[];
  const int slice = blockIdx.x % slices;
  const int first = blockIdx.x / slices, step = gridDim.x / slices;
  const int n_local = first < tiles ? (tiles - first + step - 1) / step : 0;
  if (n_local == 0) return;
  const int col0 = slice * NC;
  const bool rotary = col0 < rot_cols;

  unsigned char* sm = wg::align1024(smem_raw);
  unsigned char* Ws = sm;
  unsigned char* Xs = Ws + W_BYTES;
  unsigned char* CSs = Xs + X_BYTES;
  unsigned char* Qs = CSs + STAGES * CS_BYTES;
  unsigned char* Os = Qs + Q_BYTES;  // the output staging, 16 KB a warpgroup
  float* RSs = reinterpret_cast<float*>(Os + O_BYTES);  // the tile's row scales
  float* WSs = RSs + TR;                                // the slice's column scales
  float* Bs = WSs + NC;                                 // and biases
  uint64_t* cs_full = reinterpret_cast<uint64_t*>(Bs + NC);
  uint64_t* cs_empty = cs_full + STAGES;
  uint64_t* x_full = cs_empty + STAGES;
  uint64_t* x_empty = x_full + 1;
  uint64_t* wbar = x_empty + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&cs_full[s], 1);
      wg::bar_init(&cs_empty[s], wg::CONSUMER_WARPS);
    }
    wg::bar_init(x_full, 1);
    wg::bar_init(x_empty, wg::CONSUMER_WARPS);
    wg::bar_init(wbar, 1);
    wg::bar_init_fence();
  }
  for (int i = threadIdx.x; i < NC; i += blockDim.x) {
    WSs[i] = ws[col0 + i];
    Bs[i] = bias[col0 + i];
  }
  __syncthreads();

  if (threadIdx.x >= wg::CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == wg::CONSUMERS) {
      wg::bar_expect(wbar, W_BYTES);
      for (int kq = 0; kq < KQ; ++kq)
        wg::tma_load(Ws + kq * W_BOX, &maps.w, kq * 128, col0, 0, wbar);
      for (int it = 0; it < n_local; ++it) {
        const int t0 = (first + it * step) * TR;
        if (it > 0) wg::bar_wait(x_empty, (it - 1) & 1);  // the last x quantized
        wg::bar_expect(x_full, X_BYTES);
        for (int kb = 0; kb < KB; ++kb)
          wg::tma_load(Xs + kb * TILE_BYTES, &maps.x, kb * HD, t0, 0, x_full);
        if (rotary) {
          const int s = it % STAGES;
          if (it >= STAGES) wg::bar_wait(&cs_empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* cs = CSs + s * CS_BYTES;
          wg::bar_expect(&cs_full[s], CS_BYTES);
          for (int b = 0; b < HD / CW; ++b) {
            wg::tma_load(cs + b * CS_BOX, &maps.cos, b * CW, t0, 0, &cs_full[s]);
            wg::tma_load(cs + (2 + b) * CS_BOX, &maps.sin, b * CW, t0, 0,
                         &cs_full[s]);
          }
        }
      }
    }
    return;
  }

  // consumers: both warpgroups quantize each tile, then warpgroup g takes
  // the slice's 64-column blocks g * NB .. g * NB + NB - 1
  const int g = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* Og = Os + g * NB * TILE_BYTES;

  wg::bar_wait(wbar, 0);
  for (int it = 0; it < n_local; ++it) {
    const int s = it % STAGES;
    const int t0 = (first + it * step) * TR;
    wg::bar_wait(x_full, it & 1);
    quant_tile_rows(Xs, Qs, RSs, threadIdx.x >> 5);
    __syncwarp();
    if (lane == 0) wg::bar_arrive(x_empty);  // x read: the next tile's may come
    proj::fence_async_shared();  // the s8 tile, for wgmma
    proj::bar_sync(CONSUMER_BAR, wg::CONSUMERS);

    AccS32 acc[NB];
    wg::mma_fence();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const uint64_t da = wg::desc(Qs + kq * Q_BOX);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_s8(acc[n], da + k * wg::DESC_K_STEP,
                 wg::desc(Ws + kq * W_BOX + (g * NB + n) * Q_BOX) +
                     k * wg::DESC_K_STEP,
                 kq | k);
    }
    wg::mma_commit();
    wg::mma_wait();
#pragma unroll
    for (int n = 0; n < NB; ++n) reg_fence(acc[n]);
    const float rs0 = RSs[r0], rs1 = RSs[r0 + 8];
    proj::bar_sync(CONSUMER_BAR, wg::CONSUMERS);  // Qs, RSs free for the next tile

    if (rotary) wg::bar_wait(&cs_full[s], (it / STAGES) & 1);
    if (leader) proj::store_wait_read();  // the last tile's blocks have left
    proj::group_sync(g);
    proj::stage_blocks<NB>(
        [&](int n, int half, int j) {
          const int c = (g * NB + n) * HD + 8 * j + cq;  // the slice's column
          const float rs = half ? rs1 : rs0;
          const float2 w = *reinterpret_cast<const float2*>(WSs + c);
          const float2 b = *reinterpret_cast<const float2*>(Bs + c);
          return make_float2(dequant(acc[n].d[4 * j + 2 * half], rs, w.x, b.x),
                             dequant(acc[n].d[4 * j + 2 * half + 1], rs, w.y, b.y));
        },
        rotary, CSs + s * CS_BYTES, Og);
    __syncwarp();
    if (rotary && lane == 0) wg::bar_arrive(&cs_empty[s]);  // cos, sin of s read
    proj::fence_async_shared();
    proj::group_sync(g);
    if (leader) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
        proj::store_block(&maps.out0, &maps.out1, Og + n * TILE_BYTES,
                          col0 + (g * NB + n) * HD, t0, split);
      proj::store_commit();
    }
  }
  if (leader) proj::store_wait_all();
}

int project(const void* x, const void* wq, const void* ws, const void* b,
            const void* cos, const void* sin, void* out0, void* out1,
            long long tokens, int n_out, int split, int rot_cols,
            cudaStream_t stream) {
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
      !make_map_s8(&maps.w, wq, n_out))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = proj::persistent_grid(slices, tiles, &step))
    return (int)err;
  return wg::launch(proj_s8_kernel, dim3(slices * step), wg::THREADS, SMEM,
                    stream, maps, (const float*)ws, (const float*)b, tiles,
                    slices, split, rot_cols);
}

}  // namespace

// x [tokens, 256] bf16; wq [n_out, 256] s8; ws, b [n_out] f32; cos, sin
// [tokens, 64] f32 or null without rotary; out0 [tokens, split] and out1
// [tokens, n_out - split] bf16 (out1 unused when split == n_out). tokens a
// multiple of 64, n_out and rot_cols of 256, split of 64; every pointer
// 16-byte aligned.
extern "C" int pram_project_int8(const void* x, const void* wq, const void* ws,
                                 const void* b, const void* cos,
                                 const void* sin, void* out0, void* out1,
                                 long long tokens, int n_out, int split,
                                 int rot_cols, void* stream) {
  return project(x, wq, ws, b, cos, sin, out0, out1, tokens, n_out, split,
                 rot_cols, (cudaStream_t)stream);
}

// Kernel 17, self-attention: x [B, N, 256]; wq [768, 256], ws, b [768] in
// kernel 12's qkv column order; cos, sin [B, N, 64] f32; key_bias [B, N]
// f32; qkv scratch [B, N, 768] and out [B, N, 256] bf16; splits as
// pram_self_attention_rotated takes them
extern "C" int pram_self_attention_int8(const void* x, const void* wq,
                                        const void* ws, const void* b,
                                        const void* cos, const void* sin,
                                        const void* key_bias, void* qkv,
                                        void* out, int B, int N, int heads,
                                        float scale, const int* splits,
                                        int n_splits, void* stream) {
  if (heads * HD != D) return (int)cudaErrorInvalidValue;
  const int err = project(x, wq, ws, b, cos, sin, qkv, nullptr,
                          (long long)B * N, 3 * D, 3 * D, 2 * D,
                          (cudaStream_t)stream);
  if (err) return err;
  return pram_self_attention_rotated(qkv, key_bias, out, B, N, heads, scale,
                                     splits, n_splits, stream);
}

// Kernel 17, cross-attention: x [B, N, 256] with N = n0 + n1; wq [512, 256]
// = [to_qk | to_v] rows, ws, b [512]; qk, v scratch and out [B, N, 256] bf16
extern "C" int pram_cross_attention_int8(const void* x, const void* wq,
                                         const void* ws, const void* b,
                                         const void* bias0, const void* bias1,
                                         void* qk, void* v, void* out, int B,
                                         int N, int n0, int heads, float scale,
                                         void* stream) {
  if (n0 <= 0 || n0 >= N) return (int)cudaErrorInvalidValue;
  const int err = project(x, wq, ws, b, nullptr, nullptr, qk, v,
                          (long long)B * N, 2 * D, D, 0, (cudaStream_t)stream);
  if (err) return err;
  return pram_cross_attention_tail(qk, v, bias0, bias1, out, B, N, n0, heads,
                                   scale, stream);
}
