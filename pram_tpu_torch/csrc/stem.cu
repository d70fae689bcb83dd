// SFD2 stem, for Hopper: conv1a (3 -> 64, 3x3, stride 1) + BN + ReLU, then
// conv1b (64 -> 64, 3x3, stride 2) + BN + ReLU, both with SAME padding of 1,
// in one kernel. BN is folded into the weights and biases by the wrapper (in
// f32); the weights arrive rounded to the working type T (bf16 or f32).
//
// Replaces pram_tpu/ops/stem_pallas.py:fused_stem (_stem_kernel). Like the
// TPU kernel it keeps conv1a's full-resolution 64-channel output on chip; it
// does not copy the TPU kernel's parity-split planar layout of the image or
// its block-diagonal conv1a matrix, which exist for the TPU's vector lanes.
//
// What bounds it: at 32 x 480 x 640 the two convolutions take ~215 GFLOP
// (conv1a 2 * 27 * 64 per pixel, conv1b 2 * 576 * 64 per output pixel), 0.22
// ms at the bf16 tensor-core peak, against ~0.11 ms for its bytes (the image
// read once, the [B, H/2, W/2, 64] output written once): operations.
//
// The bf16 instance (stem_kernel_bf16), which every path runs, keeps the
// tensor cores on both convolutions. One persistent CTA an SM: three
// consumer warpgroups, each walking its own 8 x 8-output-pixel tiles with
// nothing shared but the weights (so one warpgroup's conv1a epilogue runs
// while another's conv1b products keep the tensor cores busy), and a
// producer warp whose lane 0 keeps each warpgroup's image patches in
// flight, two tiles ahead (it polls the three rings, never blocking on
// one: TMA issued from diverged lanes of one warp faulted). A warpgroup's tile:
//   1. The image patch: (2 * 8 + 3) rows x (2 * 8 + 3) pixels x 3 channels,
//      by one TMA box of the image viewed as [B, H, Wp * 3] (bf16 rows of
//      the image; the box 19 rows x 64 elements, 128 bytes) into a ring of
//      two patch buffers. A box's first element must lie on a 16-byte
//      boundary (a box at 6 ox0 - 6 faulted), so it starts two elements
//      early (6 ox0 - 8, ox0 a multiple of 8) and holds 2 + 57 elements.
//      TMA zero-fills outside the image: conv1a's padding. The row pitch
//      must be a multiple of 16 bytes (Wp * 6), so the wrapper pads an image
//      whose W is not a multiple of 8 with zero columns to Wp (the padded
//      columns read as conv1a's padding; the positions past W are masked
//      below). TMA, not cp.async: one instruction a patch, no thread
//      computing addresses, and the 3-channel rows are whole elements of a
//      bf16 row.
//   2. conv1a on wgmma: an im2col product of the (2 * 8 + 1) x (2 * 8 + 1)
//      intermediate positions (306 plane entries, five blocks of 64) x K =
//      the 27 taps x channels zero-padded to 32, A gathered from the patch
//      straight into registers (the A fragments of two m64n64k16 wgmma a
//      block; the padded K reads a finite image value against a zero weight
//      row), B the folded W1 (64 x 32, K-major, resident). The epilogue adds
//      the bias, applies ReLU, rounds to bf16, and sets every intermediate
//      position outside the image to zero: that is conv1b's padding, not
//      conv1a evaluated there (which would give ReLU(bias)). It writes conv
//      tile's stride-2 arrangement (csrc/conv_tile.cuh): the no-swizzle
//      K-major layout, one plane per 8 channels (16 bytes) with the
//      intermediate positions 16 bytes apart, a halo row holding the even
//      local columns and then the odd ones (9 + 9 entries), so a conv1b tap
//      (dy, dx) is a start-address shift: dx = 0, 1, 2 read even, odd, even
//      (+1) entries, and the stride offset skips two halo rows.
//   3. conv1b on wgmma: m64n64k16 over K = 576 (36 steps: 9 taps x 4
//      channel chunks), A the planes in place, B the folded W2 (576 x 64,
//      72 KB, K-major planes, resident for the whole run).
//   4. The epilogue adds the bias, applies ReLU, rounds to bf16, stages the
//      64 pixels x 64 channels in a 128-byte-swizzled box over the first 8
//      KB of the planes, and a TMA store writes it into the NHWC output
//      (channels_last memory for the next convolution), dropping the pixels
//      past the ragged right and bottom edges. The next tile's conv1a
//      writes the planes once the store has read the box.
// Any H and W.
//
// Shared memory of the bf16 instance: W2 (72 planes x 64 x 16 bytes), W1 (4
// planes), then for each warpgroup its planes (8 x 306 x 16 bytes, rounded
// to 1 KB) and two 2560-byte patch buffers; the barriers. 214,120 bytes
// with the alignment's slack.
//
// The f32 instance (stem_kernel_f32) is only the tight check of the
// arithmetic (chip_smoke.py's STEM_F32_TOL); it stays on the CUDA cores'
// FMAs: a 256-thread block an (8 x 16)-output tile, conv1a a warp a
// position, conv1b a thread a channel and a quarter of the pixels.
//
// Layouts: image [B, H, Wp, 3] T (Wp = W but for the bf16 instance's
// padding); out [B, (H+1)/2, (W+1)/2, 64] T. bf16: w1 [4, 64, 8] bf16 (K
// plane, output channel, 8 K values; K = (dy*3+dx)*3+c, rows 27-31 zero),
// w2 [72, 64, 8] bf16 (K = (dy*3+dx)*64+c). f32: w1 [27, 64] f32 (row
// (dy*3+dx)*3+c), w2 [576, 64] f32 (row (dy*3+dx)*64+c). b1, b2 [64] f32.
// All contiguous, 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "conv_tile.cuh"
#include "proj_epilogue.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int C = 64;  // channels of both convolutions

namespace stemwg {

constexpr int NWG = 3;                       // consumer warpgroups
constexpr int THREADS = 128 * NWG + 32;      // and the producer warp
constexpr int T = 8;                         // output rows and columns of a tile
constexpr int HR = 2 * T + 1;                // intermediate rows of a tile: 17
constexpr int HCOL = T + 1;                  // entries of a halo row's even (or odd) half
constexpr int PITCH = 2 * HCOL;              // entries of a halo row: 18
constexpr int HP = HR * PITCH;               // entries: 306
constexpr int BLOCKS = (HP + 63) / 64;       // conv1a's 64-entry blocks: 5
constexpr uint32_t A_PLANE = HP * 16;        // 8 channels of every entry
constexpr uint32_t SBO = 2 * PITCH * 16;     // between conv1b's output rows
constexpr int PR = 2 * T + 3;                // patch rows: 19
constexpr int PW = 64;                       // patch row, bf16 elements (2 + 19 pixels x 3, rounded up)
constexpr int LEAD = 2;  // elements before the first pixel: the box starts 16-byte aligned
constexpr uint32_t PATCH_TX = PR * PW * 2;   // 2432 bytes a box
constexpr uint32_t PATCH = 2560;             // a patch buffer
constexpr int P_STAGES = 2;
constexpr uint32_t W2_BYTES = 72 * C * 16;   // 73728
constexpr uint32_t W1_BYTES = 4 * C * 16;    // 4096
constexpr uint32_t PLANES = (8 * A_PLANE + 1023) / 1024 * 1024;
constexpr uint32_t REGION = PLANES + P_STAGES * PATCH;  // a warpgroup's
constexpr uint32_t BARS = W2_BYTES + W1_BYTES + NWG * REGION;
constexpr size_t SMEM = 1024 + BARS + (1 + 2 * NWG * P_STAGES) * 8;
static_assert(SMEM <= 232448, "shared memory of one CTA");
static_assert(PLANES >= 8192, "the output box is staged over the planes");
static_assert(REGION % 1024 == 0, "each warpgroup's planes 1 KB aligned: the staged box is 128-byte swizzled");

struct Maps {
  CUtensorMap img, out;
};

struct Dims {
  int H, W, Ho, Wo, tiles_x, tiles_y, tiles;
};

// no-swizzle K-major descriptors: leading offset the next 8 K (16 bytes),
// stride offset the next 8 rows
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void tile_of(const Dims& d, int t, int& b, int& oy0, int& ox0) {
  const int tx = t % d.tiles_x;
  t /= d.tiles_x;
  oy0 = (t % d.tiles_y) * T;
  b = t / d.tiles_y;
  ox0 = tx * T;
}

// the patch element of K index k (dy, dx, c) relative to an entry's first
// input pixel; the padded K reads the entry's first element (finite)
// against W1's zero rows
__device__ __forceinline__ int k_offset(int k) {
  if (k >= 27) return 0;
  const int tap = k / 3, c = k - 3 * tap;
  return (tap / 3) * PW + (tap % 3) * 3 + c;
}

// plane entry i -> its patch element (row p, column q of the intermediate
// positions: the entry's conv1a window starts at patch row p, pixel q)
__device__ __forceinline__ int entry_base(int i) {
  if (i >= HP) i = 0;  // rows past the last entry: computed, never written
  const int p = i / PITCH, s = i - p * PITCH;
  const int q = s < HCOL ? 2 * s : 2 * (s - HCOL) + 1;
  return p * PW + LEAD + 3 * q;
}

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel_bf16(const __grid_constant__ Maps maps, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, Dims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  unsigned char* w2s = sm;
  unsigned char* w1s = sm + W2_BYTES;
  uint64_t* w_bar = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* p_full = w_bar + 1;                  // [NWG][P_STAGES]
  uint64_t* p_empty = p_full + NWG * P_STAGES;   // [NWG][P_STAGES]
  const int workers = gridDim.x * NWG;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    wg::bar_init(w_bar, 1);
    for (int i = 0; i < NWG * P_STAGES; ++i) {
      wg::bar_init(&p_full[i], 1);
      wg::bar_init(&p_empty[i], 4);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // the producer warp: one lane issues
    if (lane != 0) return;
    wg::bar_expect(w_bar, W2_BYTES + W1_BYTES);
    wg::bulk_load(w2s, w2, W2_BYTES, w_bar);
    wg::bulk_load(w1s, w1, W1_BYTES, w_bar);
    // each warpgroup's next patch (its it-th, tile t), issued as soon as its
    // buffer is free: the lane polls the rings and never blocks on one
    int it[NWG], t[NWG];
#pragma unroll
    for (int g = 0; g < NWG; ++g) {
      it[g] = 0;
      t[g] = blockIdx.x * NWG + g;
    }
    for (bool left = true; left;) {
      left = false;
#pragma unroll
      for (int g = 0; g < NWG; ++g) {
        if (t[g] >= d.tiles) continue;
        left = true;
        const int s = it[g] % P_STAGES;
        if (it[g] >= P_STAGES &&
            !convtile::bar_test(&p_empty[g * P_STAGES + s], ((it[g] / P_STAGES) - 1) & 1))
          continue;
        int b, oy0, ox0;
        tile_of(d, t[g], b, oy0, ox0);
        uint64_t* full = &p_full[g * P_STAGES + s];
        wg::bar_expect(full, PATCH_TX);
        wg::tma_load(sm + W2_BYTES + W1_BYTES + g * REGION + PLANES + s * PATCH, &maps.img,
                     3 * (2 * ox0 - 2) - LEAD, 2 * oy0 - 2, b, full);
        ++it[g];
        t[g] += workers;
      }
    }
    return;
  }

  // a consumer warpgroup
  const int g = threadIdx.x >> 7;
  const int w = (threadIdx.x >> 5) & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const int cq = 2 * (lane & 3);
  const int r0 = 16 * w + (lane >> 2);  // accumulator rows r0 and r0 + 8
  unsigned char* planes = sm + W2_BYTES + W1_BYTES + g * REGION;
  const unsigned char* patches = planes + PLANES;
  const uint32_t a_planes = wg::saddr(planes);
  const uint32_t a_w1 = wg::saddr(w1s), a_w2 = wg::saddr(w2s);
  // this thread's K indices of conv1a's A fragments: step ks, register k of
  // 4 holds K 16 ks + 8 (k >> 1) + cq (+ 1)
  int koff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) koff[ks][hi][e] = k_offset(16 * ks + 8 * hi + cq + e);
  const int worker = blockIdx.x * NWG + g;
  wg::bar_wait(w_bar, 0);

  for (int it = 0, t = worker; t < d.tiles; ++it, t += workers) {
    int b, oy0, ox0;
    tile_of(d, t, b, oy0, ox0);
    const int s = it % P_STAGES;
    wg::bar_wait(&p_full[g * P_STAGES + s], (it / P_STAGES) & 1);
    const bf16* patch = reinterpret_cast<const bf16*>(patches + s * PATCH);

    // conv1a, a block of 64 plane entries at a time
#pragma unroll 1
    for (int blk = 0; blk < BLOCKS; ++blk) {
      int base[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) base[half] = entry_base(64 * blk + r0 + 8 * half);
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint16_t lo = reinterpret_cast<const uint16_t*>(patch)[base[half] + koff[ks][hi][0]];
            const uint16_t up = reinterpret_cast<const uint16_t*>(patch)[base[half] + koff[ks][hi][1]];
            a[ks][2 * hi + half] = (uint32_t)lo | ((uint32_t)up << 16);
          }
      if (blk == BLOCKS - 1) {  // the patch is read: back to the producer
        __syncwarp();
        if (lane == 0) wg::bar_arrive(&p_empty[g * P_STAGES + s]);
      }
      wg::Acc acc;
      wg::mma_fence();
      wg::mma_rs<0>(acc, a[0], desc_k(a_w1, 1024, 128), 0);
      wg::mma_rs<0>(acc, a[1], desc_k(a_w1 + 2 * 1024, 1024, 128), 1);
      wg::mma_commit();
      wg::mma_wait();
      wg::reg_fence(acc);
      if (blk == 0 && it > 0) {  // the last tile's output box has left the planes
        if (leader) proj::store_wait_read();
        proj::group_sync(g);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 64 * blk + r0 + 8 * half;
        if (i >= HP) continue;
        const int p = i / PITCH, sl = i - p * PITCH;
        const int q = sl < HCOL ? 2 * sl : 2 * (sl - HCOL) + 1;
        const int y = 2 * oy0 - 1 + p, x = 2 * ox0 - 1 + q;
        const bool in = y >= 0 && y < d.H && x >= 0 && x < d.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j + cq));
          const float v0 = in ? fmaxf(__fadd_rn(acc.d[4 * j + 2 * half], bias.x), 0.f) : 0.f;
          const float v1 = in ? fmaxf(__fadd_rn(acc.d[4 * j + 2 * half + 1], bias.y), 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(planes + j * A_PLANE + i * 16 + cq * 2) =
              proj::pack_bf16_rn(v0, v1);
        }
      }
    }
    proj::fence_async_shared();
    proj::group_sync(g);  // the planes complete

    // conv1b: 9 taps x 4 chunks of 16 channels
    wg::Acc acc;
    wg::mma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int entry = dy * PITCH + (dx == 1 ? HCOL : dx >> 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wg::mma_ss(acc, desc_k(a_planes + entry * 16 + 2 * kc * A_PLANE, A_PLANE, SBO),
                   desc_k(a_w2 + (8 * tap + 2 * kc) * 1024, 1024, 128), tap | kc);
    }
    wg::mma_commit();
    wg::mma_wait();
    wg::reg_fence(acc);
    proj::group_sync(g);  // every warp's products have read the planes

    // the output box over the planes, out by TMA
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r0 + 8 * half;  // pixel (m / 8, m % 8) of the tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + cq));
        const float v0 = fmaxf(__fadd_rn(acc.d[4 * j + 2 * half], bias.x), 0.f);
        const float v1 = fmaxf(__fadd_rn(acc.d[4 * j + 2 * half + 1], bias.y), 0.f);
        *reinterpret_cast<uint32_t*>(planes + proj::swizzled(m, 8 * j + cq)) =
            proj::pack_bf16_rn(v0, v1);
      }
    }
    proj::fence_async_shared();
    proj::group_sync(g);
    if (leader) {
      convtile::tma_store4(&maps.out, planes, 0, ox0, oy0, b);
      proj::store_commit();
    }
  }
  if (leader) proj::store_wait_all();
}

inline int launch_bf16(const void* img, const void* w1, const float* b1, const void* w2,
                       const float* b2, void* out, int B, int H, int W, int Wp,
                       cudaStream_t stream) {
  if (Wp < W || (Wp * 6) % 16 != 0 ||
      ((uintptr_t)img | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.H = H;
  d.W = W;
  d.Ho = (H + 1) / 2;
  d.Wo = (W + 1) / 2;
  d.tiles_x = (d.Wo + T - 1) / T;
  d.tiles_y = (d.Ho + T - 1) / T;
  const long long tiles = (long long)B * d.tiles_x * d.tiles_y;
  if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  d.tiles = (int)tiles;
  Maps maps;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Wp * 3, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)Wp * 6, (cuuint64_t)Wp * 6 * H};
    const cuuint32_t box[3] = {PW, PR, 1};
    if (!convtile::encode(&maps.img, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, img, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t px = C * 2;
    const cuuint64_t dims[4] = {C, (cuuint64_t)d.Wo, (cuuint64_t)d.Ho, (cuuint64_t)B};
    const cuuint64_t strides[3] = {px, px * d.Wo, px * d.Wo * d.Ho};
    const cuuint32_t box[4] = {C, T, T, 1};
    if (!convtile::encode(&maps.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int need = (d.tiles + NWG - 1) / NWG;
  return wg::launch(stem_kernel_bf16, dim3(need < sms ? need : sms), THREADS, SMEM, stream, maps,
                    (const bf16*)w1, b1, (const bf16*)w2, b2, d);
}

}  // namespace stemwg

// ---- the f32 instance, on the CUDA cores

constexpr int TH = 8;             // output rows of a tile
constexpr int TW = 16;            // output columns of a tile
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int IR = 2 * TH + 1;    // intermediate rows of a tile
constexpr int IQ = 2 * TW + 1;    // intermediate columns of a tile
constexpr int PE = TW + 1;        // even-column plane width
constexpr int PO = TW;            // odd-column plane width
constexpr int PR = 2 * TH + 3;    // input rows of a tile
constexpr int PC = 2 * TW + 3;    // input columns of a tile
constexpr int S = C;              // f32 channel stride of an intermediate position

constexpr size_t INPUT_BYTES = ((size_t)PR * PC * 3 * 4 + 127) / 128 * 128;
constexpr size_t PLANE_BYTES = ((size_t)IR * (PE + PO) * S * 4 + 127) / 128 * 128;
constexpr size_t F32_SMEM = PLANE_BYTES + INPUT_BYTES;

// the input patch and the conv1a planes of one tile: the (2*8+3) x (2*16+3)
// x 3 patch as f32, zero outside the image (conv1a's padding); conv1a with
// f32 FMAs (a warp a position, a lane two channels) + bias + ReLU into two
// planes by column parity, zero at intermediate positions outside the
// image (conv1b's padding)
__device__ __forceinline__ void conv1a_tile(const float* __restrict__ img, float* inp, float* E,
                                            float* O, const float* wa, const float* wb, float ba,
                                            float bb, int b, int oy0, int ox0, int H, int W) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < PR * PC * 3; i += NTHREADS) {
    const int r = i / (PC * 3), rem = i % (PC * 3);
    const int q = rem / 3, c = rem % 3;
    const int iy = 2 * oy0 - 2 + r, ix = 2 * ox0 - 2 + q;
    inp[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? img[(((size_t)b * H + iy) * W + ix) * 3 + c]
                 : 0.f;
  }
  __syncthreads();
  for (int p = warp; p < IR * IQ; p += NWARP) {
    const int r = p / IQ, q = p % IQ;
    const int y = 2 * oy0 - 1 + r, x = 2 * ox0 - 1 + q;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = inp[((r + dy) * PC + q + dx) * 3 + c];
          const int t = (dy * 3 + dx) * 3 + c;
          acc0 = fmaf(v, wa[t], acc0);
          acc1 = fmaf(v, wb[t], acc1);
        }
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    float* dst = (q & 1) ? O + (r * PO + q / 2) * S : E + (r * PE + q / 2) * S;
    dst[lane] = in ? fmaxf(acc0 + ba, 0.f) : 0.f;
    dst[lane + 32] = in ? fmaxf(acc1 + bb, 0.f) : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
stem_kernel_f32(const float* __restrict__ img, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int B,
                int H, int W) {
  constexpr int NPIX = TH * TW / 4;  // output pixels of a thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* E = reinterpret_cast<float*>(smem);
  float* O = E + IR * PE * S;
  float* inp = reinterpret_cast<float*>(smem + PLANE_BYTES);

  const int tid = threadIdx.x, lane = tid % 32;
  float wa[27], wb[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    wa[t] = w1[t * C + lane];
    wb[t] = w1[t * C + lane + 32];
  }
  const float ba = b1[lane], bb = b1[lane + 32];
  const int f = tid % C, g = tid / C;  // a channel, a quarter of the pixels
  const float bias2 = b2[f];

  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int ty_n = (Ho + TH - 1) / TH, tx_n = (Wo + TW - 1) / TW;
  const int tiles = B * ty_n * tx_n;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (ty_n * tx_n), rem = tile % (ty_n * tx_n);
    const int oy0 = (rem / tx_n) * TH, ox0 = (rem % tx_n) * TW;
    conv1a_tile(img, inp, E, O, wa, wb, ba, bb, b, oy0, ox0, H, W);

    float acc[NPIX];
#pragma unroll
    for (int i = 0; i < NPIX; ++i) acc[i] = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        for (int c = 0; c < C; ++c) {
          const float w = __ldg(w2 + ((dy * 3 + dx) * C + c) * C + f);
#pragma unroll
          for (int i = 0; i < NPIX; ++i) {
            const int p = g + 4 * i, py = p / TW, px = p % TW;
            const int r = 2 * py + dy;
            const float* src = dx == 1 ? O + (r * PO + px) * S
                                       : E + (r * PE + px + dx / 2) * S;
            acc[i] = fmaf(src[c], w, acc[i]);
          }
        }
#pragma unroll
    for (int i = 0; i < NPIX; ++i) {
      const int p = g + 4 * i, oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy < Ho && ox < Wo)
        out[(((size_t)b * Ho + oy) * Wo + ox) * C + f] = fmaxf(acc[i] + bias2, 0.f);
    }
    __syncthreads();  // the planes are read before the next tile writes them
  }
}

}  // namespace

// Wp: the image's pixels a row (W, or the bf16 instance's padded width).
extern "C" int pram_stem(const void* img, const void* w1, const float* b1,
                         const void* w2, const float* b2, void* out, int B,
                         int H, int W, int Wp, int is_bf16, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return stemwg::launch_bf16(img, w1, b1, w2, b2, out, B, H, W, Wp, s);
  if (Wp != W) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long tiles = (long)B * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
  const int grid = (int)(tiles < sms ? tiles : sms);
  stem_kernel_f32<<<grid, NTHREADS, F32_SMEM, s>>>(
      static_cast<const float*>(img), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}
