// Hopper building blocks of the bf16 attention passes at head dim 64, and
// the message pass built from them (kernels 10-12, and kernels 1 and 5
// after their projection pass; the backward kernels 13 and 14 build their
// statistics and gradient passes from these pieces in
// attention_bwd_wgmma.cuh):
//   - tensor maps encoded on the host (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so nothing links against libcuda)
//     over [frames, rows, cols] bf16 tensors, loading 64 x 64 boxes (one
//     head's 64 columns of 64 rows: 128 bytes a row, the 128-byte swizzle);
//   - mbarriers and TMA loads (tensor boxes and plain bulk copies);
//   - wgmma descriptors of such tiles, K-major (Q and K for S = Q K^T) and
//     MN-major (V for O += P V), and m64n64k16 products with A from shared
//     memory or from registers;
//   - message_cta: 128 queries of one (frame, head) against a range of keys.
//     One producer warp keeps a ring of K, V and key-bias tiles in flight by
//     TMA; two consumer warpgroups of 64 query rows each hold their Q tile
//     in shared memory and S, P and the O accumulator in registers.
//
// Register layout of a 64 x 64 f32 accumulator over a warpgroup (PTX ISA,
// wgmma D fragments): warp w of the group holds rows 16 w .. 16 w + 15;
// lane l holds rows r = 16 w + l / 4 and r + 8, and in each 8-column block j
// the columns 8 j + 2 (l % 4) and + 1: d[4 j + 0, 1] on row r, d[4 j + 2, 3]
// on row r + 8. That is the A-fragment layout of the next product, so the
// weights P go from the S accumulator to the PV product without shared
// memory.
//
// Softmax in the log2 domain: t = s * (scale * log2 e) + bias * log2 e in
// f32 (one fma), p = 2^(t - m) by ex2.approx, m the running max of t. That
// is exp(s * scale + bias - max) up to the f32 rounding of the folded
// constants and ex2's ~2 ulp; bf16 rounds p for the product anyway. The
// rows' m is kept in log2 units for the statistics pass.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int HD = 64;                          // head dim: one 128-byte row
constexpr int TR = 64;                          // rows of a tile and a box
constexpr uint32_t TILE_BYTES = TR * HD * 2;    // 8 KB, 128-byte swizzled
constexpr int STAGES = 4;                       // depth of the TMA ring
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int THREADS = CONSUMERS + 32;         // and the producer warp
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int MQ = 2 * TR;                      // queries of a message CTA
constexpr float LOG2E = 1.4426950408889634f;

// ---- host: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A map over a [frames, rows, cols] bf16 tensor with row stride ld and
// frame stride fs (elements; base and strides 16-byte aligned) whose box is
// 64 rows of 64 columns, 128-byte swizzled. Coordinates {col, row, frame}.
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int frames, size_t ld, size_t fs) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)frames};
  const cuuint64_t strides[2] = {ld * sizeof(bf16), fs * sizeof(bf16)};
  const cuuint32_t box[3] = {HD, TR, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a launch with `smem` bytes of dynamic shared memory; 0 or the CUDA error
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---- device: shared memory, barriers, copies

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the 128-byte swizzle repeats every 1024 bytes: tiles start on such a line
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (saddr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 box at {col, row, frame} of map into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int frame,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(saddr(dst)),
      "l"((uint64_t)map), "r"(saddr(bar)), "r"(col), "r"(row), "r"(frame)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from src into dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// ---- device: wgmma

// descriptor of a 128-byte-swizzled tile (base 1024-byte aligned): 8-row
// groups 1024 bytes apart (the stride offset, in 16-byte units); the leading
// offset is not read for these layouts at 64 columns.
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return (uint64_t)((saddr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
// K-major A or B: the k-th 16-column step starts 32 bytes further
constexpr uint64_t DESC_K_STEP = 32 >> 4;
// MN-major B (rows are the reduction axis): the k-th step of 16 rows
// starts 16 * 128 bytes further
constexpr uint64_t DESC_ROW16_STEP = (16 * 128) >> 4;

struct Acc {  // a 64 x 64 f32 accumulator over a warpgroup
  float d[32];
};

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits for every committed group of this warpgroup
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching accumulator registers across the
// asynchronous products
__device__ __forceinline__ void reg_fence(Acc& c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(c.d[i])::"memory");
}

#define WG_ACC32(c)                                                          \
  "+f"(c.d[0]), "+f"(c.d[1]), "+f"(c.d[2]), "+f"(c.d[3]), "+f"(c.d[4]),      \
      "+f"(c.d[5]), "+f"(c.d[6]), "+f"(c.d[7]), "+f"(c.d[8]), "+f"(c.d[9]),  \
      "+f"(c.d[10]), "+f"(c.d[11]), "+f"(c.d[12]), "+f"(c.d[13]),            \
      "+f"(c.d[14]), "+f"(c.d[15]), "+f"(c.d[16]), "+f"(c.d[17]),            \
      "+f"(c.d[18]), "+f"(c.d[19]), "+f"(c.d[20]), "+f"(c.d[21]),            \
      "+f"(c.d[22]), "+f"(c.d[23]), "+f"(c.d[24]), "+f"(c.d[25]),            \
      "+f"(c.d[26]), "+f"(c.d[27]), "+f"(c.d[28]), "+f"(c.d[29]),            \
      "+f"(c.d[30]), "+f"(c.d[31])
#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// c (+)= A B^T-style product: A [64 x 16] and B [64 x 16] both K-major in
// shared memory; accumulate 0 overwrites c
__device__ __forceinline__ void mma_ss(Acc& c, uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(c)
      : "l"(da), "l"(db), "r"(accumulate));
}

// c (+)= A B: A [64 x 16] bf16 from registers (the accumulator layout's
// fragments), B [16 x 64] MN-major in shared memory (TB = 0: K-major, B^T,
// as the stem's conv1a reads it); accumulate 0 overwrites c
template <int TB = 1>
__device__ __forceinline__ void mma_rs(Acc& c, const uint32_t (&a)[4],
                                       uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_ACC32(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// issues S = A B^T over head dim 64 (four k-steps of K-major tiles) as one
// committed group; S is in flight until mma_wait
__device__ __forceinline__ void qk_issue(Acc& s, uint64_t da, uint64_t db) {
  mma_fence();
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
    mma_ss(s, da + k * DESC_K_STEP, db + k * DESC_K_STEP, k);
  mma_commit();
}

// issues O += P V over 64 keys (P as A fragments, V MN-major) as one group
__device__ __forceinline__ void pv_issue(Acc& o, const uint32_t (&a)[4][4],
                                         uint64_t dv) {
  mma_fence();
#pragma unroll
  for (int k = 0; k < TR / 16; ++k) mma_rs(o, a[k], dv + k * DESC_ROW16_STEP);
  mma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the message pass

// Turns S (raw q.k) into the tile's weights in place: logits in the log2
// domain, the rows' running max m0 / m1 (rows r and r + 8) raised to the
// tile's, c0 / c1 the factor that moves the earlier sums to the new max (0
// on the first tile), s0 / s1 this lane's share of the tile's f32 row sums.
// kb: the tile's 64 key biases.
__device__ __forceinline__ void softmax_tile(Acc& sc, const float* kb,
                                             float sl2, float& m0, float& m1,
                                             float& c0, float& c1, float& s0,
                                             float& s1) {
  const int cq = 2 * (threadIdx.x & 3);
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(kb + 8 * j + cq);
    const float b0 = b.x * LOG2E, b1 = b.y * LOG2E;
    sc.d[4 * j + 0] = fmaf(sc.d[4 * j + 0], sl2, b0);
    sc.d[4 * j + 1] = fmaf(sc.d[4 * j + 1], sl2, b1);
    sc.d[4 * j + 2] = fmaf(sc.d[4 * j + 2], sl2, b0);
    sc.d[4 * j + 3] = fmaf(sc.d[4 * j + 3], sl2, b1);
    mx0 = fmaxf(mx0, fmaxf(sc.d[4 * j + 0], sc.d[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc.d[4 * j + 2], sc.d[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  c0 = ex2(m0 - mx0);
  c1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  s0 = s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc.d[4 * j + 0] = ex2(sc.d[4 * j + 0] - m0);
    sc.d[4 * j + 1] = ex2(sc.d[4 * j + 1] - m0);
    sc.d[4 * j + 2] = ex2(sc.d[4 * j + 2] - m1);
    sc.d[4 * j + 3] = ex2(sc.d[4 * j + 3] - m1);
    s0 += sc.d[4 * j + 0] + sc.d[4 * j + 1];
    s1 += sc.d[4 * j + 2] + sc.d[4 * j + 3];
  }
}

// The f32 weights rounded to bf16 as the A fragments of P V: k-step k takes
// the 8-column blocks 2 k and 2 k + 1, rows r and r + 8 of each.
__device__ __forceinline__ void pack_weights(const Acc& p, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j % 2) * 2 + 0] = pack_bf16(p.d[4 * j + 0], p.d[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(p.d[4 * j + 2], p.d[4 * j + 3]);
  }
}

// shared memory: Q (two tiles), the ring's K, V and key-bias tiles, barriers
constexpr size_t MSG_SMEM = 1024 + 2 * TILE_BYTES + 2 * STAGES * TILE_BYTES +
                            STAGES * TR * sizeof(float) +
                            (2 * STAGES + 1) * sizeof(uint64_t);

// One CTA, THREADS threads: queries [q_row, q_row + 128) of `frame` (column
// q_col of mq) against keys [lo, hi) (rows of mk at column k_col and of mv
// at column v_col; lo, hi multiples of 64). kbias: the frame's key biases,
// indexed by key row (16-byte aligned). out: query q_row's first head
// column, row stride ldo. With row_m (and row_w, qbias, all at query q_row)
// it also writes each row's max in log2 units and its weight valid / sum.
__device__ __forceinline__ void message_cta(
    const CUtensorMap* mq, int q_col, const CUtensorMap* mk, int k_col,
    const CUtensorMap* mv, int v_col, int frame, int q_row, int lo, int hi,
    const float* kbias, float scale, bf16* out, size_t ldo,
    const float* qbias, float* row_m, float* row_w, unsigned char* smem_raw) {
  unsigned char* sm = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ks = Qs + 2 * TR * HD;
  bf16* Vs = Ks + STAGES * TR * HD;
  float* Bs = reinterpret_cast<float*>(Vs + STAGES * TR * HD);
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * TR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int ntiles = (hi - lo) / TR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMER_WARPS);
    }
    bar_init(qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == CONSUMERS) {
      bar_expect(qbar, 2 * TILE_BYTES);
      tma_load(Qs, mq, q_col, q_row, frame, qbar);
      tma_load(Qs + TR * HD, mq, q_col, q_row + TR, frame, qbar);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) bar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        const int k0 = lo + it * TR;
        bar_expect(&full[s], 2 * TILE_BYTES + TR * sizeof(float));
        tma_load(Ks + s * TR * HD, mk, k_col, k0, frame, &full[s]);
        tma_load(Vs + s * TR * HD, mv, v_col, k0, frame, &full[s]);
        bulk_load(Bs + s * TR, kbias + k0, TR * sizeof(float), &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows 64 g .. 64 g + 63
  const int g = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int cq = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  Acc o;
#pragma unroll
  for (int i = 0; i < 32; ++i) o.d[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows r and r + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sums

  bar_wait(qbar, 0);
  const uint64_t dq = desc(Qs + g * TR * HD);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    bar_wait(&full[s], (it / STAGES) & 1);
    Acc sc;
    qk_issue(sc, dq, desc(Ks + s * TR * HD));
    mma_wait();
    reg_fence(sc);
    float c0, c1, s0, s1;
    softmax_tile(sc, Bs + s * TR, sl2, m0, m1, c0, c1, s0, s1);
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o.d[4 * j + 0] *= c0;
      o.d[4 * j + 1] *= c0;
      o.d[4 * j + 2] *= c1;
      o.d[4 * j + 3] *= c1;
    }
    uint32_t a[4][4];
    pack_weights(sc, a);
    pv_issue(o, a, desc(Vs + s * TR * HD));
    mma_wait();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // K, V and biases of s read
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r = g * TR + warp * 16 + (lane >> 2);
  bf16* o0 = out + (size_t)r * ldo + cq;
  bf16* o1 = o0 + 8 * ldo;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
        __floats2bfloat162_rn(o.d[4 * j + 0] * i0, o.d[4 * j + 1] * i0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
        __floats2bfloat162_rn(o.d[4 * j + 2] * i1, o.d[4 * j + 3] * i1);
  }
  if (row_m != nullptr && (lane & 3) == 0) {
    row_m[r] = m0;
    row_w[r] = qbias[r] > -0.5f ? i0 : 0.f;
    row_m[r + 8] = m1;
    row_w[r + 8] = qbias[r + 8] > -0.5f ? i1 : 0.f;
  }
}

}  // namespace wg

}  // namespace
