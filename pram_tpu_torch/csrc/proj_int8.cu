// int8 attention projections for Hopper (kernel 17): the s8 prologue of the
// self-attention (kernel 1) and cross-attention (kernel 5) blocks.
//
// Replaces pram_tpu/ops/attention_pallas.py:_self_proj_kernel_i8 and
// _cross_proj_kernel_i8 (fused_self_attention_proj / fused_cross_attention_proj
// with int8=True): x is quantized per row (_quant_rows: rs = max(max|x|,
// 1e-6) / 127, q = round-half-even(x * (1 / rs)), no clip), the weights per
// output column (once, by the wrapper), the product is exact in s32, and
// bf16((acc * rs) * ws + b) (each product and sum rounded once) goes to the
// projection scratch. The attention tail is reused as it is: the
// self-attention's is kernel 12's blocked pass (csrc/attention_qkv.cu:
// rotary in f32 from the bf16 q and k, block-diagonal sides), the
// cross-attention's kernel 5's pass (csrc/cross_attention.cu:
// pram_cross_attention_tail, kernel 11's wgmma message pass).
//
// What bounds it: the projection of 32 x 1536 tokens to 768 columns is 19.3
// G s8 operations (0.010 ms at 1979 TOP/s) against 100 MB of bf16 in and out
// (0.030 ms): bytes. The TPU kernel projects a whole frame into VMEM inside
// the attention program; a Hopper block cannot hold a frame's qkv, so the
// projection is its own launch into a scratch tensor the wrapper allocates,
// followed on the same stream by the attention pass. A block quantizes 64
// rows of x once into shared memory and produces 128 output columns of them
// with mma.sync m16n8k32, the weight fragments read from L2 (0.2 MB of s8).
//
// Layouts: x [tokens, 256] bf16; wq [n_out, 256] s8 (torch Linear layout;
// the self-attention's rows in the [q heads | k heads | v heads] order of
// kernel 12, the cross-attention's [to_qk (256) | to_v (256)]); ws, b
// [n_out] f32. Output column c < split goes to out0[token, c] (row length
// split), the rest to out1[token, c - split] (row length n_out - split).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"

extern "C" int pram_self_attention_qkv(const void* qkv, const void* cos,
                                       const void* sin, const void* key_bias,
                                       void* qr, void* kr, void* out,
                                       void* rows, void* stat, int B, int N,
                                       int heads, float scale,
                                       const int* splits, int n_splits,
                                       int is_f32, void* stream);
extern "C" int pram_cross_attention_tail(const void* qk, const void* v,
                                         const void* bias0, const void* bias1,
                                         void* out, int B, int N, int n0,
                                         int heads, float scale, void* stream);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 256;    // input width
constexpr int MT = 64;    // tokens per block
constexpr int NT = 128;   // output columns per block
constexpr int NWARP = 8;  // warp w: rows (w & 3) * 16, columns (w >> 2) * 64
constexpr int NTHREADS = NWARP * 32;
constexpr int LDQ = D + 16;  // bytes, the s8 tile
constexpr size_t SMEM_BYTES = (size_t)MT * LDQ + MT * sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
proj_int8_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 bf16* __restrict__ out0, bf16* __restrict__ out1, int n_out,
                 int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Aq = smem;
  float* rs = reinterpret_cast<float*>(smem + (size_t)MT * LDQ);
  const size_t t0 = (size_t)blockIdx.x * MT;
  const int n_blk = blockIdx.y * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // _quant_rows, one warp per row
  for (int r = warp; r < MT; r += NWARP) {
    const float s = mma8::quant_row256(x + (t0 + r) * D, Aq + (size_t)r * LDQ);
    if (lane == 0) rs[r] = s;
  }
  __syncthreads();

  const int m0 = (warp & 3) * 16, nw = n_blk + (warp >> 2) * 64;
  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const unsigned char* arow = Aq + (size_t)(m0 + g) * LDQ + 4 * t;
  const unsigned char* wbase = reinterpret_cast<const unsigned char*>(wq);
  for (int kc = 0; kc < D; kc += 32) {
    uint32_t a[4];
    mma8::load_a(a, arow, LDQ, kc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned char* wrow = wbase + (size_t)(nw + j * 8 + g) * D + kc + 4 * t;
      mma8::mma(acc[j], a, __ldg(reinterpret_cast<const unsigned int*>(wrow)),
                __ldg(reinterpret_cast<const unsigned int*>(wrow + 16)));
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + (i >> 1) * 8, c = nw + j * 8 + 2 * t + (i & 1);
      const float v = __fadd_rn(
          __fmul_rn(__fmul_rn(__int2float_rn(acc[j][i]), rs[r]), ws[c]), bias[c]);
      bf16* dst = c < split ? out0 + (t0 + r) * split + c
                            : out1 + (t0 + r) * (n_out - split) + (c - split);
      *dst = __float2bfloat16_rn(v);
    }
}

int project(const void* x, const void* wq, const void* ws, const void* b,
            void* out0, void* out1, long tokens, int n_out, int split,
            cudaStream_t stream) {
  if (tokens <= 0 || tokens % MT != 0 || n_out % NT != 0)
    return (int)cudaErrorInvalidValue;
  proj_int8_kernel<<<dim3((unsigned)(tokens / MT), n_out / NT), NTHREADS,
                     SMEM_BYTES, stream>>>(
      (const bf16*)x, (const int8_t*)wq, (const float*)ws, (const float*)b,
      (bf16*)out0, (bf16*)out1, n_out, split);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, N, 256]; wq [768, 256], ws, b [768] in kernel 12's qkv column order;
// qkv [B, N, 768], qr, kr scratch and out [B, N, 256] bf16
extern "C" int pram_self_attention_int8(const void* x, const void* wq,
                                        const void* ws, const void* b,
                                        const void* cos, const void* sin,
                                        const void* key_bias, void* qkv,
                                        void* qr, void* kr, void* out, int B,
                                        int N, int heads, float scale,
                                        const int* splits, int n_splits,
                                        void* stream) {
  auto s = (cudaStream_t)stream;
  int err = project(x, wq, ws, b, qkv, nullptr, (long)B * N, 3 * D, 3 * D, s);
  if (err) return err;
  return pram_self_attention_qkv(qkv, cos, sin, key_bias, qr, kr, out, nullptr,
                                 nullptr, B, N, heads, scale, splits, n_splits,
                                 0, stream);
}

// x [B, N, 256] with N = n0 + n1; wq [512, 256] = [to_qk | to_v] rows, ws, b
// [512]; qk, v scratch and out [B, N, 256] bf16
extern "C" int pram_cross_attention_int8(const void* x, const void* wq,
                                         const void* ws, const void* b,
                                         const void* bias0, const void* bias1,
                                         void* qk, void* v, void* out, int B,
                                         int N, int n0, int heads, float scale,
                                         void* stream) {
  auto s = (cudaStream_t)stream;
  int err = project(x, wq, ws, b, qk, v, (long)B * N, 2 * D, D, s);
  if (err) return err;
  return pram_cross_attention_tail(qk, v, bias0, bias1, out, B, N, n0, heads,
                                   scale, stream);
}
