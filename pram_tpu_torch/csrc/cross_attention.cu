// Symmetric shared-QK cross-attention with the to_qk / to_v projections,
// for Hopper (bf16 in, f32 accumulation, f32 softmax): kernel 5.
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_cross_attention_proj
// (_cross_proj_kernel and _symmetric_cross_attention). The tokens are the
// concatenation of two sides, x_cat = [x0 (n0 tokens) | x1 (n1 tokens)]. Both
// sides share to_qk and to_v; the similarity qk0 . qk1^T is softmaxed along
// each axis, so side 0's queries attend to side 1's keys (masked by bias1)
// and side 1's queries to side 0's keys (masked by bias0). No rotary.
//
// Two launches on one stream:
//   1. csrc/proj_bf16.cu projects qk and v (bf16, bias added in f32 before
//      the rounding, as the TPU kernel's scratch holds them) into two
//      [B, N, 256] scratch tensors the wrapper allocates.
//   2. kernel 11's bf16 message pass without statistics
//      (csrc/cross_attention_packed.cu, wg::message_cta): one CTA per
//      (frame, head, 128 queries of either side) over the other side's
//      keys, the sides read as strided views of the scratch. The similarity
//      is computed once per direction, as the TPU kernel does.
// pram_cross_attention_tail is launch 2 alone; kernel 17's cross projection
// (csrc/proj_int8.cu) runs it on its s8 projection.
//
// What bounds it: at GML's shapes (B=32, 512 + 1024 tokens, d=256, 4 heads
// of 64) the projection moves ~76 MB (x in, qk and v out; 0.023 ms) and the
// two directions' QK and PV products are 25.8 GFLOP (0.026 ms).
//
// Rounding follows _attn_weights: logits = qk_q . qk_k * scale + bias in
// f32; the weights exp(logit - max) are rounded to bf16 for the P @ V
// product and 1/sum is folded into the output, so an all-masked key side
// (bias all -1e9) gives the mean of v. The output is rounded to bf16.
//
// Layouts: x [B, N, 256] bf16 with N = n0 + n1; w [512, 256] bf16 = the
// rows of to_qk then to_v (torch Linear layout [out, in]); b [512] f32;
// bias0 [B, n0] and bias1 [B, n1] f32 (0 or -1e9); scratch qk, v
// [B, N, 256] bf16; out [B, N, 256] bf16 with column h * 64 + i for head h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" int pram_project_bf16(const void* x, const void* w, const void* b,
                                 const void* cos, const void* sin, void* out0,
                                 void* out1, long long tokens, int n_out,
                                 int split, int rot_cols, void* stream);
extern "C" int pram_cross_attention_packed(
    const void* qk0, const void* qk1, const void* v0, const void* v1,
    long long qk0_stride, long long qk1_stride, long long v0_stride,
    long long v1_stride, const void* bias0, const void* bias1, void* m0,
    void* m1, long long m0_stride, long long m1_stride, void* rows,
    void* stat0, void* stat1, int B, int N, int M, int heads, float scale,
    int is_f32, void* stream);

namespace {
constexpr int D = 256;  // model width
typedef __nv_bfloat16 bf16;
}  // namespace

// the attention pass alone, on projections made outside: qk, v [B, N, 256]
// bf16; both sides multiples of 128 tokens
extern "C" int pram_cross_attention_tail(const void* qk, const void* v,
                                         const void* bias0, const void* bias1,
                                         void* out, int B, int N, int n0,
                                         int heads, float scale, void* stream) {
  if (n0 <= 0 || n0 >= N) return (int)cudaErrorInvalidValue;
  const long long fs = (long long)N * D;  // every side's frame stride
  const size_t side1 = (size_t)n0 * D;    // side 1's first row in a frame
  return pram_cross_attention_packed(
      qk, (const bf16*)qk + side1, v, (const bf16*)v + side1, fs, fs, fs, fs,
      bias0, bias1, out, (bf16*)out + side1, fs, fs, nullptr, nullptr, nullptr,
      B, n0, N - n0, heads, scale, 0, stream);
}

extern "C" int pram_cross_attention(const void* x, const void* w,
                                    const void* b, const void* bias0,
                                    const void* bias1, void* qk_scratch,
                                    void* v_scratch, void* out, int B, int N,
                                    int n0, int heads, float scale,
                                    void* stream) {
  if (n0 <= 0 || n0 >= N) return (int)cudaErrorInvalidValue;
  const int err = pram_project_bf16(x, w, b, nullptr, nullptr, qk_scratch,
                                    v_scratch, (long long)B * N, 2 * D, D, 0,
                                    stream);
  if (err) return err;
  return pram_cross_attention_tail(qk_scratch, v_scratch, bias0, bias1, out, B,
                                   N, n0, heads, scale, stream);
}
