// Self-attention with the qkv projection, rotary encoding and key mask fused,
// for Hopper (bf16 in, f32 accumulation, f32 softmax): kernel 1.
//
// Replaces pram_tpu/ops/attention_pallas.py:fused_self_attention_proj
// (_self_proj_kernel), with its block-diagonal `splits` option: the tokens
// are a concatenation of independent sides (GML runs both keypoint sets
// through one layer stack), and a query attends only to the keys of its own
// side. Every split is a multiple of the 128-row query tile.
//
// Two launches on one stream:
//   1. csrc/proj_bf16.cu projects qkv = bf16(x W^T + b) into a [B, N, 768]
//      scratch the wrapper allocates, in [q heads | k heads | v heads]
//      column blocks, with q and k rotated in its epilogue. Every key is
//      projected once, where a CTA of one (frame, head, query tile) that
//      projected its own keys would redo each key once per query tile of
//      its side (4x at 512 tokens, 8x at 1024).
//   2. kernel 12's bf16 message pass (csrc/attention_qkv.cu,
//      wg::message_cta): one CTA per (frame, head, 128 queries) over the
//      keys of its side, q, k and v read by TMA through one tensor map of
//      the scratch, S, P and O in registers.
//
// What bounds it: at GML's shapes (B=32, 512 + 1024 tokens, d=256, 4 heads
// of 64) the projection moves ~126 MB (x and cos / sin in, qkv out; 0.038
// ms at 3.35 TB/s) and the attention's QK and PV products are 42.9 GFLOP
// (0.043 ms at 989 TFLOP/s) over the scratch it wrote.
//
// Rounding follows the TPU kernel: qkv = bf16(x @ W + b) with an f32 bias;
// the rotary product in f32 from the bf16 q/k, rounded back to bf16;
// logits q.k * scale + key_bias in f32; the weights rounded to bf16 for the
// P @ V product, 1/sum folded into the f32 output, which is rounded to bf16.
//
// Layouts: x [B, N, 256] bf16; w_qkv [768, 256] bf16 and b_qkv [768] f32 in
// the block order (the wrapper gathers them from the flax layout); cos, sin
// [B, N, 64] f32; key_bias [B, N] f32 (0 or -1e9); qkv scratch [B, N, 768]
// bf16; out [B, N, 256] bf16 with column h * 64 + i.

#include <cuda_runtime.h>

extern "C" int pram_project_bf16(const void* x, const void* w, const void* b,
                                 const void* cos, const void* sin, void* out0,
                                 void* out1, long long tokens, int n_out,
                                 int split, int rot_cols, void* stream);
extern "C" int pram_self_attention_rotated(const void* qkv,
                                           const void* key_bias, void* out,
                                           int B, int N, int heads,
                                           float scale, const int* splits,
                                           int n_splits, void* stream);

// splits: n_splits side lengths (host memory), each a multiple of 128 and
// summing to N; one side of N tokens is plain self-attention
extern "C" int pram_self_attention(const void* x, const void* w_qkv,
                                   const void* b_qkv, const void* cos,
                                   const void* sin, const void* key_bias,
                                   void* qkv, void* out, int B, int N,
                                   int heads, float scale, const int* splits,
                                   int n_splits, void* stream) {
  constexpr int D = 256;
  if (heads * 64 != D) return (int)cudaErrorInvalidValue;
  const int err = pram_project_bf16(x, w_qkv, b_qkv, cos, sin, qkv, nullptr,
                                    (long long)B * N, 3 * D, 3 * D, 2 * D,
                                    stream);
  if (err) return err;
  return pram_self_attention_rotated(qkv, key_bias, out, B, N, heads, scale,
                                     splits, n_splits, stream);
}
