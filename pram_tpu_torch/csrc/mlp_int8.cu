// int8 residual concat-MLP (kernel 16):
//   y = x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3
// with every product s8 x s8 -> s32: weights per output column (quantized
// once by the wrapper), activations per row (quantized here), on the s8
// instance of the TMA/wgmma tile of mlp_tile.cuh (its header says what
// bounds it and how it works).
//
// Replaces pram_tpu/ops/mlp_pallas.py:fused_residual_mlp_int8
// (_mlp_kernel_i8). Quantization follows _quant_rows: rs = max(max|a|,
// 1e-6) / 127, q = round-half-even(a * (1 / rs)), no clip; msg, x, proj(msg)
// (after its rounding to bf16) and the f32 GELU output are quantized
// separately. The products are exact in s32 and dequantized in f32 in the
// TPU kernel's order, each product and sum rounded once (no FMA):
//   pm  = bf16((acc * rs_msg) * wps + bp)
//   h   = ((acc_x * rs_x) + (acc_pm * rs_pm)) * w0s + b0
//   out = bf16(x + bf16((acc * rs_y) * w3s + b3)).
// LayerNorm (eps from the caller) and the exact GELU run in f32, as in the
// bf16 instance; the GELU output is quantized from f32, not rounded to bf16
// first.
//
// Layouts (torch Linear, [out, in]): wpq [256, 256], w0q [512, 512] whose
// input columns are [x (256) | proj(msg) (256)], w3q [256, 512], all s8;
// wps [256], w0s [512], w3s [256] f32 per output feature; biases and the
// LayerNorm weight and bias f32; x, msg, out [tokens, 256] bf16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"

extern "C" int pram_residual_mlp_int8(const void* x, const void* msg, const void* wpq,
                                      const void* wps, const void* bp, const void* w0q,
                                      const void* w0s, const void* b0, const void* ln_w,
                                      const void* ln_b, const void* w3q, const void* w3s,
                                      const void* b3, void* out, int tokens, float eps,
                                      void* stream) {
  const mlptile::Vecs v = {(const float*)bp,   (const float*)b0,  (const float*)ln_w,
                           (const float*)ln_b, (const float*)b3,  (const float*)wps,
                           (const float*)w0s,  (const float*)w3s, eps};
  return mlptile::launch<int8_t>(x, msg, wpq, w0q, w3q, v, out, tokens, (cudaStream_t)stream);
}
