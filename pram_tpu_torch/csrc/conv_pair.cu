// Fused 3x3 convolution pair conv3a + BN + ReLU + conv3b + BN + ReLU,
// stride 1, NHWC bf16, for Hopper (kernel 19).
//
// Replaces pram_tpu/ops/convpair_pallas.py:fused_conv_pair (_pair_kernel),
// SFD2's 128 -> 256 -> 256 pair as im2col products with the BatchNorms
// folded into the weights (bf16) and biases (f32), f32 accumulation, and
// the intermediate rounded to bf16 after its bias and ReLU, as the TPU
// kernel rounds it into VMEM.
//
// What bounds it: at 32 x 120 x 160 the two convolutions are 1.09 TFLOP of
// bf16 products against 470 MB of input and output, so the tensor cores
// bound them (1.1 ms at 989 TFLOP/s against 0.14 ms). The TPU kernel keeps a
// row tile's 256-channel intermediate in VMEM; a Hopper CTA cannot hold the
// intermediate rows that a tile of conv3b reads without recomputing conv3a
// on every tile's halo, so the pair runs as two launches of kernel 18's
// tile (conv_tile.cuh: wgmma m64nNk16.f32.bf16.bf16 in place of s8, its
// converter warps copying the TMA-loaded halo into the A layout instead of
// quantizing it) on one stream, through an intermediate scratch tensor the
// wrapper allocates (9.8 MB a frame, read back from L2 in part).
//
// Layouts: x [B, H, W, cin] bf16; w1 [cmid, 9, cin], w2 [cout, 9, cmid] bf16
// (tap dy * 3 + dx); b1 [cmid], b2 [cout] f32; mid [B, H, W, cmid] bf16
// scratch; out [B, H, W, cout] bf16. cin a multiple of 16, cmid and cout
// multiples of 128 (the wrapper pads with zero channels).

#include "conv_tile.cuh"

extern "C" int pram_conv_pair(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* mid,
                              void* out, int B, int H, int W, int cin,
                              int cmid, int cout, void* stream) {
  using namespace convtile;
  auto s = (cudaStream_t)stream;
  Shape sa;
  sa.H = sa.Ho = H;
  sa.W = sa.Wo = W;
  sa.cin = sa.x_cstride = cin;
  sa.x_coff = 0;
  sa.out_cstride = cmid;
  sa.out_coff = 0;
  int err = launch<bf16, 1, EPI_BF16>(x, w1, nullptr, (const float*)b1, 1.f,
                                      mid, B, sa, cmid, 1, s);
  if (err) return err;
  Shape sb = sa;
  sb.cin = sb.x_cstride = cmid;
  sb.out_cstride = cout;
  return launch<bf16, 1, EPI_BF16>(mid, w2, nullptr, (const float*)b2, 1.f,
                                   out, B, sb, cout, 1, s);
}
