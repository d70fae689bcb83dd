// int8 3x3 SAME convolution, stride 1 or 2, NHWC, for Hopper (kernel 18).
//
// Replaces pram_tpu/ops/conv_int8_pallas.py:conv3x3_int8 (_conv_kernel) and
// conv3x3s2_int8 (_conv_s2_kernel): the input arrives bf16 and is quantized
// in the tile with the layer's static scale (divided, rounded half to even,
// clipped to +-127), the s8 x s8 products accumulate exactly in s32, and the
// f32 tail y * (in_scale * w_scale) + bias, optional ReLU, is rounded to
// bf16. The JAX package runs the layers its gates refuse (conv2a at 64 input
// channels, convPa_3 at 60 rows) as XLA s8 convolutions with a bf16 tail;
// PyTorch has no s8 convolution on the card, so this kernel takes those
// layers too, with that tail (EPI_I8_BF16), and any H, W and a channel
// count that is a multiple of 32.
//
// What bounds it: operations. The 14 layers of one int8 batch (32 frames of
// 480 x 640) do 4.53 T s8 operations against 2.06 GB of bf16 in and out and
// s8 weights: 2.29 ms at 1979 TOP/s against 0.61 ms at 3.35 TB/s. The
// thickest, conv3b (256 -> 256 at 32 x 120 x 160), does 725 G: 0.37 ms
// against 0.19 ms of bytes.
//
// Design (conv_tile.cuh): an implicit GEMM on wgmma m64nNk32.s32.s8.s8 with
// TMA-fed operands. A CTA tile is 8 x 16 output pixels x all the layer's
// output channels (up to 256), so the bf16 halo is loaded by TMA and
// quantized into shared memory once a CTA, by three converter warps, while
// the consumer warpgroups' products run; the A operand is that halo in the
// no-swizzle K-major layout, each tap a shifted descriptor; the weights
// stream in (tap, 64-channel) stages through a TMA ring; the per-channel
// scale and bias are applied to the s32 sums in registers and the bf16
// result leaves through shared memory by TMA stores. A residual block's
// grouped convolution runs as two 128-channel dense splits
// (pram_tpu/models/sfd2_int8.py:_expand_grouped): the channel offset and
// stride arguments let each split read its slice of the input and write its
// slice of one output, with no copy.
//
// Layouts: x [B, H, W, x_cstride] bf16, channels x_coff .. + cin read; wq
// [cout, 9, cin] s8 (tap dy * 3 + dx); scale, bias [cout] f32 (for
// EPI_I8_BF16 both hold bf16 values: bf16(in_scale * w_scale) and
// bf16(bias)); out [B, Ho, Wo, out_cstride] bf16, channels out_coff .. +
// cout written. Channel offsets and strides are multiples of 8, cout of
// 128; every pointer 16-byte aligned.

#include "conv_tile.cuh"

extern "C" int pram_conv3x3_int8(const void* x, const void* wq,
                                 const void* scale, const void* bias,
                                 float in_scale, void* out, int B, int H,
                                 int W, int cin, int x_cstride, int x_coff,
                                 int cout, int out_cstride, int out_coff,
                                 int stride, int bf16_tail, int relu,
                                 void* stream) {
  using namespace convtile;
  Shape sh;
  sh.H = H;
  sh.W = W;
  sh.Ho = (H - 1) / stride + 1;
  sh.Wo = (W - 1) / stride + 1;
  sh.cin = cin;
  sh.x_cstride = x_cstride;
  sh.x_coff = x_coff;
  sh.out_cstride = out_cstride;
  sh.out_coff = out_coff;
  auto s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  if (stride == 1 && !bf16_tail)
    return launch<int8_t, 1, EPI_I8_F32>(x, wq, sc, bi, in_scale, out, B, sh, cout, relu, s);
  if (stride == 1)
    return launch<int8_t, 1, EPI_I8_BF16>(x, wq, sc, bi, in_scale, out, B, sh, cout, relu, s);
  if (stride == 2 && !bf16_tail)
    return launch<int8_t, 2, EPI_I8_F32>(x, wq, sc, bi, in_scale, out, B, sh, cout, relu, s);
  if (stride == 2)
    return launch<int8_t, 2, EPI_I8_BF16>(x, wq, sc, bi, in_scale, out, B, sh, cout, relu, s);
  return (int)cudaErrorInvalidValue;
}
