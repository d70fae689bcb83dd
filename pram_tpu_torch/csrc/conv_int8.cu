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
// What bounds it: the extractor's thick layers at 32 x 120 x 160 (conv3b:
// 256 -> 256) do 725 G s8 operations against 630 MB of bf16 in and out, so
// the tensor cores bound them (0.37 ms at 1979 TOP/s against 0.19 ms).
// The design (conv_tile.cuh) loads each block's input halo once, quantizing
// it on the way into shared memory as the TPU kernel quantizes its tile once,
// and reads the im2col rows in place with mma.sync m16n8k32; the per-channel
// scale and bias are applied to the s32 sums in registers. A residual
// block's grouped convolution runs as two 128-channel dense splits
// (pram_tpu/models/sfd2_int8.py:_expand_grouped): the channel offset and
// stride arguments let each split read its slice of the input and write its
// slice of one output, with no copy. wgmma with TMA-staged weights is the
// next step for speed.
//
// Layouts: x [B, H, W, x_cstride] bf16, channels x_coff .. + cin read; wq
// [cout, 9, cin] s8 (tap dy * 3 + dx); scale, bias [cout] f32 (for
// EPI_I8_BF16 both hold bf16 values: bf16(in_scale * w_scale) and
// bf16(bias)); out [B, Ho, Wo, out_cstride] bf16, channels out_coff .. +
// cout written.

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
