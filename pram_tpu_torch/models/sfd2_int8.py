"""int8 inference path of the frozen SFD2 extractor (pram_tpu/models/sfd2_int8.py).

BatchNorm is folded into the convolutions, the weights are quantized per
output channel (``ops/quant.py:quant_w``) and each quantized layer's input
per tensor, with a static scale calibrated by a float forward over a few
representative images (:func:`quantize_extractor`). The stem (conv1a,
conv1b) stays float and runs kernel 8 (``ops/stem.py``); the 1x1 heads
convPb and convDb stay float. Every 3x3 int8 convolution runs kernel 18
(``ops/conv_int8.py``), each with the tail the JAX package gives it: the
f32 tail where ``conv_kernel`` is on (``PRAM_INT8_CONV=1``) and the TPU
kernel's gate takes the layer, else the XLA route's tail in the working
type. The residual blocks' 1x1 convolutions are exact s8 products outside
any kernel (``torch._int_mm`` on the card), with the XLA route's tail.

:class:`Int8ResNet4x` returns what ``ResNet4x`` returns (NHWC
``score_map``, ``desc_map``, ``mid_features``, ``logits``), so
``models/sfd2.py:extract`` takes either. Inside, tensors are NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.models.sfd2 import ResNet4x, pixel_shuffle_score
from pram_tpu_torch.ops.conv_int8 import (
    conv3x3_int8,
    conv3x3_int8_plain,
    conv3x3_int8_supported,
    conv3x3s2_int8_supported,
    conv_tail,
)
from pram_tpu_torch.ops.quant import int_matmul, quant_static, quant_w
from pram_tpu_torch.ops.stem import fused_stem, fused_stem_plain

BN_EPS = 1e-5
# the backbone's quantized 3x3 layers (name, stride) and the heads' 3x3 layers
LAYERS = (("conv2a", 1), ("conv2b", 2), ("conv3a", 1), ("conv3b", 1))
HEADS = ("convPa_0", "convPa_3", "convDa_0", "convDa_3")
N_RES = 3


def fold_bn(kernel, bias, bn):
    """``models/sfd2_int8.py:_fold_bn``: fold ``bn = (scale, bias, mean,
    var)`` into a kernel whose last axis is the output channel, and its
    bias (None: no conv bias)."""
    g, b, mu, var = bn
    f = g / torch.sqrt(var + BN_EPS)
    return kernel * f, (bias - mu) * f + b if bias is not None else -mu * f + b


def expand_grouped(kernel, groups: int = 32, split: int = 128):
    """``models/sfd2_int8.py:_expand_grouped``: a grouped ``[3, 3, ipg, F]``
    kernel as dense block-diagonal splits ``[3, 3, split, split * opg /
    ipg]``, and the split width."""
    kh, kw, ipg, f = kernel.shape
    c = ipg * groups
    opg = f // groups
    split = min(split, c)
    gs = split // ipg
    n_split = groups // gs
    kg = kernel.reshape(kh, kw, ipg, n_split, gs, opg)
    eye = torch.eye(gs, dtype=kernel.dtype, device=kernel.device)
    return [
        torch.einsum("hwigo,Gg->hwGigo", kg[:, :, :, si], eye).reshape(kh, kw, split, gs * opg)
        for si in range(n_split)
    ], split


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch ``[O, I, kh, kw]`` -> flax ``[kh, kw, I, O]``."""
    return weight.permute(2, 3, 1, 0)


class Int8ResNet4x(nn.Module):
    """The quantized extractor, built from an int8 state (the names of the
    JAX package's qparams; :func:`quantize_extractor` or
    ``models/convert.py:int8_extractor_state``).

    ``conv_kernel`` stands for ``PRAM_INT8_CONV``. ``use_kernels = False``
    runs the stem and the int8 convolutions through their plain versions
    (the A/B check on the card). The static input scales are read once, at
    construction, into Python floats.
    """

    def __init__(self, state: Dict[str, torch.Tensor], outdim: int = 128, conv_kernel: bool = False):
        super().__init__()
        self.outdim = outdim
        self.conv_kernel = conv_kernel
        self.use_kernels = True
        for name, value in state.items():
            self.register_buffer(name, value)
        self.in_scales = {
            k[: -len("_in_scale")]: float(v) for k, v in state.items() if k.endswith("_in_scale")
        }

    def _stem_args(self):
        def bn(nm):
            return tuple(getattr(self, f"{nm}_bn_{p}") for p in ("scale", "bias", "mean", "var"))

        return tuple(
            a for nm in ("conv1a", "conv1b")
            for a in (getattr(self, f"{nm}_kernel"), getattr(self, f"{nm}_bias"), bn(nm))
        )

    def _conv(self, x, wq, name, w_scale, bias, stride, relu, f32_tail, x_coff=0, out=None, out_coff=0):
        kw = dict(stride=stride, relu=relu, bf16_tail=not f32_tail)
        sa = self.in_scales[name]
        if self.use_kernels:
            return conv3x3_int8(x, wq, sa, w_scale, bias, x_coff=x_coff, out=out, out_coff=out_coff, **kw)
        y = conv3x3_int8_plain(x[..., x_coff:x_coff + wq.shape[2]], wq, sa, w_scale, bias, **kw)
        if out is None:
            return y
        out[..., out_coff:out_coff + y.shape[-1]] = y
        return out

    def _qlayer(self, name, x, stride, relu=True):
        """Quantize with the layer's static scale, s8 3x3 conv, tail."""
        wq = getattr(self, f"{name}_wq")
        gate = conv3x3_int8_supported if stride == 1 else conv3x3s2_int8_supported
        f32_tail = self.conv_kernel and gate(x.shape[1], x.shape[2], x.shape[3], wq.shape[-1])
        return self._conv(x, wq, name, getattr(self, f"{name}_wscale"), getattr(self, f"{name}_bias"),
                          stride, relu, f32_tail)

    def _q1x1(self, name, x, relu):
        """1x1 s8 product (exact) and the XLA route's tail."""
        sa = self.in_scales[name]
        wq = getattr(self, f"{name}_wq")
        xq = quant_static(x, sa)
        if x.is_cuda:
            acc = torch._int_mm(xq.to(torch.int8).reshape(-1, x.shape[-1]), wq.T.contiguous().T)
            acc = acc.reshape(*x.shape[:-1], wq.shape[-1])
        else:
            acc = int_matmul(xq, wq)
        return conv_tail(acc, sa, getattr(self, f"{name}_wscale"), getattr(self, f"{name}_bias"),
                         x.dtype, relu, bf16_tail=True)

    def _qres(self, name, x):
        identity = x
        y = self._q1x1(f"{name}_conv1", x, relu=True)
        wq = getattr(self, f"{name}_conv2_wq")  # [n_split, 3, 3, split, oc]
        split, oc = wq.shape[3], wq.shape[4]
        f32_tail = self.conv_kernel and conv3x3_int8_supported(y.shape[1], y.shape[2], split, oc)
        ws, bias = getattr(self, f"{name}_conv2_wscale"), getattr(self, f"{name}_conv2_bias")
        out = torch.empty(y.shape[:-1] + (oc * wq.shape[0],), dtype=y.dtype, device=y.device)
        for si in range(wq.shape[0]):
            sl = slice(si * oc, (si + 1) * oc)
            self._conv(y, wq[si], f"{name}_conv2", ws[sl], bias[sl], 1, True, f32_tail,
                       x_coff=si * split, out=out, out_coff=si * oc)
        y = self._q1x1(f"{name}_conv3", out, relu=False)
        return torch.clamp(y + identity, min=0)

    def _head(self, name, x):
        """Float 1x1 head: f32 products of the working-type operands, f32
        bias, rounded to the working type."""
        w = getattr(self, f"{name}_w")
        return (x.float() @ w.to(x.dtype).float() + getattr(self, f"{name}_b").float()).to(x.dtype)

    def forward(self, image: torch.Tensor) -> dict:
        """``image [B, H, W, 3]`` ImageNet-normalized: ``ResNet4x``'s outputs."""
        stem = fused_stem if self.use_kernels else fused_stem_plain
        x = stem(image.contiguous(), *self._stem_args())
        for name, stride in LAYERS:
            x = self._qlayer(name, x, stride)
        for i in range(N_RES):
            x = self._qres(f"res_{i}", x)
        out4 = x

        cpa = self._qlayer("convPa_0", out4, 2)
        cpa = self._qlayer("convPa_3", cpa, 1, relu=False)
        logits = self._head("convPb", cpa)
        semi = torch.softmax(logits, dim=-1)[..., :-1]
        score_map = pixel_shuffle_score(semi.permute(0, 3, 1, 2))

        cda = self._qlayer("convDa_0", out4, 1)
        cda = self._qlayer("convDa_3", cda, 1, relu=False)
        desc = self._head("convDb", cda)
        norm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
        desc = desc / torch.clamp(norm, min=1e-12)
        return {"score_map": score_map, "desc_map": desc, "mid_features": out4, "logits": logits}


def _conv_f(x, k_hwio, stride=1):
    """f32 SAME 3x3 conv, NHWC in and out, HWIO kernel, no bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k_hwio.permute(3, 2, 0, 1), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def quantize_extractor(model: ResNet4x, calib_images: torch.Tensor, conv_kernel: bool = False) -> Int8ResNet4x:
    """``models/sfd2_int8.py:quantize_extractor``: fold BN, quantize the
    weights, calibrate the static input scales by a float forward (f32, on
    the model's weights as they are, in f32; TF32 off) over ``calib_images
    [B, H, W, 3]`` (preprocessed). The int8 model is on the model's device,
    its stem in f32 (:func:`cast_stem` casts it)."""
    dev = next(model.parameters()).device
    f32 = torch.float32

    def t(a):
        return a.detach().to(dev, f32)

    def bn_of(bn):
        return (t(bn.weight), t(bn.bias), t(bn.running_mean), t(bn.running_var))

    state: Dict[str, torch.Tensor] = {}
    for nm in ("conv1a", "conv1b"):
        blk = getattr(model, nm)
        state[f"{nm}_kernel"], state[f"{nm}_bias"] = t(blk.conv.weight), t(blk.conv.bias)
        for p, v in zip(("scale", "bias", "mean", "var"), bn_of(blk.bn)):
            state[f"{nm}_bn_{p}"] = v

    maxima: Dict[str, float] = {}

    def track(name, x):
        maxima[name] = float(x.abs().max())

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = fused_stem_plain(calib_images.to(dev, f32), *(
            a for nm in ("conv1a", "conv1b")
            for a in (state[f"{nm}_kernel"], state[f"{nm}_bias"],
                      tuple(state[f"{nm}_bn_{p}"] for p in ("scale", "bias", "mean", "var")))
        ))
        folded = {}
        for nm, stride in LAYERS:
            blk = getattr(model, nm)
            kf, bf = fold_bn(_hwio(t(blk.conv.weight)), t(blk.conv.bias), bn_of(blk.bn))
            folded[nm] = (kf, bf)
            track(nm, x)
            x = torch.clamp(_conv_f(x, kf, stride) + bf, min=0)
        for i, blk in enumerate(model.res):
            nm = f"res_{i}"
            identity = x
            k1 = t(blk.conv1.weight)[:, :, 0, 0].T  # [C, F]
            k1f, b1f = fold_bn(k1, None, bn_of(blk.bn1))
            track(f"{nm}_conv1", x)
            y = torch.clamp(x @ k1f + b1f, min=0)
            k2f, b2f = fold_bn(_hwio(t(blk.conv2.weight)), None, bn_of(blk.bn2))
            track(f"{nm}_conv2", y)
            splits, split = expand_grouped(k2f)
            y = torch.cat([_conv_f(y[..., si * split:(si + 1) * split], w) for si, w in enumerate(splits)], -1)
            y = torch.clamp(y + b2f, min=0)
            k3f, b3f = fold_bn(t(blk.conv3.weight)[:, :, 0, 0].T, None, bn_of(blk.bn3))
            track(f"{nm}_conv3", y)
            x = torch.clamp(y @ k3f + b3f + identity, min=0)
            folded[f"{nm}_conv1"], folded[f"{nm}_conv3"] = (k1f, b1f), (k3f, b3f)
            folded[f"{nm}_conv2"] = (splits, b2f)
        out4 = x
        for head, stride in (("Pa", 2), ("Da", 1)):
            c0, bn, c3 = (getattr(model, f"conv{head}_0"), getattr(model, f"conv{head}_bn"),
                          getattr(model, f"conv{head}_3"))
            kf, bf = fold_bn(_hwio(t(c0.weight)), t(c0.bias), bn_of(bn))
            folded[f"conv{head}_0"] = (kf, bf)
            track(f"conv{head}_0", out4)
            y = torch.clamp(_conv_f(out4, kf, stride) + bf, min=0)
            folded[f"conv{head}_3"] = (_hwio(t(c3.weight)), t(c3.bias))
            track(f"conv{head}_3", y)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def in_scale(name):
        return torch.tensor(max(maxima[name], 1e-6) / 127.0, dtype=f32, device=dev)

    for nm in [n for n, _ in LAYERS] + list(HEADS) + [f"res_{i}_conv{j}" for i in range(N_RES) for j in (1, 3)]:
        kf, bf = folded[nm]
        state[f"{nm}_wq"], state[f"{nm}_wscale"] = quant_w(kf)
        state[f"{nm}_bias"], state[f"{nm}_in_scale"] = bf, in_scale(nm)
    for i in range(N_RES):
        nm = f"res_{i}_conv2"
        splits, bf = folded[nm]
        qs = [quant_w(w) for w in splits]
        state[f"{nm}_wq"] = torch.stack([q for q, _ in qs])
        state[f"{nm}_wscale"] = torch.cat([s for _, s in qs])
        state[f"{nm}_bias"], state[f"{nm}_in_scale"] = bf, in_scale(nm)
    for nm in ("convPb", "convDb"):
        conv = getattr(model, nm)
        state[f"{nm}_w"], state[f"{nm}_b"] = t(conv.weight)[:, :, 0, 0].T.contiguous(), t(conv.bias)
    state = {k: v.contiguous() for k, v in state.items()}
    return Int8ResNet4x(state, outdim=model.convDb.out_channels, conv_kernel=conv_kernel)


def cast_stem(model: Int8ResNet4x, dtype: torch.dtype) -> Int8ResNet4x:
    """``models/sfd2_int8.py:cast_stem``: the float stem's kernels, biases
    and BN statistics in the pipeline's type, in place; the int8 weights and
    the f32 scales and biases stay."""
    for name, buf in model.named_buffers():
        if name.startswith(("conv1a_", "conv1b_")):
            setattr(model, name, buf.to(dtype))
    return model
