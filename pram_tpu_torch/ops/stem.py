"""SFD2 stem: conv1a (3 -> 64, stride 1) + BN + ReLU, conv1b (64 -> 64,
stride 2) + BN + ReLU, 3x3 SAME convolutions (pram_tpu/models/sfd2.py).

:func:`fused_stem` replaces ``pram_tpu/ops/stem_pallas.py:fused_stem``: a CPU
tensor takes :func:`fused_stem_plain`, a CUDA tensor launches
``csrc/stem.cu`` or raises. Both fold the inference-mode BatchNorm into the
convolutions in f32 (:func:`fold_bn`), round the folded weights to the
image's type, accumulate in f32, and round conv1a's output to that type
before conv1b, as the TPU kernel does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of

LAUNCHES = {"fused_stem": 0}

# the bf16 kernel reads the image by TMA, whose rows must be a multiple of
# 16 bytes: a multiple of 8 pixels of 3 bf16 channels
KERNEL_ROW_PIXELS = 8

BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # scale, bias, mean, var


def fold_bn(kernel, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into a conv ``kernel [O, I, kh, kw]``
    and ``bias [O]``, in f32 whatever the inputs' type:
    ``conv(x) * g + (bias - mean) * g + bn_bias`` with
    ``g = scale / sqrt(var + eps)``."""
    g = scale.float() / torch.sqrt(var.float() + eps)
    kf = kernel.float() * g[:, None, None, None]
    bf = (bias.float() - mean.float()) * g + bn_bias.float()
    return kf, bf


def _folded(k1, b1, bn1: BN, k2, b2, bn2: BN, dtype):
    """Folded weights rounded to ``dtype`` and f32 biases."""
    k1f, b1f = fold_bn(k1, b1, *bn1)
    k2f, b2f = fold_bn(k2, b2, *bn2)
    return k1f.to(dtype), b1f, k2f.to(dtype), b2f


def fused_stem_plain(image, k1, b1, bn1: BN, k2, b2, bn2: BN) -> torch.Tensor:
    """``image [B, H, W, 3]`` (normalized, f32 or bf16) -> ``[B, (H+1)//2,
    (W+1)//2, 64]`` in the image's type (plain torch: two ``F.conv2d`` in f32
    on the rounded operands)."""
    dt = image.dtype
    w1, c1, w2, c2 = _folded(k1, b1, bn1, k2, b2, bn2, dt)
    x = image.permute(0, 3, 1, 2).float()
    a = F.relu(F.conv2d(x, w1.float(), c1, padding=1)).to(dt)
    y = F.relu(F.conv2d(a.float(), w2.float(), c2, stride=2, padding=1)).to(dt)
    return y.permute(0, 2, 3, 1)


def fused_stem(image, k1, b1, bn1: BN, k2, b2, bn2: BN) -> torch.Tensor:
    """:func:`fused_stem_plain` on the CPU; ``csrc/stem.cu`` on CUDA.

    Conv weights are torch's ``[O, I, 3, 3]`` (conv1a ``[64, 3, 3, 3]``,
    conv1b ``[64, 64, 3, 3]``); each BN is ``(scale, bias, mean, var)``. On
    CUDA the image is contiguous NHWC and the output is contiguous NHWC,
    which is channels_last memory for the next convolution.
    """
    if image.device.type == "cpu":
        return fused_stem_plain(image, k1, b1, bn1, k2, b2, bn2)
    dt, dev = image.dtype, image.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"CUDA stem takes an f32 or bf16 image, got {dt}")
    b, h, w, _ = image.shape
    check_tensor(image, "image", (b, h, w, 3), dt, dev)
    if tuple(k1.shape) != (64, 3, 3, 3) or tuple(k2.shape) != (64, 64, 3, 3):
        raise ValueError(f"stem kernels must be [64, 3, 3, 3] and [64, 64, 3, 3], "
                         f"got {tuple(k1.shape)} and {tuple(k2.shape)}")
    w1, c1, w2, c2 = _folded(k1, b1, bn1, k2, b2, bn2, dt)
    # rows K = (dy, dx, c), columns the output channel
    w1 = w1.float().permute(2, 3, 1, 0).reshape(27, 64)
    w2 = w2.permute(2, 3, 1, 0).reshape(576, 64)
    c1, c2 = c1.contiguous(), c2.contiguous()
    wp = w
    if dt == torch.bfloat16:
        # the wgmma instance's K-major planes [K / 8, 64, 8], conv1a's K
        # zero-padded to 32; the image's rows padded with zero pixels to a
        # multiple of 16 bytes for its TMA map
        w1 = torch.cat([w1, w1.new_zeros(5, 64)]).to(dt).reshape(4, 8, 64).transpose(1, 2).contiguous()
        w2 = w2.reshape(72, 8, 64).transpose(1, 2).contiguous()
        check_tensor(w1, "w1", (4, 64, 8), dt, dev)
        check_tensor(w2, "w2", (72, 64, 8), dt, dev)
        wp = -(-w // KERNEL_ROW_PIXELS) * KERNEL_ROW_PIXELS
        if wp != w or image.data_ptr() % 16:
            image = F.pad(image, (0, 0, 0, wp - w))
    else:
        w1, w2 = w1.contiguous(), w2.contiguous()
        check_tensor(w1, "w1", (27, 64), torch.float32, dev)
        check_tensor(w2, "w2", (576, 64), dt, dev)
    check_tensor(c1, "b1", (64,), torch.float32, dev)
    check_tensor(c2, "b2", (64,), torch.float32, dev)
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 64), dtype=dt, device=dev)
    check_status(
        library().pram_stem(
            ptr(image), ptr(w1), ptr(c1), ptr(w2), ptr(c2), ptr(out), b, h, w, wp,
            int(dt == torch.bfloat16), stream_of(dev),
        ),
        "pram_stem",
    )
    LAUNCHES["fused_stem"] += 1
    return out
