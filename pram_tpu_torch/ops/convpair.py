"""Fused 3x3 convolution pair: conv + BN + ReLU, twice, stride 1, NHWC.

:func:`fused_conv_pair` replaces ``pram_tpu/ops/convpair_pallas.py:fused_conv_pair``
(SFD2's conv3a + conv3b). A CPU tensor takes :func:`fused_conv_pair_plain`; a
CUDA tensor launches ``csrc/conv_pair.cu`` (bf16) or raises. Both fold each
BatchNorm into its convolution in f32 (``ops/stem.py:fold_bn``), round the
folded weights to x's type, accumulate in f32, add the f32 bias, apply ReLU
and round to x's type, the intermediate included, as the TPU kernel does.

Weights are torch's ``[O, I, 3, 3]``; each BN is ``(scale, bias, mean,
var)``. The JAX package's models keep the unfused convolutions
(``pram_tpu/models/sfd2.py``); so does the port's ``ResNet4x``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.stem import BN, fold_bn

LAUNCHES = {"fused_conv_pair": 0}

# channel multiples the CUDA kernel is written for (the wrapper pads to them)
KERNEL_CIN_MULTIPLE = 16
KERNEL_COUT_MULTIPLE = 128


def fused_conv_pair_plain(x, k1, b1, bn1: BN, k2, b2, bn2: BN) -> torch.Tensor:
    """``x [B, H, W, Cin]`` -> ``[B, H, W, Cout]`` in x's type (plain torch:
    two ``F.conv2d`` in f32 on the rounded operands)."""
    dt = x.dtype
    k1f, b1f = fold_bn(k1, b1, *bn1)
    k2f, b2f = fold_bn(k2, b2, *bn2)
    xc = x.permute(0, 3, 1, 2).float()
    a = F.relu(F.conv2d(xc, k1f.to(dt).float(), b1f, padding=1)).to(dt)
    y = F.relu(F.conv2d(a.float(), k2f.to(dt).float(), b2f, padding=1)).to(dt)
    return y.permute(0, 2, 3, 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _tap_major(kf: torch.Tensor, cout_p: int, cin_p: int) -> torch.Tensor:
    """``[O, I, 3, 3]`` -> ``[cout_p, 9, cin_p]`` bf16, zero-padded."""
    o, i = kf.shape[:2]
    w = torch.zeros((cout_p, 9, cin_p), dtype=torch.bfloat16, device=kf.device)
    w[:o, :, :i] = kf.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(o, 9, i)
    return w


def fused_conv_pair(x, k1, b1, bn1: BN, k2, b2, bn2: BN) -> torch.Tensor:
    """:func:`fused_conv_pair_plain` on the CPU; ``csrc/conv_pair.cu`` on CUDA.

    On CUDA the channel counts are padded with zero channels to the
    kernel's multiples (16 in, 128 for the intermediate and the output) and
    the output is sliced back.
    """
    if x.device.type == "cpu":
        return fused_conv_pair_plain(x, k1, b1, bn1, k2, b2, bn2)
    dev = x.device
    bsz, h, w, cin = x.shape
    cmid, cout = k1.shape[0], k2.shape[0]
    if tuple(k1.shape) != (cmid, cin, 3, 3) or tuple(k2.shape) != (cout, cmid, 3, 3):
        raise ValueError(f"conv pair kernels {tuple(k1.shape)} and {tuple(k2.shape)} do not "
                         f"chain from {cin} input channels")
    check_tensor(x, "x", (bsz, h, w, cin), torch.bfloat16, dev)
    cin_p = _round_up(cin, KERNEL_CIN_MULTIPLE)
    cmid_p = _round_up(cmid, KERNEL_COUT_MULTIPLE)
    cout_p = _round_up(cout, KERNEL_COUT_MULTIPLE)
    k1f, b1f = fold_bn(k1, b1, *bn1)
    k2f, b2f = fold_bn(k2, b2, *bn2)
    w1, w2 = _tap_major(k1f, cmid_p, cin_p), _tap_major(k2f, cout_p, cmid_p)
    b1p = torch.zeros(cmid_p, dtype=torch.float32, device=dev)
    b2p = torch.zeros(cout_p, dtype=torch.float32, device=dev)
    b1p[:cmid], b2p[:cout] = b1f, b2f
    if cin_p != cin:
        x = F.pad(x, (0, cin_p - cin))
    mid = torch.empty((bsz, h, w, cmid_p), dtype=torch.bfloat16, device=dev)
    out = torch.empty((bsz, h, w, cout_p), dtype=torch.bfloat16, device=dev)
    check_status(
        library().pram_conv_pair(
            ptr(x), ptr(w1), ptr(b1p), ptr(w2), ptr(b2p), ptr(mid), ptr(out),
            bsz, h, w, cin_p, cmid_p, cout_p, stream_of(dev),
        ),
        "pram_conv_pair",
    )
    LAUNCHES["fused_conv_pair"] += 1
    return out if cout_p == cout else out[..., :cout].contiguous()
