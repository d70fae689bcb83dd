"""int8 3x3 SAME convolution, stride 1 or 2, NHWC (the int8 extractor).

:func:`conv3x3_int8` replaces ``pram_tpu/ops/conv_int8_pallas.py:conv3x3_int8``
and ``conv3x3s2_int8``: ``relu?(s8conv(quant(x)) * (in_scale * w_scale) +
bias)`` with ``quant(x) = clip(round(x / in_scale), -127, 127)``, the sums
exact in s32 and the tail in f32, rounded to x's type. With ``bf16_tail``
it computes the XLA s8 route of ``pram_tpu/models/sfd2_int8.py`` instead,
whose tail runs in x's type: ``relu?(T(y) * T(in_scale * w_scale) +
T(bias))``, each operation rounded to T. In f32 the two tails agree.

A CPU tensor takes :func:`conv3x3_int8_plain`; a CUDA tensor launches
``csrc/conv_int8.cu`` (bf16 only) or raises. The gates
:func:`conv3x3_int8_supported` and :func:`conv3x3s2_int8_supported` are the
TPU kernel's, copied as they are: the int8 extractor takes the f32 tail on
exactly the layers where the JAX package takes its kernel. The CUDA kernel
itself takes any H and W (at least 2 columns at stride 2) and channel
counts that are multiples of 32 (in) and 128 (out), so it also runs the
layers the gates refuse, with the bf16 tail: the card has no s8
convolution in PyTorch.

The weights are ``[3, 3, Cin, Cout]`` int8 (the JAX HWIO layout, one scale
per output channel). ``x_coff``, ``out`` and ``out_coff`` read and write
channel slices in place (a residual block's two dense splits); on CUDA the
offsets and the tensors' channel counts are multiples of 8 (the kernel's
TMA copies move 16-byte aligned rows).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.quant import EXACT_F32_DEPTH, int_matmul, quant_static

LAUNCHES = {"conv3x3_int8": 0}

_VMEM_BUDGET = 14 << 20  # the TPU kernel's budget, kept for its gates

# shapes the CUDA kernel is written for
KERNEL_CIN_MULTIPLE = 32
KERNEL_COUT_MULTIPLE = 128
KERNEL_CHANNEL_ALIGN = 8  # channel offsets and pixel strides, for 16-byte TMA rows


def conv3x3_int8_supported(h: int, w: int, cin: int, cout: int) -> bool:
    """The TPU stride-1 gate (``conv_int8_pallas.py:conv3x3_int8_supported``)."""
    if cin % 128 != 0 or cout % 128 != 0 or h % 8 != 0:
        return False
    wp = -(-(w + 2) // 8) * 8
    vmem = (
        16 * wp * cin * 2
        + 16 * wp * cin
        + 2 * 16 * w * cin
        + w * 9 * cin
        + 9 * cin * cout
        + 8 * w * cout * 2
        + w * cout * 4
    )
    return vmem <= _VMEM_BUDGET


def conv3x3s2_int8_supported(h: int, w: int, cin: int, cout: int) -> bool:
    """The TPU stride-2 gate (``conv_int8_pallas.py:conv3x3s2_int8_supported``)."""
    if cin % 128 != 0 or cout % 128 != 0 or w % 2 != 0 or h % 2 != 0:
        return False
    ho = h // 2
    if ho % 8 != 0 and ho % 4 != 0:
        return False
    wo = w // 2
    wp2 = -(-(wo + 1) // 8) * 8
    th = 8 if ho % 8 == 0 else 4
    rows = 2 * th + 8
    vmem = (
        rows * wp2 * 2 * cin * 2
        + rows * wp2 * 2 * cin
        + rows * wo * cin
        + wo * 9 * cin
        + 9 * cin * cout
        + th * wo * cout * 2
        + wo * cout * 4
    )
    return vmem <= _VMEM_BUDGET


def int_conv3x3(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Exact SAME 3x3 convolution of integer-valued ``xq [B, H, W, Cin]``
    with ``wq [3, 3, Cin, Cout]``: one exact f32 product per tap, summed in
    f32 over as many taps as keep every sum below 2^24, and those groups in
    float64. Returns ``[B, Ho, Wo, Cout]`` (float64 when there is more than
    one group)."""
    b, h, w, cin = xq.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = F.pad(xq.float(), (0, 0, 1, 1, 1, 1))
    per_group = max(1, EXACT_F32_DEPTH // cin)
    acc = group = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        xs = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
        part = int_matmul(xs, wq[dy, dx])
        group = part if group is None else group.add_(part)
        if (tap + 1) % per_group == 0 or tap == 8:
            acc = group if acc is None else acc.double().add_(group.double())
            group = None
    return acc


def conv_tail(acc, in_scale, w_scale, bias, dtype, relu: bool, bf16_tail: bool):
    """The dequantizing tail on exact sums ``acc``: f32 (the TPU kernel's) or,
    with ``bf16_tail``, in ``dtype`` one operation at a time (the XLA route's)."""
    scale = w_scale.float() * float(in_scale)  # the f32 product
    if bf16_tail:
        y = acc.float().to(dtype) * scale.to(dtype) + bias.to(dtype)
    else:
        y = (acc.float() * scale + bias.float()).to(dtype)
    return torch.clamp(y, min=0) if relu else y


def conv3x3_int8_plain(x, wq, in_scale, w_scale, bias, *, stride=1, relu=True, bf16_tail=False):
    """``[B, Ho, Wo, Cout]`` in x's type from ``x [B, H, W, Cin]`` (plain
    torch: exact integer sums, then :func:`conv_tail`)."""
    acc = int_conv3x3(quant_static(x, in_scale), wq, stride)
    return conv_tail(acc, in_scale, w_scale, bias, x.dtype, relu, bf16_tail)


def conv3x3_int8(
    x, wq, in_scale, w_scale, bias, *, stride: int = 1, relu: bool = True,
    bf16_tail: bool = False, x_coff: int = 0, out: Optional[torch.Tensor] = None,
    out_coff: int = 0,
):
    """:func:`conv3x3_int8_plain` on the CPU; ``csrc/conv_int8.cu`` on CUDA.

    Reads channels ``x_coff .. x_coff + Cin`` of ``x``; writes channels
    ``out_coff .. out_coff + Cout`` of ``out`` (allocated ``[B, Ho, Wo,
    Cout]`` when None) and returns it. ``in_scale`` is a Python float.
    """
    b, h, w, c_all = x.shape
    cin, cout = wq.shape[2], wq.shape[3]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if out is None:
        out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        out[..., out_coff:out_coff + cout] = conv3x3_int8_plain(
            x[..., x_coff:x_coff + cin], wq, in_scale, w_scale, bias,
            stride=stride, relu=relu, bf16_tail=bf16_tail,
        )
        return out
    dev = x.device
    if stride not in (1, 2):
        raise ValueError(f"CUDA int8 conv takes stride 1 or 2, got {stride}")
    if cin % KERNEL_CIN_MULTIPLE or cout % KERNEL_COUT_MULTIPLE:
        raise ValueError(
            f"CUDA int8 conv needs Cin % {KERNEL_CIN_MULTIPLE} == 0 and Cout % "
            f"{KERNEL_COUT_MULTIPLE} == 0; got {cin} and {cout}"
        )
    if stride == 2 and w < 2:
        raise ValueError(f"CUDA int8 conv at stride 2 needs at least 2 columns, got {w}")
    a = KERNEL_CHANNEL_ALIGN
    if x_coff % a or c_all % a or x_coff + cin > c_all:
        raise ValueError(f"input channels {x_coff}..{x_coff + cin} of {c_all} are not readable "
                         f"(offset and count multiples of {a})")
    c_out_all = out.shape[-1]
    if out_coff % a or c_out_all % a or out_coff + cout > c_out_all:
        raise ValueError(f"output channels {out_coff}..{out_coff + cout} of {c_out_all} are not writable "
                         f"(offset and count multiples of {a})")
    scale = w_scale.float() * float(in_scale)
    if bf16_tail:
        scale, bias = scale.to(torch.bfloat16).float(), bias.to(torch.bfloat16).float()
    scale, bias = scale.contiguous(), bias.float().contiguous()
    w9 = wq.permute(3, 0, 1, 2).reshape(cout, 9, cin).contiguous()
    check_tensor(x, "x", (b, h, w, c_all), torch.bfloat16, dev)
    check_tensor(out, "out", (b, ho, wo, c_out_all), torch.bfloat16, dev)
    check_tensor(w9, "wq", (cout, 9, cin), torch.int8, dev)
    check_tensor(scale, "scale", (cout,), torch.float32, dev)
    check_tensor(bias, "bias", (cout,), torch.float32, dev)
    check_status(
        library().pram_conv3x3_int8(
            ptr(x), ptr(w9), ptr(scale), ptr(bias), ctypes.c_float(float(in_scale)),
            ptr(out), b, h, w, cin, c_all, x_coff, cout, c_out_all, out_coff,
            stride, int(bf16_tail), int(relu), stream_of(dev),
        ),
        "pram_conv3x3_int8",
    )
    LAUNCHES["conv3x3_int8"] += 1
    return out
