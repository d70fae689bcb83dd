"""Symmetric shared-QK cross-attention with the to_qk / to_v projections fused.

:func:`cross_attention` replaces
``pram_tpu/ops/attention_pallas.py:fused_cross_attention_proj``. The tokens
are the concatenation ``[x0 | x1]`` of two sides (``n0`` tokens, then the
rest); both sides share ``to_qk`` and ``to_v``, side 0's queries attend to
side 1's keys (masked by ``bias1``) and side 1's to side 0's (``bias0``).
A CPU tensor takes :func:`cross_attention_plain`; a CUDA tensor launches
``csrc/cross_attention.cu`` or raises. Weights are in torch ``Linear``
layout (``[out, in]``).
"""

from __future__ import annotations

import ctypes

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.attention import attend_plain

LAUNCHES = {"cross_attention": 0}

# shapes the CUDA kernel is written for
KERNEL_D = 256
KERNEL_HEAD_DIM = 64
KERNEL_QUERY_TILE = 128


def cross_attention_plain(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    """Messages ``[B, N, d]`` for the concatenation, in x_cat's dtype.

    qk and v are rounded to x_cat's dtype after an f32 bias; the logits
    ``qk_q . qk_k * scale + bias`` and the softmax are f32, and the weights
    are rounded to x_cat's dtype for the product with v (``attend_plain``).
    """
    b, n, _ = x_cat.shape
    d = w_qk.shape[0]
    hd = d // heads
    dt = x_cat.dtype

    def proj(w, bias):
        t = (x_cat.float() @ w.float().T + bias.float()).to(dt)
        return t.reshape(b, n, heads, hd).permute(0, 2, 1, 3)  # [B, H, N, hd]

    qk, v = proj(w_qk, b_qk), proj(w_v, b_v)
    m0 = attend_plain(qk[:, :, :n0], qk[:, :, n0:], v[:, :, n0:], bias1, scale)
    m1 = attend_plain(qk[:, :, n0:], qk[:, :, :n0], v[:, :, :n0], bias0, scale)
    return torch.cat([m0, m1], dim=2).permute(0, 2, 1, 3).reshape(b, n, d)


def cross_attention(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    """:func:`cross_attention_plain` on the CPU; ``csrc/cross_attention.cu`` on CUDA."""
    if x_cat.device.type == "cpu":
        return cross_attention_plain(
            x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0
        )
    b, n, d = x_cat.shape
    n1 = n - n0
    dev = x_cat.device
    if d != KERNEL_D or heads * KERNEL_HEAD_DIM != d:
        raise ValueError(
            f"CUDA cross-attention is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d={d}, heads={heads}"
        )
    if n0 <= 0 or n1 <= 0 or n0 % KERNEL_QUERY_TILE or n1 % KERNEL_QUERY_TILE:
        raise ValueError(
            f"CUDA cross-attention needs both sides a positive multiple of "
            f"{KERNEL_QUERY_TILE} tokens; got {n0} and {n1}"
        )
    f32 = torch.float32
    b_qk = b_qk.to(f32).contiguous()
    b_v = b_v.to(f32).contiguous()
    check_tensor(x_cat, "x_cat", (b, n, d), torch.bfloat16, dev)
    check_tensor(w_qk, "w_qk", (d, d), torch.bfloat16, dev)
    check_tensor(w_v, "w_v", (d, d), torch.bfloat16, dev)
    check_tensor(b_qk, "b_qk", (d,), f32, dev)
    check_tensor(b_v, "b_v", (d,), f32, dev)
    check_tensor(bias0, "bias0", (b, n0), f32, dev)
    check_tensor(bias1, "bias1", (b, n1), f32, dev)
    for name, t in (("x_cat", x_cat), ("w_qk", w_qk), ("w_v", w_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qk = torch.empty_like(x_cat)
    v = torch.empty_like(x_cat)
    out = torch.empty_like(x_cat)
    check_status(
        library().pram_cross_attention(
            ptr(x_cat), ptr(w_qk), ptr(b_qk), ptr(w_v), ptr(b_v), ptr(bias0),
            ptr(bias1), ptr(qk), ptr(v), ptr(out), b, n, n0, heads,
            ctypes.c_float(scale), stream_of(dev),
        ),
        "pram_cross_attention",
    )
    LAUNCHES["cross_attention"] += 1
    return out
