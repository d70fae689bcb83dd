"""Masked multi-head self-attention with the qkv projection and rotary fused.

:func:`self_attention` replaces
``pram_tpu/ops/attention_pallas.py:fused_self_attention_proj``, with its
block-diagonal ``splits``: the tokens are a concatenation of independent
sides and each query attends only to the keys of its own side. A CPU tensor
takes :func:`self_attention_plain`; a CUDA tensor launches
``csrc/attention.cu`` or raises.

:func:`self_attention_int8` is the same function with the projection in
int8 (``int8=True`` of the JAX function, kernel 17): x quantized per row,
the weights per output column, the product exact in s32.

Weights are in torch ``Linear`` layout: ``w_qkv [3 * d, d_in]`` whose output
index is ``(head * head_dim + i) * 3 + c`` for c in (q, k, v), the flax
kernel transposed and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.quant import int_matmul, quant_rows

LAUNCHES = {"self_attention": 0, "self_attention_int8": 0}

# shapes the CUDA kernel is written for
KERNEL_D_IN = 256
KERNEL_HEAD_DIM = 64
KERNEL_QUERY_TILE = 128
KERNEL_MAX_SPLITS = 8


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    xp = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-xp[..., 1], xp[..., 0]], dim=-1).reshape(x.shape)


def apply_rotary(freqs, t: torch.Tensor) -> torch.Tensor:
    """t * cos + rotate_half(t) * sin; ``freqs`` = (cos, sin) broadcasting over ``t``."""
    cos, sin = freqs
    return t * cos + rotate_half(t) * sin


def mask_to_bias(mask: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    """Bool validity mask -> f32 additive attention bias (0 / -1e9)."""
    if mask is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    return torch.where(mask, 0.0, -1e9).to(torch.float32)


def split_edges(splits: Optional[Sequence[int]], n: int) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` of the sides; one side of ``n`` tokens for None."""
    if splits is None:
        return [(0, n)]
    if sum(splits) != n:
        raise ValueError(f"splits {tuple(splits)} do not sum to {n} tokens")
    edges = [0]
    for s in splits:
        edges.append(edges[-1] + s)
    return list(zip(edges[:-1], edges[1:]))


def self_attention_plain(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """Messages ``[B, N, d]`` in x's dtype.

    x ``[B, N, d_in]``; cos/sin ``[B, N, head_dim]`` f32 or None; key_bias
    ``[B, N]`` f32; ``splits`` side lengths summing to N (None: one side).
    qkv and the rotated q/k are rounded to x's dtype, the logits and softmax
    are f32, and the probabilities are rounded to x's dtype for the product
    with v, as the kernel does.
    """
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    return _attend_qkv_plain(qkv, cos, sin, key_bias, scale, heads, splits)


def _attend_qkv_plain(qkv, cos, sin, key_bias, scale, heads, splits):
    """The attention of :func:`self_attention_plain` on its projected qkv
    ``[B, N, 3 * d]`` (the interleaved column order)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    qkv = qkv.reshape(b, n, heads, hd, 3).permute(0, 2, 1, 3, 4)
    q, k, v = qkv.unbind(-1)  # [B, H, N, hd]
    if cos is not None:
        enc = (cos[:, None].float(), sin[:, None].float())
        q = apply_rotary(enc, q.float()).to(dt)
        k = apply_rotary(enc, k.float()).to(dt)
    out = torch.cat(
        [
            attend_plain(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                         key_bias[:, lo:hi], scale)
            for lo, hi in split_edges(splits, n)
        ],
        dim=2,
    )
    return out.permute(0, 2, 1, 3).reshape(b, n, d)


def attend_plain(q, k, v, key_bias, scale, query_bias=None):
    """Masked softmax attention ``[B, (H,) Nq, hd]`` in v's dtype.

    Logits ``q k^T * scale + key_bias`` in f32 (key_bias ``[B, Nk]``); the
    max-subtracted weights are rounded to v's dtype for the product with v
    and the f32 1/sum is folded into the output (``_attn_weights`` of the
    TPU kernels), so an all-masked key row gives the mean of v. With
    ``query_bias [B, Nq]`` it also returns the per-key statistic
    ``[B, (H,) Nk]`` f32: the normalized f32 weights summed over the
    queries whose bias is above -0.5 (AdaGML's received attention).
    """
    lead = (key_bias.shape[0],) + (1,) * (q.dim() - 2)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    logits = logits + key_bias.float().reshape(*lead, key_bias.shape[-1])
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    del logits
    r = 1.0 / e.sum(dim=-1, keepdim=True)
    msg = ((e.to(v.dtype).float() @ v.float()) * r).to(v.dtype)
    if query_bias is None:
        return msg
    valid = (query_bias > -0.5).to(torch.float32).reshape(*lead[:-1], query_bias.shape[-1], 1)
    return msg, ((e * r) * valid).sum(dim=-2)


def _cuda_sides(x, cos, sin, heads, splits) -> List[int]:
    """The side lengths, after checking that the CUDA kernels take x's shape."""
    b, n, d_in = x.shape
    if cos is None or sin is None:
        raise ValueError("the CUDA self-attention kernel needs the rotary cos/sin")
    if d_in != KERNEL_D_IN or heads * KERNEL_HEAD_DIM != d_in:
        raise ValueError(
            f"CUDA self-attention is built for d_in={KERNEL_D_IN} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d_in={d_in}, heads={heads}"
        )
    sides = [hi - lo for lo, hi in split_edges(splits, n)]
    if any(s % KERNEL_QUERY_TILE for s in sides) or len(sides) > KERNEL_MAX_SPLITS:
        raise ValueError(
            f"CUDA self-attention needs N % {KERNEL_QUERY_TILE} == 0 on each of at "
            f"most {KERNEL_MAX_SPLITS} sides; got sides {tuple(sides)}"
        )
    return sides


def self_attention(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_plain` on the CPU; ``csrc/attention.cu`` on CUDA."""
    if x.device.type == "cpu":
        return self_attention_plain(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits)
    b, n, d_in = x.shape
    dev = x.device
    sides = _cuda_sides(x, cos, sin, heads, splits)
    b_qkv = b_qkv.to(torch.float32).contiguous()
    check_tensor(x, "x", (b, n, d_in), torch.bfloat16, dev)
    check_tensor(w_qkv, "w_qkv", (3 * d_in, d_in), torch.bfloat16, dev)
    check_tensor(b_qkv, "b_qkv", (3 * d_in,), torch.float32, dev)
    check_tensor(cos, "cos", (b, n, KERNEL_HEAD_DIM), torch.float32, dev)
    check_tensor(sin, "sin", (b, n, KERNEL_HEAD_DIM), torch.float32, dev)
    check_tensor(key_bias, "key_bias", (b, n), torch.float32, dev)
    for name, t in (("x", x), ("w_qkv", w_qkv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, n, d_in), dtype=torch.bfloat16, device=dev)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention(
            ptr(x), ptr(w_qkv), ptr(b_qkv), ptr(cos), ptr(sin),
            ptr(key_bias), ptr(out), b, n, heads, ctypes.c_float(scale),
            ctypes.cast(side_lengths, ctypes.c_void_p), len(sides), stream_of(dev),
        ),
        "pram_self_attention",
    )
    LAUNCHES["self_attention"] += 1
    return out


def int8_projection_plain(x, wq, ws, b):
    """``bf16((acc * rs) * ws + b)`` in x's dtype: x quantized per row
    (``quant_rows``), ``wq [out, in]`` int8 with ``ws [out]`` f32 scales,
    ``acc`` the exact integer product."""
    xq, xrs = quant_rows(x)
    return ((int_matmul(xq, wq.T) * xrs) * ws.float() + b.float()).to(x.dtype)


def qkv_block_order(d: int, device) -> torch.Tensor:
    """Row indices that take the interleaved qkv order ``(h * hd + i) * 3 +
    c`` to the ``[q heads | k heads | v heads]`` blocks of kernel 12."""
    return (torch.arange(d, device=device)[None, :] * 3 + torch.arange(3, device=device)[:, None]).reshape(-1)


def self_attention_int8_plain(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_plain` with the projection in int8
    (:func:`int8_projection_plain`): ``wq [3 * d, d_in]`` int8 and ``ws [3 *
    d]`` f32 are ``quant_linear`` of the interleaved ``w_qkv``."""
    qkv = int8_projection_plain(x, wq, ws, b_qkv)
    return _attend_qkv_plain(qkv, cos, sin, key_bias, scale, heads, splits)


def self_attention_int8(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_int8_plain` on the CPU; on CUDA
    ``csrc/proj_int8.cu`` (kernel 17) then kernel 12's blocked attention pass.

    The rows of wq, their scales and the bias are gathered into kernel 12's
    column order here, each scale with its row. Inference only.
    """
    if x.device.type == "cpu":
        return self_attention_int8_plain(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits)
    b, n, d_in = x.shape
    dev = x.device
    sides = _cuda_sides(x, cos, sin, heads, splits)
    order = qkv_block_order(d_in, dev)
    wq = wq.index_select(0, order).contiguous()
    ws = ws.float().index_select(0, order).contiguous()
    bq = b_qkv.float().index_select(0, order).contiguous()
    check_tensor(x, "x", (b, n, d_in), torch.bfloat16, dev)
    check_tensor(wq, "wq", (3 * d_in, d_in), torch.int8, dev)
    check_tensor(ws, "ws", (3 * d_in,), torch.float32, dev)
    check_tensor(cos, "cos", (b, n, KERNEL_HEAD_DIM), torch.float32, dev)
    check_tensor(sin, "sin", (b, n, KERNEL_HEAD_DIM), torch.float32, dev)
    check_tensor(key_bias, "key_bias", (b, n), torch.float32, dev)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    qkv = torch.empty((b, n, 3 * d_in), dtype=torch.bfloat16, device=dev)
    qr = torch.empty((b, n, d_in), dtype=torch.bfloat16, device=dev)
    kr, out = torch.empty_like(qr), torch.empty_like(qr)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention_int8(
            ptr(x), ptr(wq), ptr(ws), ptr(bq), ptr(cos), ptr(sin), ptr(key_bias),
            ptr(qkv), ptr(qr), ptr(kr), ptr(out), b, n, heads, ctypes.c_float(scale),
            ctypes.cast(side_lengths, ctypes.c_void_p), len(sides), stream_of(dev),
        ),
        "pram_self_attention_int8",
    )
    LAUNCHES["self_attention_int8"] += 1
    return out
