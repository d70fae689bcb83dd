"""Masked self-attention from a packed qkv tensor, with rotary on q and k and,
optionally, AdaGML's per-key received-attention statistics.

:func:`self_attention_qkv` replaces
``pram_tpu/ops/attention_pallas.py:fused_self_attention_qkv`` and, with
``splits``, ``fused_self_attention_qkv_blocked``: the tokens are a
concatenation of independent sides and each query attends only to the keys
of its own side. A CPU tensor takes :func:`self_attention_qkv_plain`; a
CUDA tensor launches ``csrc/attention_qkv.cu`` or raises.

The qkv tensor is ``[B, N, 3 * d]`` in ``[q heads | k heads | v heads]``
column blocks, the output of a projection whose weight columns went
through :func:`permute_qkv_kernel`. The statistic of a key is the attention
mass it receives, summed over heads and over the valid queries (bias > -0.5)
of its side, from the normalized f32 weights; the caller divides by
``heads * n_valid`` for the mean. Sides off the 128-token query tile are
padded inside the CUDA wrapper (:func:`qkv_on_query_tile`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, ptr_or_null, stream_of
from pram_tpu_torch.ops.attention import apply_rotary, attend_plain, split_edges
from pram_tpu_torch.ops.padding import pad_sides, unpad

LAUNCHES = {"self_attention_qkv": 0, "self_attention_qkv_blocked": 0}

# shapes the CUDA kernel is written for
KERNEL_D = 256
KERNEL_HEAD_DIM = 64
KERNEL_QUERY_TILE = 128
KERNEL_MAX_SPLITS = 8


def permute_qkv_kernel(kernel: torch.Tensor, bias: torch.Tensor, heads: int, hd: int):
    """Reorder a qkv projection ``kernel [in, (h, hd, 3)]`` (flax layout, the
    torch weight transposed) and its bias to the packed ``[q | k | v]``
    column blocks the kernel slices: ``([in, 3 * d], [3 * d])``."""
    d = heads * hd
    w = kernel.reshape(kernel.shape[0], heads, hd, 3).permute(0, 3, 1, 2)
    bp = bias.reshape(heads, hd, 3).permute(2, 0, 1)
    return w.reshape(kernel.shape[0], 3 * d), bp.reshape(3 * d)


def self_attention_qkv_plain(
    qkv, cos, sin, key_bias, scale, heads,
    splits: Optional[Sequence[int]] = None, return_stats: bool = False,
):
    """Messages ``[B, N, d]`` in qkv's dtype, and with ``return_stats`` the
    per-key statistic ``[B, N]`` f32.

    qkv ``[B, N, 3 * d]`` in ``[q | k | v]`` blocks; cos/sin ``[B, N, hd]``
    f32 or None (no rotary); key_bias ``[B, N]`` f32, also the queries'
    validity; ``splits`` side lengths summing to N (None: one side). Rotary
    runs in f32 from q and k in qkv's dtype and is rounded back to it, as
    the kernel does. One head at a time, so the f32 logits held are
    ``[B, N, N]`` of a single head.
    """
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    edges = split_edges(splits, n)
    out = torch.empty((b, n, d), dtype=dt, device=qkv.device)
    stat = torch.zeros((b, n), dtype=torch.float32, device=qkv.device) if return_stats else None
    for h in range(heads):
        q = qkv[:, :, h * hd:(h + 1) * hd]
        k = qkv[:, :, d + h * hd:d + (h + 1) * hd]
        v = qkv[:, :, 2 * d + h * hd:2 * d + (h + 1) * hd]
        if cos is not None:
            q = apply_rotary((cos.float(), sin.float()), q.float()).to(dt)
            k = apply_rotary((cos.float(), sin.float()), k.float()).to(dt)
        for lo, hi in edges:
            kb = key_bias[:, lo:hi]
            msg = attend_plain(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], kb, scale, kb if return_stats else None)
            if return_stats:
                msg, st = msg
                stat[:, lo:hi] += st
            out[:, lo:hi, h * hd:(h + 1) * hd] = msg
    return (out, stat) if return_stats else out


def self_attention_qkv(
    qkv, cos, sin, key_bias, scale, heads,
    splits: Optional[Sequence[int]] = None, return_stats: bool = False,
):
    """:func:`self_attention_qkv_plain` on the CPU; ``csrc/attention_qkv.cu``
    on CUDA, in bf16 or f32, sides off the query tile padded
    (:func:`qkv_on_query_tile`)."""
    if qkv.device.type == "cpu":
        return self_attention_qkv_plain(qkv, cos, sin, key_bias, scale, heads, splits, return_stats)
    return qkv_on_query_tile(_self_attention_qkv_cuda, qkv, cos, sin, key_bias, scale, heads, splits,
                             return_stats)


def qkv_on_query_tile(launch, qkv, cos, sin, key_bias, scale, heads, splits=None, return_stats=False):
    """``launch(qkv, cos, sin, key_bias, scale, heads, splits,
    return_stats)`` on the sides each padded to the 128-token query tile,
    the padded tokens' bias at ``padding.PAD_BIAS`` (masked as keys, invalid
    as queries, so they add to no statistic), cut back to the real tokens:
    the route of :func:`self_attention_qkv` on CUDA (the CPU tests give the
    plain version as ``launch``)."""
    sides = [hi - lo for lo, hi in split_edges(splits, qkv.shape[1])]
    (qp, cp, sp), kb, padded, index = pad_sides((qkv, cos, sin), key_bias, sides, KERNEL_QUERY_TILE)
    out = launch(qp, cp, sp, kb, scale, heads, None if splits is None else padded, return_stats)
    return tuple(unpad(t, index) for t in out) if return_stats else unpad(out, index)


def _self_attention_qkv_cuda(qkv, cos, sin, key_bias, scale, heads, splits, return_stats):
    b, n, d3 = qkv.shape
    dev = qkv.device
    dt = qkv.dtype
    f32 = torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"CUDA self-attention takes bf16 or f32, got {dt}")
    if cos is None or sin is None:
        raise ValueError("the CUDA self-attention kernel needs the rotary cos/sin")
    if d3 != 3 * KERNEL_D or heads * KERNEL_HEAD_DIM != KERNEL_D:
        raise ValueError(
            f"CUDA self-attention is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got qkv width {d3}, heads={heads}"
        )
    sides = [hi - lo for lo, hi in split_edges(splits, n)]
    if len(sides) > KERNEL_MAX_SPLITS:
        raise ValueError(f"CUDA self-attention takes at most {KERNEL_MAX_SPLITS} sides; got {len(sides)}")
    check_tensor(qkv, "qkv", (b, n, d3), dt, dev)
    check_tensor(cos, "cos", (b, n, KERNEL_HEAD_DIM), f32, dev)
    check_tensor(sin, "sin", (b, n, KERNEL_HEAD_DIM), f32, dev)
    check_tensor(key_bias, "key_bias", (b, n), f32, dev)
    for name, t in (("qkv", qkv), ("key_bias", key_bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qr = torch.empty((b, n, KERNEL_D), dtype=dt, device=dev)
    kr = torch.empty_like(qr)
    out = torch.empty_like(qr)
    rows = stat = None
    if return_stats:
        rows = torch.empty((2, b, heads, n), dtype=f32, device=dev)
        stat = torch.empty((b, n), dtype=f32, device=dev)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention_qkv(
            ptr(qkv), ptr(cos), ptr(sin), ptr(key_bias), ptr(qr), ptr(kr),
            ptr(out), ptr_or_null(rows), ptr_or_null(stat), b, n, heads,
            ctypes.c_float(scale), ctypes.cast(side_lengths, ctypes.c_void_p),
            len(sides), int(dt == f32), stream_of(dev),
        ),
        "pram_self_attention_qkv",
    )
    LAUNCHES["self_attention_qkv_blocked" if splits is not None else "self_attention_qkv"] += 1
    return (out, stat) if return_stats else out
