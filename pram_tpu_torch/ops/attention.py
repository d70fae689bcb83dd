"""Masked multi-head self-attention with the qkv projection and rotary fused.

:func:`self_attention` replaces
``pram_tpu/ops/attention_pallas.py:fused_self_attention_proj``, with its
block-diagonal ``splits``: the tokens are a concatenation of independent
sides and each query attends only to the keys of its own side. A CPU tensor
takes :func:`self_attention_plain`; a CUDA tensor launches
``csrc/attention.cu`` or raises: two launches, the projection pass
``csrc/proj_bf16.cu`` with q and k rotated in its epilogue, then kernel
12's wgmma message pass.

:func:`project` is that projection pass alone (also kernel 5's, with two
outputs), and :func:`project_plain` its plain version, on which the plain
versions of kernels 1 and 5 are built.

:func:`self_attention_int8` is the same function with the projection in
int8 (``int8=True`` of the JAX function, kernel 17): x quantized per row,
the weights per output column, the product exact in s32. On CUDA it is two
launches too: the s8 projection pass ``csrc/proj_int8.cu`` (the same
epilogue, rotary included), then kernel 12's message pass.
:func:`project_int8` is that pass alone (also kernel 17 cross-attention's,
with two outputs), and :func:`project_int8_plain` its plain version.

Weights are in torch ``Linear`` layout: ``w_qkv [3 * d, d_in]`` whose output
index is ``(head * head_dim + i) * 3 + c`` for c in (q, k, v), the flax
kernel transposed and nothing else.

Token counts off the kernels' tiles are padded inside the CUDA wrappers
(``ops/padding.py``): each side up to 128 tokens for the message pass,
padded keys masked, padded queries sliced off (:func:`on_query_tile`); the
projection passes' rows up to 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, ptr_or_null, stream_of
from pram_tpu_torch.ops.padding import on_row_tile, pad_sides, unpad
from pram_tpu_torch.ops.quant import int_matmul, quant_rows

# "projection" counts the standalone wrapper :func:`project` only: kernels
# 1 and 5 launch the same pass from their C entries. "projection_int8"
# counts every launch of the s8 pass: :func:`project_int8`'s and those of
# kernel 17's two forms (self_attention_int8 here, cross_attention_int8 in
# ops/cross_attention.py), whose C entries launch it before their message
# pass.
LAUNCHES = {"self_attention": 0, "self_attention_int8": 0, "projection": 0, "projection_int8": 0}

# shapes the CUDA kernel is written for
KERNEL_D_IN = 256
KERNEL_HEAD_DIM = 64
KERNEL_QUERY_TILE = 128
KERNEL_MAX_SPLITS = 8
# output columns of a CTA of the projection passes: n_out and rotary_cols
# are multiples of them; their token tile
KERNEL_PROJ_SLICE = 128
KERNEL_PROJ_INT8_SLICE = 256
KERNEL_PROJ_TOKEN_TILE = 64


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


def project_plain(x, w, b, cos=None, sin=None, rotary_cols=0):
    """``x @ w^T + b`` ``[..., n_out]`` in x's dtype, and with ``rotary_cols``
    its first columns rotated head by head (the plain version of
    ``csrc/proj_bf16.cu``).

    w ``[n_out, d_in]`` (torch ``Linear`` layout); the bias is added in f32
    before the one rounding to x's dtype. The rotary takes cos/sin ``[...,
    head_dim]`` f32 of each token, runs in f32 from the rounded value and is
    rounded back, pair index ``column % head_dim``.
    """
    y = (x.float() @ w.float().T + b.float()).to(x.dtype)
    return _rotate_columns(y, cos, sin, rotary_cols) if rotary_cols else y


def _rotate_columns(y, cos, sin, cols):
    """y with its first ``cols`` columns rotated, head by head, in f32 from
    y's dtype and rounded back to it."""
    hd = cos.shape[-1]
    r = y[..., :cols].unflatten(-1, (cols // hd, hd))
    enc = (cos.float().unsqueeze(-2), sin.float().unsqueeze(-2))
    r = apply_rotary(enc, r.float()).to(y.dtype).flatten(-2)
    return torch.cat([r, y[..., cols:]], dim=-1)


def self_attention_plain(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """Messages ``[B, N, d]`` in x's dtype.

    x ``[B, N, d_in]``; cos/sin ``[B, N, head_dim]`` f32 or None; key_bias
    ``[B, N]`` f32; ``splits`` side lengths summing to N (None: one side).
    qkv and the rotated q/k are rounded to x's dtype (:func:`project_plain`
    on the weights in kernel 12's block order), the logits and softmax are
    f32, and the probabilities are rounded to x's dtype for the product with
    v, as the kernel does.
    """
    d = w_qkv.shape[0] // 3
    order = qkv_block_order(d, x.device)
    qkv = project_plain(x, w_qkv.index_select(0, order), b_qkv.index_select(0, order),
                        cos, sin, 0 if cos is None else 2 * d)
    return _attend_blocks_plain(qkv, key_bias, scale, heads, splits)


def _attend_blocks_plain(qkv, key_bias, scale, heads, splits):
    """The attention of :func:`self_attention_plain` on its projected qkv
    ``[B, N, 3 * d]`` in ``[q heads | k heads | v heads]`` blocks, q and k
    already rotated."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    q, k, v = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, N, hd]
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
    """The side lengths, after checking that the CUDA kernels take x's shape
    (each side is a multiple of the query tile: :func:`on_query_tile` pads)."""
    b, n, d_in = x.shape
    if cos is None or sin is None:
        raise ValueError("the CUDA self-attention kernel needs the rotary cos/sin")
    if d_in != KERNEL_D_IN or heads * KERNEL_HEAD_DIM != d_in:
        raise ValueError(
            f"CUDA self-attention is built for d_in={KERNEL_D_IN} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d_in={d_in}, heads={heads}"
        )
    sides = [hi - lo for lo, hi in split_edges(splits, n)]
    if len(sides) > KERNEL_MAX_SPLITS:
        raise ValueError(f"CUDA self-attention takes at most {KERNEL_MAX_SPLITS} sides; got {len(sides)}")
    return sides


def on_query_tile(launch, x, weights, cos, sin, key_bias, scale, heads, splits=None):
    """``launch(x, *weights, cos, sin, key_bias, scale, heads, splits)`` on
    x's sides each padded to the 128-token query tile, the padded keys at
    ``padding.PAD_BIAS``, and its real tokens' messages ``[B, N, d]``: the
    route of :func:`self_attention` and :func:`self_attention_int8` on CUDA
    (the CPU tests give the plain versions as ``launch``)."""
    sides = [hi - lo for lo, hi in split_edges(splits, x.shape[1])]
    (xp, cp, sp), kb, padded, index = pad_sides((x, cos, sin), key_bias, sides, KERNEL_QUERY_TILE)
    out = launch(xp, *weights, cp, sp, kb, scale, heads, None if splits is None else padded)
    return unpad(out, index)


def check_aligned(**tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (TMA)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _projection_outputs(x, n_out, b, cos, sin, rotary_cols, split, slice_cols, name):
    """Check what the projection passes take (x ``[..., 256]`` bf16, the
    bias, cos/sin with ``rotary_cols``, the shape) and allocate their
    outputs: ``(b f32, split, out0, out1 or None, tokens)``."""
    dev = x.device
    split = n_out if split is None else split
    b = b.to(torch.float32).contiguous()
    check_tensor(x, "x", (*x.shape[:-1], KERNEL_D_IN), torch.bfloat16, dev)
    check_tensor(b, "b", (n_out,), torch.float32, dev)
    tokens = x.numel() // KERNEL_D_IN
    if n_out % slice_cols or rotary_cols % slice_cols or rotary_cols > n_out or split % 64 or not 0 < split <= n_out:
        raise ValueError(
            f"{name} needs n_out and rotary_cols multiples of {slice_cols} and split of 64; got "
            f"n_out {n_out}, rotary_cols {rotary_cols}, split {split}"
        )
    check_aligned(x=x, b=b)
    if rotary_cols:
        for t_name, t in (("cos", cos), ("sin", sin)):
            check_tensor(t, t_name, (*x.shape[:-1], KERNEL_HEAD_DIM), torch.float32, dev)
        check_aligned(cos=cos, sin=sin)
    out0 = torch.empty((*x.shape[:-1], split), dtype=torch.bfloat16, device=dev)
    out1 = torch.empty((*x.shape[:-1], n_out - split), dtype=torch.bfloat16, device=dev) if split < n_out else None
    return b, split, out0, out1, tokens


def _split_plain(y, split):
    return y if split is None else (y[..., :split], y[..., split:])


def project(x, w, b, cos=None, sin=None, rotary_cols=0, split=None):
    """:func:`project_plain` on the CPU; ``csrc/proj_bf16.cu`` on CUDA.

    x ``[..., 256]`` bf16; w ``[n_out, 256]`` bf16; b ``[n_out]``; cos/sin
    ``[..., 64]`` f32 with ``rotary_cols``. With ``split`` the result is two
    tensors, the columns before and from ``split``, as the kernel writes
    them. On CUDA n_out and rotary_cols are multiples of 128 and split of
    64; the tokens are padded to 64 (:func:`on_token_tile`).
    """
    if x.device.type == "cpu":
        return _split_plain(project_plain(x, w, b, cos, sin, rotary_cols), split)
    return on_token_tile(_project_cuda, x, (w, b), cos, sin, rotary_cols, split)


def on_token_tile(launch, x, weights, cos, sin, rotary_cols, split):
    """``launch(x, *weights, cos, sin, rotary_cols, split)`` on x's tokens
    flattened and padded with zero rows to the projection passes' 64, cut
    back to x's leading shape: the route of :func:`project` and
    :func:`project_int8` on CUDA (the CPU tests give the plain versions)."""
    rot = (cos, sin) if rotary_cols else (None, None)
    if rotary_cols and any(t is None or t.shape[:-1] != x.shape[:-1] for t in rot):
        raise ValueError(f"cos/sin need x's token shape {tuple(x.shape[:-1])}; got "
                         f"{[None if t is None else tuple(t.shape) for t in rot]}")
    return on_row_tile(lambda x2, c2, s2: launch(x2, *weights, c2, s2, rotary_cols, split),
                       KERNEL_PROJ_TOKEN_TILE, x, *rot)


def _project_cuda(x, w, b, cos, sin, rotary_cols, split):
    n_out = w.shape[0]
    b, split, out0, out1, tokens = _projection_outputs(
        x, n_out, b, cos, sin, rotary_cols, split, KERNEL_PROJ_SLICE, "the CUDA projection")
    check_tensor(w, "w", (n_out, KERNEL_D_IN), torch.bfloat16, x.device)
    check_aligned(w=w)
    check_status(
        library().pram_project_bf16(
            ptr(x), ptr(w), ptr(b), ptr_or_null(cos if rotary_cols else None),
            ptr_or_null(sin if rotary_cols else None), ptr(out0), ptr_or_null(out1),
            tokens, n_out, split, rotary_cols, stream_of(x.device),
        ),
        "pram_project_bf16",
    )
    LAUNCHES["projection"] += 1
    return out0 if out1 is None else (out0, out1)


def project_int8_plain(x, wq, ws, b, cos=None, sin=None, rotary_cols=0):
    """``bf16((acc * rs) * ws + b)`` ``[..., n_out]`` in x's dtype, and with
    ``rotary_cols`` its first columns rotated as :func:`project_plain`
    rotates them (the plain version of ``csrc/proj_int8.cu``).

    x is quantized per row (``quant_rows``: scales ``rs``), ``wq [n_out,
    d_in]`` int8 carries the column scales ``ws [n_out]`` f32
    (``quant_linear``), and ``acc`` is the exact integer product; each
    product and the bias sum are rounded once in f32.
    """
    xq, xrs = quant_rows(x)
    y = ((int_matmul(xq, wq.T) * xrs) * ws.float() + b.float()).to(x.dtype)
    return _rotate_columns(y, cos, sin, rotary_cols) if rotary_cols else y


def project_int8(x, wq, ws, b, cos=None, sin=None, rotary_cols=0, split=None):
    """:func:`project_int8_plain` on the CPU; ``csrc/proj_int8.cu`` on CUDA.

    x ``[..., 256]`` bf16; wq ``[n_out, 256]`` int8 and ws ``[n_out]``;
    b ``[n_out]``; cos/sin ``[..., 64]`` f32 with ``rotary_cols``. With
    ``split`` the result is two tensors, the columns before and from
    ``split``. On CUDA n_out and rotary_cols are multiples of 256 and split
    of 64; the tokens are padded to 64 (:func:`on_token_tile`).
    """
    if x.device.type == "cpu":
        return _split_plain(project_int8_plain(x, wq, ws, b, cos, sin, rotary_cols), split)
    return on_token_tile(_project_int8_cuda, x, (wq, ws, b), cos, sin, rotary_cols, split)


def _project_int8_cuda(x, wq, ws, b, cos, sin, rotary_cols, split):
    n_out = wq.shape[0]
    b, split, out0, out1, tokens = _projection_outputs(
        x, n_out, b, cos, sin, rotary_cols, split, KERNEL_PROJ_INT8_SLICE, "the CUDA s8 projection")
    ws = ws.to(torch.float32).contiguous()
    check_tensor(wq, "wq", (n_out, KERNEL_D_IN), torch.int8, x.device)
    check_tensor(ws, "ws", (n_out,), torch.float32, x.device)
    check_aligned(wq=wq, ws=ws)
    check_status(
        library().pram_project_int8(
            ptr(x), ptr(wq), ptr(ws), ptr(b), ptr_or_null(cos if rotary_cols else None),
            ptr_or_null(sin if rotary_cols else None), ptr(out0), ptr_or_null(out1),
            tokens, n_out, split, rotary_cols, stream_of(x.device),
        ),
        "pram_project_int8",
    )
    LAUNCHES["projection_int8"] += 1
    return out0 if out1 is None else (out0, out1)


def self_attention(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_plain` on the CPU; ``csrc/attention.cu`` on CUDA.

    The rows of w_qkv and b_qkv are gathered into kernel 12's block order
    here; the kernel writes the rotated qkv into a ``[B, N, 768]`` scratch
    and runs the message pass on it. Sides off the query tile are padded
    (:func:`on_query_tile`).
    """
    if x.device.type == "cpu":
        return self_attention_plain(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits)
    return on_query_tile(_self_attention_cuda, x, (w_qkv, b_qkv), cos, sin, key_bias, scale, heads, splits)


def _self_attention_cuda(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits):
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
    check_aligned(x=x, cos=cos, sin=sin, key_bias=key_bias)
    order = qkv_block_order(d_in, dev)
    w = w_qkv.index_select(0, order)
    bq = b_qkv.index_select(0, order)
    qkv = torch.empty((b, n, 3 * d_in), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, n, d_in), dtype=torch.bfloat16, device=dev)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention(
            ptr(x), ptr(w), ptr(bq), ptr(cos), ptr(sin), ptr(key_bias), ptr(qkv),
            ptr(out), b, n, heads, ctypes.c_float(scale),
            ctypes.cast(side_lengths, ctypes.c_void_p), len(sides), stream_of(dev),
        ),
        "pram_self_attention",
    )
    LAUNCHES["self_attention"] += 1
    return out


def qkv_block_order(d: int, device) -> torch.Tensor:
    """Row indices that take the interleaved qkv order ``(h * hd + i) * 3 +
    c`` to the ``[q heads | k heads | v heads]`` blocks of kernel 12."""
    return _block_order(d, torch.device(device))


@functools.lru_cache(maxsize=None)
def _block_order(d: int, device: torch.device) -> torch.Tensor:
    return (torch.arange(d)[None, :] * 3 + torch.arange(3)[:, None]).reshape(-1).to(device)


def self_attention_int8_plain(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_plain` with the projection in int8
    (:func:`project_int8_plain` on the rows in kernel 12's block order):
    ``wq [3 * d, d_in]`` int8 and ``ws [3 * d]`` f32 are ``quant_linear``
    of the interleaved ``w_qkv``."""
    d = wq.shape[0] // 3
    order = qkv_block_order(d, x.device)
    qkv = project_int8_plain(x, wq.index_select(0, order), ws.index_select(0, order),
                             b_qkv.index_select(0, order), cos, sin, 0 if cos is None else 2 * d)
    return _attend_blocks_plain(qkv, key_bias, scale, heads, splits)


def self_attention_int8(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    """:func:`self_attention_int8_plain` on the CPU; on CUDA kernel 17's C
    entry in ``csrc/proj_int8.cu``: the s8 projection pass into a ``[B, N,
    768]`` qkv scratch, q and k rotated in its epilogue, then kernel 12's
    message pass on it (no rotate launch).

    The rows of wq, their scales and the bias are gathered into kernel 12's
    column order here, each scale with its row. Sides off the query tile are
    padded (:func:`on_query_tile`). Inference only.
    """
    if x.device.type == "cpu":
        return self_attention_int8_plain(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits)
    return on_query_tile(_self_attention_int8_cuda, x, (wq, ws, b_qkv), cos, sin, key_bias, scale, heads, splits)


def _self_attention_int8_cuda(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits):
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
    check_aligned(x=x, cos=cos, sin=sin, key_bias=key_bias)
    qkv = torch.empty((b, n, 3 * d_in), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, n, d_in), dtype=torch.bfloat16, device=dev)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention_int8(
            ptr(x), ptr(wq), ptr(ws), ptr(bq), ptr(cos), ptr(sin), ptr(key_bias),
            ptr(qkv), ptr(out), b, n, heads, ctypes.c_float(scale),
            ctypes.cast(side_lengths, ctypes.c_void_p), len(sides), stream_of(dev),
        ),
        "pram_self_attention_int8",
    )
    LAUNCHES["self_attention_int8"] += 1
    LAUNCHES["projection_int8"] += 1
    return out
