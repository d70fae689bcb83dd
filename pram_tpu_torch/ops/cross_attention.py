"""Symmetric shared-QK cross-attention with the to_qk / to_v projections fused.

:func:`cross_attention` replaces
``pram_tpu/ops/attention_pallas.py:fused_cross_attention_proj``. The tokens
are the concatenation ``[x0 | x1]`` of two sides (``n0`` tokens, then the
rest); both sides share ``to_qk`` and ``to_v``, side 0's queries attend to
side 1's keys (masked by ``bias1``) and side 1's to side 0's (``bias0``).
A CPU tensor takes :func:`cross_attention_plain`; a CUDA tensor launches
``csrc/cross_attention.cu`` or raises: two launches, the projection pass
``csrc/proj_bf16.cu`` into qk and v scratch tensors, then kernel 11's wgmma
message pass without statistics on views of them. Weights are in torch
``Linear`` layout (``[out, in]``). :func:`cross_attention_int8` is the same
function with both projections in int8 (``int8=True`` of the JAX function,
kernel 17): the s8 projection pass ``csrc/proj_int8.cu`` into the same
scratch tensors, then the same message pass.

:func:`cross_attention_packed` replaces
``pram_tpu/ops/attention_pallas.py:fused_cross_attention_packed``: the same
symmetric attention on projections made outside (AdaGML's blocks), with
optionally each side's received-attention statistics. A CPU tensor takes
:func:`cross_attention_packed_plain`; a CUDA tensor launches
``csrc/cross_attention_packed.cu`` or raises.

Sides off the 128-token query tile are padded inside the CUDA wrappers
(``ops/padding.py``: padded keys masked, padded queries sliced off;
:func:`on_side_tile`, :func:`packed_on_tile`).
"""

from __future__ import annotations

import ctypes

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, ptr_or_null, stream_of
from pram_tpu_torch.ops import attention
from pram_tpu_torch.ops.attention import attend_plain, check_aligned, project_int8_plain, project_plain
from pram_tpu_torch.ops.padding import pad_end, pad_sides, round_up, unpad, PAD_BIAS

LAUNCHES = {"cross_attention": 0, "cross_attention_packed": 0, "cross_attention_int8": 0}

# shapes the CUDA kernel is written for
KERNEL_D = 256
KERNEL_HEAD_DIM = 64
KERNEL_QUERY_TILE = 128


def cross_attention_plain(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    """Messages ``[B, N, d]`` for the concatenation, in x_cat's dtype.

    qk and v are rounded to x_cat's dtype after an f32 bias
    (``project_plain``); the logits ``qk_q . qk_k * scale + bias`` and the
    softmax are f32, and the weights are rounded to x_cat's dtype for the
    product with v (``attend_plain``).
    """
    qk = project_plain(x_cat, w_qk, b_qk)
    v = project_plain(x_cat, w_v, b_v)
    return _cross_attend_plain(qk, v, bias0, bias1, scale, heads, n0)


def _cross_attend_plain(qk, v, bias0, bias1, scale, heads, n0):
    """The attention of :func:`cross_attention_plain` on its projections
    ``qk, v [B, N, d]``."""
    b, n, d = qk.shape
    hd = d // heads
    qk = qk.reshape(b, n, heads, hd).permute(0, 2, 1, 3)  # [B, H, N, hd]
    v = v.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
    m0 = attend_plain(qk[:, :, :n0], qk[:, :, n0:], v[:, :, n0:], bias1, scale)
    m1 = attend_plain(qk[:, :, n0:], qk[:, :, :n0], v[:, :, :n0], bias0, scale)
    return torch.cat([m0, m1], dim=2).permute(0, 2, 1, 3).reshape(b, n, d)


def cross_attention_int8_plain(x_cat, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, bias0, bias1, scale, heads, n0):
    """:func:`cross_attention_plain` with both projections in int8 from one
    per-row quantization of x_cat (``project_int8_plain``): ``wq_* [d, d]``
    int8 and ``ws_* [d]`` f32 are ``quant_linear`` of to_qk and to_v."""
    qk = project_int8_plain(x_cat, wq_qk, ws_qk, b_qk)
    v = project_int8_plain(x_cat, wq_v, ws_v, b_v)
    return _cross_attend_plain(qk, v, bias0, bias1, scale, heads, n0)


def cross_attention_int8(x_cat, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, bias0, bias1, scale, heads, n0):
    """:func:`cross_attention_int8_plain` on the CPU; on CUDA kernel 17's C
    entry in ``csrc/proj_int8.cu``: the s8 projection pass into qk and v
    scratch tensors, then kernel 5's message pass (kernel 11's). Sides off
    the query tile are padded (:func:`on_side_tile`). Inference only."""
    if x_cat.device.type == "cpu":
        return cross_attention_int8_plain(
            x_cat, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, bias0, bias1, scale, heads, n0
        )
    return on_side_tile(_cross_attention_int8_cuda, x_cat, (wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v),
                        bias0, bias1, scale, heads, n0)


def _cross_attention_int8_cuda(x_cat, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, bias0, bias1, scale, heads, n0):
    b, n, d = x_cat.shape
    n1 = n - n0
    dev = x_cat.device
    _check_cuda_shape(d, heads)
    f32 = torch.float32
    wq = torch.cat([wq_qk, wq_v]).contiguous()
    ws = torch.cat([ws_qk.float(), ws_v.float()]).contiguous()
    bias = torch.cat([b_qk.float(), b_v.float()]).contiguous()
    check_tensor(x_cat, "x_cat", (b, n, d), torch.bfloat16, dev)
    check_tensor(wq, "wq", (2 * d, d), torch.int8, dev)
    check_tensor(ws, "ws", (2 * d,), f32, dev)
    check_tensor(bias0, "bias0", (b, n0), f32, dev)
    check_tensor(bias1, "bias1", (b, n1), f32, dev)
    check_aligned(x_cat=x_cat, bias0=bias0, bias1=bias1)
    qk, v, out = torch.empty_like(x_cat), torch.empty_like(x_cat), torch.empty_like(x_cat)
    check_status(
        library().pram_cross_attention_int8(
            ptr(x_cat), ptr(wq), ptr(ws), ptr(bias), ptr(bias0), ptr(bias1),
            ptr(qk), ptr(v), ptr(out), b, n, n0, heads, ctypes.c_float(scale),
            stream_of(dev),
        ),
        "pram_cross_attention_int8",
    )
    LAUNCHES["cross_attention_int8"] += 1
    attention.LAUNCHES["projection_int8"] += 1
    return out


def _check_cuda_shape(d, heads):
    if d != KERNEL_D or heads * KERNEL_HEAD_DIM != d:
        raise ValueError(
            f"CUDA cross-attention is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d={d}, heads={heads}"
        )


def _check_sides(n0, n1):
    if n0 <= 0 or n1 <= 0:
        raise ValueError(f"cross-attention needs two non-empty sides; got {n0} and {n1}")


def on_side_tile(launch, x_cat, weights, bias0, bias1, scale, heads, n0):
    """``launch(x_cat, *weights, bias0, bias1, scale, heads, n0)`` on the two
    sides each padded to the 128-token query tile, the padded keys at
    ``padding.PAD_BIAS``, and the real tokens' messages ``[B, N, d]``: the
    route of :func:`cross_attention` and :func:`cross_attention_int8` on
    CUDA (the CPU tests give the plain versions as ``launch``)."""
    n1 = x_cat.shape[1] - n0
    _check_sides(n0, n1)
    (xp,), kb, (p0, _), index = pad_sides((x_cat,), torch.cat([bias0, bias1], 1), (n0, n1), KERNEL_QUERY_TILE)
    if index is not None:
        bias0, bias1 = kb[:, :p0].contiguous(), kb[:, p0:].contiguous()
    return unpad(launch(xp, *weights, bias0, bias1, scale, heads, p0), index)


def cross_attention(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    """:func:`cross_attention_plain` on the CPU; ``csrc/cross_attention.cu`` on
    CUDA, with to_qk's and to_v's rows concatenated here into the
    projection's one ``[2 * d, d]`` weight. Sides off the query tile are
    padded (:func:`on_side_tile`)."""
    if x_cat.device.type == "cpu":
        return cross_attention_plain(
            x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0
        )
    return on_side_tile(_cross_attention_cuda, x_cat, (w_qk, b_qk, w_v, b_v), bias0, bias1, scale, heads, n0)


def _cross_attention_cuda(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    b, n, d = x_cat.shape
    n1 = n - n0
    dev = x_cat.device
    _check_cuda_shape(d, heads)
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
    check_aligned(x_cat=x_cat, bias0=bias0, bias1=bias1)
    w = torch.cat([w_qk, w_v])
    bias = torch.cat([b_qk, b_v])
    qk = torch.empty_like(x_cat)
    v = torch.empty_like(x_cat)
    out = torch.empty_like(x_cat)
    check_status(
        library().pram_cross_attention(
            ptr(x_cat), ptr(w), ptr(bias), ptr(bias0), ptr(bias1), ptr(qk), ptr(v),
            ptr(out), b, n, n0, heads, ctypes.c_float(scale), stream_of(dev),
        ),
        "pram_cross_attention",
    )
    LAUNCHES["cross_attention"] += 1
    return out


def cross_attention_packed_plain(qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats=False):
    """``(m0 [B, N, d], m1 [B, M, d])`` in qk0's dtype, and with
    ``return_stats`` also ``(stat0 [B, N], stat1 [B, M])`` f32.

    qk0, v0 ``[B, N, d]`` and qk1, v1 ``[B, M, d]`` are the raw to_qk /
    to_v outputs of the two sides (the scale applies to the similarity);
    bias0 ``[B, N]``, bias1 ``[B, M]`` f32 mask the keys and give the
    queries' validity. stat0 is the mass side 0's tokens receive from side
    1's valid queries, summed over heads; stat1 the mirror. One head at a
    time (``attend_plain``).
    """
    b, n, d = qk0.shape
    m = qk1.shape[1]
    hd = d // heads
    m0 = torch.empty((b, n, d), dtype=qk0.dtype, device=qk0.device)
    m1 = torch.empty((b, m, d), dtype=qk1.dtype, device=qk1.device)
    stat0 = torch.zeros((b, n), dtype=torch.float32, device=qk0.device)
    stat1 = torch.zeros((b, m), dtype=torch.float32, device=qk0.device)
    qb0, qb1 = (bias0, bias1) if return_stats else (None, None)
    for h in range(heads):
        s = slice(h * hd, (h + 1) * hd)
        r0 = attend_plain(qk0[:, :, s], qk1[:, :, s], v1[:, :, s], bias1, scale, qb0)
        r1 = attend_plain(qk1[:, :, s], qk0[:, :, s], v0[:, :, s], bias0, scale, qb1)
        if return_stats:
            (r0, st1), (r1, st0) = r0, r1
            stat0 += st0
            stat1 += st1
        m0[:, :, s], m1[:, :, s] = r0, r1
    return (m0, m1, stat0, stat1) if return_stats else (m0, m1)


def cross_attention_packed(qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats=False):
    """:func:`cross_attention_packed_plain` on the CPU;
    ``csrc/cross_attention_packed.cu`` on CUDA, in bf16 or f32.

    The four inputs may be views into one ``[B, N + M, d]`` projection:
    the kernel takes any frame stride with rows of ``d`` contiguous elements.
    Sides off the query tile are padded (:func:`packed_on_tile`).
    """
    if qk0.device.type == "cpu":
        return cross_attention_packed_plain(qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats)
    return packed_on_tile(_cross_attention_packed_cuda, qk0, qk1, v0, v1, bias0, bias1, scale, heads,
                          return_stats)


def packed_on_tile(launch, qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats=False):
    """``launch(qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats)``
    on each side padded at its end to the 128-token query tile (zero tokens,
    keys at ``padding.PAD_BIAS``, so a padded query is invalid and adds to
    no statistic), cut back to the real tokens: the route of
    :func:`cross_attention_packed` on CUDA (the CPU tests give the plain
    version as ``launch``). A side on the tile is passed as it is, views
    included."""
    n, m = qk0.shape[1], qk1.shape[1]
    _check_sides(n, m)
    pn, pm = round_up(n, KERNEL_QUERY_TILE), round_up(m, KERNEL_QUERY_TILE)
    qk0, v0, qk1, v1 = pad_end(qk0, pn), pad_end(v0, pn), pad_end(qk1, pm), pad_end(v1, pm)
    out = launch(qk0, qk1, v0, v1, pad_end(bias0, pn, PAD_BIAS), pad_end(bias1, pm, PAD_BIAS), scale, heads,
                 return_stats)
    if (pn, pm) == (n, m):
        return out
    cut = (n, m, n, m)
    return tuple(t[:, :k] for t, k in zip(out, cut))


def _cross_attention_packed_cuda(qk0, qk1, v0, v1, bias0, bias1, scale, heads, return_stats):
    b, n, d = qk0.shape
    m = qk1.shape[1]
    dev = qk0.device
    dt = qk0.dtype
    f32 = torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"CUDA cross-attention takes bf16 or f32, got {dt}")
    if d != KERNEL_D or heads * KERNEL_HEAD_DIM != d:
        raise ValueError(
            f"CUDA cross-attention is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d={d}, heads={heads}"
        )
    for name, t, rows in (("qk0", qk0, n), ("qk1", qk1, m), ("v0", v0, n), ("v1", v1, m)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (b, rows, d):
            raise ValueError(f"{name} must be {dt} [{b}, {rows}, {d}] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(2) != 1 or t.stride(1) != d or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous 16-byte aligned rows of {d} elements")
    check_tensor(bias0, "bias0", (b, n), f32, dev)
    check_tensor(bias1, "bias1", (b, m), f32, dev)
    check_aligned(bias0=bias0, bias1=bias1)
    m0 = torch.empty((b, n, d), dtype=dt, device=dev)
    m1 = torch.empty((b, m, d), dtype=dt, device=dev)
    rows = stat0 = stat1 = None
    if return_stats:
        rows = torch.empty((2, b, heads, n + m), dtype=f32, device=dev)
        stat0 = torch.empty((b, n), dtype=f32, device=dev)
        stat1 = torch.empty((b, m), dtype=f32, device=dev)
    check_status(
        library().pram_cross_attention_packed(
            ptr(qk0), ptr(qk1), ptr(v0), ptr(v1), qk0.stride(0), qk1.stride(0),
            v0.stride(0), v1.stride(0), ptr(bias0), ptr(bias1), ptr(m0), ptr(m1),
            n * d, m * d, ptr_or_null(rows), ptr_or_null(stat0), ptr_or_null(stat1), b, n, m,
            heads, ctypes.c_float(scale), int(dt == f32), stream_of(dev),
        ),
        "pram_cross_attention_packed",
    )
    LAUNCHES["cross_attention_packed"] += 1
    return (m0, m1, stat0, stat1) if return_stats else (m0, m1)
