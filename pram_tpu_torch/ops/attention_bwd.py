"""Backward of the fused self- and cross-attention (kernels 1 and 5).

:func:`self_attention_bwd` replaces
``pram_tpu/ops/attention_bwd_pallas.py:fused_self_attention_bwd`` and
:func:`cross_attention_bwd` its ``fused_cross_attention_bwd``. Both take the
projections recomputed by the caller (``ops/train_vjp.py``) and the
messages' cotangent, and return the cotangents of the projections, the
rotary tables and the key biases. A CPU tensor takes the ``*_plain``
version; a CUDA tensor launches ``csrc/attention_bwd.cu`` (a pack of the
rotated q, k and v into a scratch, a statistics pass, a gradient pass) or
``csrc/cross_attention_bwd.cu`` (a statistics pass, a gradient pass), or
raises. Each call counts one launch.

Token counts off the kernels' 64-token tile are padded inside the CUDA
wrappers (:func:`self_bwd_on_tile`, :func:`cross_bwd_on_tile`), each side
at its end: a padded token is zero in the projections and the upstream
gradient and its key sits at ``padding.PAD_BIAS``, so its softmax weight
and its gradient row are exactly zero and it adds nothing to a real
token's gradients; its rows of the outputs are sliced off.

``qkv`` is in the port's layout, the torch ``Linear`` output of the flax
kernel: column ``(head * head_dim + i) * 3 + c`` for c in (q, k, v), and
``dqkv`` comes out the same way, so ``dqkv^T x`` is the gradient of the
``Linear`` weight.
"""

from __future__ import annotations

import ctypes

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.attention import rotate_half, split_edges
from pram_tpu_torch.ops.padding import pad_sides, unpad

LAUNCHES = {"self_attention_bwd": 0, "cross_attention_bwd": 0}

# shapes the CUDA kernels are written for
KERNEL_D = 256
KERNEL_HEAD_DIM = 64
KERNEL_TILE = 64
KERNEL_MAX_SPLITS = 8


def _softmax(logits: torch.Tensor, dim: int) -> torch.Tensor:
    """exp(l - max) / sum in f32, as the TPU kernels take it."""
    e = torch.exp(logits - logits.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def self_attention_bwd_plain(qkv, cos, sin, key_bias, g, scale, heads, splits=None):
    """``(dqkv [B, N, 3d], dcos, dsin [B, N, hd] f32 or None, dbias [B, N] f32)``.

    qkv ``[B, N, 3d]`` (port layout) and g ``[B, N, d]`` in the working
    type; cos/sin ``[B, N, hd]`` f32 or None; key_bias ``[B, N]`` f32.
    The rotated q and k are rounded to the working type, the softmax and
    its gradient are f32, and dlogit and p are rounded to the working type
    before their products, as the kernel does.
    """
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    q0, k0, v = qkv.reshape(b, n, heads, hd, 3).permute(0, 2, 1, 3, 4).float().unbind(-1)
    gh = g.reshape(b, n, heads, hd).permute(0, 2, 1, 3).float()
    if cos is not None:
        c, s = cos[:, None].float(), sin[:, None].float()
        q = (q0 * c + rotate_half(q0) * s).to(dt).float()
        k = (k0 * c + rotate_half(k0) * s).to(dt).float()
    else:
        q, k = q0, k0
    dqr, dkr, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((b, n), dtype=torch.float32, device=qkv.device)
    for lo, hi in split_edges(splits, n):
        qs, ks, vs, gs = (t[:, :, lo:hi] for t in (q, k, v, gh))
        p = _softmax((qs @ ks.transpose(-1, -2)) * scale + key_bias[:, None, None, lo:hi].float(), -1)
        dp = gs @ vs.transpose(-1, -2)
        dlog = p * (dp - (dp * p).sum(-1, keepdim=True))
        dbias[:, lo:hi] = dlog.sum(dim=(1, 2))
        dlc, pc = dlog.to(dt).float(), p.to(dt).float()
        dqr[:, :, lo:hi] = (dlc @ ks) * scale
        dkr[:, :, lo:hi] = (dlc.transpose(-1, -2) @ qs) * scale
        dv[:, :, lo:hi] = pc.transpose(-1, -2) @ gs
    if cos is None:
        dq, dk, dcos, dsin = dqr, dkr, None, None
    else:
        dq = dqr * c - rotate_half(dqr * s)
        dk = dkr * c - rotate_half(dkr * s)
        dcos = (dqr * q0 + dkr * k0).sum(1)
        dsin = (dqr * rotate_half(q0) + dkr * rotate_half(k0)).sum(1)
    dqkv = torch.stack([dq, dk, dv], dim=-1).permute(0, 2, 1, 3, 4).reshape(b, n, d3).to(dt)
    return dqkv, dcos, dsin, dbias


def self_attention_bwd(qkv, cos, sin, key_bias, g, scale, heads, splits=None):
    """:func:`self_attention_bwd_plain` on the CPU; ``csrc/attention_bwd.cu`` on
    CUDA, sides off the tile padded (:func:`self_bwd_on_tile`)."""
    if qkv.device.type == "cpu":
        return self_attention_bwd_plain(qkv, cos, sin, key_bias, g, scale, heads, splits)
    return self_bwd_on_tile(_self_attention_bwd_cuda, qkv, cos, sin, key_bias, g, scale, heads, splits)


def self_bwd_on_tile(launch, qkv, cos, sin, key_bias, g, scale, heads, splits=None):
    """``launch(qkv, cos, sin, key_bias, g, scale, heads, splits)`` on each
    side padded at its end to the 64-token tile (zero qkv, g, cos and sin,
    keys at ``padding.PAD_BIAS``), and the real tokens' ``(dqkv, dcos, dsin,
    dbias)``: the route of :func:`self_attention_bwd` on CUDA (the CPU tests
    give the plain version as ``launch``)."""
    sides = [hi - lo for lo, hi in split_edges(splits, qkv.shape[1])]
    (qp, cp, sp, gp), kb, padded, index = pad_sides((qkv, cos, sin, g), key_bias, sides, KERNEL_TILE)
    out = launch(qp, cp, sp, kb, gp, scale, heads, None if splits is None else padded)
    return tuple(None if t is None else unpad(t, index) for t in out)


def _self_attention_bwd_cuda(qkv, cos, sin, key_bias, g, scale, heads, splits=None):
    b, n, d3 = qkv.shape
    dev = qkv.device
    f32 = torch.float32
    if cos is None or sin is None:
        raise ValueError("the CUDA self-attention backward needs the rotary cos/sin")
    if d3 != 3 * KERNEL_D or heads * KERNEL_HEAD_DIM != KERNEL_D:
        raise ValueError(
            f"CUDA self-attention backward is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got qkv width {d3}, heads={heads}"
        )
    sides = [hi - lo for lo, hi in split_edges(splits, n)]
    if any(s % KERNEL_TILE for s in sides) or len(sides) > KERNEL_MAX_SPLITS:
        raise ValueError(
            f"CUDA self-attention backward takes sides padded to {KERNEL_TILE} tokens, at "
            f"most {KERNEL_MAX_SPLITS} of them; got sides {tuple(sides)}"
        )
    check_tensor(qkv, "qkv", (b, n, d3), torch.bfloat16, dev)
    check_tensor(g, "g", (b, n, KERNEL_D), torch.bfloat16, dev)
    check_tensor(cos, "cos", (b, n, KERNEL_HEAD_DIM), f32, dev)
    check_tensor(sin, "sin", (b, n, KERNEL_HEAD_DIM), f32, dev)
    check_tensor(key_bias, "key_bias", (b, n), f32, dev)
    for name, t in (("qkv", qkv), ("g", g), ("cos", cos), ("sin", sin)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    packed = torch.empty_like(qkv)
    dqkv = torch.empty_like(qkv)
    dcos = torch.empty_like(cos)
    dsin = torch.empty_like(sin)
    dbias = torch.empty_like(key_bias)
    stats = torch.empty((3, b, heads, n), dtype=f32, device=dev)
    side_lengths = (ctypes.c_int * len(sides))(*sides)
    check_status(
        library().pram_self_attention_bwd(
            ptr(qkv), ptr(cos), ptr(sin), ptr(key_bias), ptr(g), ptr(packed), ptr(dqkv),
            ptr(dcos), ptr(dsin), ptr(dbias), ptr(stats), b, n, heads,
            ctypes.c_float(scale), ctypes.cast(side_lengths, ctypes.c_void_p),
            len(sides), stream_of(dev),
        ),
        "pram_self_attention_bwd",
    )
    LAUNCHES["self_attention_bwd"] += 1
    return dqkv, dcos, dsin, dbias


def cross_attention_bwd_plain(qk, v, bias0, bias1, g, scale, heads, n0):
    """``(dqk, dv [B, N, d], db0 [B, n0], db1 [B, N - n0] f32)``.

    qk, v, g ``[B, N, d]`` in the working type (column head * hd + i);
    bias0, bias1 f32 key biases of the two sides. One similarity serves
    both directions; the softmaxes and dsim are f32, the two directions'
    dsim are added in f32 and rounded to the working type before the
    products with qk, the weights before the products with g.
    """
    b, n, d = qk.shape
    hd = d // heads
    dt = qk.dtype

    def split(t):
        t = t.reshape(b, n, heads, hd).permute(0, 2, 1, 3).float()
        return t[:, :, :n0], t[:, :, n0:]

    (qk0, qk1), (v0, v1), (g0, g1) = split(qk), split(v), split(g)
    sim = (qk0 @ qk1.transpose(-1, -2)) * scale  # [B, H, n0, n1]
    a01 = _softmax(sim + bias1[:, None, None, :].float(), -1)
    dp01 = g0 @ v1.transpose(-1, -2)
    dsim01 = a01 * (dp01 - (dp01 * a01).sum(-1, keepdim=True))
    dv1 = a01.to(dt).float().transpose(-1, -2) @ g0
    a10 = _softmax(sim + bias0[:, None, :, None].float(), -2)
    dp10 = v0 @ g1.transpose(-1, -2)
    dsim10 = a10 * (dp10 - (dp10 * a10).sum(-2, keepdim=True))
    dv0 = a10.to(dt).float() @ g1
    dsim = (dsim01 + dsim10).to(dt).float()
    dqk0 = (dsim @ qk1) * scale
    dqk1 = (dsim.transpose(-1, -2) @ qk0) * scale

    def merge(t0, t1):
        return torch.cat([t0, t1], dim=2).permute(0, 2, 1, 3).reshape(b, n, d).to(dt)

    return merge(dqk0, dqk1), merge(dv0, dv1), dsim10.sum(dim=(1, 3)), dsim01.sum(dim=(1, 2))


def cross_attention_bwd(qk, v, bias0, bias1, g, scale, heads, n0):
    """:func:`cross_attention_bwd_plain` on the CPU; ``csrc/cross_attention_bwd.cu``
    on CUDA, sides off the tile padded (:func:`cross_bwd_on_tile`)."""
    if qk.device.type == "cpu":
        return cross_attention_bwd_plain(qk, v, bias0, bias1, g, scale, heads, n0)
    return cross_bwd_on_tile(_cross_attention_bwd_cuda, qk, v, bias0, bias1, g, scale, heads, n0)


def cross_bwd_on_tile(launch, qk, v, bias0, bias1, g, scale, heads, n0):
    """``launch(qk, v, bias0, bias1, g, scale, heads, n0)`` on the two sides
    each padded at its end to the 64-token tile (zero qk, v and g, keys at
    ``padding.PAD_BIAS``), and the real tokens' ``(dqk, dv, db0, db1)``: the
    route of :func:`cross_attention_bwd` on CUDA (the CPU tests give the
    plain version as ``launch``)."""
    n1 = qk.shape[1] - n0
    if n0 <= 0 or n1 <= 0:
        raise ValueError(f"cross-attention backward needs both sides non-empty; got {n0} and {n1}")
    (qkp, vp, gp), kb, (p0, _), index = pad_sides((qk, v, g), torch.cat([bias0, bias1], 1), (n0, n1), KERNEL_TILE)
    if index is None:
        return launch(qk, v, bias0, bias1, g, scale, heads, n0)
    dqk, dv, db0, db1 = launch(qkp, vp, kb[:, :p0].contiguous(), kb[:, p0:].contiguous(), gp, scale, heads, p0)
    return unpad(dqk, index), unpad(dv, index), db0[:, :n0], db1[:, :n1]


def _cross_attention_bwd_cuda(qk, v, bias0, bias1, g, scale, heads, n0):
    b, n, d = qk.shape
    n1 = n - n0
    dev = qk.device
    f32 = torch.float32
    if d != KERNEL_D or heads * KERNEL_HEAD_DIM != d:
        raise ValueError(
            f"CUDA cross-attention backward is built for d={KERNEL_D} and head_dim="
            f"{KERNEL_HEAD_DIM}; got d={d}, heads={heads}"
        )
    if n0 % KERNEL_TILE or n1 % KERNEL_TILE:  # cross_bwd_on_tile refuses an empty side
        raise ValueError(
            f"CUDA cross-attention backward takes both sides padded to a multiple "
            f"of {KERNEL_TILE} tokens; got {n0} and {n1}"
        )
    for name, t in (("qk", qk), ("v", v), ("g", g)):
        check_tensor(t, name, (b, n, d), torch.bfloat16, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    check_tensor(bias0, "bias0", (b, n0), f32, dev)
    check_tensor(bias1, "bias1", (b, n1), f32, dev)
    dqk = torch.empty_like(qk)
    dv = torch.empty_like(v)
    db0 = torch.empty_like(bias0)
    db1 = torch.empty_like(bias1)
    stats = torch.empty((3, b, heads, n), dtype=f32, device=dev)
    check_status(
        library().pram_cross_attention_bwd(
            ptr(qk), ptr(v), ptr(bias0), ptr(bias1), ptr(g), ptr(dqk), ptr(dv),
            ptr(db0), ptr(db1), ptr(stats), b, n, n0, heads,
            ctypes.c_float(scale), stream_of(dev),
        ),
        "pram_cross_attention_bwd",
    )
    LAUNCHES["cross_attention_bwd"] += 1
    return dqk, dv, db0, db1
