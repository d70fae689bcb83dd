"""Residual concat-MLP: ``x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3``.

:func:`residual_mlp` replaces ``pram_tpu/ops/mlp_pallas.py:fused_residual_mlp``.
A CPU tensor takes :func:`residual_mlp_plain`; a CUDA tensor launches
``csrc/mlp.cu`` or raises. Weights are in torch ``Linear`` layout
(``[out, in]``); ``w0``'s input columns are ``[x | proj(msg)]``. The kernel
takes bf16, the working type, or f32 (products on the CUDA cores), which
the f32 A/B checks of the matcher use.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of

LAUNCHES = {"residual_mlp": 0}

# shapes the CUDA kernel is written for
KERNEL_D = 256
KERNEL_HIDDEN = 512
KERNEL_TOKEN_TILE = 32


def residual_mlp_plain(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6):
    """Output in x's dtype. proj(msg) and GELU's output are rounded to x's
    dtype before the next product; LayerNorm and GELU run in f32."""
    dt = x.dtype
    pm = (msg.float() @ wp.float().T + bp.float()).to(dt)
    h = torch.cat([x, pm], dim=-1).float() @ w0.float().T + b0.float()
    hn = F.layer_norm(h, (h.shape[-1],), ln_w.float(), ln_b.float(), eps)
    y = F.gelu(hn).to(dt)
    out = (y.float() @ w3.float().T + b3.float()).to(dt)
    return x + out


def residual_mlp(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6):
    """:func:`residual_mlp_plain` on the CPU; ``csrc/mlp.cu`` on CUDA."""
    if x.device.type == "cpu":
        return residual_mlp_plain(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps)
    dev = x.device
    d = x.shape[-1]
    tokens = x.numel() // d
    if d != KERNEL_D or w0.shape[0] != KERNEL_HIDDEN:
        raise ValueError(
            f"CUDA residual MLP is built for d={KERNEL_D}, hidden={KERNEL_HIDDEN}; "
            f"got d={d}, hidden={w0.shape[0]}"
        )
    if tokens % KERNEL_TOKEN_TILE:
        raise ValueError(f"CUDA residual MLP needs tokens % {KERNEL_TOKEN_TILE} == 0")
    dt = x.dtype if x.dtype == torch.float32 else torch.bfloat16
    f32 = [t.to(torch.float32).contiguous() for t in (bp, b0, ln_w, ln_b, b3)]
    bp, b0, ln_w, ln_b, b3 = f32
    check_tensor(x, "x", x.shape, dt, dev)
    check_tensor(msg, "msg", x.shape, dt, dev)
    check_tensor(wp, "wp", (d, d), dt, dev)
    check_tensor(w0, "w0", (KERNEL_HIDDEN, 2 * d), dt, dev)
    check_tensor(w3, "w3", (d, KERNEL_HIDDEN), dt, dev)
    check_tensor(bp, "bp", (d,), torch.float32, dev)
    check_tensor(b0, "b0", (KERNEL_HIDDEN,), torch.float32, dev)
    check_tensor(ln_w, "ln_w", (KERNEL_HIDDEN,), torch.float32, dev)
    check_tensor(ln_b, "ln_b", (KERNEL_HIDDEN,), torch.float32, dev)
    check_tensor(b3, "b3", (d,), torch.float32, dev)
    for name, t in (("x", x), ("msg", msg), ("wp", wp), ("w0", w0), ("w3", w3)):
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    out = torch.empty_like(x)
    check_status(
        library().pram_residual_mlp(
            ptr(x), ptr(msg), ptr(wp), ptr(bp), ptr(w0), ptr(b0),
            ptr(ln_w), ptr(ln_b), ptr(w3), ptr(b3), ptr(out), tokens,
            ctypes.c_float(eps), int(dt == torch.float32), stream_of(dev),
        ),
        "pram_residual_mlp",
    )
    LAUNCHES["residual_mlp"] += 1
    return out
