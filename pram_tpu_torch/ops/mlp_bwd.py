"""Backward of the residual concat-MLP (kernel 2).

:func:`residual_mlp_bwd` replaces
``pram_tpu/ops/mlp_bwd_pallas.py:fused_residual_mlp_bwd``. It takes the
block input x, the message projection pm recomputed by the caller
(``ops/train_vjp.py``) and the output's cotangent ct, and returns dx (the
residual included), dpm and the gradients of mlp_0, the LayerNorm and
mlp_3, summed over every token. A CPU tensor takes
:func:`residual_mlp_bwd_plain`; a CUDA tensor launches ``csrc/mlp_bwd.cu``
or raises. Weights are in torch ``Linear`` layout (``[out, in]``), and so
are their gradients. The kernel reads b0, ln_w and ln_b as the caller holds
them (all bf16, as the training step's casts leave them, or f32) and widens
them exactly as it loads them.

Token counts off the kernel's 32-token tile are padded inside the CUDA
wrapper (:func:`mlp_bwd_on_token_tile`) with zero rows of x, pm and ct. A
zero row's LayerNorm input is b0, so its statistics stay finite, and its
zero cotangent makes dz, dh and every product it feeds exactly zero: it
adds 0 to each weight gradient. Its rows of dx and dpm are sliced off.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.padding import on_row_tile

LAUNCHES = {"residual_mlp_bwd": 0}

# shapes the CUDA kernel is written for
KERNEL_D = 256
KERNEL_HIDDEN = 512
KERNEL_TOKEN_TILE = 32  # tokens must be a multiple of this
KERNEL_TILE = 64  # tokens of a tile of the token pass (the last may be half empty)
# the weight-gradient pass splits the tokens into this many contiguous
# ranges (12 output tiles x 11 = 132 CTAs, one an SM of the H100)
KERNEL_SPLITS = 11


def residual_mlp_bwd_plain(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps=1e-6):
    """``(dx, dpm, dw0, db0, dln_w, dln_b, dw3, db3)``: dx and dpm in x's
    dtype, the rest f32.

    x, pm, ct ``[..., d]`` in the working type; w0 ``[dh, 2d]``, w3
    ``[d, dh]``. The hidden chain is recomputed in f32; y and dh are
    rounded to the working type before their products, as the kernel does.
    """
    dt = x.dtype
    d = x.shape[-1]
    xc = torch.cat([x, pm], dim=-1).reshape(-1, 2 * d).float()
    ctf = ct.reshape(-1, d).float()
    h = xc @ w0.float().T + b0.float()
    mu = h.mean(-1, keepdim=True)
    hc = h - mu
    rstd = torch.rsqrt((hc * hc).mean(-1, keepdim=True) + eps)
    hhat = hc * rstd
    z = hhat * ln_w.float() + ln_b.float()
    phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    big_phi = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    y = (z * big_phi).to(dt).float()
    dz = (ctf @ w3.float()) * (big_phi + z * phi)
    dhhat = dz * ln_w.float()
    dh = (dhhat - dhhat.mean(-1, keepdim=True) - hhat * (dhhat * hhat).mean(-1, keepdim=True)) * rstd
    dhc = dh.to(dt).float()
    dxc = dhc @ w0.float()
    dx = (ctf + dxc[:, :d]).to(dt).reshape(x.shape)
    dpm = dxc[:, d:].to(dt).reshape(x.shape)
    return (
        dx, dpm, dhc.T @ xc, dh.sum(0), (dz * hhat).sum(0), dz.sum(0),
        ctf.T @ y, ctf.sum(0),
    )


def residual_mlp_bwd(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps=1e-6):
    """:func:`residual_mlp_bwd_plain` on the CPU; ``csrc/mlp_bwd.cu`` on CUDA,
    token counts off the tile padded (:func:`mlp_bwd_on_token_tile`)."""
    if x.device.type == "cpu":
        return residual_mlp_bwd_plain(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps)
    return mlp_bwd_on_token_tile(_residual_mlp_bwd_cuda, x, pm, ct, w0, b0, ln_w, ln_b, w3, eps)


def mlp_bwd_on_token_tile(launch, x, pm, ct, w0, b0, ln_w, ln_b, w3, eps=1e-6):
    """``launch(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps)`` on the tokens
    flattened to rows and padded with zero rows to a multiple of 32
    (``padding.on_row_tile``); dx and dpm cut back to x's shape, the weight
    gradients as they come: the route of :func:`residual_mlp_bwd` on CUDA
    (the CPU tests give the plain version as ``launch``)."""
    return on_row_tile(lambda x2, p2, c2: launch(x2, p2, c2, w0, b0, ln_w, ln_b, w3, eps), KERNEL_TOKEN_TILE,
                       x, pm, ct, row_outputs=2)


def _residual_mlp_bwd_cuda(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps=1e-6):
    dev = x.device
    d = x.shape[-1]
    tokens = x.numel() // d
    f32 = torch.float32
    if d != KERNEL_D or w0.shape[0] != KERNEL_HIDDEN:
        raise ValueError(
            f"CUDA residual MLP backward is built for d={KERNEL_D}, hidden="
            f"{KERNEL_HIDDEN}; got d={d}, hidden={w0.shape[0]}"
        )
    if tokens % KERNEL_TOKEN_TILE:
        raise ValueError(f"CUDA residual MLP backward takes tokens padded to a multiple of {KERNEL_TOKEN_TILE}")
    # the vectors go in as the caller holds them: all bf16, or else f32
    vdt = torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in (b0, ln_w, ln_b)) else f32
    if any(t.dtype != vdt for t in (b0, ln_w, ln_b)):
        b0, ln_w, ln_b = (t.to(vdt) for t in (b0, ln_w, ln_b))
    for name, t in (("x", x), ("pm", pm), ("ct", ct)):
        check_tensor(t, name, x.shape, torch.bfloat16, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    check_tensor(w0, "w0", (KERNEL_HIDDEN, 2 * d), torch.bfloat16, dev)
    check_tensor(w3, "w3", (d, KERNEL_HIDDEN), torch.bfloat16, dev)
    for name, t in (("b0", b0), ("ln_w", ln_w), ("ln_b", ln_b)):
        check_tensor(t, name, (KERNEL_HIDDEN,), vdt, dev)
    for name, t in (("w0", w0), ("w3", w3), ("b0", b0), ("ln_w", ln_w), ("ln_b", ln_b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dx, dpm = torch.empty_like(x), torch.empty_like(x)
    dw0 = torch.empty((KERNEL_HIDDEN, 2 * d), dtype=f32, device=dev)
    dw3 = torch.empty((d, KERNEL_HIDDEN), dtype=f32, device=dev)
    db0, dln_w, dln_b = (torch.empty(KERNEL_HIDDEN, dtype=f32, device=dev) for _ in range(3))
    db3 = torch.empty(d, dtype=f32, device=dev)
    y = torch.empty((tokens, KERNEL_HIDDEN), dtype=torch.bfloat16, device=dev)
    dh = torch.empty_like(y)
    tiles = -(-tokens // KERNEL_TILE)
    splits = min(KERNEL_SPLITS, tiles)
    # each tile's column sums of dz hhat, dz and dh by warp (4 x 16 rows), then ct's
    colsums = torch.empty((tiles, 4 * 3 * KERNEL_HIDDEN + d), dtype=f32, device=dev)
    partial = torch.empty((splits, dw0.numel() + dw3.numel()), dtype=f32, device=dev)
    check_status(
        library().pram_residual_mlp_bwd(
            ptr(x), ptr(pm), ptr(ct), ptr(w0), ptr(b0), ptr(ln_w), ptr(ln_b),
            ptr(w3), ptr(dx), ptr(dpm), ptr(dw0), ptr(db0), ptr(dln_w),
            ptr(dln_b), ptr(dw3), ptr(db3), ptr(y), ptr(dh), ptr(colsums),
            ptr(partial), tokens, splits, int(vdt == torch.bfloat16), ctypes.c_float(eps),
            stream_of(dev),
        ),
        "pram_residual_mlp_bwd",
    )
    LAUNCHES["residual_mlp_bwd"] += 1
    return dx, dpm, dw0, db0, dln_w, dln_b, dw3, db3
