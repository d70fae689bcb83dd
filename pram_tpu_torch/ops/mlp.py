"""Residual concat-MLP: ``x + W3 gelu_erf(LN(W0 [x, Wp msg + bp] + b0)) + b3``.

:func:`residual_mlp` replaces ``pram_tpu/ops/mlp_pallas.py:fused_residual_mlp``.
A CPU tensor takes :func:`residual_mlp_plain`; a CUDA tensor launches
``csrc/mlp.cu`` or raises. Weights are in torch ``Linear`` layout
(``[out, in]``); ``w0``'s input columns are ``[x | proj(msg)]``. The kernel
takes bf16, the working type (the TMA/wgmma tile of ``csrc/mlp_tile.cuh``),
or f32 (products on the CUDA cores), which the f32 A/B checks of the
matcher use.

:func:`residual_mlp_int8` replaces
``pram_tpu/ops/mlp_pallas.py:fused_residual_mlp_int8`` (kernel 16, inference
only): the same function with the three products in int8, weights per output
column (``ops/quant.py:quant_linear``, once per model), activations per row;
a CPU tensor takes :func:`residual_mlp_int8_plain`, a CUDA tensor launches
``csrc/mlp_int8.cu`` (the s8 instance of the same tile) or raises. :func:`fused_mlp_int8_supported` is the JAX
package's gate, copied as it is.

Token counts off the kernels' 32-token tile are padded inside the CUDA
wrappers with zero rows, which are sliced off (``ops/padding.py``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.padding import on_row_tile
from pram_tpu_torch.ops.quant import int_matmul, quant_rows

LAUNCHES = {"residual_mlp": 0, "residual_mlp_int8": 0}

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
    """:func:`residual_mlp_plain` on the CPU; ``csrc/mlp.cu`` on CUDA, the
    tokens padded to the 32-token tile (:func:`mlp_on_token_tile`)."""
    if x.device.type == "cpu":
        return residual_mlp_plain(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps)
    return mlp_on_token_tile(_residual_mlp_cuda, x, msg, (wp, bp, w0, b0, ln_w, ln_b, w3, b3), eps)


def mlp_on_token_tile(launch, x, msg, weights, eps=1e-6):
    """``launch(x, msg, *weights, eps=eps)`` on the tokens of x and msg
    flattened and padded with zero rows to a multiple of 32, cut back to x's
    shape: the route of :func:`residual_mlp` and :func:`residual_mlp_int8`
    on CUDA (the CPU tests give the plain versions as ``launch``)."""
    return on_row_tile(lambda x2, m2: launch(x2, m2, *weights, eps=eps), KERNEL_TOKEN_TILE, x, msg)


def _residual_mlp_cuda(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6):
    dev = x.device
    d = x.shape[-1]
    tokens = x.numel() // d
    if d != KERNEL_D or w0.shape[0] != KERNEL_HIDDEN:
        raise ValueError(
            f"CUDA residual MLP is built for d={KERNEL_D}, hidden={KERNEL_HIDDEN}; "
            f"got d={d}, hidden={w0.shape[0]}"
        )
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


# the TPU kernel's VMEM budget and estimates, kept for its gate
_VMEM_BUDGET = 14 << 20


def _vmem_estimate(nt: int, d: int, dh: int, itemsize: int) -> int:
    io_w = (3 * nt * d + d * d + 3 * d * dh) * itemsize
    scratch = 8 * nt * (d + dh)
    return io_w + scratch


def fused_mlp_int8_supported(n: int, d: int, dh: int, itemsize: int) -> bool:
    """``pram_tpu/ops/mlp_pallas.py:fused_mlp_int8_supported``: a 32-aligned
    token tile of ``n`` whose int8 working set fits the TPU kernel's VMEM."""
    for nt in (n, 1024, 512, 256, 128):
        if (
            nt <= n
            and n % nt == 0
            and nt % 32 == 0
            and _vmem_estimate(nt, d, dh, itemsize) + nt * (3 * d + dh) <= _VMEM_BUDGET
        ):
            return True
    return False


def _int8_linear(aq, ars, wq, ws, b):
    """``((acc * ars) * ws + b)`` in f32, acc the exact product of the row-
    quantized ``aq`` with ``wq [out, in]``."""
    return (int_matmul(aq, wq.T) * ars) * ws.float() + b.float()


def residual_mlp_int8_plain(x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps=1e-6):
    """Output in x's dtype. msg, x, proj(msg) (rounded to x's dtype) and the
    f32 GELU output are each quantized per row; ``w*q`` int8 ``[out, in]``
    with ``w*s [out]`` f32 scales. LayerNorm and GELU run in f32."""
    dt = x.dtype
    d = x.shape[-1]
    mq, mrs = quant_rows(msg)
    pm = _int8_linear(mq, mrs, wpq, wps, bp).to(dt)
    xq, xrs = quant_rows(x)
    pmq, pmrs = quant_rows(pm)
    h = (int_matmul(xq, w0q[:, :d].T) * xrs + int_matmul(pmq, w0q[:, d:].T) * pmrs) * w0s.float() + b0.float()
    hn = F.layer_norm(h, (h.shape[-1],), ln_w.float(), ln_b.float(), eps)
    yq, yrs = quant_rows(F.gelu(hn))
    return x + _int8_linear(yq, yrs, w3q, w3s, b3).to(dt)


def residual_mlp_int8(x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps=1e-6):
    """:func:`residual_mlp_int8_plain` on the CPU; ``csrc/mlp_int8.cu`` on CUDA
    (bf16), the tokens padded to the 32-token tile (:func:`mlp_on_token_tile`)."""
    if x.device.type == "cpu":
        return residual_mlp_int8_plain(x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps)
    return mlp_on_token_tile(_residual_mlp_int8_cuda, x, msg,
                             (wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3), eps)


def _residual_mlp_int8_cuda(x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps=1e-6):
    dev = x.device
    d = x.shape[-1]
    tokens = x.numel() // d
    if d != KERNEL_D or w0q.shape[0] != KERNEL_HIDDEN:
        raise ValueError(
            f"CUDA int8 residual MLP is built for d={KERNEL_D}, hidden={KERNEL_HIDDEN}; "
            f"got d={d}, hidden={w0q.shape[0]}"
        )
    vecs = [t.to(torch.float32).contiguous() for t in (wps, bp, w0s, b0, ln_w, ln_b, w3s, b3)]
    wps, bp, w0s, b0, ln_w, ln_b, w3s, b3 = vecs
    bf16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    check_tensor(x, "x", x.shape, bf16, dev)
    check_tensor(msg, "msg", x.shape, bf16, dev)
    check_tensor(wpq, "wpq", (d, d), i8, dev)
    check_tensor(w0q, "w0q", (KERNEL_HIDDEN, 2 * d), i8, dev)
    check_tensor(w3q, "w3q", (d, KERNEL_HIDDEN), i8, dev)
    for name, t, n in (("wps", wps, d), ("bp", bp, d), ("w0s", w0s, KERNEL_HIDDEN),
                       ("b0", b0, KERNEL_HIDDEN), ("ln_w", ln_w, KERNEL_HIDDEN),
                       ("ln_b", ln_b, KERNEL_HIDDEN), ("w3s", w3s, d), ("b3", b3, d)):
        check_tensor(t, name, (n,), f32, dev)
    for name, t in (("x", x), ("msg", msg), ("wpq", wpq), ("w0q", w0q), ("w3q", w3q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(x)
    check_status(
        library().pram_residual_mlp_int8(
            ptr(x), ptr(msg), ptr(wpq), ptr(wps), ptr(bp), ptr(w0q), ptr(w0s), ptr(b0),
            ptr(ln_w), ptr(ln_b), ptr(w3q), ptr(w3s), ptr(b3), ptr(out), tokens,
            ctypes.c_float(eps), stream_of(dev),
        ),
        "pram_residual_mlp_int8",
    )
    LAUNCHES["residual_mlp_int8"] += 1
    return out
