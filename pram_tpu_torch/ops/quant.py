"""Symmetric int8 quantizers and exact integer products (the int8 paths).

Copies of the JAX package's three quantizers, which differ on purpose:

- :func:`quant_rows` (``pram_tpu/ops/mlp_pallas.py:_quant_rows``): per-row
  dynamic scales of an activation, ``rs = max(max|a|, 1e-6) / 127``, values
  ``round(a * (1 / rs))`` (a multiply by the f32 reciprocal, no clip);
- :func:`quant_cols` (``mlp_pallas.py:_quant_cols``): per-output-column
  weight scales floored at 1e-6, values ``round(w / ws)`` (a divide, no
  clip);
- :func:`quant_w` (``pram_tpu/models/sfd2_int8.py:_quant_w``): per-output-
  channel conv weight scales floored at 1e-12, values clipped to +-127.

:func:`quant_static` is the extractor's static activation quantizer
(``clip(round(x / in_scale), -127, 127)``, a divide, as the conv kernel
does). ``torch.round`` rounds half to even, as ``jnp.round`` does.

Quantized values are returned as float32 tensors holding integers (an exact
representation); :func:`int_matmul` multiplies two of them exactly. Every
division is a true f32 division (:func:`_div`): PyTorch's CUDA kernels
multiply by the reciprocal of a Python-number divisor, which can land one
step away from the division the JAX package and the kernels compute.
"""

from __future__ import annotations

import torch

# |sum| <= k * 127 * 127 stays below 2^24, where every f32 sum of integers is
# exact, for depths up to 1040
EXACT_F32_DEPTH = (1 << 24) // (127 * 127)


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` divided elementwise in a's type (a 0-d tensor divisor)."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def quant_rows(a: torch.Tensor):
    """``(q, rs)``: f32 integer values of ``a`` and its ``[..., 1]`` f32 row
    scales."""
    af = a.float()
    rs = _div(torch.clamp(af.abs().amax(dim=-1, keepdim=True), min=1e-6), 127.0)
    return torch.round(af * (1.0 / rs)), rs


def quant_cols(w: torch.Tensor):
    """``(q, ws)`` of a ``[K, N]`` weight (flax layout): f32 integer values
    and ``[1, N]`` f32 column scales."""
    wf = w.float()
    ws = _div(torch.clamp(wf.abs().amax(dim=0, keepdim=True), min=1e-6), 127.0)
    return torch.round(wf / ws), ws


def quant_linear(weight: torch.Tensor):
    """:func:`quant_cols` of a torch ``Linear`` weight ``[out, in]``:
    ``(int8 [out, in], f32 [out])``, one scale per output feature."""
    q, ws = quant_cols(weight.T)
    return q.T.to(torch.int8).contiguous(), ws[0].contiguous()


def quant_w(kernel: torch.Tensor):
    """``(int8 q, f32 scale [out])`` of a kernel whose last axis is the
    output channel (HWIO conv kernels, ``[in, out]`` 1x1 kernels)."""
    kf = kernel.float()
    absmax = kf.abs().amax(dim=tuple(range(kf.dim() - 1)))
    scale = _div(torch.clamp(absmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale


def quant_static(x: torch.Tensor, in_scale) -> torch.Tensor:
    """``clip(round(x / in_scale), -127, 127)`` in f32 (a static per-tensor
    scale, divided, as ``models/sfd2_int8.py`` and the conv kernel do)."""
    return torch.clamp(torch.round(_div(x.float(), float(in_scale))), -127.0, 127.0)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of integer-valued tensors with entries in [-127, 127]
    (f32 or int8), as f32 integers: f32 products over depth chunks of at most
    :data:`EXACT_F32_DEPTH`, summed in float64 (exact to 2^53)."""
    k = a.shape[-1]
    a, b = a.float(), b.float()
    if k <= EXACT_F32_DEPTH:
        return a @ b
    acc = None
    for k0 in range(0, k, EXACT_F32_DEPTH):
        part = (a[..., k0:k0 + EXACT_F32_DEPTH] @ b[k0:k0 + EXACT_F32_DEPTH]).double()
        acc = part if acc is None else acc + part
    return acc.float()
