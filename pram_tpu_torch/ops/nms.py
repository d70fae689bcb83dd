"""Score-map non-maximum suppression (pram_tpu/ops/nms.py).

:func:`nms` replaces ``pram_tpu/ops/nms_pallas.py:simple_nms_pallas``: a CPU
tensor takes :func:`simple_nms`, a CUDA tensor launches ``csrc/nms.cu`` or
raises. Max and equality are exact, so the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of

LAUNCHES = {"nms": 0}

KERNEL_RADII = (2, 4)  # the radii the CUDA kernel is instantiated for


def max_pool_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sliding-window max with window (2r+1, 2r+1), stride 1, SAME padding
    with -inf, over the last two dims of ``x [..., H, W]``; separable (rows
    then columns), which is exact for a max."""
    if radius <= 0:
        return x
    k = 2 * radius + 1
    lead = x.shape[:-2]
    y = x.reshape(-1, 1, *x.shape[-2:])
    y = F.max_pool2d(y, (k, 1), stride=1, padding=(radius, 0))
    y = F.max_pool2d(y, (1, k), stride=1, padding=(0, radius))
    return y.reshape(*lead, *x.shape[-2:])


def simple_nms(scores: torch.Tensor, nms_radius: int, num_iters: int = 2) -> torch.Tensor:
    """Keep local maxima, then re-admit maxima of the residual map outside
    the suppressed regions ``num_iters`` times (plain torch).

    ``scores [..., H, W]``; returns the map with non-maxima zeroed, same
    shape and dtype.
    """
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_2d(scores, nms_radius)
    for _ in range(num_iters):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def nms(scores: torch.Tensor, nms_radius: int, num_iters: int = 2) -> torch.Tensor:
    """:func:`simple_nms` on the CPU; ``csrc/nms.cu`` on CUDA.

    ``scores [B, H, W]`` in f32 or bf16, any H and W.
    """
    if scores.device.type == "cpu":
        return simple_nms(scores, nms_radius, num_iters)
    if nms_radius not in KERNEL_RADII:
        raise ValueError(f"CUDA NMS takes a radius in {KERNEL_RADII}, got {nms_radius}")
    if num_iters < 0:
        raise ValueError("num_iters must be >= 0")
    if scores.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"CUDA NMS takes f32 or bf16 scores, got {scores.dtype}")
    b, h, w = scores.shape
    check_tensor(scores, "scores", (b, h, w), scores.dtype, scores.device)
    out = torch.empty_like(scores)
    check_status(
        library().pram_nms(
            ptr(scores), ptr(out), b, h, w, nms_radius, num_iters,
            int(scores.dtype == torch.bfloat16), stream_of(scores.device),
        ),
        "pram_nms",
    )
    LAUNCHES["nms"] += 1
    return out
