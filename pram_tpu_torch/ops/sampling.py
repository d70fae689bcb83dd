"""Bilinear descriptor sampling at keypoint locations
(pram_tpu/ops/sampling.py): ``grid_sample(mode='bilinear',
align_corners=True, padding_mode='zeros')`` in pixel units."""

from __future__ import annotations

import torch


def grid_sample_nchw(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``image [..., C, H, W]`` at f32 pixel ``coords
    [..., N, 2]`` (x, y), out-of-bounds taps contributing zero; returns
    ``[..., C, N]`` in f32 (the f32 tap weights promote a bf16 map).

    The taps are gathered as rows of the channels-last view, so a map in
    channels_last memory is read in place.
    """
    c, h, w = image.shape[-3:]
    lead = image.shape[:-3]
    hwc = image.movedim(-3, -1).reshape(-1, h, w, c)  # [L, H, W, C]
    xy = coords.reshape(hwc.shape[0], -1, 2)  # [L, N, 2]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    li = torch.arange(hwc.shape[0], device=image.device)[:, None]

    def gather(xi, yi, wgt):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        vals = hwc[li, yc, xc]  # [L, N, C]
        return vals * (wgt * inb.to(image.dtype))[..., None]

    out = (
        gather(x0, y0, wx0 * wy0)
        + gather(x1, y0, wx1 * wy0)
        + gather(x0, y1, wx0 * wy1)
        + gather(x1, y1, wx1 * wy1)
    )
    return out.transpose(-1, -2).reshape(*lead, c, -1)


def sample_descriptors(
    kpts_xy: torch.Tensor,
    desc_map: torch.Tensor,
    stride: int,
    *,
    normalize: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Descriptors ``[..., N, C]`` of ``desc_map [..., C, Hc, Wc]`` (stride
    ``stride``) at image-pixel keypoints ``kpts_xy [..., N, 2]``, in the
    map's type. Image pixels map to the align-corners grid by
    ``f = (k - s/2 + 0.5) / (size * s - s/2 - 0.5) * (size - 1)``; the
    norm is taken in f32."""
    c, hc, wc = desc_map.shape[-3:]
    s = float(stride)
    denom = torch.tensor(
        [wc * s - s / 2 - 0.5, hc * s - s / 2 - 0.5], dtype=kpts_xy.dtype,
        device=kpts_xy.device,
    )
    g = (kpts_xy - s / 2 + 0.5) / denom
    g = g * 2.0 - 1.0
    fx = (g[..., 0] + 1.0) / 2.0 * (wc - 1)
    fy = (g[..., 1] + 1.0) / 2.0 * (hc - 1)
    desc = grid_sample_nchw(desc_map, torch.stack([fx, fy], dim=-1))
    desc = desc.transpose(-1, -2)  # [..., N, C]
    if normalize:
        d32 = desc.float()
        norm = torch.sqrt(torch.sum(d32 * d32, dim=-1, keepdim=True))
        desc = d32 / torch.clamp(norm, min=eps)
    return desc.to(desc_map.dtype)
