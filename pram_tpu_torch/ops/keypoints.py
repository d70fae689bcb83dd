"""Fixed-shape keypoint selection from NMS'd score maps
(pram_tpu/ops/keypoints.py).

Every image returns exactly ``max_keypoints`` slots with a validity mask:
threshold (halved when too few maxima pass), border removal, then the top
scores, with ties taken in index order as ``lax.top_k`` takes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """A fixed-size batch of keypoints: ``xy [..., K, 2]`` f32 (x, y) pixel
    coordinates, ``scores [..., K]`` (0 for invalid slots), ``mask [..., K]``."""

    xy: torch.Tensor
    scores: torch.Tensor
    mask: torch.Tensor


def top_k(values: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last dim, ties in
    index order (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _border_mask(h: int, w: int, border: int, dtype, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    my = (ys >= border) & (ys < h - border)
    mx = (xs >= border) & (xs < w - border)
    return (my[:, None] & mx[None, :]).to(dtype)


def _nms_block_reduce(bordered: torch.Tensor, block: int = 4):
    """Per ``block x block`` cell the max and the flat index of its first
    argmax: after NMS with radius >= block a cell holds at most one survivor
    (exact ties aside). 307,200 -> 19,200 candidates at 480 x 640."""
    b, h, w = bordered.shape
    hb, wb = h // block, w // block
    r = bordered.reshape(b, hb, block, wb, block).permute(0, 1, 3, 2, 4)
    r = r.reshape(b, hb * wb, block * block)
    bmax = r.amax(dim=-1)
    barg = torch.argmax(r, dim=-1)  # first maximum, as jnp.argmax
    cell = torch.arange(hb * wb, device=bordered.device)
    by, bx = cell // wb, cell % wb
    dy, dx = barg // block, barg % block
    flat_idx = (by[None] * block + dy) * w + (bx[None] * block + dx)
    return bmax, flat_idx


def extract_keypoints(
    nms_scores: torch.Tensor,
    *,
    max_keypoints: int,
    conf_th: float = 0.005,
    border: int = 4,
    min_keypoints: int = 128,
    nms_radius: int = 4,
) -> Keypoints:
    """Up to ``max_keypoints`` top maxima of ``nms_scores [B, H, W]`` above an
    adaptive threshold: ``conf_th``, halved when at most ``min_keypoints``
    maxima pass it (counted before border removal); points within ``border``
    pixels of the edge are removed."""
    b, h, w = nms_scores.shape
    dt, dev = nms_scores.dtype, nms_scores.device
    bordered = nms_scores * _border_mask(h, w, border, dt, dev)[None]

    block = 4
    if nms_radius >= block and h % block == 0 and w % block == 0:
        cand, cand_idx = _nms_block_reduce(bordered, block)
        pad = max(0, max_keypoints - cand.shape[1])
        if pad:  # tiny images: fewer blocks than requested keypoints
            cand = torch.cat([cand, cand.new_zeros(b, pad)], dim=1)
            cand_idx = torch.cat([cand_idx, cand_idx.new_zeros(b, pad)], dim=1)
        vals, sel = top_k(cand, max_keypoints)
        idx = torch.gather(cand_idx, 1, sel)
    else:
        vals, idx = top_k(bordered.reshape(b, h * w), max_keypoints)
    # coordinates in f32 whatever the map's type
    xy = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)

    # the thresholds compare in the map's type, as JAX's weakly typed scalars do
    n_above = (nms_scores >= conf_th).reshape(b, -1).sum(-1)
    th = torch.where(
        n_above <= min_keypoints,
        torch.tensor(conf_th * 0.5, dtype=dt, device=dev),
        torch.tensor(conf_th, dtype=dt, device=dev),
    )
    mask = (vals >= th[:, None]) & (vals > 0)
    return Keypoints(xy=xy, scores=vals * mask, mask=mask)


def normalize_keypoints(kpts: torch.Tensor, image_hw) -> torch.Tensor:
    """Center at the image center and divide by 0.7 * max(W, H)."""
    height, width = image_hw
    size = torch.tensor([float(width), float(height)], dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2) / (size.max() * 0.7)
