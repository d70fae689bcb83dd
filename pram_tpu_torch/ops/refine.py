"""Projection-refinement nearest neighbour with a reprojection gate and a
top-2 ratio test (the NN stage of pram_tpu/engine/localizer.py:
refine_projection_core).

:func:`refine_nn` replaces ``pram_tpu/ops/refine_pallas.py:refine_nn_pallas``,
batched over problems: a CPU tensor takes :func:`refine_nn_plain`, a CUDA
tensor launches ``csrc/refine.cu`` or raises. Query and point counts off
the kernel's 64 are padded inside the CUDA wrapper
(:func:`refine_on_tile`): padded queries are sliced off, and the kernel
skips the points from the real count on, so a padded point never enters
the top-2.
"""

from __future__ import annotations

import ctypes

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.ops.padding import pad_end, round_up

LAUNCHES = {"refine_nn": 0}

# shapes the CUDA kernel is written for
KERNEL_DESC_DIM = 128
KERNEL_QUERY_TILE = 64
KERNEL_POINT_TILE = 64


def refine_nn_plain(descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio, n_points=None):
    """``(nn_idx int64 [B, N], d1 f32 [B, N], keep bool [B, N])``.

    descs ``[B, N, D]``, pdesc ``[B, P, D]`` (similarity accumulated in f32);
    kpts ``[B, N, 2]``, uv ``[B, P, 2]``; in_img ``[B, P]``, qmask ``[B, N]``
    bool. ``dist = sqrt(max(2 - 2 sim + 1e-6, 0))``, + 100 where the point
    projects ``gate_radius`` or further from the keypoint or outside the
    image; ``keep = d1 / max(d2, 1e-9) <= ratio & d1 < 100 & qmask``. With
    ``n_points`` the points from that index on are padding and never chosen
    (the kernel's real point count).
    """
    sim = descs.float() @ pdesc.float().transpose(-1, -2)  # [B, N, P]
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * sim + 1e-6, min=0.0))
    proj_err = torch.linalg.norm(kpts[:, :, None, :] - uv[:, None], dim=-1)
    gate = (proj_err < gate_radius) & in_img[:, None]
    dist = torch.where(gate, dist, dist + 100.0)
    if n_points is not None:
        dist[..., n_points:] = float("inf")
    # top-2 by min/argmin and a masked second min, as the TPU kernel
    d1, nn_idx = dist.min(dim=-1)
    cols = torch.arange(dist.shape[-1], device=dist.device)
    d2 = torch.where(cols == nn_idx[..., None], float("inf"), dist).amin(dim=-1)
    keep = (d1 / torch.clamp(d2, min=1e-9) <= ratio) & (d1 < 100.0) & qmask
    return nn_idx, d1, keep


def refine_nn(descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio):
    """:func:`refine_nn_plain` on the CPU; ``csrc/refine.cu`` on CUDA, the
    queries and points padded to the kernel's tiles (:func:`refine_on_tile`)."""
    if descs.device.type == "cpu":
        return refine_nn_plain(descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio)
    return refine_on_tile(_refine_nn_cuda, descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio)


def refine_on_tile(launch, descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio):
    """``launch(descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio,
    n_points)`` on the queries padded to 64 (zero descriptors and keypoints,
    qmask false) and the points padded to 64 (zero descriptors and uv,
    in_img false), ``n_points`` the real point count, cut back to the real
    queries: the route of :func:`refine_nn` on CUDA (the CPU tests give
    :func:`refine_nn_plain` as ``launch``)."""
    n, p = descs.shape[1], pdesc.shape[1]
    pn, pp = round_up(n, KERNEL_QUERY_TILE), round_up(p, KERNEL_POINT_TILE)
    out = launch(pad_end(descs, pn), pad_end(pdesc, pp), pad_end(kpts, pn), pad_end(uv, pp),
                 pad_end(in_img, pp, False), pad_end(qmask, pn, False), gate_radius, ratio, p)
    return out if pn == n else tuple(t[:, :n] for t in out)


def _refine_nn_cuda(descs, pdesc, kpts, uv, in_img, qmask, gate_radius, ratio, n_points):
    b, n, d = descs.shape
    p = pdesc.shape[1]
    dev = descs.device
    if d != KERNEL_DESC_DIM:
        raise ValueError(f"CUDA refinement NN is built for {KERNEL_DESC_DIM}-d descriptors; got d={d}")
    bf, f32, u8 = torch.bfloat16, torch.float32, torch.uint8
    check_tensor(descs, "descs", (b, n, d), bf, dev)
    check_tensor(pdesc, "pdesc", (b, p, d), bf, dev)
    check_tensor(kpts, "kpts", (b, n, 2), f32, dev)
    check_tensor(uv, "uv", (b, p, 2), f32, dev)
    check_tensor(in_img, "in_img", (b, p), torch.bool, dev)
    check_tensor(qmask, "qmask", (b, n), torch.bool, dev)
    # TMA boxes (descriptors) and bulk copies (uv, in_img) start on 16 bytes
    for name, t in (("descs", descs), ("pdesc", pdesc), ("uv", uv), ("in_img", in_img)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nn_idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    d1 = torch.empty((b, n), dtype=f32, device=dev)
    keep = torch.empty((b, n), dtype=u8, device=dev)
    check_status(
        library().pram_refine_nn(
            ptr(descs), ptr(pdesc), ptr(kpts), ptr(uv), ptr(in_img.view(u8)),
            ptr(qmask.view(u8)), ctypes.c_float(gate_radius), ctypes.c_float(ratio),
            ptr(nn_idx), ptr(d1), ptr(keep), b, n, p, n_points, stream_of(dev),
        ),
        "pram_refine_nn",
    )
    LAUNCHES["refine_nn"] += 1
    return nn_idx.long(), d1, keep.bool()
