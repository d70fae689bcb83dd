"""RANSAC hypothesis scoring and the LO / Gauss-Newton polish.

Two kernels of ``csrc/pnp.cu`` with their plain PyTorch twins:

- :func:`ransac_score` replaces ``pram_tpu/ops/pnp_pallas.py:ransac_score_pallas``:
  the inlier count of every pose hypothesis over all correspondences. On
  the card a CTA takes 512 poses of a problem and one slice of its points;
  :func:`score_slices` picks the slices from the shape;
- :func:`gn_polish` replaces ``pram_tpu/ops/pnp_pallas.py:gn_polish_pallas``:
  ``lo_rounds`` rounds of [count, Gauss-Newton, count, accept] followed by
  the graduated polish (gates 1, 1/2, 1/4 of the threshold, floored at 2 px)
  and a final count. On the card a problem takes a cluster of C CTAs,
  chosen by :func:`polish_cluster` from the number of points.

Both run over a batch of ``P`` independent problems. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, stream_of
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.pnp import _count_inliers, gauss_newton_pose

# kernel launches, counted where each wrapper launches its kernel
LAUNCHES = {"ransac_score": 0, "gn_polish": 0}
# the scoring kernel: poses a CTA, the least points a slice of the point
# axis, and the CTAs it is given an SM (four waves of the four that fit)
SCORE_POSES_PER_CTA = 512
SCORE_MIN_SLICE = 64
SCORE_CTAS_PER_SM = 16
# the polish's cluster sizes: points a CTA is given at most, and the largest
# cluster (the largest portable size)
POLISH_POINTS_PER_CTA = 512
POLISH_MAX_CLUSTER = 8


# ---------------------------------------------------------------------------
# RANSAC scoring
# ---------------------------------------------------------------------------


def ransac_score_plain(cam_params, R, t, valid, xyz, uv, mask, threshold):
    """Inlier counts ``[P, K]`` int32 (-1 for invalid poses).

    cam_params ``[P, 8]``, R ``[P, K, 3, 3]``, t ``[P, K, 3]``, valid ``[P, K]``,
    xyz ``[P, N, 3]``, uv ``[P, N, 2]``, mask ``[P, N]``.
    """
    cam = Camera(cam_params[:, None], None)
    counts, _ = _count_inliers(
        cam, R, t, xyz[:, None], uv[:, None], mask[:, None], threshold
    )
    return torch.where(valid, counts, -1).to(torch.int32)


def score_slices(p: int, k: int, n: int, sms: int) -> int:
    """The slices the scoring kernel splits the point axis of ``p`` problems
    of ``k`` poses and ``n`` points into: as many as give the card's ``sms``
    SMs SCORE_CTAS_PER_SM CTAs each, no slice under SCORE_MIN_SLICE points
    (8 at GML's 32 x 512 x 512, 64 at AdaGML's 8 x 512 x 4096, 66 at
    32 x 512 x 10240 on 132 SMs)."""
    ctas = p * -(-k // SCORE_POSES_PER_CTA)
    return max(1, min(-(-sms * SCORE_CTAS_PER_SM // ctas), n // SCORE_MIN_SLICE))


@functools.lru_cache(maxsize=None)
def _slices_on(p: int, k: int, n: int, index: int) -> int:
    """score_slices on card ``index``, once a shape."""
    return score_slices(p, k, n, torch.cuda.get_device_properties(index).multi_processor_count)


_SCORE_ARGS = ("cam_params", "R", "t", "valid", "xyz", "uv", "mask")
_SCORE_DTYPES = (torch.float32,) * 3 + (torch.bool,) + (torch.float32,) * 2 + (torch.bool,)


def ransac_score(cam_params, R, t, valid, xyz, uv, mask, threshold):
    """:func:`ransac_score_plain` on the CPU; ``csrc/pnp.cu:ransac_score`` on
    CUDA, for any number of poses and points."""
    if xyz.device.type == "cpu":
        return ransac_score_plain(cam_params, R, t, valid, xyz, uv, mask, threshold)
    p, k = valid.shape
    n = mask.shape[1]
    dev = xyz.device
    args = (cam_params, R, t, valid, xyz, uv, mask)
    shapes = ((p, 8), (p, k, 3, 3), (p, k, 3), (p, k), (p, n, 3), (p, n, 2), (p, n))
    for a, shape, dtype, name in zip(args, shapes, _SCORE_DTYPES, _SCORE_ARGS):
        check_tensor(a, name, shape, dtype, dev)
    out = torch.empty((p, k), dtype=torch.int32, device=dev)
    check_status(
        library().pram_ransac_score(
            *(a.data_ptr() for a in args), threshold, out.data_ptr(), p, k, n,
            _slices_on(p, k, n, dev.index), stream_of(dev),
        ),
        "pram_ransac_score",
    )
    LAUNCHES["ransac_score"] += 1
    return out


# ---------------------------------------------------------------------------
# LO rounds + graduated Gauss-Newton polish
# ---------------------------------------------------------------------------


def gn_polish_plain(
    cam_params, R0, t0, xyz, uv, mask, threshold, min_inliers,
    *, gn_iters: int = 8, lo_rounds: int = 2, damping: float = 1e-4,
):
    """(R ``[P, 3, 3]``, t ``[P, 3]``, num_inliers ``[P]`` int32, inliers ``[P, N]``)."""
    cam = Camera(cam_params, None)
    R, t = R0, t0

    def keep(cond, new, old):
        return torch.where(cond.reshape(cond.shape + (1,) * (old.ndim - 1)), new, old)

    for _ in range(lo_rounds):
        cnt, inl = _count_inliers(cam, R, t, xyz, uv, mask, threshold)
        Rn, tn = gauss_newton_pose(
            cam, R, t, xyz, uv, inl.to(uv.dtype), num_iters=gn_iters,
            damping=damping,
        )
        cn, _ = _count_inliers(cam, Rn, tn, xyz, uv, mask, threshold)
        better = cn >= cnt
        R, t = keep(better, Rn, R), keep(better, tn, t)

    for s in (1.0, 0.5, 0.25):
        th_r = max(threshold * s, 2.0)
        cnt_r, inl_r = _count_inliers(cam, R, t, xyz, uv, mask, th_r)
        Rp, tp = gauss_newton_pose(
            cam, R, t, xyz, uv, inl_r.to(uv.dtype), num_iters=gn_iters,
            huber_delta=max(th_r / 2.0, 1.0), damping=damping,
        )
        cnt_new, _ = _count_inliers(cam, Rp, tp, xyz, uv, mask, th_r)
        ok = (cnt_r >= min_inliers) & (cnt_new >= cnt_r)
        R, t = keep(ok, Rp, R), keep(ok, tp, t)

    num_inl, inliers = _count_inliers(cam, R, t, xyz, uv, mask, threshold)
    return R, t, num_inl.to(torch.int32), inliers


def polish_cluster(n: int) -> int:
    """The cluster size the polish takes for problems of ``n`` points: the
    least power of two that gives a CTA at most POLISH_POINTS_PER_CTA points
    (1 at GML's 512, 8 at AdaGML's 4096), capped at POLISH_MAX_CLUSTER."""
    c = 1
    while c < POLISH_MAX_CLUSTER and c * POLISH_POINTS_PER_CTA < n:
        c *= 2
    return c


def gn_polish(
    cam_params, R0, t0, xyz, uv, mask, threshold, min_inliers,
    *, gn_iters: int = 8, lo_rounds: int = 2, damping: float = 1e-4,
):
    """:func:`gn_polish_plain` on the CPU; ``csrc/pnp.cu:gn_polish`` on CUDA,
    each problem on a cluster of :func:`polish_cluster` CTAs."""
    if xyz.device.type == "cpu":
        return gn_polish_plain(
            cam_params, R0, t0, xyz, uv, mask, threshold, min_inliers,
            gn_iters=gn_iters, lo_rounds=lo_rounds, damping=damping,
        )
    p, n = mask.shape
    dev = xyz.device
    f32 = torch.float32
    R0 = R0.contiguous()
    t0 = t0.contiguous()
    check_tensor(cam_params, "cam_params", (p, 8), f32, dev)
    check_tensor(R0, "R0", (p, 3, 3), f32, dev)
    check_tensor(t0, "t0", (p, 3), f32, dev)
    check_tensor(xyz, "xyz", (p, n, 3), f32, dev)
    check_tensor(uv, "uv", (p, n, 2), f32, dev)
    check_tensor(mask, "mask", (p, n), torch.bool, dev)
    R = torch.empty((p, 3, 3), dtype=f32, device=dev)
    t = torch.empty((p, 3), dtype=f32, device=dev)
    num = torch.empty((p,), dtype=torch.int32, device=dev)
    inliers = torch.empty((p, n), dtype=torch.bool, device=dev)
    lib = library()
    check_status(
        lib.pram_gn_polish(
            ptr(cam_params), ptr(R0), ptr(t0), ptr(xyz), ptr(uv),
            ptr(mask), ctypes.c_float(threshold), ctypes.c_float(min_inliers),
            ctypes.c_float(damping), gn_iters, lo_rounds, ptr(R), ptr(t),
            ptr(num), ptr(inliers), p, n, polish_cluster(n), stream_of(dev),
        ),
        "pram_gn_polish",
    )
    LAUNCHES["gn_polish"] += 1
    return R, t, num, inliers
