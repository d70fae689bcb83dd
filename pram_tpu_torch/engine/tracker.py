"""Frame-to-frame tracker: temporal localization without recognition
(pram_tpu/engine/tracker.py).

Rebuild of localization/tracker.py:21-338: match the current frame's
keypoints against the previous frame, lift matches through the previous
frame's per-keypoint 3D associations, solve PnP; if inliers fall below the
refinement trigger (256, tracker.py:85), refine against the map by
projection. The ``lost`` flag falls back to full relocalization
(loc_by_rec_online.py:181-189), orchestrated by the host Tracker class.

As in the JAX package, a step computes the projection refinement whether or
not it is taken, and its PnP runs at the library's default schedule (8
Gauss-Newton iterations, 2 LO rounds), not the config's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pram_tpu_torch.engine.localizer import (
    LocConfig,
    MatchFn,
    _refine_by_projection,
    normalize_kpts_like_reference,
)
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.pnp import ransac_pnp
from pram_tpu_torch.geometry.rotations import rotmat2qvec
from pram_tpu_torch.maps.device import DeviceMap


class TrackResult(NamedTuple):
    qvec: torch.Tensor
    tvec: torch.Tensor
    R: torch.Tensor
    success: torch.Tensor
    num_inliers: torch.Tensor
    kpt_point_idx: torch.Tensor  # [N] updated 3D associations for the new frame
    kpt_xyz: torch.Tensor


@torch.no_grad()
def track_frame(
    dmap: DeviceMap,
    match_fn: MatchFn,
    camera: Camera,  # params [8], size [2]
    curr_kpts: torch.Tensor,  # [N, 2]
    curr_scores: torch.Tensor,  # [N]
    curr_descs: torch.Tensor,  # [N, D]
    curr_mask: torch.Tensor,  # [N]
    last_kpts: torch.Tensor,  # [M, 2]
    last_scores: torch.Tensor,
    last_descs: torch.Tensor,
    last_mask: torch.Tensor,
    last_point_idx: torch.Tensor,  # [M] map point index per last kpt (-1 none)
    last_vrf_slot: torch.Tensor,  # scalar: VRF slot of the last localization
    cfg: LocConfig,
    refine_below: int = 256,
    generator: Optional[torch.Generator] = None,
) -> TrackResult:
    """One tracking step (tracker.py:162-233 + the <256-inlier refinement).

    ``generator`` (CPU) draws the tracking RANSAC's hypotheses, then the
    refinement's.
    """
    cam = Camera(camera.params[None], camera.size[None])
    w, h = camera.size[0], camera.size[1]
    nk0 = normalize_kpts_like_reference(curr_kpts, w, h)[None]
    nk1 = normalize_kpts_like_reference(last_kpts, w, h)[None]
    matches = match_fn(
        curr_descs[None], nk0, curr_scores[None], curr_mask[None],
        last_descs[None], nk1, last_scores[None], last_mask[None],
    )[0]  # [N]

    m_valid = matches >= 0
    safe = torch.clamp(matches, 0, last_kpts.shape[0] - 1)
    m_pt = torch.where(m_valid, last_point_idx[safe], -1)
    has_3d = m_pt >= 0
    safe_pt = torch.clamp(m_pt, 0, dmap.point_xyz.shape[0] - 1)
    m_xyz = dmap.point_xyz[safe_pt]
    corr_mask = m_valid & has_3d & curr_mask

    res = ransac_pnp(
        cam,
        (curr_kpts + 0.5)[None],
        m_xyz[None].float().contiguous(),
        corr_mask[None].contiguous(),
        generator=generator,
        inlier_threshold=cfg.threshold,
        num_hypotheses=cfg.num_hypotheses,
        min_inliers=cfg.min_inliers,
    )
    kpt_point_idx = torch.where(res.inliers[0], m_pt, -1)
    kpt_xyz = m_xyz

    # map refinement when tracking-only inliers are low (tracker.py:85-94)
    need_refine = res.success[0] & (res.num_inliers[0] < refine_below)
    slot = torch.as_tensor(last_vrf_slot, device=curr_kpts.device).reshape(1)
    Rr, tr, inl_r, ref_ok, r_pt_idx, r_xyz = _refine_by_projection(
        dmap, cam, curr_kpts[None], curr_descs[None], curr_mask[None], slot,
        res.R, res.t, cfg, generator,
    )
    use = need_refine & ref_ok[0]
    R_fin = torch.where(use, Rr[0], res.R[0])
    t_fin = torch.where(use, tr[0], res.t[0])
    inl_fin = torch.where(use, inl_r[0], res.num_inliers[0])
    kpt_point_idx = torch.where(use, r_pt_idx[0], kpt_point_idx)
    kpt_xyz = torch.where(use, r_xyz[0], kpt_xyz)

    success = inl_fin >= cfg.min_inliers
    return TrackResult(
        qvec=rotmat2qvec(R_fin),
        tvec=t_fin,
        R=R_fin,
        success=success,
        num_inliers=inl_fin,
        kpt_point_idx=kpt_point_idx,
        kpt_xyz=kpt_xyz,
    )


class Tracker:
    """Host-side tracking state machine (lost flag + last-frame cache).

    Mirrors the reference Tracker's control flow: when ``lost`` the caller
    should run full relocalization (Localizer) and feed the result back via
    ``update_from_localization``; otherwise ``track`` advances frame-to-frame.
    """

    def __init__(self, dmap: DeviceMap, match_fn: MatchFn, cfg: LocConfig):
        self.dmap = dmap
        self.cfg = cfg
        self.match_fn = match_fn
        self.lost = True
        self._last = None  # dict of last-frame tensors

    def update_from_localization(
        self, kpts, scores, descs, mask, loc_result, vrf_slot
    ):
        """Cache the relocalized frame (a per-frame LocResult) as the tracking
        reference."""
        self._last = {
            "kpts": kpts,
            "scores": scores,
            "descs": descs,
            "mask": mask,
            "point_idx": loc_result.kpt_point_idx,
            "vrf_slot": torch.as_tensor(vrf_slot, dtype=torch.int64, device=kpts.device),
        }
        self.lost = not bool(loc_result.success)

    def track(self, generator, camera: Camera, kpts, scores, descs, mask):
        """Track the current frame against the cached previous frame."""
        if self._last is None or self.lost:
            return None
        res = track_frame(
            self.dmap, self.match_fn, camera, kpts, scores, descs, mask,
            self._last["kpts"], self._last["scores"], self._last["descs"],
            self._last["mask"], self._last["point_idx"], self._last["vrf_slot"],
            self.cfg, generator=generator,
        )
        if bool(res.success):
            self._last = {
                "kpts": kpts,
                "scores": scores,
                "descs": descs,
                "mask": mask,
                "point_idx": res.kpt_point_idx,
                "vrf_slot": self._last["vrf_slot"],
            }
            self.lost = False
        else:
            self.lost = True
        return res
