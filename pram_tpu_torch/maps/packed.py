"""Packed-array localization maps (host numpy; copy of pram_tpu/maps/packed.py).

The reference holds its map as dicts of Python objects and walks them per
query (localization/singlemap3d.py:24-533, multimap3d.py:26-379). Here the
whole map is packed into fixed-shape arrays once at load time, and the
query path runs against device-resident tables (maps/device.py):

- points:    xyz / descriptor / global-seg-id / track info, ``[P, ...]``
- frames:    poses, cameras, per-frame keypoint tables ``[F, K, ...]``
  (keypoints regenerated by projecting associated 3D points, exactly like
  RefFrame.associate_keypoints_with_point3Ds, refframe.py:99-129, with
  score = 1/clip(5*error, 1, 20))
- VRF routing: global segment id -> VRF slot -> frame index
  (multimap3d.py:121-124's sid_scene_name/start_sid routing becomes pure
  array indexing because segment ids are globalized at build time)
- covisibility graph per VRF (singlemap3d.py:228-258) and *precomputed
  refinement point sets* (the union of covisible frames' points that
  refine_pose_by_projection gathers per query, singlemap3d.py:382-398 —
  hoisted to build time so the query path has zero dynamic set ops).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from pram_tpu_torch.maps.colmap_io import (
    ColmapCamera,
    ColmapImage,
    ColmapPoint3D,
)

_CAM_MODEL_PACK = {
    "SIMPLE_PINHOLE": lambda p: [p[0], p[0], p[1], p[2], 0, 0, 0, 0],
    "PINHOLE": lambda p: [p[0], p[1], p[2], p[3], 0, 0, 0, 0],
    "SIMPLE_RADIAL": lambda p: [p[0], p[0], p[1], p[2], p[3], 0, 0, 0],
    "RADIAL": lambda p: [p[0], p[0], p[1], p[2], p[3], p[4], 0, 0],
    "OPENCV": lambda p: [p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]],
}


def _qvec2rotmat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclass
class PackedMap:
    """Fixed-shape localization map (host numpy; ship to the device with maps/device.py)."""

    # points
    point_xyz: np.ndarray  # [P, 3] f32
    point_desc: np.ndarray  # [P, D] f32
    point_seg: np.ndarray  # [P] i32 global seg id (0-based, no background)
    point_error: np.ndarray  # [P] f32
    point_ids: np.ndarray  # [P] i64 original COLMAP ids
    # frames
    frame_R: np.ndarray  # [F, 3, 3] f32 world-to-cam
    frame_t: np.ndarray  # [F, 3] f32
    frame_cam: np.ndarray  # [F, 8] f32 packed camera params
    frame_size: np.ndarray  # [F, 2] f32 (width, height)
    frame_point_idx: np.ndarray  # [F, K] i32 index into points, -1 pad
    frame_kp_uv: np.ndarray  # [F, K, 2] f32
    frame_kp_score: np.ndarray  # [F, K] f32
    frame_kp_mask: np.ndarray  # [F, K] bool
    # segment -> VRF routing
    seg_vrf_slot: np.ndarray  # [S] i32 -> slot into vrf_*, -1 if none
    vrf_frame_idx: np.ndarray  # [V] i32 -> frame index
    vrf_covis: np.ndarray  # [V, C] i32 frame indices, -1 pad
    vrf_ref_point_idx: np.ndarray  # [V, Pr] i32 refinement point set, -1 pad
    # bookkeeping (host only)
    frame_names: List[str] = field(default_factory=list)
    scene_of_frame: List[str] = field(default_factory=list)
    scene_names: List[str] = field(default_factory=list)
    n_class: int = 0  # total global classes incl. background

    @property
    def num_points(self) -> int:
        return self.point_xyz.shape[0]

    @property
    def num_frames(self) -> int:
        return self.frame_R.shape[0]


def pack_camera_params(camera: ColmapCamera) -> np.ndarray:
    if camera.model not in _CAM_MODEL_PACK:
        raise ValueError(f"unsupported camera model {camera.model}")
    return np.asarray(_CAM_MODEL_PACK[camera.model](camera.params), np.float32)


def build_scene_map(
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    points3D: Dict[int, ColmapPoint3D],
    p3d_descriptors: Dict[int, np.ndarray],
    p3d_seg: Dict[int, int],
    seg_vrf: Dict[int, Dict],
    *,
    start_sid: int = 0,
    n_cluster: int,
    covisibility_frame: int = 20,
    scene_name: str = "scene",
    max_kp_per_frame: Optional[int] = None,
    max_ref_points: Optional[int] = None,
) -> PackedMap:
    """Pack one scene (the build-time equivalent of SingleMap3D.__init__).

    Args:
      p3d_seg: point3D id -> local segment label (from point3D_cluster_*.npy,
        singlemap3d.py:44-52).
      seg_vrf: local sid -> {vrf_order: {'image_id': ..., 'original_points3d':
        ...}} (from point3D_vrf_*.npy, singlemap3d.py:62-80).
      start_sid: global label offset for multi-scene maps.
    """
    # ---- points (only those with a segment label, singlemap3d.py:108-116)
    pids = [pid for pid in points3D if pid in p3d_seg]
    pid_to_idx = {pid: i for i, pid in enumerate(pids)}
    P = len(pids)
    desc_dim = len(next(iter(p3d_descriptors.values()))) if P else 128
    point_xyz = np.zeros((P, 3), np.float32)
    point_desc = np.zeros((P, desc_dim), np.float32)
    point_seg = np.zeros((P,), np.int32)
    point_error = np.zeros((P,), np.float32)
    point_ids = np.zeros((P,), np.int64)
    for i, pid in enumerate(pids):
        pt = points3D[pid]
        point_xyz[i] = pt.xyz
        point_desc[i] = p3d_descriptors[pid]
        point_seg[i] = p3d_seg[pid] + start_sid
        point_error[i] = pt.error
        point_ids[i] = pid

    # ---- VRF frame ids and their (possibly compressed-restored) point lists
    vrf_frame_ids: List[int] = []
    seg_first_vrf: Dict[int, int] = {}
    vrf_points_override: Dict[int, np.ndarray] = {}
    for sid in sorted(seg_vrf.keys()):
        for vi in sorted(seg_vrf[sid].keys()):
            rec = seg_vrf[sid][vi]
            fid = int(rec["image_id"])
            if sid not in seg_first_vrf:
                seg_first_vrf[sid] = fid
            if "original_points3d" in rec:
                vrf_points_override[fid] = np.asarray(
                    rec["original_points3d"], np.int64
                )
            vrf_frame_ids.append(fid)

    # ---- frames: associate keypoints by projecting labeled points
    frame_ids = sorted(images.keys())
    per_frame_pidx: Dict[int, np.ndarray] = {}
    for fid in frame_ids:
        im = images[fid]
        p3d_ids = vrf_points_override.get(fid, np.asarray(im.point3D_ids))
        idx = np.array(
            [pid_to_idx[p] for p in p3d_ids if p in pid_to_idx], np.int32
        )
        per_frame_pidx[fid] = idx
    # drop frames with no associated points (singlemap3d.py:87-89)
    frame_ids = [fid for fid in frame_ids if len(per_frame_pidx[fid]) > 0]
    fid_to_row = {fid: r for r, fid in enumerate(frame_ids)}
    F = len(frame_ids)
    K = max_kp_per_frame or _round_up(
        max((len(per_frame_pidx[f]) for f in frame_ids), default=1), 128
    )

    frame_R = np.zeros((F, 3, 3), np.float32)
    frame_t = np.zeros((F, 3), np.float32)
    frame_cam = np.zeros((F, 8), np.float32)
    frame_size = np.zeros((F, 2), np.float32)
    frame_point_idx = np.full((F, K), -1, np.int32)
    frame_kp_uv = np.zeros((F, K, 2), np.float32)
    frame_kp_score = np.zeros((F, K), np.float32)
    frame_kp_mask = np.zeros((F, K), bool)
    frame_names = []

    for r, fid in enumerate(frame_ids):
        im = images[fid]
        cam = cameras[im.camera_id]
        R = _qvec2rotmat_np(im.qvec)
        t = np.asarray(im.tvec, float)
        frame_R[r] = R
        frame_t[r] = t
        frame_cam[r] = pack_camera_params(cam)
        frame_size[r] = (cam.width, cam.height)
        frame_names.append(im.name)

        idx = per_frame_pidx[fid]
        if len(idx) > K:
            # keep every segment represented under the cap: round-robin
            # across the frame's segments instead of a head-truncation that
            # would drop whole landmarks (reference VRFs keep full tables;
            # this cap only exists for fixed-shape HBM budgeting)
            seg_of = point_seg[idx]
            order = np.lexsort((np.arange(len(idx)), seg_of))
            # rank within segment, then interleave segments rank-by-rank
            sorted_idx = idx[order]
            sorted_seg = seg_of[order]
            rank = np.arange(len(idx)) - np.searchsorted(
                sorted_seg, sorted_seg, side="left"
            )
            take = np.lexsort((sorted_seg, rank))[:K]
            idx = sorted_idx[take]
        n = len(idx)
        xyz = point_xyz[idx]
        xc = xyz @ R.T + t
        z = np.maximum(xc[:, 2], 1e-8)
        xy = xc[:, :2] / z[:, None]
        # distortion-free projection matches RefFrame.project (refframe.py:131-147)
        fx, fy, cx, cy = frame_cam[r][:4]
        uv = np.stack([xy[:, 0] * fx + cx, xy[:, 1] * fy + cy], -1)
        frame_point_idx[r, :n] = idx
        frame_kp_uv[r, :n] = uv
        frame_kp_score[r, :n] = 1.0 / np.clip(point_error[idx] * 5.0, 1.0, 20.0)
        frame_kp_mask[r, :n] = True

    # ---- covisibility for VRF frames (singlemap3d.py:228-258)
    # count, for each VRF frame, how many of its points each other frame sees
    point_track_rows: List[List[int]] = [[] for _ in range(P)]
    for fid in frame_ids:
        r = fid_to_row[fid]
        for pi in per_frame_pidx[fid]:
            point_track_rows[pi].append(r)

    vrf_rows = sorted(
        {fid_to_row[f] for f in vrf_frame_ids if f in fid_to_row}
    )
    V = len(vrf_rows)
    C = covisibility_frame
    vrf_frame_idx = np.asarray(vrf_rows, np.int32)
    vrf_covis = np.full((V, C), -1, np.int32)
    for v, r in enumerate(vrf_rows):
        counts = np.zeros(F, np.int64)
        for pi in per_frame_pidx[frame_ids[r]]:
            counts[point_track_rows[pi]] += 1
        order = np.argsort(-counts)
        sel = [int(o) for o in order if counts[o] > 0][:C]
        vrf_covis[v, : len(sel)] = sel

    # ---- refinement point sets: union over covis frames + self
    ref_sets = []
    for v, r in enumerate(vrf_rows):
        rows = [r] + [int(x) for x in vrf_covis[v] if x >= 0]
        pts = np.unique(
            np.concatenate([per_frame_pidx[frame_ids[x]] for x in rows])
        )
        ref_sets.append(pts)
    Pr = max_ref_points or _round_up(
        max((len(s) for s in ref_sets), default=1), 256
    )
    vrf_ref_point_idx = np.full((V, Pr), -1, np.int32)
    for v, s in enumerate(ref_sets):
        if len(s) > Pr:
            # same stratified cap as the frame tables: round-robin across
            # segments so no landmark's points vanish from the refinement set
            seg_of = point_seg[s]
            order = np.lexsort((np.arange(len(s)), seg_of))
            ss, sg = s[order], seg_of[order]
            rank = np.arange(len(s)) - np.searchsorted(sg, sg, side="left")
            s = ss[np.lexsort((sg, rank))[:Pr]]
        vrf_ref_point_idx[v, : len(s)] = s

    # ---- segment routing (global sid -> VRF slot)
    S = start_sid + n_cluster
    seg_vrf_slot = np.full((S,), -1, np.int32)
    row_to_slot = {r: v for v, r in enumerate(vrf_rows)}
    for sid, fid in seg_first_vrf.items():
        if fid in fid_to_row:
            seg_vrf_slot[sid + start_sid] = row_to_slot[fid_to_row[fid]]

    return PackedMap(
        point_xyz=point_xyz,
        point_desc=point_desc,
        point_seg=point_seg,
        point_error=point_error,
        point_ids=point_ids,
        frame_R=frame_R,
        frame_t=frame_t,
        frame_cam=frame_cam,
        frame_size=frame_size,
        frame_point_idx=frame_point_idx,
        frame_kp_uv=frame_kp_uv,
        frame_kp_score=frame_kp_score,
        frame_kp_mask=frame_kp_mask,
        seg_vrf_slot=seg_vrf_slot,
        vrf_frame_idx=vrf_frame_idx,
        vrf_covis=vrf_covis,
        vrf_ref_point_idx=vrf_ref_point_idx,
        frame_names=frame_names,
        scene_of_frame=[scene_name] * F,
        scene_names=[scene_name],
        n_class=S + 1,  # + background
    )


def concat_maps(maps: Sequence[PackedMap]) -> PackedMap:
    """Concatenate per-scene packed maps into one multi-scene map.

    Assumes each scene was built with its global ``start_sid`` offset (the
    reference's RecDataset/MultiMap3D label-offset convention,
    dataset/recdataset.py:56-90, multimap3d.py:86-90), so segment ids are
    already global; only point/frame indices need offsetting.
    """
    if len(maps) == 1:
        return maps[0]

    def pad_to(arr, k, axis, fill):
        pad = k - arr.shape[axis]
        if pad <= 0:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=fill)

    K = max(m.frame_point_idx.shape[1] for m in maps)
    Pr = max(m.vrf_ref_point_idx.shape[1] for m in maps)
    C = max(m.vrf_covis.shape[1] for m in maps)
    S = max(m.seg_vrf_slot.shape[0] for m in maps)

    point_off = np.cumsum([0] + [m.num_points for m in maps])
    frame_off = np.cumsum([0] + [m.num_frames for m in maps])
    vrf_off = np.cumsum([0] + [len(m.vrf_frame_idx) for m in maps])

    def off_idx(arr, off):
        return np.where(arr >= 0, arr + off, -1)

    seg_vrf_slot = np.full((S,), -1, np.int32)
    for i, m in enumerate(maps):
        sl = m.seg_vrf_slot
        merged = off_idx(sl, vrf_off[i])
        # scenes only own their [start_sid, start_sid+n_cluster) range
        take = sl >= 0
        seg_vrf_slot[: len(sl)][take] = merged[take]

    return PackedMap(
        point_xyz=np.concatenate([m.point_xyz for m in maps]),
        point_desc=np.concatenate([m.point_desc for m in maps]),
        point_seg=np.concatenate([m.point_seg for m in maps]),
        point_error=np.concatenate([m.point_error for m in maps]),
        point_ids=np.concatenate([m.point_ids for m in maps]),
        frame_R=np.concatenate([m.frame_R for m in maps]),
        frame_t=np.concatenate([m.frame_t for m in maps]),
        frame_cam=np.concatenate([m.frame_cam for m in maps]),
        frame_size=np.concatenate([m.frame_size for m in maps]),
        frame_point_idx=np.concatenate(
            [
                off_idx(pad_to(m.frame_point_idx, K, 1, -1), point_off[i])
                for i, m in enumerate(maps)
            ]
        ),
        frame_kp_uv=np.concatenate(
            [pad_to(m.frame_kp_uv, K, 1, 0) for m in maps]
        ),
        frame_kp_score=np.concatenate(
            [pad_to(m.frame_kp_score, K, 1, 0) for m in maps]
        ),
        frame_kp_mask=np.concatenate(
            [pad_to(m.frame_kp_mask, K, 1, False) for m in maps]
        ),
        seg_vrf_slot=seg_vrf_slot,
        vrf_frame_idx=np.concatenate(
            [off_idx(m.vrf_frame_idx, frame_off[i]) for i, m in enumerate(maps)]
        ),
        vrf_covis=np.concatenate(
            [
                off_idx(pad_to(m.vrf_covis, C, 1, -1), frame_off[i])
                for i, m in enumerate(maps)
            ]
        ),
        vrf_ref_point_idx=np.concatenate(
            [
                off_idx(pad_to(m.vrf_ref_point_idx, Pr, 1, -1), point_off[i])
                for i, m in enumerate(maps)
            ]
        ),
        frame_names=sum([m.frame_names for m in maps], []),
        scene_of_frame=sum([m.scene_of_frame for m in maps], []),
        scene_names=sum([m.scene_names for m in maps], []),
        n_class=max(m.n_class for m in maps),
    )
