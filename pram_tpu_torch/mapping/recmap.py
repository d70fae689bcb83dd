"""RecMap: offline landmark-map generation from an SfM model
(pram_tpu/mapping/recmap.py).

Rebuild of recognition/recmap.py:29-1118 — the pipeline that turns a COLMAP
reconstruction into PRAM's self-supervised landmark map:

  load model -> outlier removal -> 3D clustering -> per-point descriptor
  assignment -> virtual-reference-frame selection -> map compression ->
  feature export (+ query-keypoint/3D association for eval)

The host steps are numpy copies of the JAX package's, so their artifacts
are the same. Two steps run on ``RecMap.device``:
- KMeans clustering (``mapping/clustering.py:kmeans``);
- descriptor assignment: tracks padded into ``[B, T, D]`` tensors, the
  median distance of each track descriptor to the others by one batched
  product, masked sort and gather (:func:`best_of`), instead of the
  reference's 32 CPU processes (recmap.py:164-189).
Artifact formats are byte/structure-compatible with the reference (cluster
npy, vrf npy, compressed COLMAP binary + point3D_desc.npy), so maps
interchange in both directions.
"""

from __future__ import annotations

import os
import os.path as osp
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from pram_tpu_torch.io import h5
from pram_tpu_torch.maps.colmap_io import (
    ColmapImage,
    read_model,
    write_compressed_model,
)
from pram_tpu_torch.mapping.clustering import cluster_points, full_f32
from pram_tpu_torch.mapping.outliers import statistical_outlier_removal


class FeatureSource:
    """Uniform reader over hloc-style h5 feature files (through the port's
    own HDF5 reader, ``io/h5.py``) or npy directories (``<name with / as
    +>.npy``, a dict of keypoints, scores, descriptors [N, D] and
    image_size)."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = None
        if path.endswith(".h5") or path.endswith(".hdf5"):
            self._h5 = h5.File(path, "r")

    def get(self, image_name: str) -> Dict[str, np.ndarray]:
        if self._h5 is not None:
            g = self._h5[image_name]
            return {
                "keypoints": g["keypoints"][()],
                "scores": g["scores"][()],
                # hloc stores descriptors [D, N]
                "descriptors": g["descriptors"][()].T,
                "image_size": g["image_size"][()]
                if "image_size" in g
                else None,
            }
        fn = osp.join(self.path, image_name.replace("/", "+") + ".npy")
        return np.load(fn, allow_pickle=True)[()]

    def names(self) -> List[str]:
        if self._h5 is not None:
            out = []

            def visit(name, obj):
                if isinstance(obj, h5.Group) and "keypoints" in obj:
                    out.append(name)

            self._h5.visititems(visit)
            return out
        return [
            f[:-4].replace("+", "/")
            for f in os.listdir(self.path)
            if f.endswith(".npy")
        ]


class RecMap:
    """Landmark-map construction over one scene's SfM model; KMeans and the
    descriptor assignment run on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.cameras = None
        self.images = None
        self.points3D = None
        self.p3d_seg: Dict[int, int] = {}
        self.seg_p3d: Dict[int, List[int]] = {}

    # ------------------------------------------------------------------
    def load_sfm_model(self, path: str, ext: str = ".bin"):
        """recmap.py:37-41."""
        self.cameras, self.images, self.points3D = read_model(path, ext)

    def remove_statics_outlier(
        self, nb_neighbors: int = 20, std_ratio: float = 2.0
    ):
        """recmap.py:43-62 (open3d replaced by a scipy kNN filter)."""
        pids = sorted(self.points3D.keys())
        xyz = np.array([self.points3D[p].xyz for p in pids])
        keep = statistical_outlier_removal(xyz, nb_neighbors, std_ratio)
        keep_ids = {pids[i] for i in keep}
        self.points3D = {p: v for p, v in self.points3D.items() if p in keep_ids}

    # ------------------------------------------------------------------
    def cluster(
        self,
        k: int = 512,
        mode: str = "xyz",
        min_obs: int = 3,
        method: str = "birch",
        birch_threshold: float = 0.01,
        save_fn: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """recmap.py:85-122: cluster points observed >= min_obs times
        (KMeans on ``self.device``)."""
        pids, xyz = [], []
        for p in self.points3D.values():
            if len(p.image_ids) < min_obs:
                continue
            pids.append(p.id)
            xyz.append(p.xyz)
        xyz = np.asarray(xyz)
        labels = cluster_points(
            xyz, k, mode=mode, method=method, birch_threshold=birch_threshold,
            device=self.device,
        )
        data = {
            "id": np.asarray(pids),
            "label": np.asarray(labels),
            "xyz": xyz,
        }
        if save_fn is not None:
            np.save(save_fn, data)
        self.load_segmentation_data(data)
        return data

    def load_segmentation(self, path: str):
        """recmap.py:64-83."""
        self.load_segmentation_data(np.load(path, allow_pickle=True)[()])

    def load_segmentation_data(self, data):
        self.p3d_seg = {
            int(i): int(l) for i, l in zip(data["id"], data["label"])
        }
        self.seg_p3d = defaultdict(list)
        for pid, sid in self.p3d_seg.items():
            self.seg_p3d[sid].append(pid)

    # ------------------------------------------------------------------
    def assign_point3D_descriptors(
        self,
        features: FeatureSource,
        save_fn: Optional[str] = None,
        batch_points: int = 4096,
    ) -> Dict[int, np.ndarray]:
        """Pick each 3D point's representative track descriptor.

        Reference semantics (recmap.py:124-196): among a point's track
        descriptors, keep the one minimizing the median squared distance to
        the others. Instead of 32 worker processes, tracks are padded into
        ``[B, T, D]`` tensors (T the longest track of the map) and the
        medians computed by :func:`best_of` on ``self.device``,
        ``batch_points`` tracks a call.
        """
        # image-major descriptor cache
        img_desc: Dict[int, np.ndarray] = {}
        for iid, im in self.images.items():
            feat = features.get(im.name)
            img_desc[iid] = np.asarray(feat["descriptors"], np.float32)

        pids = sorted(self.points3D.keys())
        tracks = []
        for pid in pids:
            pt = self.points3D[pid]
            ds = [
                img_desc[iid][k]
                for iid, k in zip(pt.image_ids, pt.point2D_idxs)
                if iid in img_desc and k < len(img_desc[iid])
            ]
            tracks.append(np.asarray(ds, np.float32))

        dim = next((t.shape[1] for t in tracks if t.size), 128)
        max_t = max((len(t) for t in tracks), default=1)

        out: Dict[int, np.ndarray] = {}
        for start in range(0, len(pids), batch_points):
            chunk = tracks[start : start + batch_points]
            b = len(chunk)
            batch = np.zeros((b, max_t, dim), np.float32)
            mask = np.zeros((b, max_t), bool)
            for i, t in enumerate(chunk):
                if len(t):
                    batch[i, : len(t)] = t
                    mask[i, : len(t)] = True
            best = best_of(
                torch.from_numpy(batch).to(self.device),
                torch.from_numpy(mask).to(self.device),
            ).cpu().numpy()
            for i, t in enumerate(chunk):
                pid = pids[start + i]
                if len(t) == 0:
                    out[pid] = np.zeros((dim,), np.float32)
                elif len(t) == 1:
                    out[pid] = t[0]
                else:
                    out[pid] = t[int(best[i])]
        if save_fn is not None:
            np.save(save_fn, out)
        return out

    # ------------------------------------------------------------------
    def _project(self, image_id: int, xyz: np.ndarray) -> np.ndarray:
        """Project points into an image -> [N, 3] (u, v, depth)
        (recmap.py:197-216)."""
        from pram_tpu_torch.maps.packed import _qvec2rotmat_np, pack_camera_params

        im = self.images[image_id]
        cam = self.cameras[im.camera_id]
        R = _qvec2rotmat_np(im.qvec)
        t = np.asarray(im.tvec)
        xc = xyz @ R.T + t
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        p = pack_camera_params(cam)
        u = xc[:, 0] / zs * p[0] + p[2]
        v = xc[:, 1] / zs * p[1] + p[3]
        return np.stack([u, v, z], -1)

    def find_covisible_frame_ids(self, image_id: int) -> List[int]:
        """All frames sharing points, most-covisible first (recmap.py:218-236)."""
        covis: Dict[int, int] = defaultdict(int)
        for pid in self.images[image_id].point3D_ids:
            if pid < 0 or pid not in self.points3D:
                continue
            for iid in self.points3D[pid].image_ids:
                covis[iid] += 1
        return [
            iid
            for iid, _ in sorted(covis.items(), key=lambda kv: -kv[1])
        ]

    def create_virtual_frames(
        self,
        save_fn: Optional[str] = None,
        min_cover_ratio: float = 0.9,
        min_obs: int = 120,
        topk_imgs: int = 500,
        n_vrf: int = 10,
        covisible_frame: int = 20,
        ignored_cameras: Optional[List[str]] = None,
    ) -> Dict:
        """Greedy max-coverage VRF selection per landmark
        (recmap.py:234-473: keep adding the frame observing the most
        still-uncovered points until >= min_cover_ratio or n_vrf frames)."""
        ignored_cameras = ignored_cameras or []
        seg_ref: Dict[int, Dict] = {}
        for sid in sorted(self.seg_p3d.keys()):
            if sid == -1:
                continue
            pid_list = [
                p for p in self.seg_p3d[sid] if p in self.points3D
            ]
            if not pid_list:
                continue
            pid_index = {p: i for i, p in enumerate(pid_list)}

            # candidate frames = frames observing any segment point, with
            # >= min_obs total valid observations; top-k by observation count
            frame_obs: Dict[int, int] = {}
            for pid in pid_list:
                for iid in self.points3D[pid].image_ids:
                    if iid in frame_obs or iid not in self.images:
                        continue
                    name = self.images[iid].name
                    if any(c in name for c in ignored_cameras):
                        continue
                    n_valid = int(np.sum(self.images[iid].point3D_ids >= 0))
                    frame_obs[iid] = n_valid
            cands = [
                iid
                for iid, n in sorted(frame_obs.items(), key=lambda kv: -kv[1])
                if n >= min_obs
            ][:topk_imgs]
            if not cands:
                cands = list(frame_obs.keys())

            # boolean observation matrix [n_cands, n_points]
            obs = np.zeros((len(cands), len(pid_list)), bool)
            for ci, iid in enumerate(cands):
                for pid in self.images[iid].point3D_ids:
                    j = pid_index.get(int(pid))
                    if j is not None:
                        obs[ci, j] = True

            unobserved = np.ones(len(pid_list), bool)
            chosen: List[int] = []
            chosen_mask = np.zeros(len(cands), bool)
            while True:
                gains = (obs & unobserved[None]).sum(axis=1)
                gains[chosen_mask] = -1
                best = int(np.argmax(gains))
                if gains[best] <= 0:
                    break
                chosen.append(cands[best])
                chosen_mask[best] = True
                unobserved &= ~obs[best]
                cover = 1.0 - unobserved.sum() / len(pid_list)
                if gains[best] / len(pid_list) < 0.01:
                    break
                if len(chosen) >= n_vrf or cover >= min_cover_ratio:
                    break

            seg_ref[sid] = {}
            for vi, iid in enumerate(chosen):
                im = self.images[iid]
                cam = self.cameras[im.camera_id]
                covis = self.find_covisible_frame_ids(iid)
                seg_ref[sid][vi] = {
                    "image_name": im.name,
                    "image_id": iid,
                    "qvec": im.qvec.copy(),
                    "tvec": np.asarray(im.tvec).copy(),
                    "camera": {
                        "model": cam.model,
                        "params": cam.params,
                        "width": cam.width,
                        "height": cam.height,
                    },
                    "original_points3d": np.array(
                        [
                            p
                            for p in im.point3D_ids
                            if p >= 0 and p in self.points3D
                        ]
                    ),
                    "covisible_frame_ids": np.array(covis[:covisible_frame]),
                }
        if save_fn is not None:
            np.save(save_fn, seg_ref)
        return seg_ref

    # ------------------------------------------------------------------
    def compress_map_by_projection(
        self,
        vrf_data: Dict,
        p3d_descriptors: Dict[int, np.ndarray],
        vrf_frames: int = 1,
        covisible_frames: int = 20,
        radius: float = 20.0,
        nkpts: int = -1,
        save_dir: Optional[str] = None,
    ):
        """Projection-overlap sparsification (recmap.py:668-925).

        Keeps VRF frames + their top covisible frames; a covisible frame only
        contributes 3D points whose projections do NOT fall within ``radius``
        px of an already-kept point in any previously retained frame; optional
        grid NMS caps keypoints per frame. Writes the compressed COLMAP model
        + its point3D_desc.npy.
        """
        vrf_image_ids: List[int] = []
        for sid, svrf in vrf_data.items():
            for vi in range(vrf_frames):
                if vi not in svrf:
                    continue
                iid = int(svrf[vi]["image_id"])
                if iid not in vrf_image_ids:
                    vrf_image_ids.append(iid)

        retained: Dict[int, Dict] = {}

        def frame_valid(iid):
            xys, pids = [], []
            im = self.images[iid]
            for xy, pid in zip(im.xys, im.point3D_ids):
                if pid >= 0 and pid in self.points3D:
                    xys.append(xy)
                    pids.append(int(pid))
            return np.asarray(xys).reshape(-1, 2), pids

        for frame_id in vrf_image_ids:
            xys, pids = frame_valid(frame_id)
            retained[frame_id] = {"xys": xys, "p3d_ids": pids}

            covis = self.find_covisible_frame_ids(frame_id)[
                : covisible_frames
            ]
            kept_chain = [frame_id]
            for iim in covis:
                if iim == frame_id:
                    continue
                if iim in retained:
                    kept_chain.append(iim)
                    continue
                # points of iim not covered by projections into kept frames
                xys_i, pids_i = frame_valid(iim)
                if not pids_i:
                    continue
                xyz_i = np.array([self.points3D[p].xyz for p in pids_i])
                keep = np.ones(len(pids_i), bool)
                for kept_id in kept_chain:
                    uvz = self._project(kept_id, xyz_i)
                    cam = self.cameras[self.images[kept_id].camera_id]
                    in_img = (
                        (uvz[:, 0] >= 0)
                        & (uvz[:, 0] < cam.width)
                        & (uvz[:, 1] >= 0)
                        & (uvz[:, 1] < cam.height)
                        & (uvz[:, 2] > 0)
                    )
                    kept_uv = retained[kept_id]["xys"]
                    if kept_uv.size == 0:
                        continue
                    d = np.linalg.norm(
                        uvz[:, None, :2] - kept_uv[None], axis=-1
                    ).min(axis=1)
                    covered = in_img & (d <= radius)
                    keep &= ~covered
                if not keep.any():
                    continue
                kept_chain.append(iim)
                retained[iim] = {
                    "xys": xys_i[keep],
                    "p3d_ids": [p for p, k in zip(pids_i, keep) if k],
                }

        # assemble compressed model
        new_images, new_points, new_cams = {}, {}, {}
        for iid, rec in retained.items():
            pids = rec["p3d_ids"]
            im = self.images[iid]
            if nkpts > 0 and len(pids) > nkpts:
                xyz = np.array([self.points3D[p].xyz for p in pids])
                uvz = self._project(iid, xyz)
                scores = np.array(
                    [len(self.points3D[p].image_ids) for p in pids]
                )
                cam = self.cameras[im.camera_id]
                keep = _sparsify_by_grid(
                    cam.height, cam.width, uvz[:, :2], scores, radius
                )
                pids = [pids[k] for k in keep]
            new_images[iid] = ColmapImage(
                iid, im.qvec, np.asarray(im.tvec), im.camera_id, im.name,
                np.zeros((0, 2)), np.asarray(pids, np.int64),
            )
            new_cams[im.camera_id] = self.cameras[im.camera_id]
            for p in pids:
                new_points[p] = self.points3D[p]

        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            write_compressed_model(new_cams, new_images, new_points, save_dir)
            np.save(
                osp.join(save_dir, "point3D_desc.npy"),
                {p: p3d_descriptors[p] for p in new_points if p in p3d_descriptors},
            )
        return new_cams, new_images, new_points

    # ------------------------------------------------------------------
    def export_features_to_directory(
        self, feat_fn: str, save_dir: str, with_descriptors: bool = False
    ):
        """h5 -> per-image npy cache for training (recmap.py:616-646)."""
        src = FeatureSource(feat_fn)
        os.makedirs(save_dir, exist_ok=True)
        for name in src.names():
            feat = src.get(name)
            data = {
                "scores": np.asarray(feat["scores"]),
                "keypoints": np.asarray(feat["keypoints"]),
                "image_size": np.asarray(feat["image_size"]),
            }
            if with_descriptors:
                data["descriptors"] = np.asarray(feat["descriptors"])
            np.save(osp.join(save_dir, name.replace("/", "+")), data)

    def extract_query_p3ds(
        self, loc_log: Dict, features: FeatureSource, save_fn=None,
        max_px: float = 1.0,
    ) -> Dict[str, np.ndarray]:
        """Associate query keypoints with matched 3D points from a
        localization log (recmap.py:535-566): each matched keypoint claims
        the nearest raw query keypoint within ``max_px``.
        """
        out = {}
        for fn, rec in loc_log.items():
            q_kpts = np.asarray(features.get(fn)["keypoints"], float)[:, :2]
            ids = np.full(len(q_kpts), -1, np.int64)
            m_kpts = np.asarray(rec["keypoints_query"], float)
            m_p3ds = np.asarray(rec["points3D_ids"])
            if len(m_kpts):
                d = np.linalg.norm(
                    m_kpts[:, None, :2] - q_kpts[None], axis=-1
                )
                nearest = np.argmin(d, axis=1)
                ok = d[np.arange(len(m_kpts)), nearest] <= max_px
                ids[nearest[ok]] = m_p3ds[ok]
            out[fn] = ids
        if save_fn is not None:
            np.save(save_fn, out)
        return out


@torch.no_grad()
def best_of(batch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index ``[B]`` of each track's representative descriptor.

    ``batch [B, T, D]`` track descriptors (L2-ish), ``mask [B, T]`` the
    valid ones. Distances ``2 - 2 sim`` to the track's valid descriptors
    (itself included), masked columns at 1e9, sorted; a row's median is the
    mean of the two middle valid entries (one when the count is odd); the
    row with the least median wins, masked rows never. The product runs in
    full f32 (TF32 off), as KMeans's do.
    """
    with full_f32():
        sim = torch.einsum("btd,bsd->bts", batch, batch)
    d = 2.0 - 2.0 * sim  # [B, T, T]
    big = torch.tensor(1e9, dtype=d.dtype, device=d.device)
    d = torch.where(mask[:, None, :], d, big)
    d_sorted = torch.sort(d, dim=-1).values
    cnt = mask.sum(-1)  # [B]
    mid_hi = cnt // 2
    mid_lo = torch.clamp((cnt - 1) // 2, min=0)
    rows = d_sorted.shape[1]

    def take(idx):
        return torch.gather(d_sorted, -1, idx[:, None, None].expand(-1, rows, 1))[..., 0]

    med = 0.5 * (take(mid_lo) + take(mid_hi))  # [B, T]
    med = torch.where(mask, med, big)
    return torch.argmin(med, dim=-1)


def _sparsify_by_grid(h, w, uvs, scores, radius):
    """Grid NMS: keep the highest-score point per radius-sized cell
    (recmap.py:670-696)."""
    nw = int(np.ceil(w / radius))
    best: Dict[int, int] = {}
    best_score: Dict[int, float] = {}
    for i, p in enumerate(uvs):
        iw = int(p[0] // radius)
        ih = int(p[1] // radius)
        idx = ih * nw + iw
        if idx not in best or scores[i] > best_score[idx]:
            best[idx] = i
            best_score[idx] = scores[i]
    return np.array(sorted(best.values()))
