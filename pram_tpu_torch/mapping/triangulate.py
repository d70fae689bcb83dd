"""Map triangulation with known reference poses (hloc-style, pycolmap-free;
numpy copy of pram_tpu/mapping/triangulate.py).

Rebuild of localization/triangulation.py:38-317. The reference delegates the
geometry to pycolmap (COLMAP C++); here the full path is native:

  reference model -> COLMAP db (features, matches)
  -> geometric verification (epipolar errors against reference poses,
     triangulation.py:131-203)
  -> feature tracks via union-find over verified matches
  -> batched multi-view DLT triangulation: each track's A^T A (4x4) is
     accumulated with vectorized outer products and solved by one batched
     symmetric eigendecomposition — thousands of tracks per call instead of
     a per-point C++ loop
  -> cheirality / reprojection / triangulation-angle filtering with COLMAP's
     defaults -> COLMAP binary model.

Features and matches come as arrays: keypoints by image name, ``(index
pairs, scores)`` by image pair, as the JAX package's h5 reads give them
(:func:`triangulate_model`). :func:`run_triangulation` reads them from hloc
h5 files through ``maps/parsers.py``'s getters (the port's own HDF5 reader,
``io/h5.py``).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from pram_tpu_torch.maps.colmap_io import (
    ColmapCamera,
    ColmapImage,
    ColmapPoint3D,
    write_model,
)
from pram_tpu_torch.maps.database import ColmapDatabase
from pram_tpu_torch.maps.packed import _qvec2rotmat_np, pack_camera_params
from pram_tpu_torch.maps.parsers import (
    compute_epipolar_errors,
    get_keypoints,
    get_matches,
    parse_retrieval,
)


def create_db_from_model(
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    db_path: str,
) -> Dict[str, int]:
    """Seed a COLMAP db with the reference cameras/images
    (triangulation.py:38-64)."""
    if os.path.exists(db_path):
        os.remove(db_path)
    with ColmapDatabase.connect(db_path) as db:
        for cid, cam in cameras.items():
            db.add_camera(
                cam.model, cam.width, cam.height, cam.params,
                prior_focal_length=True, camera_id=cid,
            )
        for iid, im in images.items():
            db.add_image(im.name, im.camera_id, image_id=iid)
    return {im.name: iid for iid, im in images.items()}


Keypoints = Dict[str, np.ndarray]  # image name -> [N, 2] pixel coordinates
Matches = Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]  # pair -> ([K, 2] indices, [K] scores)


def _matches_of(matches: Matches, name0: str, name1: str):
    """A pair's ``([K, 2] index pairs, [K] scores)``, stored under either
    order as an hloc match file stores it (``maps/parsers.py:find_pair``):
    columns swapped when found as ``(name1, name0)``."""
    if (name0, name1) in matches:
        return matches[(name0, name1)]
    m, scores = matches[(name1, name0)]
    return np.flip(m, -1), scores


def import_features(image_ids: Dict[str, int], db_path: str, keypoints: Keypoints):
    """Keypoints -> db keypoints (+0.5 COLMAP offset, triangulation.py:67-80)."""
    with ColmapDatabase.connect(db_path) as db:
        for name, iid in image_ids.items():
            db.add_keypoints(iid, keypoints[name] + 0.5)


def import_matches(
    image_ids: Dict[str, int],
    db_path: str,
    pairs: List[Tuple[str, str]],
    matches: Matches,
    min_match_score: Optional[float] = None,
):
    """Matches -> db matches (triangulation.py:83-128)."""
    with ColmapDatabase.connect(db_path) as db:
        added = set()
        for name0, name1 in pairs:
            id0, id1 = image_ids[name0], image_ids[name1]
            if (id0, id1) in added or (id1, id0) in added:
                continue
            m, scores = _matches_of(matches, name0, name1)
            if min_match_score is not None:
                m = m[scores > min_match_score]
            db.add_matches(id0, id1, m)
            added.add((id0, id1))


def _normalized(cam: ColmapCamera, kpts: np.ndarray) -> np.ndarray:
    p = pack_camera_params(cam)
    # undistortion ignored for verification (matches the reference which
    # verifies in COLMAP's calibrated space; distortion on supported
    # datasets is mild)
    return (kpts - p[2:4]) / p[0:2]


def geometric_verification(
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    image_ids: Dict[str, int],
    db_path: str,
    pairs: List[Tuple[str, str]],
    keypoints: Keypoints,
    matches: Matches,
    max_error: float = 4.0,
):
    """Epipolar check of matches against reference poses
    (triangulation.py:131-203): a match survives if both symmetric epipolar
    errors are within ``max_error`` pixels (converted to the normalized-space
    threshold with the mean focal). A pair listed in both orders is verified
    once, in its first order, as ``import_matches`` imports it once (a second
    row of the pair would break the database's unique pair id)."""
    with ColmapDatabase.connect(db_path) as db:
        added = set()
        for name0, name1 in pairs:
            id0, id1 = image_ids[name0], image_ids[name1]
            if (id0, id1) in added or (id1, id0) in added:
                continue
            added.add((id0, id1))
            im0, im1 = images[id0], images[id1]
            cam0, cam1 = cameras[im0.camera_id], cameras[im1.camera_id]
            m, _ = _matches_of(matches, name0, name1)
            if len(m) == 0:
                db.add_two_view_geometry(
                    id0, id1, np.zeros((0, 2), np.uint32)
                )
                continue
            kp0 = keypoints[name0] + 0.5
            kp1 = keypoints[name1] + 0.5
            n0 = _normalized(cam0, kp0[m[:, 0]])
            n1 = _normalized(cam1, kp1[m[:, 1]])

            R0 = _qvec2rotmat_np(im0.qvec)
            R1 = _qvec2rotmat_np(im1.qvec)
            # relative pose 1_from_0
            R = R1 @ R0.T
            t = np.asarray(im1.tvec) - R @ np.asarray(im0.tvec)
            errs0, errs1 = compute_epipolar_errors(R, t, n0, n1)
            p0 = pack_camera_params(cam0)
            p1 = pack_camera_params(cam1)
            th0 = max_error / ((p0[0] + p0[1]) / 2)
            th1 = max_error / ((p1[0] + p1[1]) / 2)
            valid = (errs0 <= th0) & (errs1 <= th1)
            db.add_two_view_geometry(id0, id1, m[valid])


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        while p != x:
            self.parent[x] = self.parent.setdefault(p, p)
            x = self.parent[x]
            p = self.parent.setdefault(x, x)
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def triangulate_tracks(
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    keypoints: Dict[int, np.ndarray],  # image_id -> [N, 2] (+0.5 applied)
    verified: Dict[Tuple[int, int], np.ndarray],  # pair -> [K, 2] idx
    max_reproj_error: float = 4.0,
    min_tri_angle_deg: float = 1.5,
    min_track_len: int = 2,
):
    """Tracks via union-find + batched DLT + COLMAP-style filtering."""
    uf = _UnionFind()
    for (i0, i1), m in verified.items():
        for a, b in m:
            uf.union((i0, int(a)), (i1, int(b)))

    groups: Dict = defaultdict(list)
    for node in list(uf.parent):
        groups[uf.find(node)].append(node)
    tracks = [
        sorted(g) for g in groups.values() if len(g) >= min_track_len
    ]
    # drop tracks observing one image twice (inconsistent)
    tracks = [
        t for t in tracks if len({iid for iid, _ in t}) == len(t)
    ]
    if not tracks:
        return {}, {}

    # per-image projection matrices and normalized rays
    P_mats, norm_kpts = {}, {}
    centers, Rmats = {}, {}
    for iid, im in images.items():
        cam = cameras[im.camera_id]
        R = _qvec2rotmat_np(im.qvec)
        t = np.asarray(im.tvec, float)
        P = np.hstack([R, t[:, None]])  # normalized projection [3, 4]
        P_mats[iid] = P
        Rmats[iid] = R
        centers[iid] = -R.T @ t
        norm_kpts[iid] = _normalized(cam, keypoints[iid])

    # accumulate A^T A per track: each observation contributes two rows
    #   (x * P[2] - P[0]), (y * P[2] - P[1])
    n_tracks = len(tracks)
    AtA = np.zeros((n_tracks, 4, 4))
    for ti, track in enumerate(tracks):
        for iid, k in track:
            P = P_mats[iid]
            x, y = norm_kpts[iid][k]
            r1 = x * P[2] - P[0]
            r2 = y * P[2] - P[1]
            AtA[ti] += np.outer(r1, r1) + np.outer(r2, r2)

    # batched smallest-eigenvector solve
    _, vecs = np.linalg.eigh(AtA)
    X = vecs[:, :, 0]
    w = X[:, 3:]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    xyz = X[:, :3] / w  # [T, 3]

    # filtering: cheirality + reprojection + triangulation angle
    points3D: Dict[int, ColmapPoint3D] = {}
    img_obs: Dict[int, Dict[int, int]] = defaultdict(dict)
    pid = 1
    for ti, track in enumerate(tracks):
        ok_obs = []
        errs = []
        for iid, k in track:
            P = P_mats[iid]
            xh = P @ np.append(xyz[ti], 1.0)
            if xh[2] <= 0:
                continue
            proj = xh[:2] / xh[2]
            cam = cameras[images[iid].camera_id]
            p = pack_camera_params(cam)
            err = np.linalg.norm(
                (proj - norm_kpts[iid][k]) * p[0:2]
            )
            if err <= max_reproj_error:
                ok_obs.append((iid, k))
                errs.append(err)
        if len(ok_obs) < min_track_len:
            continue
        # max pairwise triangulation angle
        rays = [
            (xyz[ti] - centers[iid])
            / max(np.linalg.norm(xyz[ti] - centers[iid]), 1e-12)
            for iid, _ in ok_obs
        ]
        max_ang = 0.0
        for i in range(len(rays)):
            for j in range(i + 1, len(rays)):
                c = np.clip(np.dot(rays[i], rays[j]), -1, 1)
                max_ang = max(max_ang, np.degrees(np.arccos(c)))
        if max_ang < min_tri_angle_deg:
            continue
        points3D[pid] = ColmapPoint3D(
            pid,
            xyz[ti],
            np.array([128, 128, 128], np.uint8),
            float(np.mean(errs)),
            np.array([iid for iid, _ in ok_obs], np.int32),
            np.array([k for _, k in ok_obs], np.int64),
        )
        for iid, k in ok_obs:
            img_obs[iid][k] = pid
        pid += 1
    return points3D, img_obs


def run_triangulation(
    reference_model_path: str,
    features_path: str,
    pairs_path: str,
    matches_path: str,
    output_path: str,
    max_error: float = 4.0,
    min_match_score: Optional[float] = None,
) -> Dict:
    """Full pipeline (triangulation.py:205-317) over hloc h5 features and
    matches: :func:`triangulate_model` on the reference model, the
    retrieval pairs and the h5 files' keypoints and matches."""
    from pram_tpu_torch.maps.colmap_io import read_model

    cameras, images, _ = read_model(reference_model_path, ".bin")
    retr = parse_retrieval(pairs_path)
    pairs = [(q, r) for q, rs in retr.items() for r in rs]
    keypoints = {im.name: get_keypoints(features_path, im.name) for im in images.values()}
    matches = {(a, b): get_matches(matches_path, a, b) for a, b in pairs}
    return triangulate_model(
        cameras, images, keypoints, pairs, matches, output_path,
        max_error=max_error, min_match_score=min_match_score,
    )


def triangulate_model(
    cameras: Dict[int, ColmapCamera],
    images: Dict[int, ColmapImage],
    keypoints: Keypoints,
    pairs: List[Tuple[str, str]],
    matches: Matches,
    output_path: str,
    max_error: float = 4.0,
    min_match_score: Optional[float] = None,
) -> Dict:
    """db -> verification -> tracks -> triangulated COLMAP model, written
    with its ``database.db`` to ``output_path``.

    Args:
      keypoints: image name -> ``[N, 2]`` keypoints (pixel coordinates
        without COLMAP's +0.5) of every image of ``images``.
      pairs: ``(name0, name1)`` pairs in retrieval order.
      matches: ``(name0, name1)`` (or ``(name1, name0)``) -> ``([K, 2]
        index pairs, [K] scores)``.
    """
    os.makedirs(output_path, exist_ok=True)
    db_path = os.path.join(output_path, "database.db")
    image_ids = create_db_from_model(cameras, images, db_path)
    import_features(image_ids, db_path, keypoints)
    import_matches(image_ids, db_path, pairs, matches, min_match_score)
    geometric_verification(
        cameras, images, image_ids, db_path, pairs, keypoints, matches,
        max_error,
    )

    kpts = {iid: keypoints[im.name] + 0.5 for iid, im in images.items()}
    verified = {}
    with ColmapDatabase.connect(db_path) as db:
        for name0, name1 in pairs:
            id0, id1 = image_ids[name0], image_ids[name1]
            m = db.get_two_view_matches(id0, id1)
            if len(m):
                verified[(id0, id1)] = m

    points3D, img_obs = triangulate_tracks(
        cameras, images, kpts, verified, max_reproj_error=max_error
    )

    new_images = {}
    for iid, im in images.items():
        kp = kpts[iid]
        p3d_ids = np.full(len(kp), -1, np.int64)
        for k, pid in img_obs.get(iid, {}).items():
            p3d_ids[k] = pid
        new_images[iid] = ColmapImage(
            iid, im.qvec, np.asarray(im.tvec), im.camera_id, im.name, kp,
            p3d_ids,
        )
    write_model(cameras, new_images, points3D, output_path, ".bin")
    return {
        "num_points": len(points3D),
        "mean_track_length": (
            float(
                np.mean([len(p.image_ids) for p in points3D.values()])
            )
            if points3D
            else 0.0
        ),
    }
