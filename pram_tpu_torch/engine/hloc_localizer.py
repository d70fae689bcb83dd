"""Retrieval-driven (hloc-style) localization over a COLMAP model
(pram_tpu/engine/hloc_localizer.py).

Rebuild of localization/localizer.py:28-217 + localization/pose_estimator.py
(find_2D_3D_matches:89, pose_estimator_iterative:380, pose_refinement:273):
for each query, loop over retrieved database candidates, match query
keypoints to db keypoints that have 3D points, solve PnP, early-exit when the
inlier count clears ``inlier_th``, then optionally refine against stacked
matches from covisible frames.

The candidates of a query are matched in one padded batch, and their PnP
problems are solved in one ``ransac_pnp`` call of ``P`` problems (kernels 3
and 4 launch once a query, not once a candidate); the early exit then picks
what the per-candidate loop picks: the first candidate in retrieval order
whose inlier count reaches ``inlier_th``, else the first with the most
inliers. The covisibility refinement is one more batched match and one
RANSAC over the stacked matches. The hypotheses are drawn from a
``torch.Generator`` seeded per query, in place of the JAX package's
``jax.random.fold_in(key, qi)``. Features come from an hloc h5 file through
the port's own HDF5 reader (``io/h5.py``).
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pram_tpu_torch.engine.localizer import normalize_kpts_like_reference
from pram_tpu_torch.geometry.camera import Camera, make_camera
from pram_tpu_torch.geometry.pnp import ransac_pnp
from pram_tpu_torch.geometry.rotations import compute_pose_error, rotmat2qvec
from pram_tpu_torch.io import h5
from pram_tpu_torch.maps.parsers import parse_image_list_with_intrinsics, parse_retrieval

ERROR_THRESHOLDS = ((0.25, 2.0), (0.5, 5.0), (5.0, 10.0))  # localizer.py:80


class H5Features:
    """Reader over an hloc feature h5 (descriptors stored [D, N])."""

    def __init__(self, path: str):
        self.f = h5.File(path, "r")

    def get(self, name: str) -> Dict[str, np.ndarray]:
        g = self.f[name]
        return {
            "keypoints": g["keypoints"][()],
            "scores": g["scores"][()],
            "descriptors": g["descriptors"][()].T,
            "image_size": g["image_size"][()] if "image_size" in g else None,
        }


def point_table(points3D) -> tuple:
    """``(ids, xyz, track_len)`` of a model's points, ids sorted, for
    :func:`db_3d_keypoints`' lookups."""
    ids = np.array(sorted(points3D), np.int64)
    xyz = np.array([points3D[p].xyz for p in ids], np.float32).reshape(-1, 3)
    track = np.array([len(points3D[p].image_ids) for p in ids], np.int64)
    return ids, xyz, track


def db_3d_keypoints(db_image, points3D, features, obs_th: int = 0, table=None):
    """Db keypoints that observe a 3D point with track length > obs_th
    (pose_estimator.py:89-137 semantics); ``table`` is
    :func:`point_table`'s, built once a model."""
    ids, pxyz, track = table if table is not None else point_table(points3D)
    feat = features.get(db_image.name)
    kpts = np.asarray(feat["keypoints"], np.float32)[:, :2]
    descs = np.asarray(feat["descriptors"], np.float32)
    scores = np.asarray(feat["scores"], np.float32).reshape(-1)
    p3d_ids = np.asarray(db_image.point3D_ids, np.int64)
    n = min(len(kpts), len(p3d_ids))
    cand = p3d_ids[:n]
    valid = np.zeros(len(kpts), bool)
    xyz = np.zeros((len(kpts), 3), np.float32)
    pids = np.full(len(kpts), -1, np.int64)
    if len(ids):
        at = np.clip(np.searchsorted(ids, cand), 0, len(ids) - 1)
        ok = (cand >= 0) & (ids[at] == cand) & (track[at] > obs_th)
        hit = np.nonzero(ok)[0]
        valid[hit] = True
        xyz[hit] = pxyz[at[hit]]
        pids[hit] = cand[hit]
    return kpts, descs, scores, valid, xyz, pids


class HlocLocalizer:
    """Per-query candidate-loop localization (pose_estimator_iterative) on
    ``device``."""

    def __init__(
        self,
        db_images: Dict,
        points3D: Dict,
        features: H5Features,
        match_fn,
        ransac_thresh: float = 12.0,
        inlier_th: int = 50,
        obs_th: int = 3,
        covisibility_frame: int = 50,
        do_covisibility_opt: bool = True,
        max_db_kpts: int = 4096,
        num_hypotheses: int = 256,
        device="cuda",
    ):
        self.db_images = db_images
        self.points3D = points3D
        self.features = features
        self.match_fn = match_fn
        self.ransac_thresh = ransac_thresh
        self.inlier_th = inlier_th
        self.obs_th = obs_th
        self.covisibility_frame = covisibility_frame
        self.do_covisibility_opt = do_covisibility_opt
        self.max_db_kpts = max_db_kpts
        self.num_hypotheses = num_hypotheses
        self.device = torch.device(device)
        self.db_name_to_id = {im.name: i for i, im in db_images.items()}
        self._db_cache: Dict[int, tuple] = {}
        self._table = point_table(points3D)

    def _db(self, db_id: int):
        if db_id not in self._db_cache:
            self._db_cache[db_id] = db_3d_keypoints(
                self.db_images[db_id], self.points3D, self.features,
                self.obs_th, self._table,
            )
        return self._db_cache[db_id]

    def _match_and_lift(self, qdata, db_ids: List[int]):
        """Match the query against a batch of db frames -> 2D-3D sets."""
        K = self.max_db_kpts
        b = len(db_ids)
        d = qdata["descriptors"].shape[-1]
        dd = np.zeros((b, K, d), np.float32)
        dk = np.zeros((b, K, 2), np.float32)
        ds = np.zeros((b, K), np.float32)
        dm = np.zeros((b, K), bool)
        dxyz = np.zeros((b, K, 3), np.float32)
        dpid = np.full((b, K), -1, np.int64)
        for i, db_id in enumerate(db_ids):
            kpts, descs, scores, valid, xyz, pids = self._db(db_id)
            idx = np.nonzero(valid)[0][:K]
            n = len(idx)
            dd[i, :n] = descs[idx]
            dk[i, :n] = kpts[idx]
            ds[i, :n] = scores[idx]
            dm[i, :n] = True
            dxyz[i, :n] = xyz[idx]
            dpid[i, :n] = pids[idx]

        nq = qdata["keypoints"].shape[0]
        q_sz = qdata["image_size"]
        qw = float(q_sz[0]) if q_sz is not None else 640.0
        qh = float(q_sz[1]) if q_sz is not None else 480.0
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        nk0 = normalize_kpts_like_reference(
            torch.from_numpy(np.ascontiguousarray(qdata["keypoints"][:, :2], np.float32)), f32(qw), f32(qh)
        )
        # db sizes only affect kpt normalization
        nk1 = normalize_kpts_like_reference(torch.from_numpy(dk), f32([640.0] * b), f32([480.0] * b))
        dev = self.device
        q_desc = torch.from_numpy(np.ascontiguousarray(qdata["descriptors"], np.float32))
        q_scores = torch.from_numpy(np.asarray(qdata["scores"], np.float32).reshape(1, nq))
        with torch.no_grad():
            matches = self.match_fn(
                q_desc.to(dev)[None].expand(b, nq, d).contiguous(),
                nk0.to(dev)[None].expand(b, nq, 2).contiguous(),
                q_scores.to(dev).expand(b, nq).contiguous(),
                torch.ones((b, nq), dtype=torch.bool, device=dev),
                torch.from_numpy(dd).to(dev),
                nk1.to(dev),
                torch.from_numpy(ds).to(dev),
                torch.from_numpy(dm).to(dev),
            )
        return matches.cpu().numpy(), dxyz, dpid  # [b, nq]

    def _camera(self, cam: Camera, p: int) -> Camera:
        return Camera(cam.params[None].expand(p, 8).contiguous(), cam.size[None].expand(p, 2).contiguous())

    def localize(self, qname: str, qinfo, db_ids: List[int], generator: torch.Generator) -> Dict:
        """pose_estimator_iterative for one query (early-exit semantics)."""
        camera_model, width, height, params = qinfo
        cam = make_camera(camera_model, params, width, height, device=self.device)
        qdata = self.features.get(qname)
        kpq = np.asarray(qdata["keypoints"], np.float32)[:, :2]
        nq = len(kpq)

        matches, dxyz, dpid = self._match_and_lift(qdata, db_ids)
        # candidates with 8 matches, in retrieval order, solved in one call
        cands = [o for o in range(len(db_ids)) if (matches[o] >= 0).sum() >= 8]
        best = None
        if cands:
            sel = matches[cands] >= 0
            xyz = np.stack([dxyz[o][np.clip(matches[o], 0, None)] for o in cands])
            dev = self.device
            res = ransac_pnp(
                self._camera(cam, len(cands)),
                torch.from_numpy(np.broadcast_to(kpq + 0.5, (len(cands), nq, 2)).copy()).to(dev),
                torch.from_numpy(xyz).to(dev),
                torch.from_numpy(sel).to(dev),
                generator=generator,
                inlier_threshold=self.ransac_thresh,
                num_hypotheses=self.num_hypotheses,
                min_inliers=8,
            )
            qvecs = rotmat2qvec(res.R).cpu().numpy()
            tvecs, ninls = res.t.cpu().numpy(), res.num_inliers.cpu().numpy()
            inliers, success = res.inliers.cpu().numpy(), res.success.cpu().numpy()
            for j, order in enumerate(cands):
                m = matches[order]
                ninl = int(ninls[j])
                keep = sel[j] & inliers[j]
                rec = {
                    "qvec": qvecs[j],
                    "tvec": tvecs[j],
                    "num_inliers": ninl,
                    "db_id": db_ids[order],
                    "order": order,
                    "inliers": inliers[j],
                    "keypoints_query": kpq[keep],
                    "points3D_ids": dpid[order][np.clip(m, 0, None)][keep],
                    "success": bool(success[j]),
                }
                if best is None or ninl > best["num_inliers"]:
                    best = rec
                rec["n_kpts"] = nq
                if ninl >= self.inlier_th:
                    break

        if best is None or not best["success"]:
            # fall back to retrieved-db pose (pose_estimator.py:188-208)
            db0 = self.db_images[db_ids[0]]
            return {
                "qvec": np.asarray(db0.qvec),
                "tvec": np.asarray(db0.tvec),
                "num_inliers": 0,
                "success": False,
                "db_id": db_ids[0],
                "order": -1,
                "keypoints_query": np.zeros((0, 2)),
                "points3D_ids": np.zeros((0,), np.int64),
            }

        if self.do_covisibility_opt:
            best = self._covisibility_refine(qname, qdata, cam, best, generator)
        return best

    def covisible_frames(self, db_id: int) -> List[int]:
        """The frames sharing the most points with ``db_id``, most first (ties
        in first-seen order over its points), at most ``covisibility_frame``;
        ``db_id`` first if it is not among them."""
        ids_t = self._table[0]
        pids = np.asarray(self.db_images[db_id].point3D_ids, np.int64)
        pids = pids[pids >= 0]
        if len(ids_t):
            at = np.clip(np.searchsorted(ids_t, pids), 0, len(ids_t) - 1)
            pids = pids[ids_t[at] == pids]
        else:
            pids = pids[:0]
        seen = [np.asarray(self.points3D[int(p)].image_ids, np.int64) for p in pids]
        iids = np.concatenate(seen) if seen else np.zeros(0, np.int64)
        uniq, first, counts = np.unique(iids, return_index=True, return_counts=True)
        order = np.lexsort((first, -counts))
        ids = [int(i) for i in uniq[order]][: self.covisibility_frame]
        if db_id not in ids:
            ids = [db_id] + ids
        return ids

    def _covisibility_refine(self, qname, qdata, cam, best, generator):
        """pose_refinement (pose_estimator.py:273-378): stack matches from
        covisible frames and run one large RANSAC."""
        ids = self.covisible_frames(best["db_id"])
        matches, dxyz, dpid = self._match_and_lift(qdata, ids)
        kpq = np.asarray(qdata["keypoints"], np.float32)[:, :2]
        all_uv, all_xyz = [], []
        for i in range(len(ids)):
            m = matches[i]
            sel = m >= 0
            all_uv.append(kpq[sel])
            all_xyz.append(dxyz[i][m[sel]])
        uv = np.concatenate(all_uv) if all_uv else np.zeros((0, 2), np.float32)
        xyz = np.concatenate(all_xyz) if all_xyz else np.zeros((0, 3), np.float32)
        if len(uv) < 8:
            return best
        dev = self.device
        res = ransac_pnp(
            self._camera(cam, 1),
            torch.from_numpy(uv + 0.5)[None].to(dev),
            torch.from_numpy(xyz)[None].to(dev),
            torch.ones((1, len(uv)), dtype=torch.bool, device=dev),
            generator=generator,
            inlier_threshold=self.ransac_thresh,
            num_hypotheses=self.num_hypotheses * 2,
            min_inliers=8,
        )
        ninl = int(res.num_inliers[0])
        if bool(res.success[0]) and ninl >= best["num_inliers"]:
            best = dict(best)
            best["qvec"] = rotmat2qvec(res.R[0]).cpu().numpy()
            best["tvec"] = res.t[0].cpu().numpy()
            best["num_inliers"] = ninl
            best["optimize"] = True
        return best


def run_localizer(
    model_path: str,
    features_path: str,
    retrieval_path: str,
    queries_path: str,
    match_fn,
    output_dir: str,
    gt_poses: Optional[Dict] = None,
    **kwargs,
) -> Dict:
    """Full eval loop (localizer.py:28-217): per-query localization, pose
    file + failure list + success tallies at the Aachen thresholds.
    ``kwargs`` go to :class:`HlocLocalizer` (``device`` among them)."""
    from pram_tpu_torch.maps.colmap_io import read_model

    cameras, db_images, points3D = read_model(model_path, ".bin")
    features = H5Features(features_path)
    retrievals = parse_retrieval(retrieval_path)
    queries = parse_image_list_with_intrinsics(queries_path)

    loc = HlocLocalizer(db_images, points3D, features, match_fn, **kwargs)

    os.makedirs(output_dir, exist_ok=True)
    poses = {}
    failed = []
    tallies = [0] * len(ERROR_THRESHOLDS)
    loc_log = {}
    times = []
    full_log = ""
    n_total = 0
    n_failed = 0
    for qi, (qname, qinfo) in enumerate(queries):
        n_total += 1
        if qname not in retrievals:
            failed.append(qname)
            n_failed += 1
            continue
        db_ids = [
            loc.db_name_to_id[n]
            for n in retrievals[qname]
            if n in loc.db_name_to_id
        ]
        if not db_ids:
            failed.append(qname)
            n_failed += 1
            continue
        t0 = time.time()
        # a CPU generator a query, in place of fold_in(PRNGKey(0), qi): every
        # device draws the same triplets
        out = loc.localize(qname, qinfo, db_ids, torch.Generator().manual_seed(qi))
        loc_time = time.time() - t0
        times.append(loc_time)
        poses[qname] = (out["qvec"], out["tvec"])
        # _loc.npy record schema = the reference's (localizer.py:161-165)
        loc_log[qname] = {
            "keypoints_query": out.get("keypoints_query", np.zeros((0, 2))),
            "points3D_ids": out.get("points3D_ids", np.zeros(0, np.int64)),
        }
        # failure criterion and per-query log line match localizer.py:138-167
        if out["num_inliers"] == 0:
            failed.append(qname)
            n_failed += 1
        print_text = (
            "All {:d}/{:d} failed cases, time[cs/fn]: {:.2f}/{:.2f}".format(
                n_failed, n_total, 0.0, loc_time
            )
        )
        if gt_poses and qname in gt_poses:
            f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            qe, te = compute_pose_error(
                f32(out["qvec"]), f32(out["tvec"]),
                f32(gt_poses[qname]["qvec"]), f32(gt_poses[qname]["tvec"]),
            )
            for i, (t_th, q_th) in enumerate(ERROR_THRESHOLDS):
                if float(te) <= t_th and float(qe) <= q_th:
                    tallies[i] += 1
            print_text += (
                ", q_error:{:.2f} t_error:{:.2f} {:d}/{:d}/{:d}/{:d}, "
                "time: {:.2f}, {:d}pts".format(
                    float(qe), float(te), tallies[0], tallies[1], tallies[2],
                    n_total, loc_time, int(out.get("n_kpts", 0)),
                )
            )
        full_log += out.get("log_info", "") + print_text + "\n"

    # artifact set mirrors the reference writers (localizer.py:169-192):
    # poses (full query name + qvec + tvec), <poses>.failed, _full.log,
    # _loc.npy
    results = osp.join(output_dir, "poses.txt")
    with open(results, "w") as f:
        for qname, (q, t) in poses.items():
            qvec = " ".join(map(str, np.asarray(q)))
            tvec = " ".join(map(str, np.asarray(t)))
            f.write(f"{qname} {qvec} {tvec}\n")
    with open(results + ".failed", "w") as f:
        for v in failed:
            f.write(v + "\n")
    with open(osp.join(output_dir, "poses_full.log"), "w") as f:
        f.write(full_log)
    np.save(osp.join(output_dir, "loc_log.npy"), loc_log)

    n = max(len(queries), 1)
    return {
        "poses": poses,
        "failed": failed,
        "recall": {
            f"{t}m/{q}deg": c / n
            for (t, q), c in zip(ERROR_THRESHOLDS, tallies)
        },
        "mean_time": float(np.mean(times)) if times else 0.0,
    }
