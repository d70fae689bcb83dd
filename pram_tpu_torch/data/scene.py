"""Per-scene recognition dataset: cached features -> fixed-shape samples
(numpy copy of pram_tpu/data/scene.py).

Rebuild of the reference's BasicDataset (dataset/basicdataset.py:17-477). A
sample maps each image's cached keypoints to 3D points to landmark labels,
subsamples inliers/outliers to *exactly* ``nfeatures`` tokens (padding by
jittered copies of labeled keypoints — dataset/basicdataset.py:243-262), and
emits the gt label/statistics arrays the trainer consumes. Everything is
numpy with an explicit RNG; fixed shapes by construction (TPU batches need no
further padding).

Feature cache layout matches the reference's exported per-image ``.npy``
files ('/'-to-'+' renaming, recognition/recmap.py:616-666): a dict with
``keypoints [N,2]``, ``scores [N]``, ``descriptors [N,D]``, ``image_size``.

Images for the ``with_image`` items are read by ``io/image.py`` (PNG or
``.npy``; the card has no cv2) and resized by its cv2-compatible bilinear
``resize_linear``. A ``SceneDataset`` is built for evaluation unless
``train=True`` (the JAX class trains by default).
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from pram_tpu_torch.io.image import read_image, resize_linear
from pram_tpu_torch.maps.colmap_io import read_model
from pram_tpu_torch.maps.packed import _qvec2rotmat_np, pack_camera_params


def normalize_size(kpts: np.ndarray, size, scale: float = 0.7) -> np.ndarray:
    """Center/scale keypoints by image size (dataset/utils.py:11-14).

    ``size`` is (height, width). NOTE the reference subtracts ``size/2``
    directly from the (x, y) keypoints — i.e. x is centered by h/2 and y by
    w/2 (axes swapped). The pretrained recognition models were trained under
    this convention, so it is reproduced verbatim here.
    """
    size = np.asarray(size, float).reshape(1, 2)
    norm_fac = size.max() + 0.5
    return (kpts - size / 2.0) / (norm_fac * scale)


@dataclass
class SceneSpec:
    """Paths + labels for one scene (what the per-dataset subclasses of
    BasicDataset assemble from landmark_path/dataset_path conventions)."""

    name: str  # e.g. "7Scenes/chess"
    image_names: List[str]  # relative image names (the training/eval list)
    feature_dir: str  # per-image .npy feature cache
    sfm_model_path: Optional[str] = None  # COLMAP model (train only)
    cluster_file: Optional[str] = None  # point3D_cluster_*.npy
    query_p3d_file: Optional[str] = None  # point3D_query_*.npy (eval)
    gt_pose_file: Optional[str] = None  # queries_poses.txt (eval)
    n_class: int = 0  # n_cluster + 1 (incl. background 0)
    image_prefix: str = ""
    image_dir: Optional[str] = None  # raw images (augmented training only)


def read_gt_poses(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """``name qw qx qy qz tx ty tz`` lines (localization/utils.py read_gt_pose)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 8:
                continue
            vals = np.array([float(v) for v in parts[1:8]])
            out[parts[0]] = {"qvec": vals[:4], "tvec": vals[4:7]}
    return out


class SceneDataset:
    """One scene's samples (reference BasicDataset.get_item_train/test)."""

    def __init__(
        self,
        spec: SceneSpec,
        nfeatures: int = 1024,
        train: bool = False,
        min_inliers: int = 0,
        max_inliers: int = 4096,
        sample_ratio: float = 1.0,
        with_image: bool = False,
        scale_params: Optional[tuple] = None,
    ):
        """with_image loads the raw image per train item (the reference's
        with_aug path, basicdataset.py:277-306) for in-step re-extraction
        through the frozen SFD2 (train/augmented.py). scale_params (lo, hi),
        e.g. (0.5, 1.0): with prob 0.25 the image is downscaled (keypoints
        rescaled) then zero-padded back to the fixed original size — the
        static-shape formulation of the reference's resize augmentation.
        Brightness/contrast jitter happens on device inside the train step
        (the reference's cv2.addWeighted path, basicdataset.py:299-302)."""
        self.spec = spec
        self.train = train
        self.with_image = with_image
        self.scale_params = scale_params
        self.nfeatures = nfeatures
        self.min_inliers = min_inliers
        self.max_inliers = min(max_inliers, nfeatures)
        self.n_class = spec.n_class
        self.dataset = spec.name

        self.img_fns = list(spec.image_names)
        if sample_ratio is not None and sample_ratio > 1:
            self.img_fns = self.img_fns[:: int(sample_ratio)]

        # point3D id -> segment label (cluster file, basicdataset.py:83-91)
        self.p3d_seg: Dict[int, int] = {}
        self.p3d_xyz: Dict[int, np.ndarray] = {}
        if spec.cluster_file is not None:
            data = np.load(spec.cluster_file, allow_pickle=True)[()]
            self.p3d_seg = {
                int(i): int(l) for i, l in zip(data["id"], data["label"])
            }

        self.images = None
        self.cameras = None
        self.name_to_id: Dict[str, int] = {}
        if train and spec.sfm_model_path is not None:
            self.cameras, self.images, points3D = read_model(
                spec.sfm_model_path, ".bin"
            )
            self.name_to_id = {
                im.name: i
                for i, im in self.images.items()
                if len(im.point3D_ids) > 0
            }
            for pid in self.p3d_seg:
                if pid in points3D:
                    self.p3d_xyz[pid] = points3D[pid].xyz

        # eval-time keypoint->p3d association (query_p3d file,
        # basicdataset.py:65-67)
        self.img_p3d: Dict[str, np.ndarray] = {}
        if not train and spec.query_p3d_file is not None:
            self.img_p3d = np.load(spec.query_p3d_file, allow_pickle=True)[()]
        self.gt_poses: Dict[str, Dict[str, np.ndarray]] = {}
        if not train and spec.gt_pose_file is not None and osp.exists(
            spec.gt_pose_file
        ):
            self.gt_poses = read_gt_poses(spec.gt_pose_file)

    def __len__(self) -> int:
        return len(self.img_fns)

    # ------------------------------------------------------------------
    def _load_features(self, img_name: str) -> Dict[str, np.ndarray]:
        fn = osp.join(
            self.spec.feature_dir, img_name.replace("/", "+") + ".npy"
        )
        return np.load(fn, allow_pickle=True)[()]

    def _labels_for(self, img_name: str, p3d_ids: np.ndarray) -> tuple:
        """Map per-keypoint point3D ids to (seg labels (+1, 0=bg), xyz)."""
        n = len(p3d_ids)
        seg = np.zeros((n,), np.int64)
        xyz = np.zeros((n, 3), np.float64)
        for i, pid in enumerate(p3d_ids):
            lab = self.p3d_seg.get(int(pid))
            if lab is not None and lab >= 0:
                seg[i] = lab + 1  # class 0 = background/invalid
            p = self.p3d_xyz.get(int(pid))
            if p is not None:
                xyz[i] = p
        return seg, xyz

    def _sample_tokens(self, seg_ids: np.ndarray, rng: np.random.RandomState):
        """Inlier/outlier subsampling to <= nfeatures ids
        (basicdataset.py:197-227)."""
        inlier_ids = np.where(seg_ids > 0)[0]
        outlier_ids = np.where(seg_ids == 0)[0]
        n_in, n_out = len(inlier_ids), len(outlier_ids)

        if n_in <= self.min_inliers:
            sel = np.concatenate(
                [
                    inlier_ids,
                    rng.permutation(outlier_ids)[: self.nfeatures - n_in],
                ]
            )
        else:
            sel_in = rng.randint(self.min_inliers, self.max_inliers)
            sel_in = min(sel_in, n_in)
            if sel_in + n_out < self.nfeatures:
                sel_in = self.nfeatures - n_out
            sel_out = self.nfeatures - sel_in
            sel = np.concatenate(
                [
                    rng.permutation(inlier_ids)[:sel_in],
                    rng.permutation(outlier_ids)[:sel_out],
                ]
            )
        return rng.permutation(sel)

    def _gt_stats(self, sel_seg: np.ndarray, all_seg: np.ndarray):
        """gt_cls / gt_n_seg / gt_cls_dist (basicdataset.py:264-273)."""
        gt_n_seg = np.zeros((self.n_class,), np.int64)
        gt_cls = np.zeros((self.n_class,), np.int64)
        gt_cls_dist = np.zeros((self.n_class,), np.float64)
        n_valid = max(np.sum(all_seg > 0), 1)
        for uid in np.unique(sel_seg):
            if uid == 0:
                continue
            gt_cls[uid] = 1
            gt_n_seg[uid] = np.sum(sel_seg == uid)
            gt_cls_dist[uid] = np.sum(all_seg == uid) / n_valid
        return gt_cls, gt_n_seg, gt_cls_dist

    # ------------------------------------------------------------------
    def get_train_item(self, idx: int, rng: np.random.RandomState) -> Dict:
        img_name = self.img_fns[idx]
        feat = self._load_features(img_name)
        kpts = np.asarray(feat["keypoints"], np.float64)[:, :2]
        scores = np.asarray(feat["scores"], np.float64).reshape(-1)
        image_size = np.asarray(feat["image_size"]).reshape(-1)[:2]
        # cached descriptors enable the no-augmentation training path (the
        # reference always re-extracts in-step, trainer.py:106-130; we
        # support both)
        descs = feat.get("descriptors")

        image_id = self.name_to_id[img_name]
        p3d_ids = self.images[image_id].point3D_ids
        seg_ids, xyzs = self._labels_for(img_name, p3d_ids)

        sel = self._sample_tokens(seg_ids, rng)
        sel_kpts = kpts[sel]
        sel_scores = scores[sel]
        sel_seg = seg_ids[sel]
        sel_xyz = xyzs[sel]
        sel_desc = (
            np.asarray(descs, np.float32)[sel] if descs is not None else None
        )

        # pad to exactly nfeatures with jittered copies of labeled keypoints
        # (basicdataset.py:243-262 / random_points_from_reference:449-477)
        short = self.nfeatures - len(sel)
        if short > 0:
            valid = np.where(sel_seg > 0)[0]
            if len(valid) == 0:
                valid = np.arange(len(sel))
            ref = (
                rng.choice(valid, size=short)
                if len(valid) < short
                else valid[:short]
            )
            jitter = rng.randint(-5, 5, size=(short, 2))
            sel_kpts = np.vstack([sel_kpts, sel_kpts[ref] + jitter])
            sel_scores = np.concatenate([sel_scores, rng.random(short)])
            sel_seg = np.concatenate([sel_seg, sel_seg[ref]])
            sel_xyz = np.vstack([sel_xyz, sel_xyz[ref]])
            if sel_desc is not None:
                sel_desc = np.vstack([sel_desc, sel_desc[ref]])

        gt_cls, gt_n_seg, gt_cls_dist = self._gt_stats(sel_seg, seg_ids)

        img = None
        if self.with_image:
            img = self._read_image(img_name)
            h0, w0 = img.shape[:2]
            if self.scale_params is not None and rng.random() <= 0.25:
                # basicdataset.py:286-297: pick one of 11 scales in
                # [lo, hi], resize, rescale keypoints; here the image is
                # zero-padded back to (h0, w0) so batch shapes stay static
                lo, hi = self.scale_params
                s = lo + (hi - lo) / 10 * rng.randint(0, 11)
                nh, nw = int(h0 * s), int(w0 * s)
                sel_kpts = sel_kpts * [nw / w0, nh / h0]
                small = resize_linear(img, (nw, nh))
                img = np.zeros((h0, w0, 3), np.float32)
                img[:nh, :nw] = small
                image_size = np.array([nh, nw])

        im = self.images[image_id]
        cam = self.cameras[im.camera_id]
        P = np.eye(4)
        P[:3, :3] = _qvec2rotmat_np(im.qvec)
        P[:3, 3] = im.tvec

        out = {
            "scores": sel_scores.astype(np.float32),
            "keypoints": sel_kpts.astype(np.float32),
            "norm_keypoints": normalize_size(sel_kpts, image_size).astype(
                np.float32
            ),
            "gt_seg": sel_seg.astype(np.int32),
            "gt_cls": gt_cls,
            "gt_cls_dist": gt_cls_dist.astype(np.float32),
            "gt_n_seg": gt_n_seg,
            "mask": np.ones((self.nfeatures,), bool),
            "file_name": img_name,
            "image_size": image_size.astype(np.float32),
            "camera_params": pack_camera_params(cam),
            "gt_P": P.astype(np.float32),
        }
        if sel_desc is not None:
            out["seg_descriptors"] = sel_desc
        if img is not None:
            out["image"] = img
        return out

    def _read_image(self, img_name: str) -> np.ndarray:
        """RGB float32 [0, 1] (basicdataset.py:277-282, 418-419)."""
        img = read_image(osp.join(self.spec.image_dir, img_name))
        return img.astype(np.float32) / 255.0

    def get_test_item(self, idx: int) -> Dict:
        """Eval item: top-nfeatures keypoints by score, descriptors included
        (basicdataset.py:332-409)."""
        img_name = self.img_fns[idx]
        feat = self._load_features(img_name)
        descs = np.asarray(feat["descriptors"], np.float32)
        kpts = np.asarray(feat["keypoints"], np.float64)[:, :2]
        scores = np.asarray(feat["scores"], np.float64).reshape(-1)
        image_size = np.asarray(feat["image_size"]).reshape(-1)[:2]

        p3d_ids = self.img_p3d.get(img_name, np.full(len(kpts), -1))
        seg_ids, xyzs = self._labels_for(img_name, p3d_ids)

        if self.nfeatures > 0:
            order = np.argsort(scores)[::-1][: self.nfeatures]
            descs, kpts = descs[order], kpts[order]
            scores, seg_ids, xyzs = scores[order], seg_ids[order], xyzs[order]

        n = len(kpts)
        mask = np.zeros((self.nfeatures,), bool)
        mask[:n] = True

        def pad(a, shape):
            out = np.zeros(shape, a.dtype)
            out[:n] = a
            return out

        gt_cls, gt_n_seg, gt_cls_dist = self._gt_stats(seg_ids, seg_ids)
        gt = self.gt_poses.get(img_name)
        out_pose = (
            {
                "gt_qvec": gt["qvec"].astype(np.float32),
                "gt_tvec": gt["tvec"].astype(np.float32),
            }
            if gt is not None
            else {}
        )
        return {
            **out_pose,
            "descriptors": pad(descs, (self.nfeatures, descs.shape[1])),
            "scores": pad(scores.astype(np.float32), (self.nfeatures,)),
            "keypoints": pad(kpts.astype(np.float32), (self.nfeatures, 2)),
            "norm_keypoints": pad(
                normalize_size(kpts, image_size).astype(np.float32),
                (self.nfeatures, 2),
            ),
            "gt_seg": pad(seg_ids.astype(np.int32), (self.nfeatures,)),
            "gt_cls": gt_cls,
            "gt_cls_dist": gt_cls_dist.astype(np.float32),
            "gt_n_seg": gt_n_seg,
            "mask": mask,
            "file_name": img_name,
            "image_size": image_size.astype(np.float32),
        }

    def __getitem__(self, idx):
        if self.train:
            return self.get_train_item(idx, np.random)
        return self.get_test_item(idx)
