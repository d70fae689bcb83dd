"""Per-scene recognition dataset: cached features -> fixed-shape samples
(numpy copy of pram_tpu/data/scene.py).

Rebuild of the eval half of the reference's BasicDataset
(dataset/basicdataset.py:332-409). A sample keeps an image's top
``nfeatures`` cached keypoints by score, maps them through the query's 3D
point ids to landmark labels, pads to ``nfeatures`` and emits the gt
label/statistics arrays and pose. Fixed shapes by construction (batches
need no further padding).

Feature cache layout matches the reference's exported per-image ``.npy``
files ('/'-to-'+' renaming, recognition/recmap.py:616-666): a dict with
``keypoints [N,2]``, ``scores [N]``, ``descriptors [N,D]``, ``image_size``.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


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
    image_names: List[str]  # relative image names (the eval list)
    feature_dir: str  # per-image .npy feature cache
    cluster_file: Optional[str] = None  # point3D_cluster_*.npy
    query_p3d_file: Optional[str] = None  # point3D_query_*.npy (eval)
    gt_pose_file: Optional[str] = None  # queries_poses.txt (eval)
    n_class: int = 0  # n_cluster + 1 (incl. background 0)


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
    """One scene's eval samples (reference BasicDataset.get_item_test). The
    training items (get_item_train, with its token sampling and image
    augmentation) wait for a training CLI of the port (ROADMAP queue 1)."""

    def __init__(
        self,
        spec: SceneSpec,
        nfeatures: int = 1024,
    ):
        self.spec = spec
        self.nfeatures = nfeatures
        self.n_class = spec.n_class
        self.dataset = spec.name
        self.img_fns = list(spec.image_names)

        # point3D id -> segment label (cluster file, basicdataset.py:83-91)
        self.p3d_seg: Dict[int, int] = {}
        if spec.cluster_file is not None:
            data = np.load(spec.cluster_file, allow_pickle=True)[()]
            self.p3d_seg = {
                int(i): int(l) for i, l in zip(data["id"], data["label"])
            }

        # eval-time keypoint->p3d association (query_p3d file,
        # basicdataset.py:65-67)
        self.img_p3d: Dict[str, np.ndarray] = {}
        if spec.query_p3d_file is not None:
            self.img_p3d = np.load(spec.query_p3d_file, allow_pickle=True)[()]
        self.gt_poses: Dict[str, Dict[str, np.ndarray]] = {}
        if spec.gt_pose_file is not None and osp.exists(spec.gt_pose_file):
            self.gt_poses = read_gt_poses(spec.gt_pose_file)

    def __len__(self) -> int:
        return len(self.img_fns)

    # ------------------------------------------------------------------
    def _load_features(self, img_name: str) -> Dict[str, np.ndarray]:
        fn = osp.join(
            self.spec.feature_dir, img_name.replace("/", "+") + ".npy"
        )
        return np.load(fn, allow_pickle=True)[()]

    def _labels_for(self, p3d_ids: np.ndarray) -> np.ndarray:
        """Per-keypoint point3D ids -> seg labels (+1, 0=bg)."""
        seg = np.zeros((len(p3d_ids),), np.int64)
        for i, pid in enumerate(p3d_ids):
            lab = self.p3d_seg.get(int(pid))
            if lab is not None and lab >= 0:
                seg[i] = lab + 1  # class 0 = background/invalid
        return seg

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
        seg_ids = self._labels_for(p3d_ids)

        if self.nfeatures > 0:
            order = np.argsort(scores)[::-1][: self.nfeatures]
            descs, kpts = descs[order], kpts[order]
            scores, seg_ids = scores[order], seg_ids[order]

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
        return self.get_test_item(idx)
