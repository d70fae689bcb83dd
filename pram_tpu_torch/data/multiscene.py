"""Multi-scene composition with global landmark label offsets
(pram_tpu/data/multiscene.py).

Rebuild of RecDataset (dataset/recdataset.py:12-95): scenes are concatenated
into one dataset; each scene's segment labels [1, n_class) are offset into a
shared global label space (class 0 = background is shared); the composed
``n_class = 1 + sum(scene n_cluster)`` — the same convention the packed
multi-scene map uses (maps/packed.py concat_maps), so training labels and
localization routing agree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pram_tpu_torch.data.scene import SceneDataset


class MultiSceneDataset:
    def __init__(self, sub_sets: List[SceneDataset]):
        assert len(sub_sets) >= 1
        self.sub_sets = sub_sets
        self.index: List[tuple] = []  # (subset idx, item idx)
        self.seg_offset: List[int] = []  # per subset
        self.scene_names: List[str] = []

        start = 1  # 0 is background
        for si, s in enumerate(sub_sets):
            self.seg_offset.append(start)
            start += s.n_class - 1
            for k in range(len(s)):
                self.index.append((si, k))
        self.n_class = start

    def __len__(self):
        return len(self.index)

    def _remap(self, out: Dict, si: int) -> Dict:
        """Offset per-scene labels into the global space (recdataset.py:56-90)."""
        off = self.seg_offset[si]
        org_n = self.sub_sets[si].n_class
        seg = np.asarray(out["gt_seg"])
        gt_seg = np.where(seg > 0, seg + off - 1, 0).astype(seg.dtype)

        def expand(org, dtype):
            g = np.zeros((self.n_class,), dtype)
            g[0] = org[0]
            g[off : off + org_n - 1] = org[1:]
            return g

        out["gt_seg"] = gt_seg
        out["gt_cls"] = expand(np.asarray(out["gt_cls"]), np.int64)
        out["gt_n_seg"] = expand(np.asarray(out["gt_n_seg"]), np.int64)
        out["gt_cls_dist"] = expand(
            np.asarray(out["gt_cls_dist"]), np.float32
        )
        out["scene_name"] = self.sub_sets[si].dataset
        return out

    def get_train_item(self, idx: int, rng: np.random.RandomState) -> Dict:
        si, k = self.index[idx]
        return self._remap(self.sub_sets[si].get_train_item(k, rng), si)

    def get_test_item(self, idx: int) -> Dict:
        si, k = self.index[idx]
        return self._remap(self.sub_sets[si].get_test_item(k), si)

    def __getitem__(self, idx):
        si, k = self.index[idx]
        return self._remap(self.sub_sets[si][k], si)
