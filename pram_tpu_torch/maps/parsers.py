"""Query/retrieval list parsers + h5 feature/match store helpers
(pram_tpu/maps/parsers.py).

hloc-compatible query-with-intrinsics lists, retrieval pair files, pair
naming, the epipolar helpers and the h5 keypoint and match getters, which
read hloc's files through the port's own HDF5 reader (``io/h5.py``).
"""

from __future__ import annotations

import glob
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from pram_tpu_torch.io import h5


def parse_image_list_with_intrinsics(path: str) -> List[Tuple[str, tuple]]:
    """``name MODEL W H params...`` lines (colmap_utils/parsers.py:9-27)."""
    files = sorted(glob.glob(path))
    assert files, f"no files match {path}"
    results = []
    for lfile in files:
        with open(lfile) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(" ")
                name, model, width, height = parts[:4]
                params = np.array(parts[4:], float)
                results.append((name, (model, int(width), int(height), params)))
    assert results
    return results


def parse_retrieval(path: str) -> Dict[str, List[str]]:
    """``query db`` pair lines (colmap_utils/parsers.py:59-65)."""
    retrieval = defaultdict(list)
    with open(path) as f:
        for line in f.read().rstrip("\n").split("\n"):
            if not line:
                continue
            q, r = line.split(" ")
            retrieval[q].append(r)
    return dict(retrieval)


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    return separator.join(
        (name0.replace("/", "-"), name1.replace("/", "-"))
    )


def names_to_pair_old(name0: str, name1: str) -> str:
    return "_".join((name0.replace("/", "-"), name1.replace("/", "-")))


def list_h5_names(path: str) -> List[str]:
    """All image names stored in an hloc-style h5 file."""
    names = []
    with h5.File(path, "r") as f:

        def visit(_, obj):
            if isinstance(obj, h5.Dataset):
                names.append(obj.parent.name.strip("/"))

        f.visititems(visit)
    return sorted(set(names))


def get_keypoints(path: str, name: str) -> np.ndarray:
    with h5.File(path, "r") as f:
        return f[name]["keypoints"][()]


def find_pair(hfile, name0: str, name1: str) -> Tuple[str, bool]:
    for pair, rev in (
        (names_to_pair(name0, name1), False),
        (names_to_pair(name1, name0), True),
        (names_to_pair_old(name0, name1), False),
        (names_to_pair_old(name1, name0), True),
    ):
        if pair in hfile:
            return pair, rev
    raise ValueError(f"pair {(name0, name1)} not found in match file")


def get_matches(path: str, name0: str, name1: str):
    """Return ([K, 2] index pairs, [K] scores) from a match h5."""
    with h5.File(path, "r") as f:
        pair, reverse = find_pair(f, name0, name1)
        matches = f[pair]["matches0"][()]
        scores = f[pair]["matching_scores0"][()]
    idx = np.where(matches != -1)[0]
    out = np.stack([idx, matches[idx]], -1)
    if reverse:
        out = np.flip(out, -1)
    return out, scores[idx]


def to_homogeneous(p: np.ndarray) -> np.ndarray:
    return np.pad(
        p, ((0, 0),) * (p.ndim - 1) + ((0, 1),), constant_values=1
    )


def essential_from_pose(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """E = [t]x R for the relative pose j_from_i (x_j ~ R x_i + t)."""
    tx = np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
    )
    return tx @ R


def compute_epipolar_errors(
    R_j_i: np.ndarray, t_j_i: np.ndarray, p2d_i: np.ndarray, p2d_j: np.ndarray
):
    """Symmetric epipolar distances in normalized coords
    (colmap_utils/geometry.py:10-18, pycolmap-free)."""
    E = essential_from_pose(R_j_i, t_j_i)
    l2d_j = to_homogeneous(p2d_i) @ E.T
    l2d_i = to_homogeneous(p2d_j) @ E
    dist = np.abs(np.sum(to_homogeneous(p2d_i) * l2d_i, axis=1))
    errors_i = dist / np.linalg.norm(l2d_i[:, :2], axis=1)
    errors_j = dist / np.linalg.norm(l2d_j[:, :2], axis=1)
    return errors_i, errors_j
