"""Statistical outlier removal for 3D point clouds (numpy copy of
pram_tpu/mapping/outliers.py).

Replacement for open3d's remove_statistical_outlier used by the reference
(recognition/recmap.py:43-62): a point is kept if its mean distance to its
k nearest neighbours is within ``mean + std_ratio * std`` of the population.
Backed by scipy's cKDTree (host-side, offline path).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def statistical_outlier_removal(
    xyz: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0
) -> np.ndarray:
    """Return indices of inlier points (open3d semantics).

    Args:
      xyz: ``[N, 3]`` points.
      nb_neighbors: neighbours per point for the mean-distance statistic.
      std_ratio: inlier threshold in standard deviations.
    """
    n = xyz.shape[0]
    if n <= nb_neighbors:
        return np.arange(n)
    tree = cKDTree(xyz)
    # k+1 because the query point itself is its own nearest neighbour
    dists, _ = tree.query(xyz, k=nb_neighbors + 1, workers=-1)
    mean_d = dists[:, 1:].mean(axis=1)
    mu = mean_d.mean()
    sigma = mean_d.std()
    return np.nonzero(mean_d <= mu + std_ratio * sigma)[0]
