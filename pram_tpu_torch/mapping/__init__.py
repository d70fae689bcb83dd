"""Offline map construction: clustering, VRFs, compression, feature export
(pram_tpu/mapping/__init__.py)."""

from pram_tpu_torch.mapping.recmap import RecMap
from pram_tpu_torch.mapping.outliers import statistical_outlier_removal
from pram_tpu_torch.mapping.clustering import cluster_points, kmeans

__all__ = [
    "RecMap",
    "statistical_outlier_removal",
    "cluster_points",
    "kmeans",
]
