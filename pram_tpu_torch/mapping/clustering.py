"""3D landmark clustering: KMeans on the tensor's device, Birch on the host
(pram_tpu/mapping/clustering.py).

Rebuild of the reference's cluster step (recognition/recmap.py:85-122):
points observed >= min_obs times are clustered on (axis-masked) coordinates
into n_cluster landmarks. ``cluster_mode`` zeroes unused axes (e.g. 'xz'
clusters in the ground plane).

KMeans runs Lloyd's iterations as the JAX package's ``kmeans_jax`` does,
on the device of the tensor it is given (one distance product and one
one-hot product an iteration, in f32 with TF32 off); Birch is the port's
numpy copy of scikit-learn's (``mapping/birch.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from pram_tpu_torch.mapping.birch import Birch


@contextlib.contextmanager
def full_f32():
    """f32 products in full precision on the card, whatever the global TF32
    setting: KMeans and the descriptor choice are held against f32 oracles."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _sq_distances(xyz: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``[N, k]`` squared distances as |x|^2 - 2 x c^T + |c|^2."""
    return (
        torch.sum(xyz**2, -1, keepdim=True)
        - 2.0 * xyz @ centers.T
        + torch.sum(centers**2, -1)[None]
    )


@torch.no_grad()
def kmeans(
    xyz: torch.Tensor,
    k: int,
    num_iters: int = 50,
    *,
    generator: Optional[torch.Generator] = None,
    init_idx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on ``xyz``'s device (``kmeans_jax``'s steps).

    Args:
      xyz: ``[N, D]`` f32 points.
      k: number of clusters.
      generator: CPU generator of the initial centres' ``randperm`` (seed 0
        when None); ``jax.random.choice`` has no torch counterpart.
      init_idx: ``[k]`` indices of the initial centres, overriding the draw.

    Returns:
      (labels ``[N]`` int32, centers ``[k, D]``); empty clusters keep their
      centre, and the labels come from the final centres.
    """
    n = xyz.shape[0]
    if init_idx is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        init_idx = torch.randperm(n, generator=gen)[:k]
    init_idx = torch.tensor(np.asarray(init_idx), dtype=torch.long).to(xyz.device)
    centers = xyz[init_idx]
    classes = torch.arange(k, device=xyz.device)
    with full_f32():
        for _ in range(num_iters):
            lab = torch.argmin(_sq_distances(xyz, centers), dim=-1)
            onehot = (lab[:, None] == classes[None]).to(xyz.dtype)  # [N, k]
            counts = onehot.sum(0)
            new = (onehot.T @ xyz) / torch.clamp(counts[:, None], min=1.0)
            centers = torch.where(counts[:, None] > 0, new, centers)
        labels = torch.argmin(_sq_distances(xyz, centers), dim=-1).to(torch.int32)
    return labels, centers


def cluster_points(
    xyz: np.ndarray,
    k: int,
    mode: str = "xyz",
    method: str = "birch",
    birch_threshold: float = 0.01,
    seed: int = 0,
    *,
    device="cuda",
    init_idx=None,
) -> np.ndarray:
    """Cluster (axis-masked) 3D points into k landmarks
    (recognition/recmap.py:85-122). KMeans runs on ``device``, its initial
    centres drawn from ``seed`` unless ``init_idx`` gives them.

    Returns integer labels ``[N]``.
    """
    masked = xyz.astype(np.float64).copy()
    if "x" not in mode:
        masked[:, 0] = 0
    if "y" not in mode:
        masked[:, 1] = 0
    if "z" not in mode:
        masked[:, 2] = 0

    if method == "kmeans":
        labels, _ = kmeans(
            torch.from_numpy(masked.astype(np.float32)).to(device), k,
            generator=torch.Generator().manual_seed(seed), init_idx=init_idx,
        )
        return labels.cpu().numpy()
    if method == "birch":
        model = Birch(threshold=birch_threshold, n_clusters=k).fit(masked)
        return np.asarray(model.labels_).reshape(-1)
    raise ValueError(f"unknown clustering method {method}")
