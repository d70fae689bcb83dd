"""Load reference-format landmark directories into PackedMaps
(pram_tpu/maps/loader.py).

Mirrors SingleMap3D's artifact layout (localization/singlemap3d.py:30-66):

  <landmark_path>/model/{cameras,images,points3D}.bin         (full model)
  <landmark_path>/compress_model_<method>/...                 (compressed)
  <landmark_path>/point3D_desc.npy                            (pid -> desc)
  <landmark_path>/point3D_cluster_n<K>_<mode>_<method>.npy    ({'id','label'})
  <landmark_path>/point3D_vrf_n<K>_<mode>_<method>.npy        (sid -> vrfs)

and MultiMap3D's multi-scene composition with global segment offsets
(localization/multimap3d.py:58-93).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from pram_tpu_torch.maps.colmap_io import read_compressed_model, read_model
from pram_tpu_torch.maps.packed import PackedMap, build_scene_map, concat_maps


def load_scene_map(
    landmark_path: str,
    *,
    n_cluster: int,
    cluster_mode: str = "xz",
    cluster_method: str = "birch",
    with_compress: bool = True,
    start_sid: int = 0,
    covisibility_frame: int = 20,
    scene_name: str = "scene",
    max_kp_per_frame: Optional[int] = None,
    max_ref_points: Optional[int] = None,
) -> PackedMap:
    """Load one scene's landmark artifacts into a PackedMap."""
    if with_compress:
        model_dir = osp.join(landmark_path, f"compress_model_{cluster_method}")
        cameras, images, points3D = read_compressed_model(model_dir, ".bin")
        desc_path = osp.join(model_dir, "point3D_desc.npy")
    else:
        model_dir = osp.join(landmark_path, "model")
        cameras, images, points3D = read_model(model_dir, ".bin")
        desc_path = osp.join(landmark_path, "point3D_desc.npy")
    p3d_desc = np.load(desc_path, allow_pickle=True)[()]

    seg_data = np.load(
        osp.join(
            landmark_path,
            f"point3D_cluster_n{n_cluster}_{cluster_mode}_{cluster_method}.npy",
        ),
        allow_pickle=True,
    )[()]
    p3d_seg = {
        int(i): int(l) for i, l in zip(seg_data["id"], seg_data["label"])
    }
    seg_vrf = np.load(
        osp.join(
            landmark_path,
            f"point3D_vrf_n{n_cluster}_{cluster_mode}_{cluster_method}.npy",
        ),
        allow_pickle=True,
    )[()]

    return build_scene_map(
        cameras,
        images,
        points3D,
        p3d_desc,
        p3d_seg,
        seg_vrf,
        start_sid=start_sid,
        n_cluster=n_cluster,
        covisibility_frame=covisibility_frame,
        scene_name=scene_name,
        max_kp_per_frame=max_kp_per_frame,
        max_ref_points=max_ref_points,
    )


def load_multi_map(
    scene_configs: List[Dict],
    *,
    with_compress: bool = True,
    covisibility_frame: int = 20,
) -> PackedMap:
    """Load and concatenate multiple scenes with global segment offsets.

    Args:
      scene_configs: list of dicts with keys landmark_path, n_cluster,
        cluster_mode, cluster_method, scene_name.
    """
    maps = []
    start_sid = 0
    for cfg in scene_configs:
        m = load_scene_map(
            cfg["landmark_path"],
            n_cluster=cfg["n_cluster"],
            cluster_mode=cfg.get("cluster_mode", "xz"),
            cluster_method=cfg.get("cluster_method", "birch"),
            with_compress=with_compress,
            start_sid=start_sid,
            covisibility_frame=covisibility_frame,
            scene_name=cfg.get("scene_name", cfg["landmark_path"]),
        )
        maps.append(m)
        start_sid += cfg["n_cluster"]
    return concat_maps(maps)
