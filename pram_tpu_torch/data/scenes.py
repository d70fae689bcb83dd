"""Per-dataset image-listing conventions + scene composition
(pram_tpu/data/scenes.py).

Rebuild of the reference's per-dataset BasicDataset subclasses and
compose_datasets (dataset/{seven_scenes,twelve_scenes,cambridge_landmarks,
aachen,customdataset}.py, dataset/get_dataset.py:31-89):

- 7Scenes: Train/TestSplit.txt name seq-NN directories of .png frames
- 12Scenes: data/ directory with frame-NNNNNN.color.jpg, split.txt gives the
  test frame-id range (first sequence for testing)
- CambridgeLandmarks: dataset_train.txt/dataset_test.txt (skip 3 header lines)
- Aachen: aachen_db_imglist.txt (train), day+night query lists w/ intrinsics
- Custom: any image list file

All return SceneSpec + SceneDataset; compose_scenes applies the YAML scene
configs (read by core/config.py's YAML reader) and the single-letter dataset
shorthands (S/T/A/C/R). Scenes are composed for evaluation unless
``train=True`` (the JAX function trains by default).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional

from pram_tpu_torch.core.config import load_yaml
from pram_tpu_torch.data.multiscene import MultiSceneDataset
from pram_tpu_torch.data.scene import SceneDataset, SceneSpec

DATASET_SHORTHAND = {
    "S": "7Scenes",
    "T": "12Scenes",
    "A": "Aachen",
    "R": "RobotCar-Seasons",
    "C": "CambridgeLandmarks",
}


def _filter_names(names, keep, sample_ratio):
    out = []
    nf = 0
    for n in names:
        if keep is not None and n not in keep:
            continue
        if nf % max(int(sample_ratio), 1) == 0:
            out.append(n)
        nf += 1
    return out


def list_seven_scenes(dataset_path: str, train: bool) -> List[str]:
    """seq-NN dirs from Train/TestSplit.txt (dataset/seven_scenes.py:69-89)."""
    split_fn = osp.join(
        dataset_path, "TrainSplit.txt" if train else "TestSplit.txt"
    )
    names = []
    with open(split_fn) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            seq = int(line[8:])  # 'sequenceN'
            d = f"seq-{seq:02d}"
            for fn in sorted(os.listdir(osp.join(dataset_path, d))):
                if "png" in fn:
                    names.append(f"{d}/{fn}")
    return names


def list_twelve_scenes(dataset_path: str, train: bool) -> List[str]:
    """data/frame-*.color.jpg split by split.txt's test range
    (dataset/twelve_scenes.py:68-95)."""
    with open(osp.join(dataset_path, "split.txt")) as f:
        parts = f.readline().strip().split(" ")
        test_end = int(parts[-1].split("=")[-1][:-1])
    names = []
    for fn in sorted(os.listdir(osp.join(dataset_path, "data"))):
        if "jpg" not in fn:
            continue
        frame_id = int(fn.split(".")[0].split("-")[-1])
        if train and frame_id <= test_end:
            continue
        if not train and frame_id > test_end:
            continue
        names.append(f"data/{fn}")
    return names


def list_cambridge(dataset_path: str, train: bool) -> List[str]:
    """dataset_train/test.txt with 3 header lines
    (dataset/cambridge_landmarks.py:66-75)."""
    fn = osp.join(
        dataset_path, "dataset_train.txt" if train else "dataset_test.txt"
    )
    with open(fn) as f:
        return [l.strip().split()[0] for l in f.readlines()[3:] if l.strip()]


def list_aachen(dataset_path: str, train: bool) -> List[str]:
    """db list for train; day+night query lists for eval
    (dataset/aachen.py:67-90)."""
    names = []
    if train:
        with open(osp.join(dataset_path, "aachen_db_imglist.txt")) as f:
            names = [l.strip() for l in f if l.strip()]
    else:
        for q in (
            "day_time_queries_with_intrinsics.txt",
            "night_time_queries_with_intrinsics.txt",
        ):
            with open(osp.join(dataset_path, "queries", q)) as f:
                names += [l.strip().split()[0] for l in f if l.strip()]
    return names


def list_custom(dataset_path: str, train: bool, list_file: str) -> List[str]:
    with open(osp.join(dataset_path, list_file)) as f:
        return [l.strip() for l in f if l.strip()]


_LISTERS = {
    "7Scenes": list_seven_scenes,
    "12Scenes": list_twelve_scenes,
    "CambridgeLandmarks": list_cambridge,
    "Aachen": list_aachen,
}


def make_scene_dataset(
    dataset_name: str,
    scene: str,
    landmark_path: str,
    dataset_path: str,
    scene_config: Dict,
    *,
    train: bool = False,
    nfeatures: int = 1024,
    min_inliers: int = 0,
    max_inliers: int = 4096,
    sample_ratio: Optional[float] = None,
) -> SceneDataset:
    """Assemble one scene's SceneDataset from the reference's path layout."""
    scene_landmark = osp.join(landmark_path, scene)
    scene_data = osp.join(dataset_path, scene)
    n_cluster = scene_config["n_cluster"]
    mode = scene_config["cluster_mode"]
    method = scene_config["cluster_method"]

    lister = _LISTERS.get(dataset_name)
    if lister is None:
        names = list_custom(
            scene_data, train, scene_config.get("image_list", "imglist.txt")
        )
    else:
        names = lister(scene_data, train)
    if sample_ratio is None:
        sample_ratio = (
            scene_config.get("training_sample_ratio", 1)
            if train
            else scene_config.get("eval_sample_ratio", 1)
        )
    names = _filter_names(names, None, sample_ratio)

    spec = SceneSpec(
        name=f"{dataset_name}/{scene}",
        image_names=names,
        feature_dir=osp.join(scene_landmark, "feats"),
        sfm_model_path=osp.join(scene_landmark, "3D-models"),
        cluster_file=osp.join(
            scene_landmark,
            f"point3D_cluster_n{n_cluster}_{mode}_{method}.npy",
        ),
        query_p3d_file=osp.join(
            scene_landmark,
            f"point3D_query_n{n_cluster}_{mode}_{method}.npy",
        ),
        gt_pose_file=osp.join(
            scene_data, scene_config.get("gt_pose_path", "queries_poses.txt")
        )
        if scene_config.get("gt_pose_path")
        else None,
        n_class=n_cluster + 1,
        image_prefix=scene_config.get("image_path_prefix", ""),
    )
    ds = SceneDataset(
        spec,
        nfeatures=nfeatures,
        train=train,
        min_inliers=min_inliers,
        max_inliers=max_inliers,
        sample_ratio=1,  # already applied to names
    )
    # drop images without sfm registration / query association
    if train and ds.name_to_id:
        ds.img_fns = [n for n in ds.img_fns if n in ds.name_to_id]
    if not train and ds.img_p3d:
        ds.img_fns = [n for n in ds.img_fns if n in ds.img_p3d]
    return ds


def compose_scenes(
    datasets: List[str],
    config: Dict,
    train: bool = False,
    sample_ratio: Optional[float] = None,
) -> MultiSceneDataset:
    """compose_datasets equivalent (dataset/get_dataset.py:31-89)."""
    subs = []
    for name in datasets:
        ds_name = DATASET_SHORTHAND.get(name, name)
        landmark_path = osp.join(config["landmark_path"], ds_name)
        dataset_path = osp.join(config["dataset_path"], ds_name)
        cfg_fn = osp.join(
            config.get("config_path", "configs/datasets"), f"{ds_name}.yaml"
        )
        scene_cfg = load_yaml(cfg_fn)
        for scene in scene_cfg["scenes"]:
            subs.append(
                make_scene_dataset(
                    ds_name,
                    scene,
                    landmark_path,
                    dataset_path,
                    scene_cfg[scene],
                    train=train,
                    nfeatures=config["max_keypoints"]
                    if train
                    else config["eval_max_keypoints"],
                    min_inliers=config.get("min_inliers", 0),
                    max_inliers=config.get("max_inliers", 4096),
                    sample_ratio=sample_ratio,
                )
            )
    return MultiSceneDataset(subs)
