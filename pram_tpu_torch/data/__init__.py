"""Training/eval data pipeline: scene datasets, multi-scene composition, batching."""

from pram_tpu_torch.data.scene import SceneDataset, SceneSpec, normalize_size
from pram_tpu_torch.data.multiscene import MultiSceneDataset
from pram_tpu_torch.data.loader import BatchLoader, collate

__all__ = [
    "SceneDataset",
    "SceneSpec",
    "normalize_size",
    "MultiSceneDataset",
    "BatchLoader",
    "collate",
]
