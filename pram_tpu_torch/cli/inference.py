"""Relocalization inference/eval CLI (pram_tpu/cli/inference.py).

Rebuild of inference.py:16-45 + loc_by_rec_eval (localization/
loc_by_rec_eval.py:25-299): load the recognition model and the maps, stream
query frames (pre-extracted ``.npy`` features) through the engine in batches,
and report pose-recall buckets and stage timings.

Usage:
  python -m pram_tpu_torch.cli.inference --config configs/config_train_7scenes_sfd2.yaml \\
      [--rec_weight_path W] [--matcher_weight_path W] [--batch 16] [--device cpu]

Weights are reference torch checkpoints, as for the JAX CLI, or the repo's
flax ``.msgpack`` files (``weights/*.msgpack``), read without flax. It runs on
the CUDA card, in bf16, unless ``--device cpu`` is given (f32, as the JAX CLI).
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

WEIGHT_HELP = (
    "a reference torch checkpoint (converted as the JAX CLI converts it) or a flax "
    ".msgpack file of weights/ (read without flax)"
)


def not_ported(flag: str, what: str):
    raise NotImplementedError(f"{flag} needs {what}, which pram_tpu_torch does not port yet")


def scene_configs(cfg):
    """The multi-scene map's per-scene dicts from the dataset YAMLs."""
    from pram_tpu_torch.core.config import load_dataset_config
    from pram_tpu_torch.data.scenes import DATASET_SHORTHAND

    out = []
    for name in cfg.dataset:
        ds = DATASET_SHORTHAND.get(name, name)
        _, scenes = load_dataset_config(osp.join(cfg.config_path, f"{ds}.yaml"))
        for scene, sc in scenes.items():
            out.append(
                {
                    "landmark_path": osp.join(cfg.landmark_path, ds, scene),
                    "n_cluster": sc.n_cluster,
                    "cluster_mode": sc.cluster_mode,
                    "cluster_method": sc.cluster_method,
                    "scene_name": f"{ds}/{scene}",
                }
            )
    return out


def load_recognizer(network: str, config: Dict, weight_path: Optional[str], device):
    """The recognition model (``segnetvit`` or ``segnet``) on ``device`` in
    ``model_dtype``: from a reference torch checkpoint (converted by the
    network's own converter; the JAX CLI converts any with
    ``convert_segnetvit``, ROADMAP 3), a flax ``.msgpack``, or, without a
    path, the seeded init. The weights must fit ``config`` (``n_class``
    included), as flax requires of the JAX CLI's."""
    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.models import convert
    from pram_tpu_torch.models.registry import build_recognizer
    from pram_tpu_torch.models.segnet import SegNetConfig
    from pram_tpu_torch.models.segnetvit import SegNetViTConfig

    dtype = model_dtype(device)
    segnet = network.lower() == "segnet"
    if weight_path and weight_path.endswith(".msgpack"):
        build_recognizer(network, config)  # raises for an unknown network
        if segnet:
            return convert.load_segnet(weight_path, SegNetConfig(**config), device=device, dtype=dtype)
        return convert.load_segnetvit(weight_path, SegNetViTConfig(**config), device=device, dtype=dtype)
    torch.manual_seed(0)
    model = build_recognizer(network, config)
    if weight_path:
        sd = convert.load_torch_state_dict(weight_path)
        if segnet:
            tree = convert.convert_segnet(sd, n_layers=config["n_layers"])
            state = convert.segnet_state_dict(tree, config["n_layers"])
        else:
            tree = convert.convert_segnetvit(sd, n_layers=config["n_layers"])
            state = convert.segnetvit_state_dict(tree["params"])
        model.load_state_dict(state, strict=True)
    return model.to(device, dtype).eval()


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--rec_weight_path", default=None, help=WEIGHT_HELP)
    ap.add_argument("--matcher_weight_path", default=None, help=WEIGHT_HELP)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the query batch over all devices (not ported: "
                         "ROADMAP queue 1 item 9)")
    ap.add_argument("--shard_map", action="store_true",
                    help="row-shard the map tables over the devices (not ported: "
                         "ROADMAP queue 1 item 9)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh or args.shard_map:
        not_ported("--mesh / --shard_map", "the parallel modules (ROADMAP queue 1 item 9)")

    from pram_tpu_torch.cli.match_features import build_match_fn, model_dtype
    from pram_tpu_torch.core.config import load_config
    from pram_tpu_torch.core.profiling import StageTimer
    from pram_tpu_torch.data.loader import BatchLoader
    from pram_tpu_torch.data.scenes import compose_scenes
    from pram_tpu_torch.engine.evaluator import evaluate_queries
    from pram_tpu_torch.engine.localizer import Localizer
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.loader import load_multi_map

    device = torch.device(args.device)
    cfg = load_config(args.config)

    # ---- multi-scene map
    dtype = model_dtype(device)
    pmap = load_multi_map(scene_configs(cfg), with_compress=cfg.with_compress)
    dmap = to_device(pmap, device, desc_dtype=dtype)

    # ---- models
    rec = load_recognizer(
        cfg.network,
        {
            "descriptor_dim": 256 if cfg.use_mid_feature else cfg.feat_dim,
            "output_dim": cfg.output_dim,
            "n_class": pmap.n_class,
            "n_layers": cfg.layers,
        },
        args.rec_weight_path,
        device,
    )
    match_fn = build_match_fn(cfg.matching_method, args.matcher_weight_path, device)
    localizer = Localizer(dmap, match_fn, cfg.localization)

    # ---- eval data: pre-extracted query features
    dataset = compose_scenes(
        cfg.dataset,
        {
            "landmark_path": cfg.landmark_path,
            "dataset_path": cfg.dataset_path,
            "config_path": cfg.config_path,
            "eval_max_keypoints": cfg.eval_max_keypoints,
        },
    )
    loader = BatchLoader(dataset, batch_size=args.batch, drop_last=False)
    timer = StageTimer(device)

    def batches():
        # the producer thread's host work: numpy only
        for b in loader.epoch():
            yield {
                "camera_params": b.get(
                    "camera_params",
                    np.tile(
                        np.array(
                            [500, 500, 320, 240, 0, 0, 0, 0], np.float32
                        ),
                        (len(b["mask"]), 1),
                    ),
                ),
                "camera_size": np.stack(
                    [b["image_size"][:, 1], b["image_size"][:, 0]], -1
                ),
                "keypoints": b["keypoints"],
                "scores": b["scores"],
                "descriptors": b["descriptors"],
                "norm_keypoints": b["norm_keypoints"],
                "mask": b["mask"],
                "gt_qvec": b.get(
                    "gt_qvec", np.zeros((len(b["mask"]), 4), np.float32)
                ),
                "gt_tvec": b.get(
                    "gt_tvec", np.zeros((len(b["mask"]), 3), np.float32)
                ),
                "names": b.get("file_name"),
            }

    def recognize(b):
        # on the consuming thread: the batch's upload and recognition (the
        # descriptors feed the recognizer and the matcher alike, as in the
        # JAX CLI; the mask goes by name, which SegNet's third argument,
        # the scores, is not: ROADMAP 3)
        with timer.stage("rec"):
            b["seg_logits"] = rec(
                torch.as_tensor(b["descriptors"]).to(device, dtype),
                torch.as_tensor(b["norm_keypoints"]).to(device),
                mask=torch.as_tensor(b["mask"]).to(device),
            )["prediction"].float()
        return b

    report = evaluate_queries(localizer, batches(), prepare=recognize)
    print(report.summary())
    print("stage times:", timer.summary())
    return report


if __name__ == "__main__":
    main()
