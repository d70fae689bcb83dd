"""Recognition training CLI (pram_tpu/cli/train.py).

Rebuild of train.py:28-170: load the experiment YAML, compose the
multi-scene training dataset, build the recognition model and train it with
``train/trainer.py:Trainer`` on one card, from the descriptors cached with
the features (the in-step extraction path is ``train/augmented.py``).

Usage:
  python -m pram_tpu_torch.cli.train --config configs/config_train_7scenes_sfd2.yaml
      [--save_dir D] [--device cpu]

It runs on the CUDA card, the step in bf16 over f32 masters (the kernels
take bf16), unless ``--device cpu`` is given (f32). Checkpoints go to
``--save_dir`` or ``<save_path>/<timestamp>_<network>_L<layers>_nc<n_class>``
(``epoch_<n>.pt`` each epoch, ``best.pt``); the config's ``resume_path``
restores one. ``--tp``, ``--sp``, ``--pp`` above 1 and ``--packs`` raise,
naming their ROADMAP items; ``--no_mesh`` is accepted (one card is the only
layout).
"""

from __future__ import annotations

import argparse
import os.path as osp
import time

import torch

from pram_tpu_torch.cli.inference import not_ported

# the batch keys the step reads, and their types on the device
_STEP_KEYS = {"seg_descriptors": None, "norm_keypoints": None, "gt_seg": torch.long, "mask": None}


def batches_on(device, batches):
    """The step's arrays of each numpy batch, as tensors on ``device``."""
    for batch in batches:
        yield {k: torch.from_numpy(batch[k]).to(device=device, dtype=dt) for k, dt in _STEP_KEYS.items()
               if k in batch}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--no_mesh", action="store_true", help="single-device (one card is the only layout)")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="model-axis size (not ported: parallel/tp.py, ROADMAP queue 1 item 9)")
    ap.add_argument("--sp", type=int, default=1, metavar="N",
                    help="sequence-axis size (not ported: parallel/tp.py, ROADMAP queue 1 item 9)")
    ap.add_argument("--pp", type=int, default=1, metavar="N",
                    help="pipeline-axis size (not ported: parallel/tp.py, ROADMAP queue 1 item 9)")
    ap.add_argument("--pp_micro", type=int, default=2, metavar="M", help="microbatches per pipeline step (with --pp)")
    ap.add_argument("--packs", default=None, metavar="DIR",
                    help="feature-pack directory (not ported: data/feature_pack.py, data/pack_loader.py, "
                         "ROADMAP queue 1 item 5)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if max(args.tp, args.sp, args.pp) > 1:
        not_ported("--tp / --sp / --pp", "the parallel modules (ROADMAP queue 1 item 9)")
    if args.packs:
        not_ported("--packs", "data/feature_pack.py and data/pack_loader.py (ROADMAP queue 1 item 5)")

    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.core.config import load_config
    from pram_tpu_torch.data.loader import BatchLoader
    from pram_tpu_torch.data.scenes import compose_scenes
    from pram_tpu_torch.models.registry import build_recognizer
    from pram_tpu_torch.train.trainer import Trainer, make_train_step

    device = torch.device(args.device)
    cfg = load_config(args.config)
    tcfg = cfg.train_config()

    dataset = compose_scenes(
        cfg.dataset,
        {
            "landmark_path": cfg.landmark_path,
            "dataset_path": cfg.dataset_path,
            "config_path": cfg.config_path,
            "max_keypoints": cfg.max_keypoints,
            "eval_max_keypoints": cfg.eval_max_keypoints,
            "min_inliers": cfg.min_inliers,
            "max_inliers": cfg.max_inliers,
        },
        train=True,
    )
    n_class = dataset.n_class
    print(f"composed {len(dataset)} samples, {n_class} classes")

    model = build_recognizer(
        cfg.network,
        {
            "descriptor_dim": 256 if cfg.use_mid_feature else cfg.feat_dim,
            "output_dim": cfg.output_dim,
            "n_class": n_class,
            "n_layers": cfg.layers,
        },
    ).to(device)

    loader_kw = dict(batch_size=cfg.batch_size, train=True, its_per_epoch=cfg.its_per_epoch)
    loader = BatchLoader(dataset, num_workers=cfg.workers, **loader_kw)
    # the first batch, made without the workers (an abandoned threaded epoch
    # would leave them blocked)
    example = next(BatchLoader(dataset, **loader_kw).epoch(0))
    if "seg_descriptors" not in example:
        raise SystemExit(
            "training from cached features requires the feature export to "
            "include descriptors (RecMap.export_features_to_directory with "
            "with_descriptors=True); for on-the-fly augmentation see "
            "pram_tpu_torch.train.augmented"
        )

    save_dir = args.save_dir or osp.join(
        cfg.save_path,
        time.strftime("%Y%m%d_%H%M%S") + f"_{cfg.network}_L{cfg.layers}_nc{n_class}",
    )
    compute = model_dtype(device) if device.type == "cuda" else None
    trainer = Trainer(model, tcfg, save_dir=save_dir, step_fn=make_train_step(model, tcfg, compute))
    if cfg.resume_path:
        trainer.restore_checkpoint(cfg.resume_path)
    trainer.train(lambda epoch: batches_on(device, loader.epoch(epoch)))
    return trainer


if __name__ == "__main__":
    main()
