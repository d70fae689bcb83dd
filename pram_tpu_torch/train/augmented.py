"""Augmented training step: the frozen extractor inside the step
(pram_tpu/train/augmented.py).

Each step re-extracts the recognition tokens' descriptors: photometric
jitter of the images, the frozen SFD2 forward (no gradient, in the
extractor's own type), bilinear sampling of its stride-4 ``mid_features``
at the batch's keypoints, then the recognition forward, the loss and the
AdamW step on the recognizer alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pram_tpu_torch.models.sfd2 import preprocess_image
from pram_tpu_torch.ops.sampling import sample_descriptors
from pram_tpu_torch.train.trainer import (
    TrainConfig,
    TrainState,
    apply_gradients,
    cast_forward,
    seg_metrics,
)


def photometric_jitter(
    images: torch.Tensor,
    brightness: float = 0.5,
    contrast: float = 0.5,
    generator: Optional[torch.Generator] = None,
    delta_b: Optional[torch.Tensor] = None,
    factor_c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-image ``clip(img * factor_c + delta_b, 0, 1)`` of ``images [B, H,
    W, 3]``: delta_b uniform in [-brightness, brightness], factor_c in
    1 + [-contrast, contrast], drawn from ``generator`` unless given
    (``[B, 1, 1, 1]`` each)."""
    b = images.shape[0]
    shape = (b, 1, 1, 1)
    if delta_b is None:
        u = torch.rand(shape, generator=generator, device=images.device)
        delta_b = (2.0 * u - 1.0) * brightness
    if factor_c is None:
        u = torch.rand(shape, generator=generator, device=images.device)
        factor_c = 1.0 + (2.0 * u - 1.0) * contrast
    return torch.clamp(images * factor_c + delta_b, 0.0, 1.0)


def make_augmented_train_step(
    rec_model: nn.Module,
    extractor_model: nn.Module,
    cfg: TrainConfig,
    jitter_brightness: float = 0.5,
    jitter_contrast: float = 0.5,
    compute_dtype: Optional[torch.dtype] = None,
):
    """``step(state, batch) -> metrics`` over raw images and keypoints.

    Batch dict: ``image [B, H, W, 3]`` in [0, 1] (H, W divisible by 8),
    ``keypoints [B, N, 2]`` (image pixels), ``norm_keypoints [B, N, 2]``,
    ``gt_seg [B, N]``, ``mask [B, N]``. The descriptors are the
    extractor's ``mid_features`` sampled at stride 4, unnormalized (the
    reference configs' ``use_mid_feature: true``, ``norm_desc: false``).
    ``compute_dtype``: the recognizer's forward and backward run in this
    type through casts of its f32 parameters; the loss and metrics are f32.
    The jitter is drawn from a generator on the extractor's device seeded
    from ``cfg.seed``. ``mark(stage)``, if given, is called after each stage of
    a step: ``extract``, ``forward``, ``backward``, ``optimizer``.
    """
    # the extractor's first convolution weight: the type and device its
    # input must have
    conv = next(p for p in extractor_model.parameters() if p.dim() >= 2 and p.is_floating_point())
    gen = torch.Generator(conv.device).manual_seed(cfg.seed)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], mark=None):
        images = photometric_jitter(batch["image"], jitter_brightness, jitter_contrast, gen)
        with torch.no_grad():
            out = extractor_model(preprocess_image(images).to(conv.dtype).contiguous())
        descs = sample_descriptors(batch["keypoints"], out["mid_features"].permute(0, 3, 1, 2), 4,
                                   normalize=False)
        if mark:
            mark("extract")
        nk = batch["norm_keypoints"]
        if compute_dtype is not None:
            descs, nk = descs.to(compute_dtype), nk.to(compute_dtype)
        out = cast_forward(rec_model, compute_dtype, descs, nk, batch.get("mask"))
        loss, metrics = seg_metrics(out["prediction"].float(), batch, cfg)
        if mark:
            mark("forward")
        metrics["lr"] = apply_gradients(state, cfg, loss, mark)
        return metrics

    return step
