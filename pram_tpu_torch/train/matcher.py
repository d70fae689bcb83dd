"""Matcher training step (the step of scripts/train_synthetic_gml.py:127-140).

The GML forward over cast copies of the f32 master parameters
(``train/trainer.py:cast_forward``), the assignment NLL of its plan
(``train/losses.py:matching_nll_loss``) and one Adam step. Adam is optax's
``adam``: betas 0.9 / 0.999, eps 1e-8, no weight decay and a constant LR,
unlike the recognition trainer's AdamW.

On the card the forward and backward run in bf16 (the attention and MLP
kernels 1, 2, 5 and 13-15 take bf16) over f32 masters; the JAX script
trains in f32 on XLA. The plan is f32 either way: the similarity is summed
in f32 and the Sinkhorn runs in f32 (kernel 6 forward, its plain iterations
differentiated backward).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pram_tpu_torch.train.losses import matching_nll_loss
from pram_tpu_torch.train.trainer import cast_forward


def make_adam(params, lr: float) -> torch.optim.Adam:
    """optax's ``adam(lr)``: the same moments, bias corrections and eps
    outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def make_matcher_train_step(model: nn.Module, lr: float, compute_dtype: Optional[torch.dtype] = None):
    """``step(d0, d1, nk0, nk1, m0, m1, gt, mark=None) -> {"loss": 0-d tensor}``.

    Inputs as GML takes them (descriptors ``[B, N, D]`` / ``[B, M, D]``,
    normalized keypoints, validity masks) and ``gt [B, N]``: the frame row
    of each query keypoint's point, M for the dustbin, -1 for a padded row.
    The descriptors are cast to ``compute_dtype`` (None: the model's own
    type), as the parameters are. The loss stays on the device (no host
    sync). ``mark(stage)``, if given, is called after ``forward``,
    ``backward`` and ``optimizer``. The optimizer is ``step.optimizer``.
    """
    opt = make_adam(model.parameters(), lr)

    def step(d0, d1, nk0, nk1, m0, m1, gt, mark=None):
        if compute_dtype is not None:
            d0, d1 = d0.to(compute_dtype), d1.to(compute_dtype)
        out = cast_forward(model, compute_dtype, d0, d1, nk0, nk1, m0, m1)
        loss = matching_nll_loss(out["plan"], gt, m1)
        if mark:
            mark("forward")
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mark:
            mark("backward")
        opt.step()
        if mark:
            mark("optimizer")
        return {"loss": loss.detach()}

    step.optimizer = opt
    return step
