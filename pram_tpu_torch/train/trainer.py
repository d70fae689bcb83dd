"""Recognition trainer (pram_tpu/train/trainer.py) on one card.

- AdamW with the manual exponential LR decay and its floor:
  ``lr(it) = clip(lr * decay_rate^(it - decay_iter), min_lr, lr)``, set
  before each step from the iteration count, weight decay on every
  parameter (as optax's ``adamw`` applies it);
- the background-weighted segmentation CE (``train/losses.py``);
- a checkpoint per epoch with ``{epoch, iteration, model, optimizer,
  min_loss}`` and a copy of the best epoch, written with ``torch.save``;
  an epoch whose mean loss is not finite is logged and not checkpointed.

The model's parameters are the f32 masters; a step may run the forward and
backward in another type (``compute_dtype``) through casts of them, so the
gradients land on the masters in f32.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from pram_tpu_torch.train.losses import seg_accuracy, seg_loss_weighted


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference configs/config_train_*_sfd2.yaml)."""

    lr: float = 1e-4
    min_lr: float = 1e-5
    decay_rate: float = 0.999992
    decay_iter: int = 300000
    weight_decay: float = 0.01
    epochs: int = 200
    its_per_epoch: int = 1000
    batch_size: int = 32
    weight_background: float = 0.1
    seed: int = 0


@dataclass
class TrainState:
    """What a step carries and a checkpoint keeps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    iteration: int = 0
    epoch: int = 0
    min_loss: float = math.inf


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """clip(lr * decay_rate^(it - decay_iter), min_lr, lr)."""

    def fn(it: int) -> float:
        lr = cfg.lr * cfg.decay_rate ** (float(it) - cfg.decay_iter)
        return min(max(lr, cfg.min_lr), cfg.lr)

    return fn


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """AdamW (optax's defaults: betas 0.9 / 0.999, eps 1e-8) with weight
    decay on every parameter; each step sets its LR from the schedule."""
    return torch.optim.AdamW(
        params, lr=lr_schedule(cfg)(0), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )


def init_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A fresh state around ``model``'s f32 parameters."""
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))


def cast_forward(model: nn.Module, compute_dtype, *args):
    """``model(*args)`` with every f32 parameter cast to ``compute_dtype``
    (None: as they are). The casts are differentiable, so gradients reach
    the f32 masters."""
    if compute_dtype is None:
        return model(*args)
    params = {
        k: (p.to(compute_dtype) if p.dtype == torch.float32 else p)
        for k, p in model.named_parameters()
    }
    return functional_call(model, params, args)


def apply_gradients(state: TrainState, cfg: TrainConfig, loss: torch.Tensor, mark=None) -> float:
    """Back-propagates ``loss`` and takes one AdamW step at the LR of the
    current iteration; returns that LR. ``mark(stage)`` is called after the
    backward and after the optimizer, if given."""
    lr = lr_schedule(cfg)(state.iteration)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mark:
        mark("backward")
    state.optimizer.step()
    if mark:
        mark("optimizer")
    state.iteration += 1
    return lr


def seg_metrics(logits, batch, cfg: TrainConfig):
    """(loss, metrics) of f32 logits: the weighted CE and the accuracy pair."""
    mask = batch.get("mask")
    loss = seg_loss_weighted(logits, batch["gt_seg"], mask, weight_background=cfg.weight_background)
    with torch.no_grad():
        corr, incorr = seg_accuracy(logits, batch["gt_seg"], mask)
    return loss, {"loss": loss.detach(), "acc_corr": corr, "acc_incorr": incorr}


def make_train_step(model: nn.Module, cfg: TrainConfig, compute_dtype: Optional[torch.dtype] = None):
    """``step(state, batch) -> metrics`` over precomputed descriptors.

    Batch dict: ``seg_descriptors [B, N, D]``, ``norm_keypoints [B, N, 2]``,
    ``gt_seg [B, N]``, ``mask [B, N]``. ``compute_dtype``: the forward and
    backward run in this type through casts of the f32 parameters, the
    descriptors and keypoints cast likewise (None: the model's own type);
    the loss and metrics are f32. The metrics ``loss``, ``acc_corr`` and
    ``acc_incorr`` are 0-d tensors (no host sync), ``lr`` the float the
    step used.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        d, nk = batch["seg_descriptors"], batch["norm_keypoints"]
        if compute_dtype is not None:
            d, nk = d.to(compute_dtype), nk.to(compute_dtype)
        out = cast_forward(model, compute_dtype, d, nk, batch.get("mask"))
        loss, metrics = seg_metrics(out["prediction"].float(), batch, cfg)
        metrics["lr"] = apply_gradients(state, cfg, loss)
        return metrics

    return step


class Trainer:
    """Epoch loop with checkpoints, the best copy and the NaN-epoch skip.

    ``step_fn(state, batch) -> metrics`` defaults to :func:`make_train_step`;
    ``make_augmented_train_step`` gives the step with the frozen extractor.
    """

    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        save_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        step_fn: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.save_dir = save_dir
        self.log_fn = log_fn
        self.state = init_train_state(model, cfg)
        self.step_fn = step_fn or make_train_step(model, cfg)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)

    def save_checkpoint(self, tag: Optional[str] = None) -> Optional[str]:
        if self.save_dir is None:
            return None
        s = self.state
        path = os.path.join(self.save_dir, f"{tag or f'epoch_{s.epoch:04d}'}.pt")
        torch.save(
            {
                "epoch": s.epoch, "iteration": s.iteration, "min_loss": s.min_loss,
                "model": s.model.state_dict(), "optimizer": s.optimizer.state_dict(),
            },
            path,
        )
        return path

    def restore_checkpoint(self, path: str) -> None:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        s = self.state
        s.model.load_state_dict(ckpt["model"])
        s.optimizer.load_state_dict(ckpt["optimizer"])
        s.epoch, s.iteration, s.min_loss = ckpt["epoch"], ckpt["iteration"], ckpt["min_loss"]

    def process_epoch(self, batch_iter) -> Dict[str, float]:
        """One epoch over an iterator of batches; returns the mean metrics."""
        agg: Dict[str, list] = {}
        for batch in batch_iter:
            for k, v in self.step_fn(self.state, batch).items():
                agg.setdefault(k, []).append(float(v))
        means = {k: float(np.mean(v)) for k, v in agg.items()}
        self.log_fn(
            "Epoch [{:d}/{:d}] loss {:.4f} acc_corr {:.4f} acc_incorr {:.4f}".format(
                self.state.epoch, self.cfg.epochs, means.get("loss", float("nan")),
                means.get("acc_corr", float("nan")), means.get("acc_incorr", float("nan")),
            )
        )
        return means

    def train(self, epoch_batches: Callable[[int], object]) -> None:
        """The loop from the state's epoch: ``epoch_batches(epoch)`` yields
        an epoch's batches."""
        for epoch in range(self.state.epoch, self.cfg.epochs):
            means = self.process_epoch(epoch_batches(epoch))
            self.state.epoch += 1
            loss = means.get("loss", float("inf"))
            if np.isfinite(loss):
                if loss < self.state.min_loss:
                    self.state.min_loss = loss
                    self.save_checkpoint("best")
                self.save_checkpoint()
            else:
                self.log_fn(f"skip checkpoint at epoch {epoch}: loss={loss}")
