"""Segmentation losses and metrics for recognition training
(pram_tpu/train/losses.py).

The background-weighted segmentation cross-entropy, the correct/incorrect
accuracy pair, the IoU/precision evaluation, the classification and
scene-coordinate losses and the matcher's assignment NLL, all masked for
padded keypoint tokens.

``seg_loss_weighted`` applies ``log_softmax`` twice by default, as the
reference training does (``log_softmax`` and then a cross-entropy that
applies it again). In exact arithmetic the second one is the identity, so
value and gradient equal the textbook loss up to rounding; the flag keeps
the arithmetic of the published runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def seg_loss_weighted(
    logits: torch.Tensor,  # [B, N, C]
    target: torch.Tensor,  # [B, N] int
    mask: Optional[torch.Tensor] = None,  # [B, N]
    background_id: int = 0,
    weight_background: float = 0.1,
    double_softmax: bool = True,
) -> torch.Tensor:
    """Background-down-weighted CE: sum(w_i * nll_i) / sum(w_i)."""
    x = F.log_softmax(logits, dim=-1)
    if double_softmax:
        x = F.log_softmax(x, dim=-1)
    nll = -torch.gather(x, -1, target[..., None].long())[..., 0]
    w = torch.where(target == background_id, weight_background, 1.0).to(nll.dtype)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-8)


def seg_accuracy(
    logits: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    ignored_ids: Tuple[int, ...] = (0,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, incorrect) ratios ignoring background, both relative to the
    number of (valid) keypoints."""
    pred = torch.argmax(logits, dim=-1)
    ignore = torch.zeros_like(target, dtype=torch.bool)
    for i in ignored_ids:
        ignore |= target == i
    valid = ~ignore
    if mask is not None:
        valid &= mask.bool()
        total = torch.clamp(mask.float().sum(), min=1.0)
    else:
        total = float(target.numel())
    corr = ((pred == target) & valid).float().sum() / total
    incorr = ((pred != target) & valid).float().sum() / total
    return corr, incorr


def seg_iou_precision(
    logits: torch.Tensor,  # [B, N, C]
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    n_class: Optional[int] = None,
    ignore_background: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean IoU and precision over the classes present in the ground truth."""
    c = n_class or logits.shape[-1]
    pred = torch.argmax(logits, dim=-1)
    valid = (mask if mask is not None else torch.ones_like(target, dtype=torch.bool)).float()
    pred_oh = F.one_hot(pred, c).float() * valid[..., None]
    gt_oh = F.one_hot(target.long(), c).float() * valid[..., None]
    dims = tuple(range(pred_oh.dim() - 1))
    inter = (pred_oh * gt_oh).sum(dims)
    pred_n = pred_oh.sum(dims)
    gt_n = gt_oh.sum(dims)
    union = pred_n + gt_n - inter
    present = gt_n > 0
    if ignore_background:
        present = present & (torch.arange(c, device=logits.device) != 0)
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-8), 0.0)
    prec = torch.where(gt_n > 0, inter / torch.clamp(gt_n, min=1e-8), 0.0)
    denom = torch.clamp(present.float().sum(), min=1.0)
    return (
        torch.where(present, iou, 0.0).sum() / denom,
        torch.where(present, prec, 0.0).sum() / denom,
    )


def cls_loss_ce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum-reduced multi-class CE normalized by the non-background count.

    ``pred`` is ``[B, C]`` or ``[B, C, S]`` (S parallel heads, summed),
    ``target`` the integer labels of matching shape without the C axis.
    """
    def one(p2, t1):  # [B, C], [B]
        logp = F.log_softmax(p2, dim=-1)
        return -torch.gather(logp, 1, t1[:, None].long()).sum()

    if pred.dim() == 2:
        total = one(pred, target)
    else:
        total = sum(one(pred[..., i], target[..., i]) for i in range(pred.shape[-1]))
    return total / torch.clamp((target > 0).float().sum(), min=1.0)


def cls_loss_kl(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum-reduced KL(softmax(target) || softmax(pred)); multi-head
    ``[..., S]`` inputs average over the heads."""
    def one(p2, t2):
        logp = F.log_softmax(p2, dim=-1)
        logq = F.log_softmax(t2, dim=-1)
        return torch.sum(torch.softmax(t2, dim=-1) * (logq - logp))

    if pred.dim() == 2:
        return one(pred, target)
    s = pred.shape[-1]
    return sum(one(pred[..., i], target[..., i]) for i in range(s)) / s


def sc_loss_l1(pred, target, mask=None):
    """Scene-coordinate L1: per-sample mean over the point axis, then the
    masked mean over the rest."""
    loss = torch.mean(torch.abs(pred - target), dim=1)
    if mask is not None:
        denom = torch.clamp(mask.to(loss.dtype).sum(), min=1.0)
        return torch.where(mask.bool(), loss, 0.0).sum() / denom
    return loss.mean()


def sc_loss_geo(pred, P, K, p2ds, mean_xyz, scale_xyz, max_value=20.0, mask=None):
    """Scene-coordinate reprojection loss.

    Projects the *normalized* coordinates (``pred``, not the de-normalized
    points), as the reference does. pred ``[B, 3, N]``, P ``[B, 3or4, 4]``,
    K ``[B, 3, 3]``, p2ds ``[B, N, 2]``.
    """
    b, _, n = pred.shape
    p3ds_homo = torch.cat([pred, torch.ones((b, 1, n), dtype=pred.dtype, device=pred.device)], dim=1)
    cam = torch.matmul(P, p3ds_homo)[:, :3, :]
    proj = torch.matmul(K, cam)
    p2 = proj[:, :2, :] / proj[:, 2:, :]
    loss = torch.sum((p2 - p2ds.transpose(1, 2)) ** 2, dim=1)
    loss = torch.clamp(loss, max=max_value)
    if mask is not None:
        denom = torch.clamp(mask.to(loss.dtype).sum(), min=1.0)
        return torch.where(mask.bool(), loss, 0.0).sum() / denom
    return loss.mean()


class SeqIoU:
    """Streaming mean-IoU accumulator: per-frame IoUs averaged over a whole
    evaluation sequence."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, logits, target, mask=None) -> float:
        iou, _ = seg_iou_precision(logits, target, mask)
        v = float(iou)
        self.total += v
        self.count += 1
        return v

    def mean(self) -> float:
        return self.total / max(self.count, 1)


def matching_nll_loss(
    plan: torch.Tensor,  # [B, N+1, M+1] assignment plan
    gt: torch.Tensor,  # [B, N] int: column in [0, M-1], M = dustbin, -1 = pad
    ref_mask: torch.Tensor,  # [B, M] bool valid reference tokens
    col_weight: float = 0.5,
) -> torch.Tensor:
    """Assignment NLL for matcher training: matched query rows pay
    ``-log plan[i, gt_i]`` (the dustbin column for unmatched queries),
    reference tokens that no query matches pay the dustbin row's NLL,
    weighted by ``col_weight``. Padded query rows (gt = -1) are excluded."""
    logp = torch.log(torch.clamp(plan, min=1e-9))
    mcols = plan.shape[-1] - 1
    valid = gt >= 0
    tgt = torch.where(valid, gt, 0).long()
    row_nll = -torch.gather(logp[:, :-1, :], -1, tgt[..., None])[..., 0]
    loss_rows = torch.where(valid, row_nll, 0.0).sum() / torch.clamp(valid.sum(), min=1)
    hit = (valid & (gt < mcols)).long()
    matched = torch.zeros((gt.shape[0], mcols), dtype=torch.long, device=gt.device)
    matched = matched.scatter_reduce(1, torch.clamp(gt, 0, mcols - 1).long(), hit, "amax") > 0
    ref_unmatched = ref_mask.bool() & ~matched
    col_nll = -logp[:, -1, :-1]
    loss_cols = torch.where(ref_unmatched, col_nll, 0.0).sum() / torch.clamp(ref_unmatched.sum(), min=1)
    return loss_rows + col_weight * loss_cols
