"""SegNet: the GNN recognition head (pram_tpu/models/segnet.py).

A keypoint MLP encoding added to the descriptor tokens, ``n_layers``
attentional-propagation layers (multi-head attention merged and
concatenated with the input through an MLP, added back as a residual) and
an MLP segmentation head emitting logits ``[B, N, n_class]``.

The reference's MLP is Conv1d + InstanceNorm / BatchNorm over ``[B, C,
N]``; tokens here are channel-last, so a 1x1 conv is a ``Linear`` and the
instance norm normalizes each channel over the token axis, with padded
tokens kept out of its statistics. Parameter names follow the flax modules
(``lin_<i>``, ``norm_<i>``, ``proj_q`` ...), so ``models/convert.py`` maps a
flax tree onto them by name. GM (``models/gm.py``) builds on
:class:`PointMLP` and :class:`AttentionalPropagation`.

The JAX package leaves all of it to XLA, so it is plain PyTorch here: no
kernel runs on this path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.models.common import flax_init_, masked_softmax

# the attention logits of one chunk of problems are kept below this many
# elements, so a batch of 4096-token problems never holds all its
# [B, heads, N, M] logits at once
ATTN_CHUNK_ELEMS = 1 << 28


class TokenInstanceNorm(nn.Module):
    """``InstanceNorm1d(C, eps)`` over ``[B, C, N]`` on channel-last tokens
    ``[B, N, C]``: each channel normalized over the tokens, without affine
    parameters, padded tokens (``mask`` false) kept out of the statistics.
    The statistics are taken in f32 and the result cast back to the
    input's type."""

    def __init__(self, eps: float = 1e-3):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if mask is None:
            mean = xf.mean(dim=1, keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=1, keepdim=True)
        else:
            m = mask[..., None].float()
            cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
            mean = (xf * m).sum(dim=1, keepdim=True) / cnt
            var = (((xf - mean) ** 2) * m).sum(dim=1, keepdim=True) / cnt
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class PointMLP(nn.Module):
    """The reference's ``MLP`` helper on tokens: ``Linear`` layers ``lin_<i>``
    with a norm (``"in"``: :class:`TokenInstanceNorm`; ``"bn"``: BatchNorm
    with eps 1e-3 on its running statistics) and an activation between all
    but the last."""

    def __init__(self, in_dim: int, channels: Sequence[int], ac_fn: str = "relu", norm_fn: str = "in"):
        super().__init__()
        if ac_fn not in ("relu", "gelu", "lrelu"):
            raise ValueError(f"unknown activation {ac_fn!r}")
        if norm_fn not in ("in", "bn"):
            raise ValueError(f"unknown norm {norm_fn!r}")
        self.ac_fn, self.norm_fn, self.n = ac_fn, norm_fn, len(channels)
        dims = [in_dim, *channels]
        for i in range(self.n):
            self.add_module(f"lin_{i}", nn.Linear(dims[i], dims[i + 1]))
            if i < self.n - 1:
                norm = TokenInstanceNorm() if norm_fn == "in" else nn.BatchNorm1d(dims[i + 1], eps=1e-3)
                self.add_module(f"norm_{i}", norm)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"lin_{i}")(x)
            if i == self.n - 1:
                break
            norm = getattr(self, f"norm_{i}")
            if self.norm_fn == "in":
                x = norm(x, mask)
            else:
                # inference BatchNorm over the channel axis, in f32
                x = F.batch_norm(x.float().transpose(1, 2), norm.running_mean.float(), norm.running_var.float(),
                                 norm.weight.float(), norm.bias.float(), False, 0.0, norm.eps)
                x = x.transpose(1, 2).to(norm.weight.dtype)
            if self.ac_fn == "relu":
                x = F.relu(x)
            elif self.ac_fn == "gelu":
                x = F.gelu(x)
            else:
                x = F.leaky_relu(x, 0.1)
        return x


def attend(q, k, v, mask=None):
    """Multi-head attention ``softmax(q k^T / sqrt(hd)) v`` over ``[B, H, N,
    hd]`` heads: the logits in f32 from the operands' values, masked keys
    (``mask [B, M]`` false) at -1e9 before the softmax, the probabilities
    in ``v``'s type, the sum over keys in f32; ``[B, H, N, hd]`` f32.
    Problems go in chunks of at most ``ATTN_CHUNK_ELEMS`` logits."""
    b, h, n, hd = q.shape
    m = k.shape[2]
    step = max(1, ATTN_CHUNK_ELEMS // (h * n * m))
    out = []
    for s in range(0, b, step):
        sl = slice(s, s + step)
        logits = (q[sl].float() @ k[sl].float().transpose(-1, -2)) / hd**0.5
        attn = masked_softmax(logits, None if mask is None else mask[sl, None, None, :]).to(v.dtype)
        del logits
        out.append(attn.float() @ v[sl].float())
    return torch.cat(out) if len(out) > 1 else out[0]


class AttentionalPropagation(nn.Module):
    """The reference's residual message-passing layer: 4-head attention of
    ``x`` over ``source`` (1x1-conv projections ``proj_q`` / ``proj_k`` /
    ``proj_v``, then ``merge``), the message concatenated with ``x`` through
    a ``[2d, d]`` :class:`PointMLP`. Returns the delta (the caller adds
    it).

    The head split is channel-strided, as the reference's (channel c is in
    head c % num_heads), which keeps SegNet / GM checkpoints usable.
    """

    def __init__(self, feature_dim: int, num_heads: int, ac_fn: str = "relu", norm_fn: str = "in"):
        super().__init__()
        d = feature_dim
        self.num_heads = num_heads
        self.proj_q = nn.Linear(d, d)
        self.proj_k = nn.Linear(d, d)
        self.proj_v = nn.Linear(d, d)
        self.merge = nn.Linear(d, d)
        self.mlp = PointMLP(2 * d, [2 * d, d], ac_fn, norm_fn)

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        source: torch.Tensor,  # [B, M, D]
        mask: Optional[torch.Tensor] = None,  # [B, M] key validity
        self_mask: Optional[torch.Tensor] = None,  # [B, N], the MLP norm's statistics
    ) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads

        def heads(t):  # [B, L, D] -> [B, H, L, hd], channel c in head c % H
            return t.reshape(b, t.shape[1], d // h, h).permute(0, 3, 1, 2)

        msg = attend(heads(self.proj_q(x)), heads(self.proj_k(source)), heads(self.proj_v(source)), mask)
        msg = self.merge(msg.permute(0, 2, 3, 1).reshape(b, n, d).to(x.dtype))
        return self.mlp(torch.cat([x, msg], dim=-1), self_mask)


@dataclass
class SegNetConfig:
    """Hyperparameters (defaults as pram_tpu's SegNetConfig)."""

    descriptor_dim: int = 256
    output_dim: int = 1024
    n_class: int = 512
    keypoint_encoder: Sequence[int] = (32, 64, 128, 256)
    n_layers: int = 9
    ac_fn: str = "relu"
    norm_fn: str = "in"
    with_score: bool = False
    with_sc: bool = False


class SegNet(nn.Module):
    """GNN recognition head: the keypoint encoder, ``n_layers``
    :class:`AttentionalPropagation` layers and the segmentation MLP (and,
    with ``with_sc``, a 3-d scene-coordinate MLP). ``Linear`` parameters are
    drawn as flax draws them (``models/common.py:flax_init_``) from a
    generator seeded with 0."""

    def __init__(self, config: SegNetConfig = SegNetConfig()):
        super().__init__()
        c = config
        self.config = c
        act = dict(ac_fn=c.ac_fn, norm_fn=c.norm_fn)
        self.kenc = PointMLP(3 if c.with_score else 2, [*c.keypoint_encoder, c.descriptor_dim], **act)
        self.gnn = nn.ModuleList(AttentionalPropagation(c.descriptor_dim, 4, **act) for _ in range(c.n_layers))
        self.seg = PointMLP(c.descriptor_dim, [c.output_dim, c.n_class], **act)
        if c.with_sc:
            self.sc = PointMLP(c.descriptor_dim, [c.output_dim, 3], **act)
        flax_init_(self, torch.Generator().manual_seed(0))

    def forward(
        self,
        descriptors: torch.Tensor,  # [B, N, D]
        norm_keypoints: torch.Tensor,  # [B, N, 2]
        scores: Optional[torch.Tensor] = None,  # [B, N], with_score only
        mask: Optional[torch.Tensor] = None,  # [B, N] bool
    ) -> dict:
        cfg = self.config
        kin = norm_keypoints.to(descriptors.dtype)
        if cfg.with_score:
            kin = torch.cat([kin, scores[..., None].to(kin.dtype)], dim=-1)
        x = descriptors + self.kenc(kin, mask)
        for layer in self.gnn:
            x = x + layer(x, x, mask, mask)
        out = {"prediction": self.seg(x, mask)}
        if cfg.with_sc:
            out["sc"] = self.sc(x, mask)
        return out
