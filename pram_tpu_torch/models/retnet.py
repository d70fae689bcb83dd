"""RetNet: a global-descriptor retrieval CNN with GeM pooling
(pram_tpu/models/retnet.py).

It takes a mid-level feature map (SFD2's or SuperPoint's ``mid_features``,
NHWC) through two stride-2 stages of grouped bottleneck residual blocks,
generalized-mean pooling with a trainable exponent and a linear layer, to
an L2-normalized global descriptor. The reference defines it and does not
use it (PRAM replaces global retrieval by recognition); neither package
calls it, and it is here so that every model module has its port.
BatchNorm runs on its running statistics. Plain PyTorch, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def generalized_mean_pool(x: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GeM over the spatial axes of ``x [B, C, H, W]``: ``mean(clip(x,
    eps) ** p) ** (1 / p)`` -> ``[B, C]``."""
    return torch.clamp(x, min=eps).pow(p).mean(dim=(2, 3)).pow(1.0 / p)


class RetResBlock(nn.Module):
    """1x1 -> grouped 3x3 (32 groups) -> 1x1 bottleneck, BN and exact GELU,
    the identity added before the last GELU."""

    def __init__(self, features: int, groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, features, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(features)

    def forward(self, x):
        y = F.gelu(self.bn1(self.conv1(x)))
        y = F.gelu(self.bn2(self.conv2(y)))
        return F.gelu(self.bn3(self.conv3(y)) + x)


class RetNet(nn.Module):
    """``[B, H, W, indim]`` -> ``[B, outdim]`` unit vectors. Parameters keep
    torch's default init (the callers seed it); ``gem_p`` starts at 3."""

    def __init__(self, indim: int = 256, outdim: int = 1024):
        super().__init__()
        self.conv_a = nn.Conv2d(indim, 512, 3, stride=2, padding=1)
        self.bn_a = nn.BatchNorm2d(512)
        self.res_a0 = RetResBlock(512)
        self.res_a1 = RetResBlock(512)
        self.conv_b = nn.Conv2d(512, 1024, 3, stride=2, padding=1)
        self.bn_b = nn.BatchNorm2d(1024)
        self.res_b0 = RetResBlock(1024)
        self.res_b1 = RetResBlock(1024)
        self.gem_p = nn.Parameter(torch.tensor([3.0]))
        self.fc = nn.Linear(1024, outdim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn_a(self.conv_a(x.permute(0, 3, 1, 2)))
        x = self.res_a1(self.res_a0(x))
        x = self.bn_b(self.conv_b(x))
        x = self.res_b1(self.res_b0(x))
        x = self.fc(generalized_mean_pool(x, self.gem_p[0]))
        norm = torch.sqrt(torch.sum(x.float() * x.float(), dim=-1, keepdim=True))
        return (x.float() / torch.clamp(norm, min=1e-12)).to(x.dtype)
