"""SegNetViT: per-keypoint landmark recognition (pram_tpu/models/segnetvit.py).

Input projection to the hidden width, learnable Fourier rotary encoding of
the normalized keypoint coordinates, a stack of self-attention blocks and a
Linear-LN-GELU-Linear head emitting logits ``[B, N, n_class]``. Tokens are
padded to a fixed N; the validity mask masks attention keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.models.common import LearnableFourierPE, SelfAttentionBlock, flax_init_


@dataclass
class SegNetViTConfig:
    """Hyperparameters (defaults as pram_tpu's SegNetViTConfig)."""

    descriptor_dim: int = 256
    output_dim: int = 1024
    n_class: int = 512
    n_layers: int = 15
    num_heads: int = 4
    hidden_dim: int = 256


class SegNetViT(nn.Module):
    """Per-keypoint landmark classifier (recognition head).

    Parameters are drawn as flax draws them (``models/common.py:flax_init_``)
    from a generator seeded with 0. ``use_kernels = False``
    sends every block, forward and backward, through the kernels' plain
    versions (the A/B check on the card). ``int8_proj``
    and ``int8_mlp`` (``PRAM_INT8_PROJ`` / ``PRAM_INT8_MLP`` of the JAX
    package; inference only) run the blocks' projections and MLPs in int8.
    """

    def __init__(self, config: SegNetViTConfig = SegNetViTConfig()):
        super().__init__()
        c = config
        self.config = c
        self.kenc = LearnableFourierPE(2, c.hidden_dim // c.num_heads)
        self.input_proj = nn.Linear(c.descriptor_dim, c.hidden_dim)
        self.gnn = nn.ModuleList(
            SelfAttentionBlock(c.hidden_dim, c.hidden_dim, c.num_heads)
            for _ in range(c.n_layers)
        )
        self.seg_0 = nn.Linear(c.hidden_dim, c.output_dim)
        self.seg_ln = nn.LayerNorm(c.output_dim, eps=1e-6)
        self.seg_3 = nn.Linear(c.output_dim, c.n_class)
        flax_init_(self, torch.Generator().manual_seed(0))
        self.use_kernels = True
        self.int8_proj = False
        self.int8_mlp = False

    def forward(
        self,
        descriptors: torch.Tensor,  # [B, N, D]
        norm_keypoints: torch.Tensor,  # [B, N, 2]
        mask: Optional[torch.Tensor] = None,  # [B, N] bool
    ) -> dict:
        enc = self.kenc(norm_keypoints)
        x = self.input_proj(descriptors)
        for block in self.gnn:
            x = block(x, enc, mask, kernels=self.use_kernels, int8_proj=self.int8_proj,
                      int8_mlp=self.int8_mlp)
        y = self.seg_0(x)
        y = F.layer_norm(
            y.float(), (y.shape[-1],), self.seg_ln.weight.float(),
            self.seg_ln.bias.float(), self.seg_ln.eps,
        ).to(y.dtype)
        y = F.gelu(y)
        return {"prediction": self.seg_3(y)}
