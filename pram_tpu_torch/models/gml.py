"""GML matcher: an attentional graph matcher producing a transport plan over
keypoints (pram_tpu/models/gml.py).

A shared input projection, a rotary Fourier encoding of the keypoints,
``n_layers`` of (self-attention within each side, symmetric cross-attention
between the sides), the last layer's output projection, Sinkhorn with a
dustbin, and mutual-max match extraction. Both sides run as one token stream
over their concatenation ``[side 0 | side 1]``: every projection and MLP runs
once over all tokens, and attention stays blocked per side through
``splits``. Both sides are padded to fixed token counts with validity masks;
masked attention and masked Sinkhorn make the result that of the unpadded
problem.

The plan goes through ``ops/sinkhorn.py:sinkhorn``: kernel 6 forward and,
with gradients enabled, the plain iterations differentiated backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from pram_tpu_torch.models.common import (
    CrossAttentionBlock,
    LearnableFourierPE,
    SelfAttentionBlock,
    flax_init_,
)
from pram_tpu_torch.ops.matching import MatchResult, mutual_matches
from pram_tpu_torch.ops.sinkhorn import dual_softmax_matching, sinkhorn, sinkhorn_matching


@dataclass
class GMLConfig:
    """Hyperparameters (defaults as pram_tpu's GMLConfig). Sinkhorn runs the
    ``csrc/sinkhorn.cu`` kernel on CUDA tensors and its plain version on CPU
    tensors, so the JAX package's ``use_pallas_sinkhorn`` switch has no
    counterpart here."""

    descriptor_dim: int = 128
    hidden_dim: int = 256
    num_heads: int = 4
    n_layers: int = 9
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    with_sinkhorn: bool = True


class GML(nn.Module):
    """Attentional graph matcher.

    Of the reference's per-layer output projections only the last one is
    applied, so only it is declared (``out_proj``); the flax checkpoint,
    likewise, holds only ``out_proj_{n_layers - 1}`` (the JAX package's
    others get no parameters and no gradient). Parameters are drawn as flax
    draws them (``models/common.py:flax_init_``, ``bin_score`` 1.0) from a
    generator seeded with 0. ``use_kernels = False`` sends
    every block and the Sinkhorn, forward and backward, through the plain
    versions (the A/B check on the card). ``int8_proj`` and ``int8_mlp``
    (``PRAM_INT8_PROJ`` / ``PRAM_INT8_MLP`` of the JAX package; inference
    only) run the blocks' projections and MLPs in int8.
    """

    def __init__(self, config: GMLConfig = GMLConfig()):
        super().__init__()
        c = config
        self.config = c
        self.input_proj = nn.Linear(c.descriptor_dim, c.hidden_dim)
        self.poseenc = LearnableFourierPE(2, c.hidden_dim // c.num_heads)
        self.self_attn = nn.ModuleList(
            SelfAttentionBlock(c.hidden_dim, c.hidden_dim, c.num_heads)
            for _ in range(c.n_layers)
        )
        self.cross_attn = nn.ModuleList(
            CrossAttentionBlock(c.hidden_dim, c.hidden_dim, c.num_heads)
            for _ in range(c.n_layers)
        )
        self.out_proj = nn.Linear(c.hidden_dim, c.hidden_dim)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        flax_init_(self, torch.Generator().manual_seed(0))
        self.use_kernels = True
        self.int8_proj = False
        self.int8_mlp = False

    def forward(
        self,
        desc0: torch.Tensor,  # [B, N, D]
        desc1: torch.Tensor,  # [B, M, D]
        norm_kpts0: torch.Tensor,  # [B, N, 2]
        norm_kpts1: torch.Tensor,  # [B, M, 2]
        mask0: Optional[torch.Tensor] = None,  # [B, N] bool
        mask1: Optional[torch.Tensor] = None,  # [B, M] bool
    ) -> dict:
        cfg = self.config
        b, n0 = desc0.shape[:2]
        n1 = desc1.shape[1]
        splits = (n0, n1)
        x = self.input_proj(torch.cat([desc0, desc1], dim=1))
        enc = self.poseenc(torch.cat([norm_kpts0, norm_kpts1], dim=1))
        if mask0 is None and mask1 is None:
            mask_cat = None
        else:
            m0 = mask0 if mask0 is not None else desc0.new_ones((b, n0), dtype=torch.bool)
            m1 = mask1 if mask1 is not None else desc1.new_ones((b, n1), dtype=torch.bool)
            mask_cat = torch.cat([m0, m1], dim=1)
        kernels = self.use_kernels
        for self_blk, cross_blk in zip(self.self_attn, self.cross_attn):
            x = self_blk(x, enc, mask_cat, splits=splits, kernels=kernels, int8_proj=self.int8_proj,
                         int8_mlp=self.int8_mlp)
            x = cross_blk(x, splits, mask0, mask1, int8_proj=self.int8_proj, int8_mlp=self.int8_mlp,
                          kernels=kernels)

        d = x.shape[-1]
        md = self.out_proj(x) / d**0.25
        md0, md1 = md[:, :n0], md[:, n0:]
        # the similarity accumulates in f32 from the working dtype's values
        sim = md0.float() @ md1.float().transpose(-1, -2)
        if cfg.with_sinkhorn:
            fn = sinkhorn if kernels else sinkhorn_matching
            plan = fn(sim, self.bin_score, cfg.sinkhorn_iterations, mask0, mask1)
        else:
            plan = dual_softmax_matching(sim, self.bin_score.float(), mask0, mask1)
        return {"plan": plan, "mdesc0": md0, "mdesc1": md1}


def extract_matches(plan: torch.Tensor, threshold: float = 0.2) -> MatchResult:
    """Mutual-max match readout."""
    return mutual_matches(plan, threshold)
