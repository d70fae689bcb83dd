"""GM: the SuperGlue-style matcher with a Sinkhorn plan (pram_tpu/models/gm.py).

Descriptors plus a keypoint MLP encoding of ``(x, y, score)``, ``2 *
n_layers`` alternating self and cross :class:`AttentionalPropagation`
layers (one layer's weights for both sides), the last layer's final
projection, the similarity divided by sqrt(d), and a plan with a learned
dustbin score: Sinkhorn, or the dual softmax without ``with_sinkhorn``.
This is the reference's intended architecture (its constructor passes an
argument the layer does not take, so it cannot build one), as the JAX
package builds it.

The plan goes through ``ops/sinkhorn.py:sinkhorn``, which launches
``csrc/sinkhorn.cu`` (kernel 6) on a CUDA tensor and runs the plain
iterations on a CPU one. The JAX GM computes the same
function with its XLA Sinkhorn, which equals its Pallas kernel within the
dustbin tolerance of ``pram_tpu/ops/sinkhorn_pallas.py``. Everything else
is plain PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from pram_tpu_torch.models.common import flax_init_
from pram_tpu_torch.models.segnet import AttentionalPropagation, PointMLP
from pram_tpu_torch.ops.matching import MatchResult, mutual_matches
from pram_tpu_torch.ops.sinkhorn import dual_softmax_matching, sinkhorn


@dataclass
class GMConfig:
    """Hyperparameters (defaults as pram_tpu's GMConfig)."""

    descriptor_dim: int = 128
    keypoint_encoder: Sequence[int] = (32, 64, 128, 256)
    n_layers: int = 9  # expands to 2 * n_layers alternating self / cross layers
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    with_sinkhorn: bool = True
    ac_fn: str = "relu"
    norm_fn: str = "in"


class GM(nn.Module):
    """SuperGlue-style matcher over two padded keypoint sets.

    ``final_proj`` keeps the reference's ``n_layers`` slots, of which only
    the last is applied: the others are placeholders without parameters,
    as flax creates none for the declared, never-called ``final_proj_<i>``,
    so the state dict lines up with the flax tree (``final_proj.<n - 1>``
    for ``final_proj_<n - 1>``). ``Linear`` parameters are drawn as flax
    draws them (``models/common.py:flax_init_``, ``bin_score`` 1.0) from a
    generator seeded with 0.
    """

    def __init__(self, config: GMConfig = GMConfig()):
        super().__init__()
        c = config
        self.config = c
        d = c.descriptor_dim
        act = dict(ac_fn=c.ac_fn, norm_fn=c.norm_fn)
        self.kenc = PointMLP(3, [*c.keypoint_encoder, d], **act)
        self.gnn = nn.ModuleList(AttentionalPropagation(d, 4, **act) for _ in range(2 * c.n_layers))
        self.final_proj = nn.ModuleList(
            [nn.Identity() for _ in range(c.n_layers - 1)] + [nn.Linear(d, d)]
        )
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        flax_init_(self, torch.Generator().manual_seed(0))

    def forward(
        self,
        desc0: torch.Tensor,  # [B, N, D]
        desc1: torch.Tensor,  # [B, M, D]
        norm_kpts0: torch.Tensor,  # [B, N, 2]
        norm_kpts1: torch.Tensor,  # [B, M, 2]
        scores0: torch.Tensor,  # [B, N]
        scores1: torch.Tensor,  # [B, M]
        mask0: Optional[torch.Tensor] = None,  # [B, N] bool
        mask1: Optional[torch.Tensor] = None,  # [B, M] bool
    ) -> dict:
        cfg = self.config
        dt = desc0.dtype

        def encode(nk, s, m):
            return self.kenc(torch.cat([nk.to(dt), s[..., None].to(dt)], dim=-1), m)

        x0 = desc0 + encode(norm_kpts0, scores0, mask0)
        x1 = desc1 + encode(norm_kpts1, scores1, mask1)
        for i, layer in enumerate(self.gnn):
            if i % 2:  # cross
                d0, d1 = layer(x0, x1, mask1, mask0), layer(x1, x0, mask0, mask1)
            else:
                d0, d1 = layer(x0, x0, mask0, mask0), layer(x1, x1, mask1, mask1)
            x0, x1 = x0 + d0, x1 + d1

        fproj = self.final_proj[-1]
        md0, md1 = fproj(x0), fproj(x1)
        # the similarity accumulates in f32 from the working type's values
        sim = (md0.float() @ md1.float().transpose(-1, -2)) / cfg.descriptor_dim**0.5
        if cfg.with_sinkhorn:
            plan = sinkhorn(sim, self.bin_score, cfg.sinkhorn_iterations, mask0, mask1)
        else:
            plan = dual_softmax_matching(sim, self.bin_score.float(), mask0, mask1)
        return {"plan": plan}


def extract_matches(plan: torch.Tensor, threshold: float = 0.2) -> MatchResult:
    """Mutual-max match readout."""
    return mutual_matches(plan, threshold)
