"""Mutual-max match extraction from a transport plan (pram_tpu/ops/matching.py).

Row and column argmax of the plan with the dustbin excluded (first index on
ties), a mutual-consistency check and a score threshold; -1 marks no match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    """matches0 ``[B, N]`` / matches1 ``[B, M]`` int64 indices into the other
    side (-1 = no match); scores0 / scores1 their plan mass."""

    matches0: torch.Tensor
    matches1: torch.Tensor
    scores0: torch.Tensor
    scores1: torch.Tensor


def mutual_matches(plan: torch.Tensor, threshold: float = 0.2) -> MatchResult:
    """Mutual-max matches of an augmented plan ``[B, N+1, M+1]`` whose plan
    mass is above ``threshold``."""
    scores = plan[:, :-1, :-1]
    b, n, m = scores.shape
    max0, indices0 = scores.max(dim=2)
    indices1 = scores.argmax(dim=1)

    ar0 = torch.arange(n, device=plan.device)[None]
    ar1 = torch.arange(m, device=plan.device)[None]
    mutual0 = ar0 == torch.gather(indices1, 1, indices0)
    mutual1 = ar1 == torch.gather(indices0, 1, indices1)

    zero = torch.zeros((), dtype=scores.dtype, device=plan.device)
    mscores0 = torch.where(mutual0, max0, zero)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), zero)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    matches0 = torch.where(valid0, indices0, -1)
    matches1 = torch.where(valid1, indices1, -1)
    return MatchResult(matches0, matches1, mscores0, mscores1)
