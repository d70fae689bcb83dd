"""Matcher adapters: ``match_fn(d0, nk0, s0, m0, d1, nk1, s1, m1) -> matches0 [B, N]``
closures for the localization engine (pram_tpu/engine/matching.py)."""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from pram_tpu_torch.models.adagml import adagml_batched_adaptive_apply
from pram_tpu_torch.models.nn_matcher import mutual_nn_match
from pram_tpu_torch.ops.matching import mutual_matches

MatchFn = Callable[..., torch.Tensor]


def make_nn_match_fn(
    ratio_threshold: Optional[float] = None,
    distance_threshold: Optional[float] = None,
) -> MatchFn:
    """Mutual nearest-neighbour matcher."""

    def fn(d0, nk0, s0, m0, d1, nk1, s1, m1):
        return mutual_nn_match(
            d0, d1, m0, m1, ratio_threshold, distance_threshold
        ).matches0

    return fn


def make_gml_match_fn(model, threshold: float = 0.2) -> MatchFn:
    """GML matcher (``models/gml.py``): mutual-max matches of its plan."""

    def fn(d0, nk0, s0, m0, d1, nk1, s1, m1):
        out = model(d0, d1, nk0, nk1, m0, m1)
        return mutual_matches(out["plan"], threshold).matches0

    return fn


def make_adagml_match_fn(
    model, threshold: float = 0.2, early_exit: Optional[bool] = None
) -> MatchFn:
    """AdaGML matcher (``models/adagml.py``): mutual-max matches of its plan.

    ``early_exit`` (default on; ``PRAM_ADA_EXIT=0`` turns it off) runs
    :func:`adagml_batched_adaptive_apply`, which gives the unrolled
    module's plan but stops running layers once every frame has stopped.
    """
    if early_exit is None:
        early_exit = os.environ.get("PRAM_ADA_EXIT", "1") == "1"
    if early_exit and model.config.adaptive:

        def fn(d0, nk0, s0, m0, d1, nk1, s1, m1):
            out = adagml_batched_adaptive_apply(model, d0, d1, nk0, nk1, m0, m1)
            return mutual_matches(out["plan"], threshold).matches0

        return fn

    def fn(d0, nk0, s0, m0, d1, nk1, s1, m1):
        out = model(d0, d1, nk0, nk1, m0, m1)
        return mutual_matches(out["plan"], threshold).matches0

    return fn
