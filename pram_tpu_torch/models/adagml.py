"""AdaGML: GML with adaptive token pruning and early stopping
(pram_tpu/models/adagml.py).

Each layer runs self-attention on both sides and cross-attention between
them; the attention kernels also emit, per token, the mean attention mass it
received (``ops/attention_qkv.py``, ``ops/cross_attention.py``). A pooling
head turns a token's features and its two statistics into a confidence.
From layer 1 on, tokens at or below the layer's threshold are masked out
(masked, not gathered: they stop giving and taking attention and cannot
match), unless a side has fewer than ``n_min_tokens`` left, and a frame
stops once more than ``stop_ratio`` of its original tokens are confident:
its features freeze and its plan is read through the output projection of
its stopping layer. Shapes stay fixed throughout.

Three forms, as in the JAX package: :class:`AdaGML` runs every layer (and
returns the per-layer confidences); :func:`adagml_batched_adaptive_apply`
gives the same plan, masks and stop layers but stops running layers once
every frame of the batch has stopped (one host sync per layer);
:func:`adagml_online_apply` treats the batch as one stream that stops as a
whole. Sinkhorn is the plain f32 one on every device
(:func:`pram_tpu_torch.ops.sinkhorn.sinkhorn_matching`), as the JAX package
calls the XLA ``sinkhorn_matching`` here, never its Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.models.common import LearnableFourierPE, _add_residual_mlp
from pram_tpu_torch.ops.attention import mask_to_bias
from pram_tpu_torch.ops.attention_qkv import (
    permute_qkv_kernel,
    self_attention_qkv,
    self_attention_qkv_plain,
)
from pram_tpu_torch.ops.cross_attention import cross_attention_packed, cross_attention_packed_plain
from pram_tpu_torch.ops.matching import MatchResult, mutual_matches
from pram_tpu_torch.ops.mlp import residual_mlp, residual_mlp_plain
from pram_tpu_torch.ops.sinkhorn import dual_softmax_matching, sinkhorn_matching


@dataclass
class AdaGMLConfig:
    """Hyperparameters (defaults as pram_tpu's AdaGMLConfig; its ``remat``
    is a training option and has no counterpart in this inference port)."""

    descriptor_dim: int = 128
    hidden_dim: int = 256
    num_heads: int = 4
    n_layers: int = 9
    sinkhorn_iterations: int = 20
    match_threshold: float = 0.2
    n_min_tokens: int = 256
    min_confidence: float = 0.9
    with_sinkhorn: bool = True
    stop_ratio: float = 0.95
    adaptive: bool = True  # False: plain GML with pooling heads


def confidence_threshold(layer_index: int, n_layers: int) -> float:
    """Layer-scaled confidence threshold ``0.5 + 0.1 exp(-4 i / L)``."""
    return min(max(0.5 + 0.1 * math.exp(-4.0 * layer_index / n_layers), 0.0), 1.0)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` in x's dtype, product and sum each rounded, as flax's
    Dense on parameters of x's dtype."""
    return x @ lin.weight.T + lin.bias


def _dense_f32(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The Dense of an f32 input: flax promotes the parameters to f32."""
    return F.linear(x.float(), lin.weight.float(), lin.bias.float())


def _valid_count(mask: torch.Tensor) -> torch.Tensor:
    """``[B, 1]`` f32 number of valid tokens, at least 1."""
    return mask.to(torch.float32).sum(-1, keepdim=True).clamp(min=1.0)


class PoolingLayer(nn.Module):
    """Token confidence from features and the two attention statistics.

    The statistics arrive in f32, so the score encoder and the predictor run
    in f32 (flax promotes the parameters to the input's type); the feature
    projection runs in the features' dtype. LayerNorm eps 1e-6, exact GELU.
    """

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.score_enc_0 = nn.Linear(2, hidden_dim)
        self.score_enc_ln = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.score_enc_3 = nn.Linear(hidden_dim, hidden_dim)
        self.proj = nn.Linear(hidden_dim, hidden_dim)
        self.predict_0 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.predict_ln = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.predict_3 = nn.Linear(hidden_dim, 1)

    @staticmethod
    def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)

    def forward(self, x: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
        """x ``[B, N, d]``, score ``[B, N, 2]`` f32 -> confidence ``[B, N]`` f32."""
        s = F.gelu(self._ln(self.score_enc_ln, _dense_f32(self.score_enc_0, score)))
        s = _dense_f32(self.score_enc_3, s)
        y = torch.cat([_dense(self.proj, x).float(), s], dim=-1)
        y = F.gelu(self._ln(self.predict_ln, _dense_f32(self.predict_0, y)))
        return torch.sigmoid(_dense_f32(self.predict_3, y))[..., 0]


def _residual_mlp(block: nn.Module, x, msg, kernels: bool):
    """The block's residual concat-MLP through the kernel or its plain version."""
    fn = residual_mlp if kernels else residual_mlp_plain
    return fn(
        x, msg, block.proj.weight, block.proj.bias, block.mlp_0.weight,
        block.mlp_0.bias, block.mlp_ln.weight, block.mlp_ln.bias,
        block.mlp_3.weight, block.mlp_3.bias, eps=block.mlp_ln.eps,
    )


class _SelfAttnStats(nn.Module):
    """Self-attention block that also returns the mean attention each key
    receives (over heads and valid queries).

    The qkv projection runs outside the kernel on weight columns permuted
    to ``[q | k | v]`` blocks; ``ops/attention_qkv.py`` attends and sums
    the statistics, ``ops/mlp.py`` applies the residual concat-MLP.
    """

    def __init__(self, feat_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.qkv = nn.Linear(feat_dim, 3 * hidden_dim)
        _add_residual_mlp(self, feat_dim, hidden_dim)

    def forward(self, x, encoding, mask, kernels: bool = True):
        """x ``[B, N, d]``, encoding (cos, sin) ``[B, N, hd]`` f32, mask
        ``[B, N]`` bool -> (x' ``[B, N, d]``, stat ``[B, N]`` f32)."""
        b, n, _ = x.shape
        h = self.num_heads
        wp, bp = permute_qkv_kernel(self.qkv.weight.T, self.qkv.bias, h, self.head_dim)
        qkv = (x @ wp + bp).contiguous()
        attn = self_attention_qkv if kernels else self_attention_qkv_plain
        msg, stat_sum = attn(
            qkv, encoding[0], encoding[1], mask_to_bias(mask, b, n, x.device),
            self.head_dim**-0.5, h, return_stats=True,
        )
        return _residual_mlp(self, x, msg, kernels), stat_sum / (h * _valid_count(mask))


class _CrossAttnStats(nn.Module):
    """Symmetric cross-attention block returning each side's received-
    attention statistic (from the other side's valid queries).

    to_qk and to_v run once over the concatenation ``[x0 | x1]``;
    ``ops/cross_attention.py:cross_attention_packed`` attends both ways on
    views of their outputs, and the residual MLP runs over all tokens.
    """

    def __init__(self, feat_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.to_qk = nn.Linear(feat_dim, hidden_dim)
        self.to_v = nn.Linear(feat_dim, hidden_dim)
        _add_residual_mlp(self, feat_dim, hidden_dim)

    def forward(self, x0, x1, mask0, mask1, kernels: bool = True):
        b, n0, _ = x0.shape
        n1 = x1.shape[1]
        h = self.num_heads
        cat = torch.cat([x0, x1], dim=1)
        qk = _dense(self.to_qk, cat)
        v = _dense(self.to_v, cat)
        attn = cross_attention_packed if kernels else cross_attention_packed_plain
        m0, m1, s0, s1 = attn(
            qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:],
            mask_to_bias(mask0, b, n0, x0.device), mask_to_bias(mask1, b, n1, x0.device),
            self.head_dim**-0.5, h, return_stats=True,
        )
        out = _residual_mlp(self, cat, torch.cat([m0, m1], dim=1), kernels)
        stat0 = s0 / (h * _valid_count(mask1))
        stat1 = s1 / (h * _valid_count(mask0))
        return out[:, :n0].contiguous(), out[:, n0:].contiguous(), stat0, stat1


class AdaGML(nn.Module):
    """Adaptive matcher with fixed-shape token pruning (inference).

    ``use_kernels = False`` sends every block through the kernels' plain
    versions on any device; only the kernel-vs-plain checks set it.
    """

    def __init__(self, config: AdaGMLConfig = AdaGMLConfig()):
        super().__init__()
        c = config
        self.config = c
        self.use_kernels = True
        self.input_proj = nn.Linear(c.descriptor_dim, c.hidden_dim)
        self.poseenc = LearnableFourierPE(2, c.hidden_dim // c.num_heads)
        self.self_attn = nn.ModuleList(
            _SelfAttnStats(c.hidden_dim, c.hidden_dim, c.num_heads) for _ in range(c.n_layers)
        )
        self.cross_attn = nn.ModuleList(
            _CrossAttnStats(c.hidden_dim, c.hidden_dim, c.num_heads) for _ in range(c.n_layers)
        )
        self.pooling = nn.ModuleList(PoolingLayer(c.hidden_dim) for _ in range(c.n_layers))
        self.out_proj = nn.ModuleList(nn.Linear(c.hidden_dim, c.hidden_dim) for _ in range(c.n_layers))
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def forward(self, desc0, desc1, norm_kpts0, norm_kpts1, mask0=None, mask1=None) -> dict:
        """Every layer at the full shape; stopped frames freeze. Returns the
        plan ``[B, N+1, M+1]``, the final masks, ``stop_layer [B]`` and the
        per-layer confidences ``[L, B, N]``, ``[L, B, M]``."""
        st = _start(self, desc0, desc1, norm_kpts0, norm_kpts1, mask0, mask1)
        confs0, confs1 = [], []
        for ni in range(self.config.n_layers):
            conf0, conf1 = _step(self, st, ni)
            confs0.append(conf0)
            confs1.append(conf1)
        out = _finish(self, st)
        out["confidences0"] = torch.stack(confs0)
        out["confidences1"] = torch.stack(confs1)
        return out


class _State:
    """The carry of the layer loop."""

    def __init__(self, x0, x1, enc0, enc1, mask0, mask1, n_layers: int):
        b = x0.shape[0]
        self.x0, self.x1, self.enc0, self.enc1 = x0, x1, enc0, enc1
        self.mask0, self.mask1 = mask0, mask1
        self.orig_total = mask0.to(torch.float32).sum(-1) + mask1.to(torch.float32).sum(-1)
        self.stopped = torch.zeros((b,), dtype=torch.bool, device=x0.device)
        self.stop_layer = torch.full((b,), n_layers - 1, dtype=torch.int64, device=x0.device)


def _start(model: AdaGML, desc0, desc1, nk0, nk1, mask0, mask1) -> _State:
    b, n0 = desc0.shape[:2]
    n1 = desc1.shape[1]
    dev = desc0.device
    if mask0 is None:
        mask0 = torch.ones((b, n0), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((b, n1), dtype=torch.bool, device=dev)
    return _State(
        _dense(model.input_proj, desc0), _dense(model.input_proj, desc1),
        model.poseenc(nk0), model.poseenc(nk1), mask0, mask1, model.config.n_layers,
    )


def _layer(model: AdaGML, ni: int, x0, x1, enc0, enc1, m0, m1):
    """Layer ``ni``: new features and the pooling confidences of both sides."""
    k = model.use_kernels
    sa, ca, pool = model.self_attn[ni], model.cross_attn[ni], model.pooling[ni]
    nx0, s00 = sa(x0, enc0, m0, k)
    nx1, s11 = sa(x1, enc1, m1, k)
    nx0, nx1, s01, s10 = ca(nx0, nx1, m0, m1, k)
    conf0 = pool(nx0, torch.stack([s00, s01], dim=-1))
    conf1 = pool(nx1, torch.stack([s11, s10], dim=-1))
    return nx0, nx1, conf0, conf1


def _step(model: AdaGML, st: _State, ni: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the batched forms, in place on ``st``: stopped frames
    keep their features, and from layer 1 on the live frames prune and may
    stop. The stop test counts the tokens below the threshold among those
    valid at the layer's entry (tokens pruned earlier count as confident)."""
    cfg = model.config
    nx0, nx1, conf0, conf1 = _layer(model, ni, st.x0, st.x1, st.enc0, st.enc1, st.mask0, st.mask1)
    keep = st.stopped[:, None, None]
    st.x0 = torch.where(keep, st.x0, nx0)
    st.x1 = torch.where(keep, st.x1, nx1)
    if cfg.adaptive and ni >= 1:
        th = confidence_threshold(ni, cfg.n_layers)
        live = ~st.stopped
        prune0 = (st.mask0.sum(-1) >= cfg.n_min_tokens) & live
        prune1 = (st.mask1.sum(-1) >= cfg.n_min_tokens) & live
        below = ((conf0 < th) & st.mask0).to(torch.float32).sum(-1) + (
            (conf1 < th) & st.mask1
        ).to(torch.float32).sum(-1)
        st.mask0 = torch.where(prune0[:, None], st.mask0 & (conf0 > th), st.mask0)
        st.mask1 = torch.where(prune1[:, None], st.mask1 & (conf1 > th), st.mask1)
        now_stop = 1.0 - below / st.orig_total.clamp(min=1.0) > cfg.stop_ratio
        st.stop_layer = torch.where(live & now_stop, ni, st.stop_layer)
        st.stopped = st.stopped | now_stop
    return conf0, conf1


def stack_adagml_layers(model: AdaGML) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-layer output projections stacked ``([L, d, d], [L, d])``, for
    the per-frame gather of ``out_proj[stop_layer]``."""
    return (
        torch.stack([p.weight for p in model.out_proj]),
        torch.stack([p.bias for p in model.out_proj]),
    )


def _finish(model: AdaGML, st: _State) -> dict:
    """Per-frame ``out_proj[stop_layer]``, similarity, plan."""
    cfg = model.config
    d = st.x0.shape[-1]
    w, bias = stack_adagml_layers(model)
    w, bias = w[st.stop_layer].transpose(1, 2), bias[st.stop_layer][:, None]
    md0 = (torch.bmm(st.x0, w) + bias) / d**0.25
    md1 = (torch.bmm(st.x1, w) + bias) / d**0.25
    # the similarity accumulates in f32 from the working dtype's values
    sim = md0.float() @ md1.float().transpose(-1, -2)
    bin_score = model.bin_score.float()
    if cfg.with_sinkhorn:
        # plain f32 Sinkhorn on every device: the JAX package runs AdaGML's
        # through XLA (its Pallas Sinkhorn is GML's)
        plan = sinkhorn_matching(sim, bin_score, cfg.sinkhorn_iterations, st.mask0, st.mask1)
    else:
        plan = dual_softmax_matching(sim, bin_score, st.mask0, st.mask1)
    return {"plan": plan, "mask0": st.mask0, "mask1": st.mask1, "stop_layer": st.stop_layer}


@torch.no_grad()
def adagml_batched_adaptive_apply(model: AdaGML, desc0, desc1, norm_kpts0, norm_kpts1,
                                  mask0=None, mask1=None) -> dict:
    """AdaGML that stops running layers once every frame has stopped.

    Layers after that point would only feed frozen features and the
    confidence heads, so the plan, masks and ``stop_layer`` are those of
    :meth:`AdaGML.forward`. The loop reads ``stopped.all()`` on the host
    after each layer (one sync per layer).
    """
    st = _start(model, desc0, desc1, norm_kpts0, norm_kpts1, mask0, mask1)
    for ni in range(model.config.n_layers):
        if bool(st.stopped.all()):
            break
        _step(model, st, ni)
    return _finish(model, st)


@torch.no_grad()
def adagml_online_apply(model: AdaGML, desc0, desc1, norm_kpts0, norm_kpts1,
                        mask0=None, mask1=None) -> dict:
    """Latency form for a single-frame stream (batch 1; a larger batch is
    treated as one frame): the token counts and the stop test run over the
    whole batch, and the loop exits at the first layer that stops it."""
    cfg = model.config
    st = _start(model, desc0, desc1, norm_kpts0, norm_kpts1, mask0, mask1)
    orig_total = st.orig_total.sum().clamp(min=1.0)
    ni = 0
    while ni < cfg.n_layers:
        st.x0, st.x1, conf0, conf1 = _layer(
            model, ni, st.x0, st.x1, st.enc0, st.enc1, st.mask0, st.mask1
        )
        stop = False
        if ni >= 1:
            th = confidence_threshold(ni, cfg.n_layers)
            below = ((conf0 < th) & st.mask0).sum() + ((conf1 < th) & st.mask1).sum()
            if int(st.mask0.sum()) >= cfg.n_min_tokens:
                st.mask0 = st.mask0 & (conf0 > th)
            if int(st.mask1.sum()) >= cfg.n_min_tokens:
                st.mask1 = st.mask1 & (conf1 > th)
            stop = bool(1.0 - below.to(torch.float32) / orig_total > cfg.stop_ratio)
        ni += 1
        if stop:
            break
    st.stop_layer.fill_(min(max(ni - 1, 0), cfg.n_layers - 1))
    return _finish(model, st)


def extract_matches(plan: torch.Tensor, threshold: float = 0.2) -> MatchResult:
    """Mutual-max readout; pruned tokens carry no plan mass, so they cannot match."""
    return mutual_matches(plan, threshold)
