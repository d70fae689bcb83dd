"""Shared transformer blocks (pram_tpu/models/common.py).

Interleaved-pair rotary embedding driven by a learnable Fourier projection
of keypoint coordinates, masked softmax, and the self- and cross-attention
blocks with their concat-MLP residual. Parameter names follow the flax
modules, so ``models/convert.py`` maps a flax tree onto these modules by
name, and :func:`flax_init_` draws fresh parameters as flax initialises
them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pram_tpu_torch.ops import attention, cross_attention, mlp
from pram_tpu_torch.ops.attention import apply_rotary, mask_to_bias, rotate_half
from pram_tpu_torch.ops.quant import quant_linear
from pram_tpu_torch.ops.train_vjp import cross_attention_proj, residual_mlp, self_attention_proj

__all__ = [
    "CrossAttentionBlock",
    "LearnableFourierPE",
    "SelfAttentionBlock",
    "apply_rotary",
    "flax_init_",
    "masked_softmax",
    "rotate_half",
]

# stddev of the standard normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps the variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` on a ``Linear.weight [out, in]``: a normal of
    variance 1 / fan_in (fan_in = in), truncated at two of its stddevs."""
    std = (1.0 / weight.shape[1]) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every parameter of ``module`` drawn as flax initialises its
    counterpart, from ``generator``: ``Linear`` weights ``lecun_normal``,
    biases zero, ``LayerNorm`` scale 1 and bias 0, and the Fourier
    encoding's ``Wr`` from ``normal(gamma ** -2)`` at flax's ``gamma`` 1
    (``pram_tpu/models/common.py:60``). Parameters of other modules are
    left as they are."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    for mod in module.modules():
        if isinstance(mod, LearnableFourierPE):
            nn.init.normal_(mod.Wr.weight, 0.0, 1.0, generator=generator)
    return module


class LearnableFourierPE(nn.Module):
    """Learnable Fourier positional encoding producing rotary (cos, sin).

    A bias-free linear maps the M-dim position to ``f_dim // 2``
    frequencies; cos/sin are duplicated per rotary pair. Returns f32
    ``[B, N, f_dim]`` each (the flax module's ``[B, 1, N, f_dim]`` without
    the head axis).
    """

    def __init__(self, m_dim: int, f_dim: int):
        super().__init__()
        self.Wr = nn.Linear(m_dim, f_dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        proj = x.float() @ self.Wr.weight.float().T
        cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)
        sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)
        return cos.contiguous(), sin.contiguous()


def masked_softmax(
    logits: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1
) -> torch.Tensor:
    """Softmax with a validity mask (True = valid); masked entries get -1e9."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e9, dtype=logits.dtype))
    return torch.softmax(logits, dim=dim)


class SelfAttentionBlock(nn.Module):
    """Self-attention with rotary encoding, then the residual concat-MLP.

    Both halves go through the differentiable kernel wrappers of
    ``ops/train_vjp.py``: ``ops/attention.py`` (qkv projection, rotary,
    masked attention) and ``ops/mlp.py``
    (``x + mlp_3(gelu(LN(mlp_0([x, proj(msg)]))))``) forward, kernels 13
    and 15 backward. ``kernels=False`` sends both ways through the plain
    versions (the A/B check on the card).

    ``int8_proj`` and ``int8_mlp`` (inference only) take the int8 kernels
    (16, 17) instead, where the JAX package takes them
    (``pram_tpu/models/common.py``): the projection where every side has at
    most 1024 tokens, the MLP where ``fused_mlp_int8_supported`` holds.
    """

    def __init__(self, feat_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.qkv = nn.Linear(feat_dim, 3 * hidden_dim)
        _add_residual_mlp(self, feat_dim, hidden_dim)

    def forward(
        self,
        x: torch.Tensor,
        encoding: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        splits: Optional[Sequence[int]] = None,
        kernels: bool = True,
        int8_proj: bool = False,
        int8_mlp: bool = False,
    ) -> torch.Tensor:
        """``splits``: x is a token concatenation of independent sides (GML
        runs both keypoint sets through shared weights); the projections and
        the MLP run over all tokens, attention stays within each side."""
        b, n, _ = x.shape
        cos, sin = encoding if encoding is not None else (None, None)
        args = (cos, sin, mask_to_bias(mask, b, n, x.device), self.head_dim**-0.5, self.num_heads, splits)
        if int8_proj and max(splits if splits is not None else (n,)) <= 1024:
            _inference_only()
            wq, ws = _quantized(self, "qkv")
            fn = attention.self_attention_int8 if kernels else attention.self_attention_int8_plain
            msg = fn(x, wq, ws, self.qkv.bias, *args)
        else:
            msg = self_attention_proj(x, self.qkv.weight, self.qkv.bias, *args, kernels)
        return _apply_residual_mlp(self, x, msg, kernels, int8_mlp)


class CrossAttentionBlock(nn.Module):
    """Symmetric cross-attention with a shared QK projection, then the
    residual concat-MLP.

    Two call forms, as the flax block's (``pram_tpu/models/common.py:
    434-451``): the cat form GML uses, ``block(x, (n0, n1), ...)`` on the
    token concatenation ``x = [x0 | x1]``, returning the concatenation; and
    the two-sided ``block(x0, x1, ...)``, returning ``(y0, y1)``. Both go
    through the differentiable kernel wrappers of ``ops/train_vjp.py`` over
    the concatenation: ``ops/cross_attention.py`` (to_qk / to_v projections,
    one similarity softmaxed along each axis) and ``ops/mlp.py`` over all
    tokens forward, kernels 14 and 15 backward; ``kernels=False`` takes
    their plain versions both ways. ``int8_proj`` and ``int8_mlp`` as in
    :class:`SelfAttentionBlock` (the projections where both sides have at
    most 1024 tokens).
    """

    def __init__(self, feat_dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.to_qk = nn.Linear(feat_dim, hidden_dim)
        self.to_v = nn.Linear(feat_dim, hidden_dim)
        _add_residual_mlp(self, feat_dim, hidden_dim)

    def forward(
        self,
        x: torch.Tensor,
        other: Union[Tuple[int, int], torch.Tensor],
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
        int8_proj: bool = False,
        int8_mlp: bool = False,
        kernels: bool = True,
    ):
        """``other``: the splits ``(n0, n1)`` of the concatenation ``x``, or
        side 1's tokens ``x1`` (then ``x`` is side 0's)."""
        if torch.is_tensor(other):
            n0 = x.shape[1]
            out = self(torch.cat([x, other], dim=1), (n0, other.shape[1]), mask0, mask1,
                       int8_proj, int8_mlp, kernels)
            return out[:, :n0], out[:, n0:]
        b, n, _ = x.shape
        n0, n1 = other
        if n0 + n1 != n:
            raise ValueError(f"splits {tuple(other)} do not sum to {n} tokens")
        biases = (mask_to_bias(mask0, b, n0, x.device), mask_to_bias(mask1, b, n1, x.device))
        args = (*biases, self.head_dim**-0.5, self.num_heads, n0)
        if int8_proj and max(n0, n1) <= 1024:
            _inference_only()
            (wq_qk, ws_qk), (wq_v, ws_v) = _quantized(self, "to_qk", "to_v")
            msg = cross_attention.cross_attention_int8(
                x, wq_qk, ws_qk, self.to_qk.bias, wq_v, ws_v, self.to_v.bias, *args
            )
        else:
            msg = cross_attention_proj(
                x, self.to_qk.weight, self.to_qk.bias, self.to_v.weight, self.to_v.bias, *args,
                kernels,
            )
        return _apply_residual_mlp(self, x, msg, kernels, int8_mlp)


def _add_residual_mlp(block: nn.Module, feat_dim: int, hidden_dim: int) -> None:
    """The flax blocks' message projection and concat-MLP parameters."""
    block.proj = nn.Linear(hidden_dim, hidden_dim)
    block.mlp_0 = nn.Linear(feat_dim + hidden_dim, 2 * feat_dim)
    block.mlp_ln = nn.LayerNorm(2 * feat_dim, eps=1e-6)
    block.mlp_3 = nn.Linear(2 * feat_dim, feat_dim)


def _inference_only() -> None:
    """The int8 kernels have no backward (the JAX package's fail at grad time)."""
    if torch.is_grad_enabled():
        raise RuntimeError("the int8 blocks are inference only: call them under torch.no_grad()")


def _quantized(block: nn.Module, *names: str):
    """``quant_linear`` of the named ``Linear`` weights of ``block``, as the
    block holds them (in its working type), cached on the block until a
    weight changes."""
    cache = block.__dict__.setdefault("_int8_cache", {})
    out = []
    for name in names:
        w = getattr(block, name).weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        hit = cache.get(name)
        if hit is None or hit[0] != key:
            hit = cache[name] = (key, quant_linear(w.detach()))
        out.append(hit[1])
    return out[0] if len(out) == 1 else out


def _apply_residual_mlp(
    block: nn.Module, x: torch.Tensor, msg: torch.Tensor, kernels: bool = True,
    int8_mlp: bool = False,
) -> torch.Tensor:
    """``x + mlp_3(gelu(LN(mlp_0([x, proj(msg)]))))`` through ``ops/mlp.py``."""
    d = x.shape[-1]
    if int8_mlp and mlp.fused_mlp_int8_supported(x.shape[-2], d, 2 * d, x.element_size()):
        _inference_only()
        (wpq, wps), (w0q, w0s), (w3q, w3s) = _quantized(block, "proj", "mlp_0", "mlp_3")
        fn = mlp.residual_mlp_int8 if kernels else mlp.residual_mlp_int8_plain
        return fn(
            x, msg, wpq, wps, block.proj.bias, w0q, w0s, block.mlp_0.bias,
            block.mlp_ln.weight, block.mlp_ln.bias, w3q, w3s, block.mlp_3.bias,
            eps=block.mlp_ln.eps,
        )
    return residual_mlp(
        x, msg, block.proj.weight, block.proj.bias, block.mlp_0.weight,
        block.mlp_0.bias, block.mlp_ln.weight, block.mlp_ln.bias,
        block.mlp_3.weight, block.mlp_3.bias, eps=block.mlp_ln.eps, kernels=kernels,
    )
