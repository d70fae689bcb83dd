"""Gradients through the fused attention and MLP kernels
(pram_tpu/ops/train_vjp.py).

Three ``torch.autograd.Function`` s. Each forward is the fused kernel:
``ops/attention.py`` (kernel 1), ``ops/cross_attention.py`` (kernel 5),
``ops/mlp.py`` (kernel 2); each takes ``kernels=False`` for its plain
versions, forward and backward (the models' A/B switch). Each
saves its inputs, no ``[B, H, N, N]`` tensor, and its backward recomputes
the projection the kernel made inside (a plain matrix product), calls the
backward kernel (``ops/attention_bwd.py`` kernels 13 and 14,
``ops/mlp_bwd.py`` kernel 15, or their plain versions) and maps its
outputs back through the projection with matrix products. A CPU tensor
takes the plain versions, forward and backward, as the wrappers do.

Under ``torch.no_grad`` a Function saves nothing, so serving runs the same
route at no cost.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pram_tpu_torch.ops import attention, attention_bwd, cross_attention, mlp, mlp_bwd


def _project_back(dproj, x, w, b):
    """(dx, dw, db) of ``proj = x w^T + b`` for the cotangent ``dproj``, in
    the operands' types (products accumulate in f32)."""
    d_in, d_out = x.shape[-1], dproj.shape[-1]
    dx = dproj @ w.to(dproj.dtype)
    dw = dproj.reshape(-1, d_out).T @ x.reshape(-1, d_in).to(dproj.dtype)
    db = dproj.float().sum(dim=tuple(range(dproj.dim() - 1)))
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


class SelfAttentionProj(torch.autograd.Function):
    """Messages of ``self_attention`` (qkv projection, rotary, masked
    block-diagonal attention); gradients for x, the projection, cos/sin
    (they carry the gradient to the Fourier encoding) and the key bias."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits, kernels):
        ctx.save_for_backward(x, w_qkv, b_qkv, cos, sin, key_bias)
        ctx.config = (scale, heads, splits, kernels)
        fn = attention.self_attention if kernels else attention.self_attention_plain
        return fn(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits)

    @staticmethod
    def backward(ctx, g):
        x, w, b, cos, sin, key_bias = ctx.saved_tensors
        scale, heads, splits, kernels = ctx.config
        qkv = F.linear(x, w.to(x.dtype), b.to(x.dtype)).contiguous()
        fn = attention_bwd.self_attention_bwd if kernels else attention_bwd.self_attention_bwd_plain
        dqkv, dcos, dsin, dbias = fn(
            qkv, cos, sin, key_bias, g.to(x.dtype).contiguous(), scale, heads, splits
        )
        dx, dw, db = _project_back(dqkv, x, w, b)
        if cos is not None:
            dcos, dsin = dcos.to(cos.dtype), dsin.to(sin.dtype)
        return dx, dw, db, dcos, dsin, dbias.to(key_bias.dtype), None, None, None, None


class CrossAttentionProj(torch.autograd.Function):
    """Messages of ``cross_attention`` (shared to_qk / to_v projections,
    symmetric attention of the two sides); gradients for the token
    concatenation, both projections and both key biases."""

    @staticmethod
    def forward(ctx, x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0, kernels):
        ctx.save_for_backward(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1)
        ctx.config = (scale, heads, n0, kernels)
        fn = cross_attention.cross_attention if kernels else cross_attention.cross_attention_plain
        return fn(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0)

    @staticmethod
    def backward(ctx, g):
        x, w_qk, b_qk, w_v, b_v, bias0, bias1 = ctx.saved_tensors
        scale, heads, n0, kernels = ctx.config
        dt = x.dtype
        qk = F.linear(x, w_qk.to(dt), b_qk.to(dt)).contiguous()
        v = F.linear(x, w_v.to(dt), b_v.to(dt)).contiguous()
        fn = attention_bwd.cross_attention_bwd if kernels else attention_bwd.cross_attention_bwd_plain
        dqk, dv, db0, db1 = fn(qk, v, bias0, bias1, g.to(dt).contiguous(), scale, heads, n0)
        dx_qk, dw_qk, db_qk = _project_back(dqk, x, w_qk, b_qk)
        dx_v, dw_v, db_v = _project_back(dv, x, w_v, b_v)
        dx = (dx_qk.float() + dx_v.float()).to(dt)
        return (dx, dw_qk, db_qk, dw_v, db_v, db0.to(bias0.dtype), db1.to(bias1.dtype),
                None, None, None, None)


class ResidualMLP(torch.autograd.Function):
    """``x + mlp_3(gelu(LN(mlp_0([x, proj(msg)]))))``; gradients for x, msg
    and every weight, the LayerNorm's included."""

    @staticmethod
    def forward(ctx, x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps, kernels):
        ctx.save_for_backward(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3)
        ctx.config = (eps, kernels)
        fn = mlp.residual_mlp if kernels else mlp.residual_mlp_plain
        return fn(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=eps)

    @staticmethod
    def backward(ctx, ct):
        x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3 = ctx.saved_tensors
        eps, kernels = ctx.config
        dt = x.dtype
        pm = F.linear(msg, wp.to(dt), bp.to(dt)).contiguous()
        fn = mlp_bwd.residual_mlp_bwd if kernels else mlp_bwd.residual_mlp_bwd_plain
        dx, dpm, dw0, db0, dln_w, dln_b, dw3, db3 = fn(
            x, pm, ct.to(dt).contiguous(), w0.to(dt), b0, ln_w, ln_b, w3.to(dt), eps
        )
        dmsg, dwp, dbp = _project_back(dpm, msg, wp, bp)
        return (
            dx, dmsg, dwp, dbp, dw0.to(w0.dtype), db0.to(b0.dtype), dln_w.to(ln_w.dtype),
            dln_b.to(ln_b.dtype), dw3.to(w3.dtype), db3.to(b3.dtype), None, None,
        )


def self_attention_proj(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None, kernels=True):
    """Differentiable :func:`ops.attention.self_attention`."""
    return SelfAttentionProj.apply(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits, kernels)


def cross_attention_proj(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0, kernels=True):
    """Differentiable :func:`ops.cross_attention.cross_attention`."""
    return CrossAttentionProj.apply(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0, kernels)


def residual_mlp(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6, kernels=True):
    """Differentiable :func:`ops.mlp.residual_mlp`."""
    return ResidualMLP.apply(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps, kernels)
