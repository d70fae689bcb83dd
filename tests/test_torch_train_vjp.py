"""Gradients of the port's fused kernels against pram_tpu on the CPU.

The JAX side runs as tests/test_train_vjp.py runs it: the backward Pallas
kernels in interpret mode (``_INTERPRET`` patched), the forward through the
XLA reference. Both sides get the same numpy-seeded inputs.

- The plain versions of kernels 13, 14 and 15 against
  ``fused_*_bwd(..., interpret=True)`` in f32, within 1e-5 of each
  output's scale: the same arithmetic, summed in another order. For 13
  and 14 also on the CUDA kernels' edge cases (unequal sides, a fully
  masked side), since the plain versions are the kernels' oracle on the
  card.
- The ``torch.autograd.Function`` s against ``jax.vjp`` of
  ``pram_tpu.ops.train_vjp``, the weights carried between the flax layout
  (and the JAX kernel's permuted qkv) and the port's: in f32 within 1e-5
  of each gradient's scale; in bf16 within 3e-2 of the f32 gradient's
  scale, the bound tests/test_train_vjp.py holds the JAX bf16 backward to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops import attention_bwd_pallas as abp
from pram_tpu.ops import mlp_bwd_pallas as mbp
from pram_tpu.ops import train_vjp as jvjp
from pram_tpu.ops.attention_pallas import permute_qkv_kernel
from pram_tpu_torch.ops import attention_bwd, mlp_bwd
from pram_tpu_torch.ops import train_vjp as tvjp

B, HEADS, HD = 2, 4, 64
D = HEADS * HD
SCALE = HD**-0.5
T = torch.from_numpy


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("PRAM_ATTN_BWD", "1")
    monkeypatch.setenv("PRAM_MLP_BWD", "1")
    monkeypatch.setattr(abp, "_INTERPRET", True)
    monkeypatch.setattr(mbp, "_INTERPRET", True)


def _close(got, ref, tol, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{name}: {err} vs scale {np.abs(ref).max()}"


def _bias(rng, *shape):
    return np.where(rng.rand(*shape) < 0.2, -1e9, 0.0).astype(np.float32)


def _to_permuted(qkv):
    """Port qkv columns (h * hd + i) * 3 + c -> the TPU kernel's [q | k | v]."""
    lead = qkv.shape[:-1]
    return qkv.reshape(*lead, HEADS, HD, 3).swapaxes(-1, -2).swapaxes(-2, -3).reshape(*lead, 3 * D)


def _from_permuted(qkv):
    lead = qkv.shape[:-1]
    return np.asarray(qkv).reshape(*lead, 3, HEADS, HD).transpose(
        *range(len(lead)), len(lead) + 1, len(lead) + 2, len(lead)
    ).reshape(*lead, 3 * D)


def _self_bwd_matches_pallas(splits, masked=False):
    rng = np.random.RandomState(0)
    n = sum(splits)
    qkv = rng.randn(B, n, 3 * D).astype(np.float32) * 0.5
    cos, sin = rng.rand(B, n, HD).astype(np.float32), rng.rand(B, n, HD).astype(np.float32)
    bias, g = _bias(rng, B, n), rng.randn(B, n, D).astype(np.float32)
    if masked:  # a fully masked side: uniform weights over its keys
        bias[1, :splits[0]] = -1e9
    ref = abp.fused_self_attention_bwd(
        jnp.asarray(_to_permuted(qkv)), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(bias),
        jnp.asarray(g), SCALE, HEADS, splits, interpret=True,
    )
    got = attention_bwd.self_attention_bwd(T(qkv), T(cos), T(sin), T(bias), T(g), SCALE, HEADS, splits)
    _close(got[0].numpy(), _from_permuted(ref[0]), 1e-5, "dqkv")
    for name, a, r in zip(("dcos", "dsin", "dbias"), got[1:], ref[1:]):
        _close(a.numpy(), r, 1e-5, name)


@pytest.mark.parametrize("splits", [(64,), (32, 32)])
def test_self_attention_bwd_plain_matches_pallas(splits):
    _self_bwd_matches_pallas(splits)


@pytest.mark.parametrize("splits,masked", [((16, 48), False), ((16, 48), True), ((64,), True)])
def test_self_attention_bwd_plain_matches_pallas_edges(splits, masked):
    """The CUDA kernel's oracle on its edge cases, at the test's width:
    unequal sides (the card's (64, 192)) and a fully masked side."""
    _self_bwd_matches_pallas(splits, masked)


def _cross_bwd_matches_pallas(n0, n1, masked_side=1):
    rng = np.random.RandomState(1)
    n = n0 + n1
    qk = rng.randn(B, n, D).astype(np.float32) * 0.5
    v, g = rng.randn(B, n, D).astype(np.float32), rng.randn(B, n, D).astype(np.float32)
    b0, b1 = _bias(rng, B, n0), _bias(rng, B, n1)
    (b0, b1)[masked_side][1] = -1e9  # an all-masked key side
    args = (qk, v, b0, b1, g)
    ref = abp.fused_cross_attention_bwd(*(jnp.asarray(a) for a in args), SCALE, HEADS, n0, interpret=True)
    got = attention_bwd.cross_attention_bwd(*(T(a) for a in args), SCALE, HEADS, n0)
    for name, a, r in zip(("dqk", "dv", "db0", "db1"), got, ref):
        _close(a.numpy(), r, 1e-5, name)


def test_cross_attention_bwd_plain_matches_pallas():
    _cross_bwd_matches_pallas(32, 64)


@pytest.mark.parametrize("n0,n1,masked_side", [(64, 32, 0), (16, 48, 0), (48, 16, 1)])
def test_cross_attention_bwd_plain_matches_pallas_edges(n0, n1, masked_side):
    """The CUDA kernel's oracle with n0 != n1 both ways and either side
    fully masked."""
    _cross_bwd_matches_pallas(n0, n1, masked_side)


def _mlp_weights(rng, d=D, dh=2 * D):
    """flax-layout weights of the residual MLP: wp [d, d], w0 [2d, dh], w3 [dh, d]."""
    def w(*s):
        return (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)

    return dict(
        wp=w(d, d), bp=w(d) * 0.1, w0=w(2 * d, dh), b0=w(dh) * 0.1,
        g=(1.0 + w(dh) * 0.1), be=w(dh) * 0.1, w3=w(dh, d), b3=w(d) * 0.1,
    )


def test_mlp_bwd_plain_matches_pallas():
    """Two batch frames of 64 tokens (two TPU grid steps, four token tiles
    of the CUDA kernel)."""
    rng = np.random.RandomState(2)
    n = 64
    x, pm, ct = (rng.randn(B, n, D).astype(np.float32) for _ in range(3))
    p = _mlp_weights(rng)
    ref = mbp.fused_residual_mlp_bwd(
        *(jnp.asarray(a) for a in (x, pm, p["w0"], p["b0"], p["g"], p["be"], p["w3"], ct)),
        interpret=True,
    )
    dx, dpm, dw0, db0, dg, dbe, dw3, db3 = mlp_bwd.residual_mlp_bwd(
        T(x), T(pm), T(ct), T(p["w0"].T.copy()), T(p["b0"]), T(p["g"]), T(p["be"]),
        T(p["w3"].T.copy()),
    )
    got = dict(dx=dx, dpm=dpm, dw0x=dw0[:, :D].T, dw0m=dw0[:, D:].T, db0=db0, dg=dg, dbe=dbe,
               dw3=dw3.T, db3=db3)
    for name, r in zip(("dx", "dpm", "dw0x", "dw0m", "db0", "dg", "dbe", "dw3", "db3"), ref):
        _close(got[name].numpy(), r, 1e-5, name)


def _grads(fn, args, ct, dtype, keep_f32=()):
    """Gradients of sum(fn(*args) * ct) w.r.t. every argument, as f32 numpy;
    the arguments are cast to ``dtype`` except those at ``keep_f32`` (the
    rotary tables and key biases, f32 in either working type)."""
    leaves = [
        (T(a) if i in keep_f32 else T(a).to(dtype)).requires_grad_()
        for i, a in enumerate(args)
    ]
    (fn(*leaves).float() * T(ct)).sum().backward()
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("splits", [(64,), (32, 32)])
def test_self_attention_function_matches_jax_vjp(splits, dtype, tol):
    rng = np.random.RandomState(3)
    n = sum(splits)
    x = rng.randn(B, n, D).astype(np.float32)
    kernel = (rng.randn(D, 3 * D) * D**-0.5).astype(np.float32)  # flax layout
    bias = (rng.randn(3 * D) * 0.1).astype(np.float32)
    ang = rng.randn(B, n, HD // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    kb, ct = _bias(rng, B, n), rng.randn(B, n, D).astype(np.float32)

    wp, bp = permute_qkv_kernel(jnp.asarray(kernel), jnp.asarray(bias), HEADS, HD)
    _, vjp = jax.vjp(
        lambda *a: jvjp.self_attention_proj(*a, SCALE, HEADS, splits, True),
        jnp.asarray(x), wp, bp, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kb),
    )
    gx, gwp, gbp, gcos, gsin, gkb = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    gk = _from_permuted(gwp)  # back to the flax kernel's columns
    gb = _from_permuted(gbp)

    got = _grads(
        lambda *a: tvjp.self_attention_proj(*a, SCALE, HEADS, splits),
        (x, kernel.T.copy(), bias, cos, sin, kb), ct, dtype, keep_f32=(3, 4, 5),
    )
    for name, a, r in zip(("x", "w_qkv", "b_qkv", "cos", "sin", "key_bias"),
                          got, (gx, gk.T, gb, gcos, gsin, gkb)):
        _close(a, r, tol, name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_cross_attention_function_matches_jax_vjp(dtype, tol):
    rng = np.random.RandomState(4)
    n0, n1 = 32, 64
    n = n0 + n1
    cat = rng.randn(B, n, D).astype(np.float32)

    def w(*s):
        return (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)

    wqk, bqk, wv, bv = w(D, D), w(D) * 0.1, w(D, D), w(D) * 0.1
    b0, b1, ct = _bias(rng, B, n0), _bias(rng, B, n1), rng.randn(B, n, D).astype(np.float32)
    args = (cat, wqk, bqk, wv, bv, b0, b1)
    _, vjp = jax.vjp(
        lambda *a: jvjp.cross_attention_proj(*a, SCALE, HEADS, n0), *(jnp.asarray(a) for a in args)
    )
    ref = [np.asarray(a) for a in vjp(jnp.asarray(ct))]
    ref[1], ref[3] = ref[1].T, ref[3].T  # flax [in, out] -> torch [out, in]
    got = _grads(
        lambda *a: tvjp.cross_attention_proj(*a, SCALE, HEADS, n0),
        (cat, wqk.T.copy(), bqk, wv.T.copy(), bv, b0, b1), ct, dtype, keep_f32=(5, 6),
    )
    for name, a, r in zip(("x_cat", "w_qk", "b_qk", "w_v", "b_v", "bias0", "bias1"), got, ref):
        _close(a, r, tol, name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_residual_mlp_function_matches_jax_vjp(dtype, tol):
    rng = np.random.RandomState(5)
    n = 64
    x, msg, ct = (rng.randn(B, n, D).astype(np.float32) for _ in range(3))
    p = _mlp_weights(rng)
    order = ("wp", "bp", "w0", "b0", "g", "be", "w3", "b3")
    _, vjp = jax.vjp(jvjp.residual_mlp, jnp.asarray(x), jnp.asarray(msg),
                     *(jnp.asarray(p[k]) for k in order))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(ct))]
    for i in (2, 4, 8):  # wp, w0, w3: flax [in, out] -> torch [out, in]
        ref[i] = ref[i].T
    torch_args = [x, msg] + [p[k].T.copy() if p[k].ndim == 2 else p[k] for k in order]
    got = _grads(lambda *a: tvjp.residual_mlp(*a), torch_args, ct, dtype)
    for name, a, r in zip(("x", "msg") + order, got, ref):
        _close(a, r, tol, name)
