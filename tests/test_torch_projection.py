"""The projection passes of kernels 1 and 5 (bf16) and of kernel 17 (s8),
and the plain versions built on them, on the CPU.

- ``project_plain`` in both epilogues (kernel 1's rotary over the q and k
  blocks, kernel 5's plain one split into qk and v) against the route the
  plain versions took before it: ``bf16(x @ W^T + b)``, then the rotary in
  f32 from the bf16 value. Bit for bit: the same operations in the same
  order.
- ``self_attention_plain``, ``self_attention_int8_plain`` and
  ``cross_attention_plain``, rebuilt on ``project_plain``, against their
  earlier inline forms (copied below): bit for bit.
- ``project_int8_plain`` in the same two epilogues against the route the
  int8 plain versions took before it (``bf16((acc * rs) * ws + b)``, then
  the rotary): bit for bit, with a row of zeros (its scale at the 1e-6
  floor) and rows with one large outlier among the tokens; and without
  rotary against the TPU kernels' scratch arithmetic
  (``_self_proj_kernel_i8``): bit for bit.
- Kernels 1 and 5's plain versions, and kernel 17's in both forms (on
  ``project_int8_plain``, with the zero and outlier rows), against the TPU
  kernels (``fused_self_attention_proj`` with splits (128, 256),
  ``fused_cross_attention_proj``, ``int8=True`` for 17) in interpret mode,
  as the JAX package's own tests run them here: b = 2, d = 256, 4 heads,
  inputs from a numpy seed. In f32 within 2e-5 (the 256-term projection
  and the softmax sums in another order; the int8 projection is exact on
  both sides); in bf16 within 2% of the output's scale (both round qkv,
  the rotated q/k and the weights to bf16, and an f32 sum in another
  order moves a value across a rounding boundary now and then: the
  tolerance of the kernels on the card, chip_smoke.py's ATTN_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.attention_pallas import (
    fused_cross_attention_proj,
    fused_self_attention_proj,
    permute_qkv_kernel,
)
from pram_tpu.ops.mlp_pallas import _quant_cols, _quant_rows
from pram_tpu_torch.ops import attention, cross_attention
from pram_tpu_torch.ops.attention import (
    apply_rotary,
    attend_plain,
    mask_to_bias,
    project,
    project_int8,
    project_int8_plain,
    project_plain,
    qkv_block_order,
    split_edges,
)
from pram_tpu_torch.ops.quant import int_matmul, quant_linear, quant_rows

T = torch.from_numpy
D, HEADS, HD = 256, 4, 64


def _inputs(rng, b, n, dtype):
    x = rng.randn(b, n, D).astype(np.float32)
    ang = rng.randn(b, n, HD // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    return T(x).to(dtype), T(cos), T(sin)


def _weights(rng, n_out, dtype):
    w = (rng.randn(n_out, D) / np.sqrt(D)).astype(np.float32)
    b = (rng.randn(n_out) * 0.1).astype(np.float32)
    return T(w).to(dtype), T(b)


def _edge_rows(x):
    """x (numpy [b, n, d]) with frame 0's token 5 all zeros (its row scale at
    the 1e-6 floor) and three tokens carrying one large outlier each, which
    quantizes the rest of their row to a few levels."""
    x = x.copy()
    x[0, 5] = 0.0
    x[0, 9, 17] = 300.0
    x[1, 0, 255] = -1e4
    x[1, 200, 0] = 64.0
    return x


# ---- the earlier inline forms of the plain versions


def _attend_qkv_before(qkv, cos, sin, key_bias, scale, heads, splits):
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    qkv = qkv.reshape(b, n, heads, hd, 3).permute(0, 2, 1, 3, 4)
    q, k, v = qkv.unbind(-1)
    if cos is not None:
        enc = (cos[:, None].float(), sin[:, None].float())
        q = apply_rotary(enc, q.float()).to(dt)
        k = apply_rotary(enc, k.float()).to(dt)
    out = torch.cat(
        [
            attend_plain(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi], key_bias[:, lo:hi], scale)
            for lo, hi in split_edges(splits, n)
        ],
        dim=2,
    )
    return out.permute(0, 2, 1, 3).reshape(b, n, d)


def _self_attention_before(x, w_qkv, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    return _attend_qkv_before(qkv, cos, sin, key_bias, scale, heads, splits)


def _int8_projection_before(x, wq, ws, b):
    xq, xrs = quant_rows(x)
    return ((int_matmul(xq, wq.T) * xrs) * ws.float() + b.float()).to(x.dtype)


def _self_attention_int8_before(x, wq, ws, b_qkv, cos, sin, key_bias, scale, heads, splits=None):
    qkv = _int8_projection_before(x, wq, ws, b_qkv)
    return _attend_qkv_before(qkv, cos, sin, key_bias, scale, heads, splits)


def _cross_attention_int8_before(x_cat, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, bias0, bias1, scale, heads, n0):
    qk = _int8_projection_before(x_cat, wq_qk, ws_qk, b_qk)
    v = _int8_projection_before(x_cat, wq_v, ws_v, b_v)
    b, n, d = qk.shape
    hd = d // heads
    qk = qk.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
    m0 = attend_plain(qk[:, :, :n0], qk[:, :, n0:], v[:, :, n0:], bias1, scale)
    m1 = attend_plain(qk[:, :, n0:], qk[:, :, :n0], v[:, :, :n0], bias0, scale)
    return torch.cat([m0, m1], dim=2).permute(0, 2, 1, 3).reshape(b, n, d)


def _cross_attention_before(x_cat, w_qk, b_qk, w_v, b_v, bias0, bias1, scale, heads, n0):
    dt = x_cat.dtype
    qk = (x_cat.float() @ w_qk.float().T + b_qk.float()).to(dt)
    v = (x_cat.float() @ w_v.float().T + b_v.float()).to(dt)
    b, n, d = qk.shape
    hd = d // heads
    qk = qk.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, n, heads, hd).permute(0, 2, 1, 3)
    m0 = attend_plain(qk[:, :, :n0], qk[:, :, n0:], v[:, :, n0:], bias1, scale)
    m1 = attend_plain(qk[:, :, n0:], qk[:, :, :n0], v[:, :, :n0], bias0, scale)
    return torch.cat([m0, m1], dim=2).permute(0, 2, 1, 3).reshape(b, n, d)


# ---- the projection


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_project_plain_rotary_epilogue(dtype):
    """Kernel 1's epilogue: q and k blocks rotated, v as projected."""
    rng = np.random.RandomState(31)
    x, cos, sin = _inputs(rng, 2, 384, dtype)
    w, b = _weights(rng, 3 * D, dtype)
    got = project_plain(x, w, b, cos, sin, rotary_cols=2 * D)
    y = (x.float() @ w.float().T + b.float()).to(dtype)
    enc = (cos[:, :, None].float(), sin[:, :, None].float())
    qk = apply_rotary(enc, y[..., :2 * D].reshape(2, 384, 8, HD).float()).to(dtype)
    want = torch.cat([qk.reshape(2, 384, 2 * D), y[..., 2 * D:]], -1)
    assert got.dtype == dtype and torch.equal(got, want)
    # the CPU route of the wrapper is the plain version
    assert torch.equal(project(x, w, b, cos, sin, rotary_cols=2 * D), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_project_plain_split_epilogue(dtype):
    """Kernel 5's epilogue: [to_qk | to_v] rows, written as qk and v."""
    rng = np.random.RandomState(32)
    x, _, _ = _inputs(rng, 2, 384, dtype)
    w, b = _weights(rng, 2 * D, dtype)
    qk, v = project(x, w, b, split=D)
    assert qk.shape == v.shape == (2, 384, D)
    assert torch.equal(qk, (x.float() @ w[:D].float().T + b[:D]).to(dtype))
    assert torch.equal(v, (x.float() @ w[D:].float().T + b[D:]).to(dtype))
    assert torch.equal(torch.cat([qk, v], -1), project_plain(x, w, b))


def _int8_case(rng, n_out, dtype):
    x, cos, sin = _inputs(rng, 2, 384, torch.float32)
    x = T(_edge_rows(x.numpy())).to(dtype)
    w, b = _weights(rng, n_out, torch.float32)
    wq, ws = quant_linear(w)
    return x, cos, sin, wq, ws, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_project_int8_plain_rotary_epilogue(dtype):
    """Kernel 17 self-attention's epilogue: q and k blocks rotated."""
    rng = np.random.RandomState(41)
    x, cos, sin, wq, ws, b = _int8_case(rng, 3 * D, dtype)
    got = project_int8_plain(x, wq, ws, b, cos, sin, rotary_cols=2 * D)
    y = _int8_projection_before(x, wq, ws, b)
    enc = (cos[:, :, None].float(), sin[:, :, None].float())
    qk = apply_rotary(enc, y[..., :2 * D].reshape(2, 384, 8, HD).float()).to(dtype)
    want = torch.cat([qk.reshape(2, 384, 2 * D), y[..., 2 * D:]], -1)
    assert got.dtype == dtype and torch.equal(got, want)
    # the zero row projects to the bias alone
    assert torch.equal(got[0, 5, 2 * D:], b[2 * D:].to(dtype))
    assert torch.equal(project_int8(x, wq, ws, b, cos, sin, rotary_cols=2 * D), got)


def test_project_int8_plain_split_epilogue():
    """Kernel 17 cross-attention's epilogue: [to_qk | to_v] rows, written as
    qk and v."""
    rng = np.random.RandomState(42)
    x, _, _, wq, ws, b = _int8_case(rng, 2 * D, torch.bfloat16)
    qk, v = project_int8(x, wq, ws, b, split=D)
    assert qk.shape == v.shape == (2, 384, D)
    assert torch.equal(qk, _int8_projection_before(x, wq[:D], ws[:D], b[:D]))
    assert torch.equal(v, _int8_projection_before(x, wq[D:], ws[D:], b[D:]))
    assert torch.equal(torch.cat([qk, v], -1), project_int8_plain(x, wq, ws, b))


def test_project_int8_plain_equals_pallas_scratch():
    """The s8 projection against _self_proj_kernel_i8's scratch arithmetic
    (_quant_rows, _quant_cols, the s32 product, the f32 dequantization and
    bias, one rounding to bf16), zero and outlier rows included."""
    rng = np.random.RandomState(43)
    x = _edge_rows(rng.randn(2, 384, D).astype(np.float32))
    kernel = (rng.randn(D, 3 * D) / np.sqrt(D)).astype(np.float32)  # flax [in, out]
    bias = (rng.randn(3 * D) * 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jq, jrs = _quant_rows(xj)
    jwq, jws = _quant_cols(jnp.asarray(kernel))
    ref = (jax.lax.dot_general(jq, jwq, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
           .astype(jnp.float32) * jrs * jws + jnp.asarray(bias)).astype(jnp.bfloat16)
    wq, ws = quant_linear(T(kernel.T.copy()))
    got = project_int8_plain(T(x).to(torch.bfloat16), wq, ws, T(bias))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_qkv_block_order_takes_interleaved_rows_to_blocks():
    order = qkv_block_order(8, "cpu")
    assert order.tolist() == [3 * i for i in range(8)] + [3 * i + 1 for i in range(8)] + [
        3 * i + 2 for i in range(8)]
    assert qkv_block_order(8, torch.device("cpu")) is order  # cached


# ---- the plain versions, rebuilt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("splits", [None, (128, 256)])
def test_self_attention_plain_unchanged(dtype, splits):
    rng = np.random.RandomState(33)
    x, cos, sin = _inputs(rng, 2, 384, dtype)
    w, b = _weights(rng, 3 * D, dtype)
    mask = T(rng.rand(2, 384) > 0.2)
    mask[1, :128] = False
    kb = mask_to_bias(mask, 2, 384, "cpu")
    args = (x, w, b, cos, sin, kb, HD**-0.5, HEADS, splits)
    got = attention.self_attention_plain(*args)
    assert torch.equal(got, _self_attention_before(*args))
    assert torch.equal(attention.self_attention(*args), got)
    # without rotary
    args = (x, w, b, None, None, kb, HD**-0.5, HEADS, splits)
    assert torch.equal(attention.self_attention_plain(*args), _self_attention_before(*args))


@pytest.mark.parametrize("splits", [None, (128, 256)])
def test_self_attention_int8_plain_unchanged(splits):
    rng = np.random.RandomState(34)
    x, cos, sin = _inputs(rng, 2, 384, torch.bfloat16)
    w, b = _weights(rng, 3 * D, torch.float32)
    wq, ws = quant_linear(w)
    kb = mask_to_bias(T(rng.rand(2, 384) > 0.2), 2, 384, "cpu")
    args = (x, wq, ws, b, cos, sin, kb, HD**-0.5, HEADS, splits)
    assert torch.equal(attention.self_attention_int8_plain(*args), _self_attention_int8_before(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_attention_plain_unchanged(dtype):
    rng = np.random.RandomState(35)
    n0, n1 = 128, 256
    x, _, _ = _inputs(rng, 2, n0 + n1, dtype)
    (w_qk, b_qk), (w_v, b_v) = _weights(rng, D, dtype), _weights(rng, D, dtype)
    m1 = rng.rand(2, n1) > 0.3
    m1[1] = False
    b0 = mask_to_bias(T(rng.rand(2, n0) > 0.1), 2, n0, "cpu")
    b1 = mask_to_bias(T(m1), 2, n1, "cpu")
    args = (x, w_qk, b_qk, w_v, b_v, b0, b1, HD**-0.5, HEADS, n0)
    got = cross_attention.cross_attention_plain(*args)
    assert torch.equal(got, _cross_attention_before(*args))
    assert torch.equal(cross_attention.cross_attention(*args), got)


def test_cross_attention_int8_plain_unchanged():
    rng = np.random.RandomState(44)
    n0, n1 = 128, 256
    x, _, _ = _inputs(rng, 2, n0 + n1, torch.bfloat16)
    (wq_qk, ws_qk), (wq_v, ws_v) = (quant_linear(_weights(rng, D, torch.float32)[0]) for _ in range(2))
    b_qk, b_v = (_weights(rng, D, torch.float32)[1] for _ in range(2))
    b0 = mask_to_bias(T(rng.rand(2, n0) > 0.1), 2, n0, "cpu")
    b1 = mask_to_bias(T(rng.rand(2, n1) > 0.3), 2, n1, "cpu")
    args = (x, wq_qk, ws_qk, b_qk, wq_v, ws_v, b_v, b0, b1, HD**-0.5, HEADS, n0)
    got = cross_attention.cross_attention_int8_plain(*args)
    assert torch.equal(got, _cross_attention_int8_before(*args))
    assert torch.equal(cross_attention.cross_attention_int8(*args), got)


# ---- against the TPU kernels in interpret mode


def _close(got, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        err = np.abs(got - ref).max()
        assert err <= 0.02 * np.abs(ref).max(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_plain_matches_pallas_interpret(dtype):
    """Kernel 1's plain version, GML's block-diagonal form at (128, 256)."""
    b, splits = 2, (128, 256)
    n = sum(splits)
    rng = np.random.RandomState(36)
    x = rng.randn(b, n, D).astype(np.float32)
    kernel = (rng.randn(D, 3 * D) / np.sqrt(D)).astype(np.float32)
    bias = (rng.randn(3 * D) * 0.1).astype(np.float32)
    ang = rng.randn(b, n, HD // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    mask = rng.rand(b, n) > 0.2
    mask[1, :128] = False  # frame 1's first side is all padding
    key_bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wp, bp = permute_qkv_kernel(jnp.asarray(kernel).astype(jdt), jnp.asarray(bias), HEADS, HD)
    ref = np.asarray(fused_self_attention_proj(
        jnp.asarray(x).astype(jdt), wp, bp, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(key_bias), HD**-0.5, HEADS, splits, interpret=True,
    ).astype(jnp.float32))
    got = attention.self_attention_plain(
        T(x).to(dtype), T(kernel.T.copy()).to(dtype), T(bias), T(cos), T(sin),
        mask_to_bias(T(mask), b, n, "cpu"), HD**-0.5, HEADS, splits,
    ).float().numpy()
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_plain_matches_pallas_interpret(dtype):
    """Kernel 5's plain version with padded masks and one all-masked side."""
    b, n0, n1 = 2, 128, 256
    rng = np.random.RandomState(37)
    x = rng.randn(b, n0 + n1, D).astype(np.float32)
    w_qk, w_v = ((rng.randn(D, D) / np.sqrt(D)).astype(np.float32) for _ in range(2))
    b_qk, b_v = ((rng.randn(D) * 0.1).astype(np.float32) for _ in range(2))
    m0, m1 = rng.rand(b, n0) > 0.15, rng.rand(b, n1) > 0.3
    m0[1] = False
    bias0 = np.where(m0, 0.0, -1e9).astype(np.float32)
    bias1 = np.where(m1, 0.0, -1e9).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(fused_cross_attention_proj(
        jnp.asarray(x).astype(jdt), jnp.asarray(w_qk).astype(jdt), jnp.asarray(b_qk),
        jnp.asarray(w_v).astype(jdt), jnp.asarray(b_v), jnp.asarray(bias0), jnp.asarray(bias1),
        HD**-0.5, HEADS, n0, interpret=True,
    ).astype(jnp.float32))
    got = cross_attention.cross_attention_plain(
        T(x).to(dtype), T(w_qk.T.copy()).to(dtype), T(b_qk), T(w_v.T.copy()).to(dtype), T(b_v),
        T(bias0), T(bias1), HD**-0.5, HEADS, n0,
    ).float().numpy()
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_int8_plain_matches_pallas_interpret(dtype):
    """Kernel 17 self-attention's plain version (project_int8_plain's rotary
    epilogue) against _self_proj_kernel_i8, GML's block-diagonal form at
    (128, 256), zero and outlier rows among the tokens."""
    b, splits = 2, (128, 256)
    n = sum(splits)
    rng = np.random.RandomState(45)
    x = _edge_rows(rng.randn(b, n, D).astype(np.float32))
    kernel = (rng.randn(D, 3 * D) / np.sqrt(D)).astype(np.float32)
    bias = (rng.randn(3 * D) * 0.1).astype(np.float32)
    ang = rng.randn(b, n, HD // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    mask = rng.rand(b, n) > 0.2
    mask[1, :128] = False
    key_bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wp, bp = permute_qkv_kernel(jnp.asarray(kernel), jnp.asarray(bias), HEADS, HD)
    ref = np.asarray(fused_self_attention_proj(
        jnp.asarray(x).astype(jdt), wp, bp, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(key_bias), HD**-0.5, HEADS, splits, int8=True, interpret=True,
    ).astype(jnp.float32))
    wq, ws = quant_linear(T(kernel.T.copy()))
    got = attention.self_attention_int8_plain(
        T(x).to(dtype), wq, ws, T(bias), T(cos), T(sin), mask_to_bias(T(mask), b, n, "cpu"),
        HD**-0.5, HEADS, splits,
    ).float().numpy()
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_int8_plain_matches_pallas_interpret(dtype):
    """Kernel 17 cross-attention's plain version (project_int8_plain twice)
    against _cross_proj_kernel_i8, zero and outlier rows among the tokens and
    an all-masked side."""
    b, n0, n1 = 2, 128, 256
    rng = np.random.RandomState(46)
    x = _edge_rows(rng.randn(b, n0 + n1, D).astype(np.float32))
    w_qk, w_v = ((rng.randn(D, D) / np.sqrt(D)).astype(np.float32) for _ in range(2))
    b_qk, b_v = ((rng.randn(D) * 0.1).astype(np.float32) for _ in range(2))
    m0, m1 = rng.rand(b, n0) > 0.15, rng.rand(b, n1) > 0.3
    m0[1] = False
    bias0 = np.where(m0, 0.0, -1e9).astype(np.float32)
    bias1 = np.where(m1, 0.0, -1e9).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(fused_cross_attention_proj(
        jnp.asarray(x).astype(jdt), *(jnp.asarray(a) for a in (w_qk, b_qk, w_v, b_v, bias0, bias1)),
        HD**-0.5, HEADS, n0, int8=True, interpret=True,
    ).astype(jnp.float32))
    (wq_qk, ws_qk), (wq_v, ws_v) = quant_linear(T(w_qk.T.copy())), quant_linear(T(w_v.T.copy()))
    got = cross_attention.cross_attention_int8_plain(
        T(x).to(dtype), wq_qk, ws_qk, T(b_qk), wq_v, ws_v, T(b_v), T(bias0), T(bias1),
        HD**-0.5, HEADS, n0,
    ).float().numpy()
    _close(got, ref, dtype)
