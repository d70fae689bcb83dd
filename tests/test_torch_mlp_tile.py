"""The epilogue arithmetic of the residual-MLP tile (csrc/mlp_tile.cuh,
kernels 2 and 16), mirrored in numpy on the CPU.

The tile splits a 64-token block's 512 hidden columns between two
warpgroups (256 each). LayerNorm's statistics are summed by each thread over
its 64 columns of a row in column order (columns 256 g + 8 j + 2 l + e, j <
32, e < 2, for quad lane l), over the quad as ((s0 + s1) + (s2 + s3)), then
as warpgroup 0's + warpgroup 1's; mu = sum / 512, the centred squares the
same way, inv = RN(1 / sqrt(var + eps)), hn = ((h - mu) * inv) * ln_w +
ln_b, GELU = (hn * 0.5) * (1 + erf(hn * sqrt(1/2))), every operation
rounded to f32 once. The s8 instance quantizes the GELU output per row with
the row's max |GELU| exchanged between the halves, by the magic-number
rounding (q + 1.5 * 2^23 holds q in its low byte). The products around it
are the plain versions' here.

Tolerances:
- the two-half statistics against float64 mean and variance: within 1e-6
  relative (f32 sums of 512 terms);
- the magic-number quantizer: bit-equal to round-half-even, on every GELU
  value and on exact .5 ties;
- the mirrored MLP against ``residual_mlp_plain`` / ``residual_mlp_int8_plain``
  (torch's layer_norm sums in another order and its erf differs by an ulp,
  so a GELU value now and then rounds to the neighbouring bf16 value or s8
  step): within 5e-3 of the output's scale (2.7e-3 seen), >= 99% of the
  elements equal;
- against the Pallas kernels in interpret mode (pram_tpu/ops/mlp_pallas.py,
  d = 256, bf16), whose statistics and products are summed in yet another
  order: within 2e-2 of scale (chip_smoke.py's MLP_TOL / INT8_TOL; 6e-3
  seen in s8, as for the plain version), >= 98% equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pram_tpu.ops.mlp_pallas as jmp
from pram_tpu_torch.ops import mlp
from pram_tpu_torch.ops.quant import int_matmul, quant_linear, quant_rows

f32 = np.float32
MAGIC = f32(12582912.0)  # 1.5 * 2^23
MAGIC_BITS = 0x4B400000
D, DH = 256, 512


def _cols():
    """[g, j, l, e] -> hidden column 256 g + 8 j + 2 l + e."""
    g, j, l, e = np.meshgrid(np.arange(2), np.arange(32), np.arange(4), np.arange(2), indexing="ij")
    return 256 * g + 8 * j + 2 * l + e


def _row_sum(v):
    """The tile's sum of each row of v [rows, 512] f32: threads in column
    order, the quad, then warpgroup 0's + 1's."""
    cols = _cols()
    s = np.zeros((v.shape[0], 2, 4), f32)
    for j in range(32):
        for e in range(2):
            s = (s + v[:, cols[:, j, :, e]]).astype(f32)
    quad = ((s[..., 0] + s[..., 1]).astype(f32) + (s[..., 2] + s[..., 3]).astype(f32)).astype(f32)
    return (quad[:, 0] + quad[:, 1]).astype(f32)


def tile_stats(h, eps):
    """(mu, inv, centred h) of h [rows, 512] f32 in the tile's arithmetic."""
    mu = (_row_sum(h) * f32(1.0 / DH)).astype(f32)
    d = (h - mu[:, None]).astype(f32)
    var = (_row_sum((d * d).astype(f32)) * f32(1.0 / DH)).astype(f32)
    inv = (1.0 / np.sqrt((var + f32(eps)).astype(f32).astype(np.float64))).astype(f32)
    return mu, inv, d


def tile_layer_norm_gelu(h, ln_w, ln_b, eps):
    """The tile's LayerNorm and GELU of h [rows, 512] f32."""
    _, inv, d = tile_stats(h, eps)
    hn = ((((d * inv[:, None]).astype(f32)) * ln_w).astype(f32) + ln_b).astype(f32)
    arg = (hn * f32(0.70710678118654752)).astype(f32)
    erf = np.vectorize(math.erf)(arg.astype(np.float64)).astype(f32)
    return ((hn * f32(0.5)).astype(f32) * (f32(1.0) + erf).astype(f32)).astype(f32)


def tile_quant_rows(g):
    """The s8 GELU quantizer: the row max of |g| over both halves, rs =
    max(m, 1e-6) / 127 and 1 / rs by true f32 divisions, q from the low bits
    of RN(g * (1 / rs)) + 1.5 * 2^23."""
    m = np.maximum(np.abs(g[:, :256]).max(1), np.abs(g[:, 256:]).max(1))
    rs = (np.maximum(m, f32(1e-6)) / f32(127.0)).astype(f32)
    inv = (f32(1.0) / rs).astype(f32)
    bits = ((g * inv[:, None]).astype(f32) + MAGIC).astype(f32).view(np.int32)
    return (bits - MAGIC_BITS).astype(f32), rs[:, None]


def _case(seed, rows, scale_msg=0.3):
    rng = np.random.RandomState(seed)

    def t(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(f32)

    return dict(
        x=t(rows, D), msg=t(rows, D, scale=scale_msg), wp=t(D, D, scale=D ** -0.5), bp=t(D, scale=0.1),
        w0=t(DH, 2 * D, scale=(2 * D) ** -0.5), b0=t(DH, scale=0.1), ln_w=1.0 + t(DH, scale=0.1),
        ln_b=t(DH, scale=0.1), w3=t(D, DH, scale=DH ** -0.5), b3=t(D, scale=0.1),
    )


def _bf16_args(c):
    bf = torch.bfloat16
    return (torch.from_numpy(c["x"]).to(bf), torch.from_numpy(c["msg"]).to(bf), torch.from_numpy(c["wp"]).to(bf),
            torch.from_numpy(c["bp"]), torch.from_numpy(c["w0"]).to(bf), torch.from_numpy(c["b0"]),
            torch.from_numpy(c["ln_w"]), torch.from_numpy(c["ln_b"]), torch.from_numpy(c["w3"]).to(bf),
            torch.from_numpy(c["b3"]))


def mirror_bf16(x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, eps=1e-6):
    """Kernel 2 with the tile's epilogue arithmetic (products as the plain
    version computes them)."""
    dt = x.dtype
    pm = (msg.float() @ wp.float().T + bp).to(dt)
    h = torch.cat([x, pm], -1).float() @ w0.float().T + b0
    g = tile_layer_norm_gelu(h.numpy(), ln_w.numpy(), ln_b.numpy(), eps)
    y = torch.from_numpy(g).to(dt)
    return x + (y.float() @ w3.float().T + b3).to(dt)


def mirror_int8(x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, eps=1e-6):
    """Kernel 16 with the tile's epilogue arithmetic: msg, x and proj(msg)
    quantized as the plain version does (the tile's quant_tile_rows is
    bit-equal to it), the two-half LayerNorm, GELU and quantizer."""
    dt = x.dtype
    mq, mrs = quant_rows(msg)
    pm = ((int_matmul(mq, wpq.T) * mrs) * wps + bp).to(dt)
    xq, xrs = quant_rows(x)
    pq, prs = quant_rows(pm)
    h = (int_matmul(xq, w0q[:, :D].T) * xrs + int_matmul(pq, w0q[:, D:].T) * prs) * w0s + b0
    g = tile_layer_norm_gelu(h.numpy(), ln_w.numpy(), ln_b.numpy(), eps)
    yq, yrs = tile_quant_rows(g)
    o = (int_matmul(torch.from_numpy(yq), w3q.T) * torch.from_numpy(yrs)) * w3s + b3
    return x + o.to(dt)


def _int8_args(c):
    a = _bf16_args(c)
    (wpq, wps), (w0q, w0s), (w3q, w3s) = (quant_linear(w) for w in (a[2], a[4], a[8]))
    return (a[0], a[1], wpq, wps, a[3], w0q, w0s, a[5], a[6], a[7], w3q, w3s, a[9])


def _scaled(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item(), (got == ref).float().mean().item()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_half_statistics_match_float64(seed):
    rng = np.random.RandomState(seed)
    h = (rng.randn(64, DH) * rng.uniform(0.1, 4.0, (64, 1)) + rng.randn(64, 1)).astype(f32)
    mu, inv, _ = tile_stats(h, 1e-6)
    h64 = h.astype(np.float64)
    np.testing.assert_allclose(mu, h64.mean(1), rtol=1e-6, atol=1e-6 * np.abs(h64).max())
    np.testing.assert_allclose(inv, 1.0 / np.sqrt(h64.var(1) + 1e-6), rtol=1e-6)


def test_magic_quantizer_rounds_half_to_even():
    g = tile_layer_norm_gelu(*(np.asarray(v, f32) for v in (
        np.random.RandomState(3).randn(64, DH) * 2.0, np.ones(DH), np.zeros(DH))), 1e-6)
    q, rs = tile_quant_rows(g)
    np.testing.assert_array_equal(q, np.round((g * (f32(1.0) / rs)).astype(f32)))
    # exact ties, both signs, and the row max itself
    v = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0] + [0.0] * (DH - 8)], f32)
    qv, rv = tile_quant_rows(v)
    assert rv[0, 0] == f32(1.0)
    np.testing.assert_array_equal(qv[0, :8], [0, 2, 2, 0, -2, -2, 126, 127])


@pytest.mark.parametrize("rows", [96, 256])
def test_mirror_bf16_matches_plain(rows):
    a = _bf16_args(_case(rows, rows))
    err, equal = _scaled(mirror_bf16(*a), mlp.residual_mlp_plain(*a))
    assert err <= 5e-3 and equal >= 0.99


@pytest.mark.parametrize("rows", [96, 256])
def test_mirror_int8_matches_plain(rows):
    a = _int8_args(_case(rows + 1, rows))
    err, equal = _scaled(mirror_int8(*a), mlp.residual_mlp_int8_plain(*a))
    assert err <= 5e-3 and equal >= 0.99


def _jax_args(c, dtype):
    """The case in the JAX layout ([in, out] weights, [B, N, d] tokens)."""
    j = {k: jnp.asarray(v) for k, v in c.items()}
    return (j["x"].reshape(2, -1, D).astype(dtype), j["msg"].reshape(2, -1, D).astype(dtype),
            j["wp"].T.astype(dtype), j["bp"], j["w0"].T.astype(dtype), j["b0"], j["ln_w"], j["ln_b"],
            j["w3"].T.astype(dtype), j["b3"])


def test_mirror_bf16_matches_pallas():
    c = _case(7, 256)
    ref = jmp.fused_residual_mlp(*_jax_args(c, jnp.bfloat16), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(256, D)
    err, equal = _scaled(mirror_bf16(*_bf16_args(c)), ref)
    assert err <= 2e-2 and equal >= 0.98


def test_mirror_int8_matches_pallas():
    c = _case(8, 256)
    ref = jmp.fused_residual_mlp_int8(*_jax_args(c, jnp.bfloat16), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(256, D)
    err, equal = _scaled(mirror_int8(*_int8_args(c)), ref)
    assert err <= 2e-2 and equal >= 0.98
