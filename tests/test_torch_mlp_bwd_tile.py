"""Kernel 15's arithmetic (csrc/mlp_bwd.cu: the token pass, the split-K
weight-gradient pass and the reduction), mirrored in numpy on the CPU.

The token pass works on 64-token tiles (the last one zero-filled past the
tokens) whose 512 hidden columns two warpgroups split (256 each):
- LayerNorm's statistics as the forward tile sums them (each thread over its
  64 columns of a row in column order, the quad, then warpgroup 0's + 1's:
  tests/test_torch_mlp_tile.py's tile_stats); hhat = (h - mu) * inv;
- z = hhat gamma + beta (an fma); Phi and phi of the GELU's derivative
  from one exponential E = 2^(z^2 (-log2(e) / 2)): phi = E / sqrt(2 pi),
  Phi by erf's Abramowitz & Stegun 7.1.26 (t = 1 / (1 + p |z| / sqrt 2),
  erfc = t (a1 + t (a2 + ...)) E by fmas); y = bf16(z Phi);
- dz = dy (Phi + z phi) (an fma inside), dhhat = dz gamma; the row sums of dhhat and dhhat
  hhat in the same order as LayerNorm's, divided by 512;
- dh = ((dhhat - mean) - hhat mean(dhhat hhat)) * inv, rounded to bf16 for
  its products (dx, dpm, dW0);
- the column sums of dz hhat, dz and dh: each thread adds its two rows (r
  and r + 8), the warp's 8 row groups meet pairwise (a tree of shuffles),
  the 4 warps of a tile in order, and the reduction adds tiles w, w + 8,
  ... in order for w < 8, then the 8 sums in order; ct's column sums the
  same with each tile's 64 rows added in order;
- dW0 and dW3 summed over 64-token blocks within each of min(11, tiles)
  contiguous splits, then the splits in order.
The products are computed as the plain version computes them (f32 sums of
the rounded operands).

Tolerances (chip_smoke.py's BWD_TOL, BWD_F32_TOL):
- in bf16, the mirror against ``residual_mlp_bwd_plain`` and the Pallas
  kernel in interpret mode: the bf16 outputs (dx, dpm) within 2e-2 of
  their scale (seen: up to 1.7e-3 against the plain version, 3.7e-3
  against Pallas), the f32 gradients within 1e-2 (seen: 2.9e-4, 4.1e-4);
- in f32, against the plain version, every output within 1e-5 of its
  scale, as tests/test_torch_train_vjp.py holds the plain version to the
  Pallas kernel (seen: 6.8e-7);
- Phi by A & S against math.erf's: within 3e-7 absolute (A & S's 1.5e-7
  in erf is 7.5e-8 in Phi, and the f32 steps round to 6e-8 each near 1;
  seen 2.2e-7); the two-half row means and the tree-ordered column
  sums against float64: within 1e-6 relative of the scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops import mlp_bwd_pallas as mbp
from pram_tpu_torch.ops import mlp_bwd
from test_torch_mlp_tile import _row_sum, tile_stats

f32 = np.float32
D, DH, TILE = 256, 512, 64
INV_SQRT2 = f32(0.70710678118654752)
INV_SQRT_2PI = f32(0.3989422804014327)
NEG_HALF_LOG2E = f32(-0.72134752044448170)
AS_P = f32(0.3275911)
AS_A = [f32(v) for v in (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)]
T = torch.from_numpy


def _round(a, dt):
    """a rounded to torch dtype dt (None: left f32)."""
    return a if dt is None else T(np.ascontiguousarray(a)).to(dt).float().numpy()


def _mm(a, b):
    """An f32 product as the plain version computes it."""
    return (T(np.ascontiguousarray(a)) @ T(np.ascontiguousarray(b))).numpy()


def _fma(a, b, c):
    """f32 fma: the exact product and sum in float64, rounded once (but for
    rare double roundings)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(f32)


def gelu_parts(z):
    """(Phi, phi) of z f32 in the kernel's arithmetic."""
    e = np.exp2(((z * z).astype(f32) * NEG_HALF_LOG2E).astype(f32).astype(np.float64)).astype(f32)
    t = (f32(1.0) / _fma(f32(AS_P * INV_SQRT2), np.abs(z), f32(1.0))).astype(f32)
    q = _fma(AS_A[4], t, AS_A[3])
    for a in AS_A[2::-1]:
        q = _fma(q, t, a)
    half_erfc = ((q * t).astype(f32) * (e * f32(0.5)).astype(f32)).astype(f32)
    phi_big = np.where(z >= 0, (f32(1.0) - half_erfc).astype(f32), half_erfc)
    return phi_big, (e * INV_SQRT_2PI).astype(f32)


def warp_tree(v):
    """Column sums of a tile's rows v [64, C] in the kernel's order: [4, C],
    one a warp (rows 16 w ..): a thread's rows r and r + 8, then the row
    groups pairwise."""
    out = []
    for w in range(4):
        rows = v[16 * w:16 * w + 16]
        s = (rows[:8] + rows[8:]).astype(f32)
        while len(s) > 1:
            s = (s[0::2] + s[1::2]).astype(f32)
        out.append(s[0])
    return np.stack(out)


def reduce_tiles(per_tile):
    """The reduction's sum over tiles of per-tile values [tiles, C]: tiles w,
    w + 8, ... in order for each w < 8, then the eight in order."""
    parts = []
    for w in range(8):
        s = np.zeros(per_tile.shape[1], f32)
        for k in range(w, len(per_tile), 8):
            s = (s + per_tile[k]).astype(f32)
        parts.append(s)
    s = parts[0]
    for p in parts[1:]:
        s = (s + p).astype(f32)
    return s


def mirror(x, pm, ct, w0, b0, ln_w, ln_b, w3, eps=1e-6, dt=torch.bfloat16):
    """Kernel 15 on [tokens, 256] f32 arrays holding the working type's
    values (weights torch layout); dt the working type (None: f32).
    Returns (dx, dpm, dw0, db0, dln_w, dln_b, dw3, db3)."""
    n = x.shape[0]
    tiles = -(-n // TILE)
    pad = tiles * TILE - n

    def padded(a):
        return np.concatenate([a, np.zeros((pad, a.shape[1]), f32)])

    x, pm, ct = padded(x), padded(pm), padded(ct)
    xc = np.concatenate([x, pm], 1)
    h = (_mm(xc, w0.T) + b0).astype(f32)
    _, inv, d = tile_stats(h, eps)
    hhat = (d * inv[:, None]).astype(f32)
    z = _fma(hhat, ln_w, ln_b)
    phi_big, phi = gelu_parts(z)
    y = _round((z * phi_big).astype(f32), dt)
    dy = _mm(ct, w3)
    dz = (dy * _fma(z, phi, phi_big)).astype(f32)
    dhhat = (dz * ln_w).astype(f32)
    m1 = (_row_sum(dhhat) * f32(1.0 / DH)).astype(f32)
    m2 = (_row_sum((dhhat * hhat).astype(f32)) * f32(1.0 / DH)).astype(f32)
    dh = (((dhhat - m1[:, None]).astype(f32) - (hhat * m2[:, None]).astype(f32)).astype(f32)
          * inv[:, None]).astype(f32)
    dhc = _round(dh, dt)
    dxc = _mm(dhc, w0)
    dx = _round((ct + dxc[:, :D]).astype(f32), dt)[:n]
    dpm = _round(dxc[:, D:], dt)[:n]

    # column sums: per tile and warp, then the reduction
    q = [(dz * hhat).astype(f32), dz, dh]
    sums = []
    for qv in q:
        per_tile = np.stack([warp_tree(qv[TILE * k:TILE * (k + 1)]) for k in range(tiles)])
        tile_tot = ((per_tile[:, 0] + per_tile[:, 1]).astype(f32) + per_tile[:, 2]).astype(f32)
        sums.append(reduce_tiles((tile_tot + per_tile[:, 3]).astype(f32)))
    ct_tiles = []
    for k in range(tiles):
        s = np.zeros(D, f32)
        for r in ct[TILE * k:TILE * (k + 1)]:
            s = (s + r).astype(f32)
        ct_tiles.append(s)
    db3 = reduce_tiles(np.stack(ct_tiles))

    # weight gradients: 64-token blocks within contiguous splits, the splits in order
    splits = min(mlp_bwd.KERNEL_SPLITS, tiles)
    dw0, dw3 = np.zeros((DH, 2 * D), f32), np.zeros((D, DH), f32)
    for sp in range(splits):
        lo, hi = sp * tiles // splits, (sp + 1) * tiles // splits
        a0, a3 = np.zeros_like(dw0), np.zeros_like(dw3)
        for k in range(lo, hi):
            rows = slice(TILE * k, TILE * (k + 1))
            a0 = (a0 + _mm(dhc[rows].T, xc[rows])).astype(f32)
            a3 = (a3 + _mm(ct[rows].T, y[rows])).astype(f32)
        dw0, dw3 = (dw0 + a0).astype(f32), (dw3 + a3).astype(f32)
    return dx, dpm, dw0, sums[2], sums[0], sums[1], dw3, db3


def _case(seed, n, scale_ct=1.0):
    rng = np.random.RandomState(seed)

    def t(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(f32)

    return dict(x=t(n, D), pm=t(n, D), ct=t(n, D, scale=scale_ct), w0=t(DH, 2 * D, scale=(2 * D) ** -0.5),
                b0=t(DH, scale=0.1), ln_w=1.0 + t(DH, scale=0.1), ln_b=t(DH, scale=0.1),
                w3=t(D, DH, scale=DH ** -0.5))


def _in(c, dt):
    """The case rounded to the working type (vectors f32) as numpy arrays."""
    return {k: (_round(v, dt) if k in ("x", "pm", "ct", "w0", "w3") else v) for k, v in c.items()}


def _plain(c, dt):
    order = ("x", "pm", "ct", "w0", "b0", "ln_w", "ln_b", "w3")
    args = [T(c[k]).to(dt) if (k in ("x", "pm", "ct", "w0", "w3") and dt is not None) else T(c[k])
            for k in order]
    return [a.float().numpy() for a in mlp_bwd.residual_mlp_bwd_plain(*args)]


def _scaled(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


NAMES = ("dx", "dpm", "dw0", "db0", "dln_w", "dln_b", "dw3", "db3")


def _check(got, ref, tol_bf16, tol_f32):
    for i, (name, a, r) in enumerate(zip(NAMES, got, ref)):
        err = _scaled(np.asarray(a, f32), np.asarray(r, f32))
        assert err <= (tol_bf16 if i < 2 else tol_f32), f"{name}: {err}"


def test_gelu_parts_match_erf():
    z = np.linspace(-8, 8, 20001).astype(f32)
    big, small = gelu_parts(z)
    exact = np.array([0.5 * (1 + math.erf(v / math.sqrt(2))) for v in z.astype(np.float64)])
    # A & S's 1.5e-7 in erf is 7.5e-8 in Phi; the f32 steps round near 1
    # to 6e-8 each
    assert np.abs(big - exact).max() <= 3e-7
    # phi: the f32 argument z^2 (-log2(e) / 2) is off by its rounding, up to
    # 2.6e-6 relative in E at |z| = 8, where phi < 1e-13
    np.testing.assert_allclose(small, np.exp(-0.5 * z.astype(np.float64) ** 2) / math.sqrt(2 * math.pi),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_means_and_column_sums_match_float64(seed):
    rng = np.random.RandomState(seed)
    v = (rng.randn(TILE * 3, DH) * rng.uniform(0.1, 4.0, (TILE * 3, 1))).astype(f32)
    v64 = v.astype(np.float64)
    np.testing.assert_allclose(_row_sum(v) / DH, v64.mean(1), rtol=0, atol=1e-6 * np.abs(v64).max())
    per_tile = np.stack([warp_tree(v[TILE * k:TILE * (k + 1)]) for k in range(3)])
    tot = reduce_tiles((((per_tile[:, 0] + per_tile[:, 1]) + per_tile[:, 2]) + per_tile[:, 3]).astype(f32))
    np.testing.assert_allclose(tot, v64.sum(0), rtol=0, atol=1e-6 * np.abs(v64).sum(0).max())


@pytest.mark.parametrize("tokens", [192, 224, 256])
def test_mirror_matches_plain_bf16(tokens):
    """224 tokens: the last tile holds 32 tokens and 32 zero rows."""
    c = _in(_case(tokens, tokens), torch.bfloat16)
    got = mirror(*(c[k] for k in ("x", "pm", "ct", "w0", "b0", "ln_w", "ln_b", "w3")))
    _check(got, _plain(c, torch.bfloat16), 2e-2, 1e-2)


@pytest.mark.parametrize("tokens", [192, 224, 256])
def test_mirror_matches_plain_f32(tokens):
    c = _case(tokens + 1, tokens)
    got = mirror(*(c[k] for k in ("x", "pm", "ct", "w0", "b0", "ln_w", "ln_b", "w3")), dt=None)
    _check(got, _plain(c, None), 1e-5, 1e-5)


@pytest.mark.parametrize("tokens", [192, 256])
def test_mirror_matches_pallas(tokens):
    """The Pallas kernel in interpret mode, one frame of ``tokens`` in bf16
    (flax layouts: w0 [2d, dh], w3 [dh, d]; dw0 split into its x and pm
    halves, transposed)."""
    c = _in(_case(tokens + 2, tokens), torch.bfloat16)
    bf = jnp.bfloat16
    ref = mbp.fused_residual_mlp_bwd(
        *(jnp.asarray(c[k])[None].astype(bf) for k in ("x", "pm")),
        jnp.asarray(c["w0"].T).astype(bf), jnp.asarray(c["b0"]), jnp.asarray(c["ln_w"]),
        jnp.asarray(c["ln_b"]), jnp.asarray(c["w3"].T).astype(bf), jnp.asarray(c["ct"])[None].astype(bf),
        interpret=True,
    )
    dx, dpm, dw0x, dw0m, db0, dg, dbe, dw3, db3 = (np.asarray(r, f32) for r in ref)
    ref = (dx[0], dpm[0], np.concatenate([dw0x.T, dw0m.T], 1), db0.reshape(-1), dg.reshape(-1),
           dbe.reshape(-1), dw3.T, db3.reshape(-1))
    got = mirror(*(c[k] for k in ("x", "pm", "ct", "w0", "b0", "ln_w", "ln_b", "w3")))
    _check(got, ref, 2e-2, 1e-2)


def test_zero_tail_rows_add_nothing():
    """A zero-filled tail (ct = 0 there) changes no column sum or weight
    gradient: 224 tokens equal 224 tokens padded with 32 explicit zero rows
    of x, pm and ct."""
    c = _in(_case(5, 224), torch.bfloat16)
    keys = ("x", "pm", "ct", "w0", "b0", "ln_w", "ln_b", "w3")
    got = mirror(*(c[k] for k in keys))
    z = dict(c)
    for k in ("x", "pm", "ct"):
        z[k] = np.concatenate([c[k], np.zeros((32, D), f32)])
    padded = mirror(*(z[k] for k in keys))
    for name, a, b in zip(NAMES[2:], got[2:], padded[2:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
