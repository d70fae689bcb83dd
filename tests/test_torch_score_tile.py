"""Kernel 3's schedule (csrc/pnp.cu:score::ransac_score_kernel) mirrored in
torch f32 on the CPU, against ransac_score_plain and the Pallas kernel.

The mirror walks the kernel's decomposition: 512 poses a CTA, the point
axis cut into the slices ``ops/pnp.py:score_slices`` picks, each slice in
256-point chunks with a short tail, every chunk packed as the kernel packs
it (X = NaN for a masked point, cx - U and cy - V), the poses' rows scaled by
fx and fy where the camera has no distortion, one rounded reciprocal of the
guarded depth a pair, the kernel's fmas (an f64 product and sum rounded
once to f32), and the slices' partial counts summed into a zeroed output
with the -1 of an invalid pose written once, by slice 0. Counts within
SCORE_MAX_DIFF = 2 of ransac_score_plain and of ransac_score_pallas in
interpret mode (sums and products round in another order, so a point at
the gate's edge can flip), and equal for every slicing of the points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.pnp_pallas import ransac_score_pallas
from pram_tpu_torch.geometry.camera import Camera, project
from pram_tpu_torch.geometry.rotations import so3_exp
from pram_tpu_torch.ops import pnp

SCORE_MAX_DIFF = 2
TILE, CHUNK = 512, 256
NAN = float("nan")


def fma(a, b, c):
    """f32 a * b + c rounded once (the f64 product of two f32 is exact)."""
    return (a.double() * b.double() + c.double()).float()


def pack(cam, xyz, uv, mask):
    """A chunk as the kernel packs it: (X or NaN, Y, Z, cx - U), cy - V."""
    x = torch.where(mask, xyz[:, 0], NAN)
    return x, xyz[:, 1], xyz[:, 2], cam[2] - uv[:, 0], cam[3] - uv[:, 1]


def count_chunk(cam, q, pts, th2):
    """The counts of poses ``q [k, 12]`` over one packed chunk."""
    X, Y, Z, cu, cv = (a[None] for a in pts)
    fx, fy, k1, k2, p1, p2 = (cam[i] for i in (0, 1, 4, 5, 6, 7))
    dist = bool((cam[4:] != 0).any())
    row = [q[:, i:i + 1] for i in range(12)]
    xc = fma(row[2], Z, fma(row[1], Y, fma(row[0], X, row[3])))
    yc = fma(row[6], Z, fma(row[5], Y, fma(row[4], X, row[7])))
    zc = fma(row[10], Z, fma(row[9], Y, fma(row[8], X, row[11])))
    iz = 1.0 / torch.where(zc.abs() < 1e-6, 1e-6, zc)  # IEEE f32: __frcp_rn
    if dist:
        x, y = xc * iz, yc * iz
        xy = x * y
        r2 = fma(x, x, y * y)
        radial = fma(fma(k2.expand_as(r2), r2, k1), r2, torch.ones_like(r2))
        xd = fma(x, radial, fma((2.0 * p1).expand_as(xy), xy, p2 * fma(2.0 * x, x, r2)))
        yd = fma(y, radial, fma(p1.expand_as(xy), fma(2.0 * y, y, r2), 2.0 * p2 * xy))
        du, dv = fma(xd, fx.expand_as(xd), cu), fma(yd, fy.expand_as(yd), cv)
    else:
        du, dv = fma(xc, iz, cu), fma(yc, iz, cv)
    ok = (fma(du, du, dv * dv) < th2) & (zc > 1e-6)
    return ok.sum(-1).to(torch.int32)


def score_tile(cam, R, t, valid, xyz, uv, mask, threshold, slices):
    """The kernel's schedule; returns the counts and how many times each
    output entry was written by a plain store."""
    P, K = valid.shape
    N = xyz.shape[1]
    slice_ = -(-N // min(slices, N))
    slices = -(-N // slice_)
    out = torch.zeros(P, K, dtype=torch.int32)
    stores = torch.zeros(P, K, dtype=torch.int32)
    th2 = torch.tensor(threshold, dtype=torch.float32) ** 2
    for p in range(P):
        c = cam[p]
        dist = bool((c[4:] != 0).any())
        q = torch.cat([R[p], t[p][..., None]], -1)  # [K, 3, 4]
        if not dist:
            q = q * torch.stack([c[0], c[1], torch.ones(())])[None, :, None]
        q = q.reshape(K, 12)
        for k0 in range(0, K, TILE):
            ks = slice(k0, min(K, k0 + TILE))
            for s in range(slices):
                i0 = s * slice_
                n = min(N, i0 + slice_) - i0
                assert n >= 1
                cnt = torch.zeros(ks.stop - ks.start, dtype=torch.int32)
                for c0 in range(i0, i0 + n, CHUNK):
                    cs = slice(c0, min(i0 + n, c0 + CHUNK))
                    cnt += count_chunk(c, q[ks], pack(c, xyz[p, cs], uv[p, cs], mask[p, cs]), th2)
                v = valid[p, ks]
                if s == 0:
                    stores[p, ks] += (~v).to(torch.int32)
                    out[p, ks] = torch.where(v, out[p, ks], -1)
                if slices == 1:
                    out[p, ks] = torch.where(v, cnt, out[p, ks])
                    stores[p, ks] += v.to(torch.int32)
                else:
                    out[p, ks] += torch.where(v, cnt, 0)  # the atomics
    return out, stores


def _case(seed, P, K, N, distorted):
    g = torch.Generator().manual_seed(seed)
    dist = [0.01, -0.005, 0.001, -0.0005] if distorted else [0.0] * 4
    cam = torch.tensor([500.0, 500.0, 320.0, 240.0] + dist).repeat(P, 1)
    R = so3_exp(torch.randn(P, 3, generator=g) * 0.2)
    t = torch.randn(P, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, 5.0])
    # points in the camera's view, as observed points are: inside the
    # 640 x 480 image, 2-8 m deep (outside it a distortion polynomial folds
    # points back in with errors of f32 rounding times its slope, 1e8 at
    # x = 250, and any two roundings count them differently)
    z = 2.0 + 6.0 * torch.rand(P, N, 1, generator=g)
    xy = (torch.rand(P, N, 2, generator=g) - 0.5) * torch.tensor([1.28, 0.96])
    xyz = torch.einsum("pji,pnj->pni", R, torch.cat([xy * z, z], -1) - t[:, None])
    uv, _ = project(Camera(cam, None), R, t, xyz)
    uv = uv + torch.randn(P, N, 2, generator=g) * 0.3
    out = torch.rand(P, N, generator=g) < 0.3
    uv[out] = torch.rand(int(out.sum()), 2, generator=g) * torch.tensor([640.0, 480.0])
    centre = -torch.einsum("pji,pj->pi", R, t)
    xyz[:, :5] = 2 * centre[:, None] - xyz[:, :5]  # a few points behind the camera (mirrored through it)
    mask = torch.rand(P, N, generator=g) > 0.1
    Rh = so3_exp(torch.randn(P, K, 3, generator=g) * 0.01) @ R[:, None]
    th = t[:, None] + torch.randn(P, K, 3, generator=g) * 0.01
    Rh[:, 0], th[:, 0] = R, t
    valid = torch.rand(P, K, generator=g) > 0.2
    valid[:, 0] = True
    return cam, Rh, th, valid, xyz, uv, mask


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("n", [300, 4096, 10000])
def test_score_tile_matches_plain_and_pallas(n, distorted):
    """K = 200 (not a multiple of 128), N not a multiple of the chunk at
    300 and 10000 (past the first design's 7264-point ceiling), 20% of the
    poses invalid, the slices picked for 132 SMs."""
    P, K = 2, 200
    args = _case(n + distorted, P, K, n, distorted)
    slices = pnp.score_slices(P, K, n, 132)
    assert slices > 1
    got, stores = score_tile(*args, 8.0, slices)
    ref = pnp.ransac_score_plain(*args, 8.0)
    valid = args[3]
    assert (stores[~valid] == 1).all() and (stores[valid] == 0).all()
    assert torch.equal(got == -1, ~valid)
    assert (got - ref).abs().max().item() <= SCORE_MAX_DIFF
    assert (got[:, 0] > 0.5 * n).all()
    cam, R, t, _, xyz, uv, mask = (a.numpy() for a in args)
    for p in range(P):
        pal = np.asarray(ransac_score_pallas(jnp.asarray(cam[p]), jnp.asarray(R[p]), jnp.asarray(t[p]),
                                             jnp.asarray(xyz[p]), jnp.asarray(uv[p]), jnp.asarray(mask[p]),
                                             8.0, interpret=True))
        v = valid[p].numpy()
        assert np.abs(got[p].numpy()[v] - pal[v]).max() <= SCORE_MAX_DIFF


@pytest.mark.parametrize("slices", [1, 3, 40])
def test_score_tile_counts_do_not_depend_on_the_slicing(slices):
    """Integer partial counts sum exactly in any order: every slicing of the
    points (one CTA, a few, many short slices past two chunks' tails) gives
    the same counts; with one slice every entry is stored once."""
    P, K, N = 1, 600, 1000  # two pose tiles, the second short
    args = _case(5, P, K, N, False)
    got, stores = score_tile(*args, 8.0, slices)
    one, _ = score_tile(*args, 8.0, 1)
    assert torch.equal(got, one)
    if slices == 1:
        assert (stores == 1).all()
    assert (got - pnp.ransac_score_plain(*args, 8.0)).abs().max().item() <= SCORE_MAX_DIFF


def test_score_slices_fill_the_card():
    """The wrapper's slicing at the path's shapes on 132 SMs: SCORE_CTAS_PER_SM
    CTAs an SM where the points allow, no slice under SCORE_MIN_SLICE
    points, never 0 slices."""
    for P, K, N in ((32, 512, 512), (8, 512, 4096), (32, 512, 10240), (32, 1024, 10240), (32, 1000, 10000)):
        s = pnp.score_slices(P, K, N, 132)
        assert P * -(-K // TILE) * s >= pnp.SCORE_CTAS_PER_SM * 132 or s == N // pnp.SCORE_MIN_SLICE
        assert N // s >= pnp.SCORE_MIN_SLICE
    assert pnp.score_slices(1, 512, 10, 132) == 1
    assert pnp.score_slices(4096, 512, 512, 132) == 1
