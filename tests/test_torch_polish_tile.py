"""The LO / graduated Gauss-Newton polish as csrc/pnp.cu runs it (kernel 4),
mirrored in torch f32 on the CPU.

The kernel's schedule, which the mirror follows:
- a problem takes a cluster of C CTAs of 256 threads; CTA k owns the points
  [k S, (k + 1) S), S = ceil(N / C), and its thread i the slice's points
  i, i + 256, .., summed in that order;
- a reduction is a reduce-scatter a warp (lane bits 4, 3, .., 0), the warps'
  rows added in warp order, then the C CTAs' rows in rank order;
- a round (lo_rounds LO rounds at the full gate, huber 3; then the gates 1,
  1/2, 1/4 of it floored at 2 px, huber max(gate / 2, 1)) is gn_iters + 1
  reductions: the first pass takes the inlier flags at the round's gate as
  the GN weights, counts them and the pose's inliers at the next round's
  gate, and sums the first GN step; gn_iters - 1 GN steps; one pass counts
  the polished pose at both gates. The select (LO: count kept or grown;
  graduated: count at least min_inliers and kept or grown) then leaves the
  next round's count known, and after the last round the final one, whose
  flags are written point by point with no reduction;
- the 6x6 solve is a Cholesky with one reciprocal square root a column,
  the rotation's coefficients by the half angle.

Tolerances as tests/test_torch_geometry.py holds the port's polish to the
JAX package's: R entries within 2e-4, t within 1e-3, counts within 2 and at
most 2 flags a problem apart, against ``gn_polish_plain`` and against
``gn_polish_pallas`` in interpret mode, for clusters of 1, 3 and 16 CTAs on
300 points (a multiple of neither C x 256 nor 256). The wrapper picks C by
the number of points, a power of two up to 8.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.pnp_pallas import gn_polish_pallas
from pram_tpu_torch.geometry.camera import Camera, distort
from pram_tpu_torch.ops.pnp import gn_polish_plain, polish_cluster

from test_torch_geometry import CAM, _problem, _so3

T = torch.from_numpy
THREADS = 256
NGN = 27


def residual(cam, R, t, xyz, uv):
    """(xc, yc, zc, 1 / zsafe, du, dv), each [P, N], with one reciprocal of
    the guarded depth, as the kernel computes them."""
    xc = torch.einsum("pij,pnj->pni", R, xyz) + t[:, None]
    x, y, z = xc.unbind(-1)
    iz = 1.0 / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    xyd = distort(Camera(cam, None), torch.stack([x * iz, y * iz], -1))
    du = xyd[..., 0] * cam[:, 0, None] + cam[:, 2, None] - uv[..., 0]
    dv = xyd[..., 1] * cam[:, 1, None] + cam[:, 3, None] - uv[..., 1]
    return x, y, z, iz, du, dv


def inliers(cam, R, t, xyz, uv, mask, gate):
    _, _, z, _, du, dv = residual(cam, R, t, xyz, uv)
    return (du * du + dv * dv < gate * gate) & (z > 1e-6) & mask


def gn_terms(cam, R, t, xyz, uv, flags, hub):
    """Each point's 27 GN terms [P, N, 27] (21 packed lower-triangle JtJ
    entries, then Jtr), 0 for a point of weight 0."""
    x, y, z, iz, du, dv = residual(cam, R, t, xyz, uv)
    rn = torch.sqrt(du * du + dv * dv)
    w = torch.where(rn <= hub, torch.ones_like(rn), hub / torch.clamp(rn, min=1e-9))
    w = torch.where(flags & (z > 1e-6), w, torch.zeros_like(w))
    fxz, fyz = cam[:, 0, None] * iz, cam[:, 1, None] * iz
    pu2, pv2 = -fxz * x * iz, -fyz * y * iz
    zero = torch.zeros_like(x)
    Ju = [pu2 * y, fxz * z - pu2 * x, -fxz * y, fxz, zero, pu2]
    Jv = [-fyz * z + pv2 * y, -pv2 * x, fyz * x, zero, fyz, pv2]
    terms = [w * Ju[a] * Ju[b] + w * Jv[a] * Jv[b] for a in range(6) for b in range(a + 1)]
    terms += [w * Ju[a] * du + w * Jv[a] * dv for a in range(6)]
    return torch.stack(terms, -1)


def slots(n, cs):
    """[C, J, THREADS] point index of (rank, round, thread), -1 where the
    rank's slice has no point there; J = ceil(S / THREADS)."""
    s = -(-n // cs)
    j = -(-s // THREADS)
    rank = torch.arange(cs)[:, None, None]
    local = torch.arange(j)[None, :, None] * THREADS + torch.arange(THREADS)[None, None, :]
    idx = rank * s + local
    ok = (local < s) & (idx < n)
    return torch.where(ok, idx, torch.full_like(idx, -1))


def cluster_sum(values, slot):
    """[P, K] sums of per-point values [P, N, K] in the kernel's order:
    each thread's points in order, a warp's butterfly, warps in order,
    ranks in order."""
    p, _, k = values.shape
    pad = torch.cat([values, torch.zeros(p, 1, k)], 1)  # index -1: a zero row
    v = pad[:, slot]  # [P, C, J, THREADS, K]
    acc = torch.zeros_like(v[:, :, 0])
    for j in range(v.shape[2]):
        acc = acc + v[:, :, j]
    lanes = acc.reshape(p, acc.shape[1], THREADS // 32, 32, k)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[..., :off, :] + lanes[..., off : 2 * off, :]
    rows = lanes[..., 0, :]  # [P, C, WARPS, K]
    cta = torch.zeros_like(rows[:, :, 0])
    for w in range(rows.shape[2]):
        cta = cta + rows[:, :, w]
    total = torch.zeros_like(cta[:, 0])
    for r in range(cta.shape[1]):
        total = total + cta[:, r]
    return total


def gn_update(S, damping, R, t):
    """The kernel's solve and SO(3) update of [P] poses from their sums."""
    p = S.shape[0]
    L = [[None] * 6 for _ in range(6)]
    inv = [None] * 6
    for i in range(6):
        for j in range(i + 1):
            s = S[:, i * (i + 1) // 2 + j] + (damping if i == j else 0.0)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                s = torch.clamp(s, min=1e-12)
                inv[i] = torch.rsqrt(s)
                L[i][i] = s * inv[i]
            else:
                L[i][j] = s * inv[j]
    y = [None] * 6
    for i in range(6):
        s = S[:, 21 + i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv[i]
    d = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * d[k]
        d[i] = s * inv[i]
    w = -torch.stack(d[:3], -1)
    # sin(theta) / theta and (1 - cos theta) / theta^2 by the half angle u:
    # sigma = sin(u) / u, ca = sigma cos(u), cb = sigma^2 / 2
    u = torch.sqrt((w * w).sum(-1)) / 2
    sigma = torch.where(u > 0, torch.sin(u) / torch.clamp(u, min=1e-30), torch.ones_like(u))
    ca, cb = sigma * torch.cos(u), 0.5 * sigma * sigma
    W = torch.zeros(p, 3, 3)
    W[:, 0, 1], W[:, 0, 2], W[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    W = W - W.transpose(1, 2)
    Rd = torch.eye(3) + ca[:, None, None] * W + cb[:, None, None] * (W @ W)
    return Rd @ R, torch.einsum("pij,pj->pi", Rd, t) - torch.stack(d[3:], -1)


def polish_tile(cam, R0, t0, xyz, uv, mask, threshold, min_inliers, *, gn_iters, lo_rounds,
                cluster, damping=1e-4):
    """(R, t, num_inliers, inliers) of [P] problems by the kernel's schedule."""
    n = mask.shape[1]
    slot = slots(n, cluster)
    count = lambda flags: cluster_sum(flags[..., None].float(), slot)[:, 0]  # noqa: E731
    gates = [threshold] * lo_rounds + [max(threshold * s, 2.0) for s in (1.0, 0.5, 0.25)] + [threshold]
    R, t = R0, t0
    cnt_next = None
    for k in range(lo_rounds + 3):
        g, g_next = gates[k], gates[k + 1]
        hub = 3.0 if k < lo_rounds else max(g / 2.0, 1.0)
        flags = inliers(cam, R, t, xyz, uv, mask, g)
        cnt_r, cnt_old_next = count(flags), count(inliers(cam, R, t, xyz, uv, mask, g_next))
        Rp, tp = R, t
        for _ in range(gn_iters):
            S = cluster_sum(gn_terms(cam, Rp, tp, xyz, uv, flags, hub), slot)
            Rp, tp = gn_update(S, damping, Rp, tp)
        cnt_new = count(inliers(cam, Rp, tp, xyz, uv, mask, g))
        cnt_new_next = count(inliers(cam, Rp, tp, xyz, uv, mask, g_next))
        ok = cnt_new >= cnt_r if k < lo_rounds else (cnt_r >= min_inliers) & (cnt_new >= cnt_r)
        R = torch.where(ok[:, None, None], Rp, R)
        t = torch.where(ok[:, None], tp, t)
        cnt_next = torch.where(ok, cnt_new_next, cnt_old_next)
    flags = inliers(cam, R, t, xyz, uv, mask, threshold)
    return R, t, cnt_next.to(torch.int32), flags


P, N, GN_ITERS = 3, 300, 2


@pytest.fixture(scope="module")
def problems():
    """Three problems of 300 points (30% outliers, 10% masked) with first
    poses 1 deg / 5 cm off, and the Pallas kernel's polish of each."""
    rng = np.random.RandomState(9)
    probs = [_problem(40 + i, n=N) for i in range(P)]
    R0 = np.stack([_so3(rng, 1, 0.02)[0] @ pr[0] for pr in probs])
    t0 = np.stack([pr[1] + rng.randn(3).astype(np.float32) * 0.05 for pr in probs])
    xyz, uv, mask = (np.stack([pr[j] for pr in probs]) for j in (2, 3, 4))
    args = (np.tile(CAM, (P, 1)), R0, t0, xyz, uv, mask)
    kern = jax.jit(lambda *a: gn_polish_pallas(
        jnp.asarray(CAM), *a, 8.0, 32, gn_iters=GN_ITERS, lo_rounds=1, interpret=True))
    pallas = [[np.asarray(x) for x in kern(R0[i], t0[i], xyz[i], uv[i], mask[i])] for i in range(P)]
    return args, pallas, [pr[1] for pr in probs]


def _close(got, ref):
    R, t, num, inl = (np.asarray(x) for x in got)
    Rr, tr, nr, ir = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(R, Rr, atol=2e-4)
    np.testing.assert_allclose(t, tr, atol=1e-3)
    assert np.abs(num.astype(np.int64) - nr.astype(np.int64)).max() <= 2
    assert (inl != ir).reshape(inl.shape[0], -1).sum(-1).max() <= 2


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_schedule_matches_plain_and_pallas(problems, cluster):
    args, pallas, t_true = problems
    targs = [T(a) for a in args]
    got = polish_tile(*targs, 8.0, 32, gn_iters=GN_ITERS, lo_rounds=1, cluster=cluster)
    _close(got, gn_polish_plain(*targs, 8.0, 32, gn_iters=GN_ITERS, lo_rounds=1))
    for i in range(P):
        _close([x[i : i + 1].numpy() for x in got], [np.asarray(x)[None] for x in pallas[i]])
    # the count known after the last select is the final flags' count
    assert torch.equal(got[2], got[3].sum(-1).to(torch.int32))
    assert np.abs(got[1].numpy() - np.stack(t_true)).max() < 2e-2


@pytest.mark.parametrize("lo_rounds,gn_iters", [(1, 5), (2, 8), (0, 1)])
def test_schedule_matches_plain_over_rounds(problems, lo_rounds, gn_iters):
    """The fused counts and the select over other round and step counts,
    against the plain version (no interpreted Pallas: it unrolls every
    step)."""
    args, _, _ = problems
    targs = [T(a) for a in args]
    got = polish_tile(*targs, 8.0, 32, gn_iters=gn_iters, lo_rounds=lo_rounds, cluster=3)
    ref = gn_polish_plain(*targs, 8.0, 32, gn_iters=gn_iters, lo_rounds=lo_rounds)
    _close(got, ref)


def test_slots_cover_each_point_once():
    for n, cs in ((300, 1), (300, 3), (300, 16), (4096, 8), (512, 1)):
        slot = slots(n, cs)
        seen = slot[slot >= 0]
        assert sorted(seen.tolist()) == list(range(n))
        s = math.ceil(n / cs)
        assert ((slot // s)[slot >= 0] == torch.arange(cs)[:, None, None].expand_as(slot)[slot >= 0]).all()


@pytest.mark.parametrize("n,cluster", [(1, 1), (300, 1), (512, 1), (513, 2), (1000, 2), (2000, 4),
                                       (4096, 8), (20000, 8)])
def test_cluster_pick(n, cluster):
    """At most 512 points a CTA, as few CTAs as that allows, at most 8."""
    assert polish_cluster(n) == cluster
