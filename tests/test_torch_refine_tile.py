"""The gated top-2 fold of the refinement NN (csrc/refine.cu, kernel 7),
mirrored in torch f32 on the CPU.

The kernel's products leave a 64-query x 64-point f32 similarity tile in a
warpgroup's registers in wgmma's accumulator layout: lane l of warp w holds
rows 16 w + l / 4 and + 8, and in each 8-column block j the columns
8 j + 2 (l % 4) and + 1. So the four lanes of a quad (q = l % 4) hold one
row, lane q the columns c with (c % 8) // 2 == q of every 64-point tile.
Each lane folds its columns in increasing index order (tile by tile, j by
j, the pair's two columns in order) into a running (d1, idx, d2):
    dist = sqrt(max((2 - 2 s) + 1e-6, 0)), + 100 outside the gate,
    lt = dist < d1; d2 = lt ? d1 : min(d2, dist); idx = lt ? c : idx;
    d1 = lt ? dist : d1,
and the quad merges by lane bits 0, then 1: the smaller d1 wins, on equal
d1 the smaller index, d2 = min(max(d1a, d1b), min(d2a, d2b)).

Fed the plain version's f32 similarities, the mirror gives the same bits
as ``refine_nn_plain`` in nn_idx, d1 and keep (the fold is exact: every
lane sees disjoint columns and the merge keeps the multiset's two
smallest), on data built to hit the fold's edges: duplicated point
descriptors and projections (exact ties: the first index wins and
d2 == d1 drops the query at the ratio test), a problem whose points all
lie outside the image and rows whose keypoint lies far from every point
(all gated out: d1 >= 100, ties within the +100's rounding), and P a
multiple of the 64-point stage but not of 128, which keeps a query tile on
one CTA, and multiples of 128, whose query tiles are split between two
CTAs (rank 1's rows merged into rank 0's by the same rule). Against the Pallas kernel in interpret mode, as
tests/test_torch_refine.py holds it: indices and flags exact, d1 within
1e-6. The kernel's 256-d instance (SuperPoint's descriptors) runs the same
fold on similarities of twice the k-steps: the cases at d = 256 hold it
likewise, and ``refine_nn_plain`` at 256-d against the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.refine_pallas import refine_nn_pallas
from pram_tpu_torch.ops.refine import refine_nn_plain

T = torch.from_numpy
GATE, RATIO = 16.0, 0.995
TILE = 64  # points of a stage


def quad_columns(p: int, tiles=None) -> torch.Tensor:
    """[4, P / 4] column indices lane q of a quad folds, in its order (of
    the 64-point tiles ``tiles``, default all)."""
    tiles = range(p // TILE) if tiles is None else tiles
    cols = []
    for q in range(4):
        cols.append([TILE * s + 8 * j + 2 * q + e for s in tiles for j in range(8) for e in range(2)])
    return torch.tensor(cols)


def merge(a, b):
    """The quad merge of two lanes' (d1, idx, d2)."""
    (d1a, ia, d2a), (d1b, ib, d2b) = a, b
    idx = torch.where((d1b < d1a) | ((d1b == d1a) & (ib < ia)), ib, ia)
    d2 = torch.minimum(torch.maximum(d1a, d1b), torch.minimum(d2a, d2b))
    return torch.minimum(d1a, d1b), idx, d2


def fold_lanes(sim, kpts, uv, in_img, gate_r, tiles=None):
    """The four lanes' (d1, idx, d2), each [B, N], after folding their
    columns of [B, N, P] f32 similarities (of the tiles ``tiles``)."""
    b, n, p = sim.shape
    f32 = torch.float32
    g2 = torch.tensor(gate_r, dtype=f32) * torch.tensor(gate_r, dtype=f32)
    eps, hundred = torch.tensor(1e-6, dtype=f32), torch.tensor(100.0, dtype=f32)
    cols = quad_columns(p, tiles)  # [4, P/4]
    kx, ky = kpts[..., 0, None], kpts[..., 1, None]  # [B, N, 1]: a row's, for the 4 lanes
    d1 = torch.full((b, n, 4), float("inf"))
    d2 = torch.full((b, n, 4), float("inf"))
    idx = torch.zeros((b, n, 4), dtype=torch.int64)
    for k in range(cols.shape[1]):
        c = cols[:, k]  # the 4 lanes' k-th columns
        s = sim[:, :, c]
        dist = torch.sqrt(torch.clamp((2.0 - 2.0 * s) + eps, min=0.0))
        dx = kx - uv[:, None, c, 0]
        dy = ky - uv[:, None, c, 1]
        gate = (dx * dx + dy * dy < g2) & in_img[:, None, c]
        dist = torch.where(gate, dist, dist + hundred)
        lt = dist < d1
        d2 = torch.where(lt, d1, torch.minimum(d2, dist))
        idx = torch.where(lt, c.expand_as(idx), idx)
        d1 = torch.where(lt, dist, d1)
    return [(d1[..., q], idx[..., q], d2[..., q]) for q in range(4)]


def refine_tile(sim, kpts, uv, in_img, qmask, gate_r, ratio, split=1):
    """(nn_idx, d1, keep) of [B, N, P] f32 similarities by the kernel's fold
    and its quad merge (bit 0: lanes (0, 1), (2, 3); bit 1: the pairs);
    with ``split`` = 2 CTAs a query tile, rank r folds the r-th half of the
    tiles and rank 1's merged rows merge into rank 0's."""
    per = sim.shape[-1] // TILE // split
    ranks = []
    for r in range(split):
        lanes = fold_lanes(sim, kpts, uv, in_img, gate_r, range(r * per, (r + 1) * per))
        ranks.append(merge(merge(lanes[0], lanes[1]), merge(lanes[2], lanes[3])))
    d1, idx, d2 = ranks[0]
    for other in ranks[1:]:
        d1, idx, d2 = merge((d1, idx, d2), other)
    keep = (d1 / torch.clamp(d2, min=1e-9) <= ratio) & (d1 < 100.0) & qmask
    return idx, d1, keep


def _case(seed, b, n, p, d=128):
    """Descriptors with near-duplicate map points (real nearest neighbours),
    exact duplicates (ties), all of problem b-1's points outside the image
    and a few keypoints far from every point."""
    rng = np.random.RandomState(seed)
    descs = rng.randn(b, n, d).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    pdesc = rng.randn(b, p, d).astype(np.float32)
    pdesc[:, : n // 2] = descs[:, : n // 2] + rng.randn(b, n // 2, d) * 0.05
    pdesc /= np.linalg.norm(pdesc, axis=-1, keepdims=True)
    h = n // 2
    pdesc[:, h : h + 16] = pdesc[:, :16]  # exact duplicates: ties
    pdesc[:, p - 8 :] = pdesc[:, 16:24]  # and some in the last tile
    kpts = (rng.rand(b, n, 2) * [640, 480]).astype(np.float32)
    uv = (rng.rand(b, p, 2) * [640, 480]).astype(np.float32)
    uv[:, :h] = kpts[:, :h] + rng.randn(b, h, 2) * 3
    uv[:, h : h + 16] = uv[:, :16]
    uv[:, p - 8 :] = uv[:, 16:24]
    in_img = rng.rand(b, p) > 0.1
    in_img[:, :24] = True
    in_img[:, h : h + 16] = in_img[:, :16]
    in_img[:, p - 8 :] = in_img[:, 16:24]
    in_img[-1] = False  # a problem with every point gated out
    kpts[0, -4:] = [-5000.0, -5000.0]  # rows with every point gated out
    qmask = rng.rand(b, n) > 0.1
    return descs, pdesc, kpts, uv.astype(np.float32), in_img, qmask


# P % 128 decides the 2-CTA point split: P a multiple of the 64-point stage
# and not of 128 (320, 448: one CTA a query tile), and multiples of 128,
# whose query tiles the kernel splits between two CTAs of a cluster where
# they do not fill the card (256, 384); N = 192 leaves a CTA's second
# warpgroup without queries
CASES = [(3, 128, 320, 1, 128), (2, 192, 448, 1, 128), (2, 128, 256, 2, 128), (2, 64, 384, 2, 128),
         (2, 192, 320, 1, 256), (2, 128, 256, 2, 256)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"b{b}_n{n}_p{p}_split{s}" + ("" if d == 128 else f"_d{d}") for b, n, p, s, d in CASES])
def case(request):
    b, n, p, split, d = request.param
    arrays = _case(11 + n + p + d, b, n, p, d)
    descs, pdesc, kpts, uv, in_img, qmask = (T(a) for a in arrays)
    sim = descs @ pdesc.transpose(-1, -2)  # the plain version's f32 similarities
    tile = refine_tile(sim, kpts, uv, in_img, qmask, GATE, RATIO, split)
    return arrays, tile


def test_fold_is_bit_equal_to_plain(case):
    arrays, (idx, d1, keep) = case
    ridx, rd1, rkeep = refine_nn_plain(*(T(a) for a in arrays), GATE, RATIO)
    assert torch.equal(idx, ridx)
    assert torch.equal(d1.view(torch.int32), rd1.view(torch.int32))
    assert torch.equal(keep, rkeep)


def test_fold_edges_are_exercised(case):
    arrays, (idx, d1, keep) = case
    n = arrays[0].shape[1]
    # the duplicated points tie: the first index wins and d2 == d1 drops them
    assert (idx[:-1, :16] < n // 2).all() and not keep[:, :16].any()
    # every point gated out: d1 >= 100, never kept, the first of the nearest
    assert (d1[-1] >= 100).all() and not keep[-1].any()
    assert (d1[0, -4:] >= 100).all()
    assert keep.any() and not keep.all()


def test_fold_matches_pallas_interpret(case):
    arrays, (idx, d1, keep) = case
    for i in range(arrays[0].shape[0]):
        ridx, rd1, rkeep = refine_nn_pallas(
            *(jnp.asarray(a[i]) for a in arrays), GATE, RATIO, interpret=True
        )
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_allclose(d1[i].numpy(), np.asarray(rd1), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rkeep))


def test_quad_columns_partition_in_order():
    """The four lanes' columns are disjoint, cover every point, and each
    lane takes its own in increasing order."""
    cols = quad_columns(320)
    assert sorted(cols.flatten().tolist()) == list(range(320))
    assert (cols[:, 1:] > cols[:, :-1]).all()
    # lane q's columns are the accumulator fragment's: (c % 8) // 2 == q
    assert all(((cols[q] % 8) // 2 == q).all() for q in range(4))


def test_merge_order_does_not_change_the_result():
    """Merging the lanes in any order, either side first, gives the same
    bits: the merge keeps the multiset's two smallest and the first index
    of the smallest."""
    arrays = _case(5, 2, 128, 320)
    descs, pdesc, kpts, uv, in_img, qmask = (T(a) for a in arrays)
    lanes = fold_lanes(descs @ pdesc.transpose(-1, -2), kpts, uv, in_img, GATE)
    ref = merge(merge(lanes[0], lanes[1]), merge(lanes[2], lanes[3]))
    for order in ((3, 1, 0, 2), (2, 3, 1, 0), (1, 0, 3, 2)):
        a, b, c, d = (lanes[i] for i in order)
        for got in (merge(merge(a, b), merge(c, d)), merge(merge(merge(a, b), c), d)):
            for x, y in zip(got, ref):
                assert torch.equal(x, y)


@pytest.mark.parametrize("p", [256, 320])
def test_refine_nn_plain_at_256d_matches_pallas_interpret(p):
    """SuperPoint's width: ``refine_nn_plain`` on 256-d descriptors gives
    the Pallas kernel's nn_idx and keep (d1 within 1e-6); the Pallas
    kernel tiles any width its point block divides."""
    arrays = _case(40 + p, 2, 128, p, 256)
    idx, d1, keep = refine_nn_plain(*(T(a) for a in arrays), GATE, RATIO)
    for i in range(2):
        ridx, rd1, rkeep = refine_nn_pallas(*(jnp.asarray(a[i]) for a in arrays), GATE, RATIO, interpret=True)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_allclose(d1[i].numpy(), np.asarray(rd1), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rkeep))
    assert keep.any() and not keep[:, :16].any()
