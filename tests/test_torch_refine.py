"""Projection refinement of the port against pram_tpu on the CPU, in f32.

- The gated top-2 NN (plain twin of csrc/refine.cu) against the TPU kernel
  in interpret mode: indices and keep flags exact, d1 within 1e-6, on data
  whose near-duplicate points make real nearest neighbours.
- ``refine_projection_core`` against pram_tpu's (its XLA branch here) on
  the recall-guard scene, with RANSAC fed pram_tpu's own triplet draws:
  the NN matches exact, the pose within 1e-4 (R entries, scene units) and
  the inlier count within 1 (f32 noise at the 8 px gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.engine import localizer as jloc
from pram_tpu.geometry import pnp as jpnp
from pram_tpu.geometry.camera import Camera as JaxCamera
from pram_tpu.maps.device import to_device as jax_to_device
from pram_tpu.ops.refine_pallas import refine_nn_pallas
from pram_tpu_torch.engine.localizer import (
    LocConfig,
    finalize_result,
    gather_refine_set,
    refine_projection_core,
)
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import qvec2rotmat, so3_exp
from pram_tpu_torch.maps.device import to_device
from pram_tpu_torch.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.ops.refine import refine_nn, refine_nn_plain

T = torch.from_numpy
SCENE = dict(
    n_cluster=16, points_per_cluster=400, n_ref_frames=12, desc_dim=128,
    width=640, height=480, max_kp_per_frame=1024, max_ref_points=2048,
)


def _nn_case(rng, b, n, p, d=64):
    descs = rng.randn(b, n, d).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    pdesc = rng.randn(b, p, d).astype(np.float32)
    pdesc[:, : n // 2] = descs[:, : n // 2] + rng.randn(b, n // 2, d) * 0.05
    pdesc[:, n // 2 : n // 2 + 8] = pdesc[:, :8]  # exact duplicates: ties
    pdesc /= np.linalg.norm(pdesc, axis=-1, keepdims=True)
    kpts = (rng.rand(b, n, 2) * [640, 480]).astype(np.float32)
    uv = (rng.rand(b, p, 2) * [640, 480]).astype(np.float32)
    uv[:, : n // 2] = kpts[:, : n // 2] + rng.randn(b, n // 2, 2) * 3
    uv[:, n // 2 : n // 2 + 8] = uv[:, :8]
    in_img = rng.rand(b, p) > 0.1
    in_img[:, n // 2 : n // 2 + 8] = in_img[:, :8]
    qmask = rng.rand(b, n) > 0.1
    return descs, pdesc, kpts, uv, in_img, qmask


@pytest.mark.parametrize("p", [128, 512])
def test_refine_nn_matches_pallas_interpret(p):
    rng = np.random.RandomState(20 + p)
    b, n = 2, 64
    case = _nn_case(rng, b, n, p)
    got_idx, got_d1, got_keep = refine_nn(*(T(a) for a in case), 16.0, 0.995)
    for i in range(b):
        ridx, rd1, rkeep = refine_nn_pallas(
            *(jnp.asarray(a[i]) for a in case), 16.0, 0.995, interpret=True
        )
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_allclose(got_d1[i].numpy(), np.asarray(rd1), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_keep[i].numpy(), np.asarray(rkeep))
    assert got_keep.any() and not got_keep.all()
    # the duplicated points tie: the first index wins and d2 == d1 drops them
    assert not got_keep[:, :8].any()


@pytest.fixture(scope="module")
def refine_problem():
    """Two rendered queries of the recall-guard scene, each with its true
    landmark's refinement set and a first pose 1 deg / 5 cm off the truth."""
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, **SCENE)
    queries = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
    st = {k: np.stack([q[k] for q in queries]) for k in ("keypoints", "descriptors", "mask", "qvec", "tvec", "gt_seg")}
    segs = [np.bincount(s[s >= 0]).argmax() for s in st["gt_seg"]]
    slots = scene.map.seg_vrf_slot[np.array(segs)]
    R_gt = qvec2rotmat(T(st["qvec"]).float())
    prng = np.random.RandomState(3)
    w = T((prng.randn(2, 3) * np.deg2rad(1.0) / np.sqrt(3)).astype(np.float32))
    R0 = (so3_exp(w) @ R_gt).numpy()
    t0 = (st["tvec"] + prng.randn(2, 3) * 0.05 / np.sqrt(3)).astype(np.float32)
    return scene, st, slots.astype(np.int64), R0, t0


def test_refine_projection_core_matches_pram_tpu(refine_problem):
    scene, st, slots, R0, t0 = refine_problem
    cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1)
    jcfg = jloc.LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1)
    cam_p = np.array([500, 500, 320, 240, 0, 0, 0, 0], np.float32)
    cam_s = np.array([640, 480], np.float32)
    jcam = JaxCamera(jnp.asarray(cam_p), jnp.asarray(cam_s))
    jdmap = jax_to_device(scene.map)
    dmap = to_device(scene.map, "cpu")
    camera = Camera(T(np.tile(cam_p, (2, 1))), T(np.tile(cam_s, (2, 1))))
    kpts, descs, mask = (T(st[k]) for k in ("keypoints", "descriptors", "mask"))

    rset = gather_refine_set(dmap, T(slots))
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jout, trip = [], []
    for i in range(2):
        jset = jloc.gather_refine_set(jdmap, jnp.asarray(slots[i]))
        args = (jnp.asarray(st["keypoints"][i]), jnp.asarray(st["descriptors"][i]), jnp.asarray(st["mask"][i]))
        jout.append([np.asarray(a) for a in jloc.refine_projection_core(
            keys[i], jcam, *args, jset, jnp.asarray(R0[i]), jnp.asarray(t0[i]), jcfg)])
        # the triplets pram_tpu's RANSAC drew: the same key over its kept matches
        keep_j = _keep_mask(jset, jcam, args, R0[i], t0[i], jcfg)
        trip.append(np.asarray(jpnp._sample_triplets(keys[i], keep_j, 128)))
        assert int(keep_j.sum()) >= 32
    got = refine_projection_core(
        camera, kpts, descs, mask, rset, T(R0), T(t0), cfg, triplets=T(np.stack(trip)),
    )
    Rr, tr, inl, ok, pidx, mxyz = (a.numpy() for a in got)
    for i in range(2):
        jR, jt, jinl, jok, jpidx, jxyz = jout[i]
        np.testing.assert_array_equal(mxyz[i], jxyz)
        np.testing.assert_allclose(Rr[i], jR, atol=1e-4)
        np.testing.assert_allclose(tr[i], jt, atol=1e-4)
        assert abs(int(inl[i]) - int(jinl)) <= 1 and bool(ok[i]) == bool(jok)
        assert (pidx[i] == jpidx).mean() >= 0.99
        # refinement lands on the truth
        assert np.abs(tr[i] - st["tvec"][i]).max() < 0.01


def _keep_mask(jset, jcam, args, R0, t0, jcfg):
    """pram_tpu's refinement keep flags (its XLA formulation)."""
    from pram_tpu.geometry.camera import project as jax_project

    kpts, descs, mask = args
    uv, z = jax_project(jcam, jnp.asarray(R0), jnp.asarray(t0), jset.xyz)
    in_img = (z > 0) & (z < 100.0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480) & (jset.pt_idx >= 0)
    sim = jnp.einsum("nd,pd->np", descs, jset.desc, preferred_element_type=jnp.float32)
    dist = jnp.sqrt(jnp.maximum(2.0 - 2.0 * sim + 1e-6, 0.0))
    gate = (jnp.linalg.norm(kpts[:, None] - uv[None], axis=-1) < 2.0 * jcfg.threshold) & in_img[None]
    dist = jnp.where(gate, dist, dist + 100.0)
    nn = jnp.argmin(dist, -1)
    d1 = jnp.min(dist, -1)
    d2 = jnp.min(jnp.where(jnp.arange(dist.shape[1])[None] == nn[:, None], jnp.inf, dist), -1)
    return (d1 / jnp.maximum(d2, 1e-9) <= jcfg.projection_ratio) & (d1 < 100.0) & mask


def test_finalize_takes_refinement_only_where_both_succeed():
    from pram_tpu_torch.engine.localizer import CoreResult

    b, n = 3, 4
    eye = torch.eye(3).expand(b, 3, 3)
    core = CoreResult(
        R0=eye, t0=torch.zeros(b, 3), inl0=torch.tensor([40, 10, 50]),
        any_ok=torch.tensor([True, False, True]), pick=torch.zeros(b, dtype=torch.long),
        picked_slot=torch.zeros(b, dtype=torch.long), picked_sid=torch.tensor([2, -1, 3]),
        kpt_point_idx=torch.zeros(b, n, dtype=torch.long), kpt_xyz=torch.zeros(b, n, 3),
    )
    ref = (-eye, torch.ones(b, 3), torch.tensor([60, 70, 20]), torch.tensor([True, True, False]),
           torch.ones(b, n, dtype=torch.long), torch.ones(b, n, 3))
    res = finalize_result(core, ref)
    np.testing.assert_array_equal(res.tvec[:, 0].numpy(), [1, 0, 0])
    np.testing.assert_array_equal(res.num_inliers.numpy(), [60, 10, 50])
    np.testing.assert_array_equal(res.initial_num_inliers.numpy(), [40, 10, 50])
    np.testing.assert_array_equal(res.kpt_point_idx[:, 0].numpy(), [1, 0, 0])
    np.testing.assert_array_equal(res.success.numpy(), [True, False, True])
    assert torch.equal(finalize_result(core).R, core.R0)


def test_refine_nn_plain_is_the_cpu_path():
    rng = np.random.RandomState(30)
    case = [T(a) for a in _nn_case(rng, 1, 64, 128)]
    for a, b in zip(refine_nn(*case, 16.0, 0.995), refine_nn_plain(*case, 16.0, 0.995)):
        assert torch.equal(a, b)


def test_localizer_refinement_methods_and_fixed_triplets(refine_problem):
    """Refinement by projection and by matching run in localize_batch;
    fixing both RANSAC calls' triplets makes the result independent of the
    generator; an unknown refinement method is refused."""
    from pram_tpu_torch.engine.localizer import Localizer
    from pram_tpu_torch.engine.matching import make_nn_match_fn

    scene, st, _, _, _ = refine_problem
    dmap = to_device(scene.map, "cpu")
    cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1)
    with pytest.raises(ValueError, match="refinement_method"):
        Localizer(dmap, make_nn_match_fn(), LocConfig(refinement_method="other"))
    gt = st["gt_seg"]
    logits = np.full(gt.shape + (scene.map.n_class,), -10.0, np.float32)
    np.put_along_axis(logits, np.where(gt >= 0, gt + 1, 0)[..., None], 10.0, axis=2)
    camera = Camera(T(np.tile(np.float32([500, 500, 320, 240, 0, 0, 0, 0]), (2, 1))),
                    T(np.tile(np.float32([640, 480]), (2, 1))))
    trng = np.random.RandomState(4)
    trip, rtrip = (T(trng.randint(0, 512, (2, 128, 3))) for _ in range(2))
    loc = Localizer(dmap, make_nn_match_fn(), cfg)
    args = (camera, T(st["keypoints"]), torch.ones(2, 512), T(st["descriptors"]), T(st["mask"]), T(logits))
    runs = [loc.localize_batch(torch.Generator().manual_seed(s), *args, triplets=trip, refine_triplets=rtrip)
            for s in (1, 2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0].success.all()
    assert (runs[0].num_inliers > runs[0].initial_num_inliers).all()
    # by matching: the refinement's RANSAC runs over the covisible frames'
    # stacked matches, C * N = 4 * 512 of them
    mcfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128, gn_iters=5, lo_rounds=1,
                     refinement_method="matching", covisibility_frame=4)
    mtrip = T(trng.randint(0, 4 * 512, (2, 128, 3)))
    loc = Localizer(dmap, make_nn_match_fn(), mcfg)
    runs = [loc.localize_batch(torch.Generator().manual_seed(s), *args, triplets=trip, refine_triplets=mtrip)
            for s in (1, 2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0].success.all()
