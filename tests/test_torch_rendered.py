"""The port's rendered world and image slice against pram_tpu on the CPU.

- Rendering: the port's numpy copy reproduces the tracked render cache of
  the JAX package (``weights/bench_cache/``, read only) bit for bit: the 12
  reference views and the first 4 clean queries of seed 11 (images, qvecs,
  tvecs); its photometric noise equals the JAX one on the same images.
- Map building: with the same fake extractor both packages build the same
  PackedMap, field for field.
- The image slice: the port's ``RenderedGuard(batch=4, device="cpu",
  dtype=float32)`` against the JAX ``RenderedGuard(batch=4)`` (f32 on the
  CPU) on the first 4 noisy queries of seed 11: rendered images -> SFD2 ->
  SegNetViT (15 layers, nc113) -> GML (9 layers) -> RANSAC PnP -> projection
  refinement. Map point counts within 1%; keypoint sets agree >= 0.99 per
  query, descriptor cosine on the common set >= 0.999; success flags equal on >= 3 of 4; both packages' poses within
  5 cm / 5 deg of the ground truth on the queries both localize. RANSAC
  draws its hypotheses from jax.random on one side and a torch.Generator on
  the other, so poses are held by outcome. The port's ``recall`` on the
  same queries reports that batch's outcome. The JAX guard's ``recall``
  writes a query cache into ``weights/``, so this test never calls it: it
  takes the 4 images from the tracked cache and calls ``pipeline``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.engine.rendered_guard import RenderedGuard as JaxRenderedGuard
from pram_tpu.geometry.rotations import compute_pose_error as jax_pose_error
from pram_tpu.maps import rendered as jrendered
from pram_tpu_torch.engine.rendered_guard import (
    RenderedGuard,
    apply_noise,
    extraction_agreement,
    render_views,
)
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.maps import rendered as trendered
from pram_tpu_torch.maps.packed import PackedMap
from pram_tpu_torch.ops.keypoints import Keypoints

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights", "bench_cache"
)
T = torch.from_numpy


@pytest.fixture(scope="module")
def cached_queries():
    with np.load(os.path.join(CACHE, "queries_s11_n128.npz")) as d:
        return d["images"][:4].copy(), d["qvecs"][:4].copy(), d["tvecs"][:4].copy()


def test_reference_views_reproduce_the_render_cache():
    rng = np.random.RandomState(0)
    world = trendered.make_world(rng)
    poses = trendered.ref_poses(12, rng)
    cam = (500.0, 500.0, 320.0, 240.0)
    images = np.stack([world.render(R, t, cam, 640, 480) for R, t in poses]).astype(np.float32)
    with np.load(os.path.join(CACHE, "ref_views.npz")) as d:
        np.testing.assert_array_equal(images, d["images"])


def test_queries_reproduce_the_render_cache(cached_queries):
    images, qvecs, tvecs = render_views(4, 11)
    for got, ref in zip((images, qvecs, tvecs), cached_queries):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_apply_noise_equals_pram_tpu(cached_queries):
    images = cached_queries[0][:2]
    got = apply_noise(images, np.random.RandomState(12))
    ref = JaxRenderedGuard.apply_noise(images, np.random.RandomState(12))
    np.testing.assert_array_equal(got, ref)


def _grid_extractor(w, h):
    xs = np.linspace(16, w - 16, 12)
    ys = np.linspace(16, h - 16, 8)
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)

    def extract_np(images):
        b = images.shape[0]
        rng = np.random.RandomState(9)
        kd = rng.randn(b, grid.shape[0], 128).astype(np.float32)
        kd /= np.linalg.norm(kd, axis=-1, keepdims=True)
        return (
            np.broadcast_to(grid, (b,) + grid.shape).copy(),
            np.ones((b, grid.shape[0]), np.float32), kd,
            np.ones((b, grid.shape[0]), bool),
        )

    return extract_np


def test_build_rendered_scene_equals_pram_tpu():
    kw = dict(width=320, height=240, n_ref=6, kp_per_ref=128, max_ref_points=512)
    got = trendered.build_rendered_scene(_grid_extractor(320, 240), np.random.RandomState(0), **kw)
    ref = jrendered.build_rendered_scene(_grid_extractor(320, 240), np.random.RandomState(0), **kw)
    for f in PackedMap.__dataclass_fields__:
        a, b = getattr(got.map, f), getattr(ref.map, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert len(got.ref_views) == len(ref.ref_views) == 6


def test_image_slice_matches_pram_tpu(cached_queries):
    images, qvecs, tvecs = cached_queries
    noisy = apply_noise(images, np.random.RandomState(12))

    # ---- pram_tpu (XLA path on the CPU, f32)
    jg = JaxRenderedGuard(batch=4)
    jres = jg.pipeline(jax.random.PRNGKey(7), jnp.asarray(noisy))
    jxy, _, jdescs, jmask, _ = (np.array(a) for a in jax.jit(jg.front)(jnp.asarray(noisy)))
    jq_err, jt_err = (np.asarray(a) for a in jax_pose_error(jres.qvec, jres.tvec, qvecs, tvecs))
    jsucc = np.asarray(jres.success)

    # ---- the port (plain versions on the CPU, f32)
    g = RenderedGuard(batch=4, device="cpu", dtype=torch.float32)
    assert abs(g.scene.map.num_points - jg.scene.map.num_points) <= 0.01 * jg.scene.map.num_points
    assert g.n_class == jg.n_class
    (kxy, _, descs, kmask, logits), res = g.pipeline(torch.Generator().manual_seed(7), noisy)
    assert descs.shape == (4, 512, 128) and logits.shape == (4, 512, g.n_class)

    for i in range(4):
        sl = slice(i, i + 1)
        ab = extraction_agreement(
            {"keypoints": Keypoints(kxy[sl], None, kmask[sl]), "descriptors": descs[sl]},
            {"keypoints": Keypoints(T(jxy[sl]), None, T(jmask[sl])), "descriptors": T(jdescs[sl])},
        )
        assert ab["kpt_set_agreement"] >= 0.99 and ab["desc_cos_min"] >= 0.999, (i, ab)

    q_err, t_err = compute_pose_error(res.qvec, res.tvec, T(qvecs).float(), T(tvecs))
    succ = res.success.numpy()
    assert (succ == jsucc).sum() >= 3
    both = succ & jsucc
    assert both.any()
    assert (q_err.numpy()[both] < 5.0).all() and (t_err.numpy()[both] < 0.05).all()
    assert (jq_err[both] < 5.0).all() and (jt_err[both] < 0.05).all()
    # RenderedGuard.recall renders the same 4 noisy queries and draws the same
    # RANSAC noise, so it reports exactly this batch's outcome
    ok = succ & (q_err.numpy() < 5.0) & (t_err.numpy() < 0.05)
    metrics = g.recall(n_queries=4, noise=True, seed=11)
    assert metrics["n_queries"] == 4 and metrics["recall"] == ok.mean()
    assert metrics["match_precision"] >= 0.95
    # refinement ran: it keeps or grows the first RANSAC's inliers, and grows them somewhere
    inl, inl0 = res.num_inliers.numpy()[succ], res.initial_num_inliers.numpy()[succ]
    assert (inl >= inl0).all() and (inl > inl0).any()
