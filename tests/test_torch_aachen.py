"""The AdaGML slice of the port against pram_tpu on the CPU, at full token
counts, in f32.

Scene and queries as scripts/bench_aachen.py's correctness section: 512
landmarks of 40 points, 24 reference frames of up to 2048 keypoints, 4096
refinement points, 1024 x 768 images, queries of 4096 keypoints rendered
with 0.5 px and 0.05 descriptor noise, routed by ground-truth logits over
513 classes. Matcher: AdaGML (9 layers, d=256) with
weights/adagml_aachen.msgpack through the batched early exit. Localizer:
seg_k=1, 128 hypotheses, gn_iters=5, lo_rounds=1, projection refinement.

- The matcher at batch 1 on query 0 against frame 0 of the map: masks and
  stop layers exact, the plan within rtol 5e-4 / atol 5e-5 (f32 sums over
  4096 tokens in another order).
- The slice at batch 2: the port's Localizer against pram_tpu's, both
  RANSAC calls drawing pram_tpu's triplets (its Gumbel noise from its keys,
  fed to the port's sampler): the AdaGML matches on the matcher's inputs
  exact, the same success flags, both within 5 cm / 5 deg of the true pose,
  the two poses within 5 mm / 0.1 deg of each other, and match precision
  (the share of final correspondences that reproject within 4 px through
  the true pose, scripts/bench_aachen.py:440-460) within 0.01 of each other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pram_tpu_torch.geometry.pnp as tpnp
from pram_tpu.engine import localizer as jloc
from pram_tpu.engine.matching import make_adagml_match_fn as jax_make_adagml_match_fn
from pram_tpu.geometry.camera import Camera as JaxCamera
from pram_tpu.maps.device import to_device as jax_to_device
from pram_tpu.models import adagml as jada
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu.ops.matching import mutual_matches as jax_mutual_matches
from pram_tpu_torch.engine.localizer import LocConfig, Localizer, normalize_kpts_like_reference
from pram_tpu_torch.engine.matching import make_adagml_match_fn
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error, qvec2rotmat
from pram_tpu_torch.maps.device import to_device
from pram_tpu_torch.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.models.adagml import AdaGMLConfig, adagml_batched_adaptive_apply
from pram_tpu_torch.models.convert import gml_state_dict, load_adagml
from pram_tpu_torch.models.gml import GML, GMLConfig
from pram_tpu_torch.ops.matching import mutual_matches

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "adagml_aachen.msgpack",
)
W, H, N_KPTS, N_CLUSTER = 1024, 768, 4096, 512
SCENE = dict(
    n_cluster=N_CLUSTER, points_per_cluster=40, n_ref_frames=24, desc_dim=128,
    width=W, height=H, max_kp_per_frame=2048, max_ref_points=4096,
)
LOC = dict(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
           do_refinement=True, gn_iters=5, lo_rounds=1)
T = torch.from_numpy


@pytest.fixture(scope="module")
def aachen():
    scene = make_synthetic_scene(np.random.RandomState(0), **SCENE)
    qrng = np.random.RandomState(11)
    queries = [scene.render_query(qrng, noise_px=0.5, desc_noise=0.05, max_kpts=N_KPTS)
               for _ in range(2)]
    q = {k: np.stack([x[k] for x in queries])
         for k in ("keypoints", "descriptors", "scores", "mask", "qvec", "tvec", "gt_seg")}
    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    model = load_adagml(WEIGHTS, AdaGMLConfig(), device="cpu")
    return scene, q, {"params": params}, model


def test_adagml_at_the_aachen_shape_matches_pram_tpu(aachen):
    """Batch 1, 4096 x 2048 tokens, trained weights, batched early exit."""
    scene, q, variables, model = aachen
    fi = 0
    size = (torch.tensor(float(W)), torch.tensor(float(H)))
    d0 = q["descriptors"][:1]
    d1 = scene.map.point_desc[np.clip(scene.map.frame_point_idx[fi], 0, None)][None].astype(np.float32)
    nk0 = normalize_kpts_like_reference(T(q["keypoints"][:1]), *size).numpy()
    nk1 = normalize_kpts_like_reference(T(scene.map.frame_kp_uv[fi][None]).float(), *size).numpy()
    m0, m1 = q["mask"][:1], scene.map.frame_kp_mask[fi][None].astype(bool)
    inputs = (d0, d1, nk0, nk1, m0, m1)
    assert d0.shape[1] == 4096 and d1.shape[1] == 2048

    out = adagml_batched_adaptive_apply(model, *map(T, inputs))
    jout = jada.adagml_batched_adaptive_apply(
        jada.stack_adagml_layers(variables, 9), *map(jnp.asarray, inputs), cfg=jada.AdaGMLConfig())
    for k in ("mask0", "mask1", "stop_layer"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_allclose(out["plan"].numpy(), np.asarray(jout["plan"]), rtol=5e-4, atol=5e-5)
    assert int(out["stop_layer"][0]) < 8  # the trained heads stop early
    assert out["mask0"].sum() < m0.sum()  # and prune


def test_gml_at_the_aachen_frame_width_matches_pram_tpu(aachen):
    """GML (2 layers, JAX-initialised params carried across) on 128 query
    keypoints of query 0 against frame 0 of the Aachen map, 2048 tokens
    wide: the frame width that takes kernel 6's wide instance on the card
    (m + 1 > 1536), where the JAX GML takes XLA's Sinkhorn
    (pram_tpu/models/gml.py:43,116). In f32: the plan within 2e-5 and 1e-6
    of each entry (the dustbin corner holds ~10^3, whose f32 sums round
    ~3e-5 apart), the mutual matches exact (as tests/test_torch_gml.py
    holds 2 random layers)."""
    scene, q, _, _ = aachen
    fi = 0
    size = (torch.tensor(float(W)), torch.tensor(float(H)))
    d0 = q["descriptors"][:1, :128]
    d1 = scene.map.point_desc[np.clip(scene.map.frame_point_idx[fi], 0, None)][None].astype(np.float32)
    nk0 = normalize_kpts_like_reference(T(q["keypoints"][:1, :128]), *size).numpy()
    nk1 = normalize_kpts_like_reference(T(scene.map.frame_kp_uv[fi][None]).float(), *size).numpy()
    m0, m1 = q["mask"][:1, :128], scene.map.frame_kp_mask[fi][None].astype(bool)
    inputs = (d0, d1, nk0, nk1, m0, m1)
    assert d1.shape[1] == 2048 and d1.shape[1] + 1 > 1536
    jm = JaxGML(JaxGMLConfig(n_layers=2))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(5), *(jnp.asarray(a[:, :8]) for a in inputs))
    ref = np.asarray(jax.jit(jm.apply)(variables, *(jnp.asarray(a) for a in inputs))["plan"])
    tm = GML(GMLConfig(n_layers=2))
    tm.load_state_dict(gml_state_dict(variables["params"], 2), strict=True)
    with torch.no_grad():
        plan = tm(*map(T, inputs))["plan"]
    assert plan.shape == (1, 129, 2049)
    np.testing.assert_allclose(plan.numpy(), ref, rtol=1e-6, atol=2e-5)
    np.testing.assert_array_equal(mutual_matches(plan, 0.01).matches0.numpy(),
                                  np.asarray(jax_mutual_matches(jnp.asarray(ref), 0.01).matches0))


def _precision(q, kpt_point_idx, kpt_xyz):
    """Share of the matched keypoints whose 3-D point reprojects within 4 px
    through the true pose (fx = fy = 500, principal point at the centre)."""
    R = qvec2rotmat(T(q["qvec"]).double()).numpy()
    num = den = 0
    for i in range(R.shape[0]):
        sel = (kpt_point_idx[i] >= 0) & q["mask"][i]
        xc = kpt_xyz[i][sel].astype(np.float64) @ R[i].T + q["tvec"][i]
        z = np.clip(xc[:, 2], 1e-6, None)
        uv = np.stack([xc[:, 0] / z * 500.0 + W / 2, xc[:, 1] / z * 500.0 + H / 2], -1)
        num += int((np.linalg.norm(uv - q["keypoints"][i][sel], axis=-1) < 4.0).sum())
        den += int(sel.sum())
    return num / den


def _jax_gumbel_sampler(key, b, seg_k):
    """pram_tpu's RANSAC noise for its two calls per query: its Localizer
    splits the batch key per query, each query's key in two, the first
    half per candidate (engine/localizer.py:localize_frame), and
    geometry/pnp.py:_sample_triplets draws Gumbel noise from each key. The
    returned sampler stands in for the port's _sample_triplets: it takes
    the top 3 of that noise over the port's mask."""
    calls = [[], []]
    for k in jax.random.split(key, b):
        first, refine = jax.random.split(k, 2)
        calls[0].extend(jax.random.split(first, seg_k))
        calls[1].append(refine)
    calls = iter(calls)

    def sample(generator, mask, num_hyps):
        keys = next(calls)
        assert len(keys) == mask.shape[0]
        g = np.stack([np.asarray(jax.random.gumbel(k, (num_hyps, mask.shape[1]))) for k in keys])
        g = torch.where(mask[:, None, :], T(g), float("-inf"))
        return torch.topk(g, 3, dim=-1).indices

    return sample


def test_aachen_slice_matches_pram_tpu(aachen, monkeypatch):
    scene, q, variables, model = aachen
    b = q["keypoints"].shape[0]
    cls = np.where(q["gt_seg"] >= 0, q["gt_seg"] + 1, 0)
    logits = np.full((b, N_KPTS, N_CLUSTER + 1), -10.0, np.float32)
    np.put_along_axis(logits, cls[..., None], 10.0, axis=2)
    cam_p = np.tile(np.array([500, 500, W / 2, H / 2, 0, 0, 0, 0], np.float32), (b, 1))
    cam_s = np.tile(np.array([W, H], np.float32), (b, 1))
    args = (q["keypoints"], q["scores"], q["descriptors"], q["mask"], logits)
    key = jax.random.PRNGKey(7)

    # ---- pram_tpu (XLA path on the CPU, f32)
    jmodel = jada.AdaGML(jada.AdaGMLConfig())
    jres = jloc.Localizer(
        jax_to_device(scene.map), jax_make_adagml_match_fn(jmodel, variables), jloc.LocConfig(**LOC)
    ).localize_batch(key, JaxCamera(jnp.asarray(cam_p), jnp.asarray(cam_s)), *args)

    # ---- the port (plain versions on the CPU, f32), pram_tpu's triplets
    monkeypatch.setattr(tpnp, "_sample_triplets", _jax_gumbel_sampler(key, b, LOC["seg_k"]))
    recorded = []
    ada_fn = make_adagml_match_fn(model)

    def match_fn(*a):
        recorded.append(([t.numpy() for t in a], ada_fn(*a)))
        return recorded[-1][1]

    res = Localizer(to_device(scene.map, "cpu"), match_fn, LocConfig(**LOC)).localize_batch(
        torch.Generator().manual_seed(7), Camera(T(cam_p), T(cam_s)), *map(T, args)
    )

    margs, matches = recorded[0]
    jmatches = jax_make_adagml_match_fn(jmodel, variables)(*(jnp.asarray(a) for a in margs))
    np.testing.assert_array_equal(matches.numpy(), np.asarray(jmatches))
    assert (matches.numpy() >= 0).sum(-1).min() >= 32

    succ, jsucc = res.success.numpy(), np.asarray(jres.success)
    np.testing.assert_array_equal(succ, jsucc)
    assert succ.all()
    q_err, t_err = compute_pose_error(res.qvec, res.tvec, T(q["qvec"]).float(), T(q["tvec"]).float())
    assert (q_err < 5.0).all() and (t_err < 0.05).all()
    dq, dt = compute_pose_error(res.qvec, res.tvec, T(np.array(jres.qvec)), T(np.array(jres.tvec)))
    assert (dq < 0.1).all() and (dt < 0.005).all(), (dq, dt)
    # refinement ran over the 4096 points and was taken
    assert (res.num_inliers > res.initial_num_inliers).all()
    precision = _precision(q, res.kpt_point_idx.numpy(), res.kpt_xyz.numpy())
    jprecision = _precision(q, np.asarray(jres.kpt_point_idx), np.asarray(jres.kpt_xyz))
    assert abs(precision - jprecision) <= 0.01, (precision, jprecision)
