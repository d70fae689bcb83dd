"""The port's slices against pram_tpu on the CPU, at full width.

Scene: bench.py's recall-guard scene (16 clusters x 400 points, 12 reference
frames, 128-d descriptors). Recognizer: SegNetViT (15 layers, d=256, nc113)
with weights/segnetvit_synthetic.msgpack in f32. Localizer: seg_k=1, 128
hypotheses, gn_iters=5, lo_rounds=1. 4 queries of 512 keypoints.

- First slice: mutual-NN matcher, no refinement.
- Second slice (bench.py's GML recall guard without the extractor): GML (9
  layers, d=256, weights/gml_synthetic.msgpack, f32) and projection
  refinement.

Logits are held to 2e-4 (15 f32 layers; summation order differs), candidate
ranks, NN matches and GML matches exactly. RANSAC draws its hypotheses from
jax.random on one side and a torch.Generator on the other, so poses are
held by outcome.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.engine import localizer as jloc
from pram_tpu.engine.matching import make_gml_match_fn as jax_make_gml_match_fn
from pram_tpu.engine.matching import make_nn_match_fn as jax_make_nn_match_fn
from pram_tpu.geometry.camera import Camera as JaxCamera
from pram_tpu.geometry.rotations import compute_pose_error as jax_pose_error
from pram_tpu.maps.device import to_device as jax_to_device
from pram_tpu.maps.synthetic import make_synthetic_scene as jax_make_scene
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu.models.nn_matcher import mutual_nn_match as jax_mutual_nn_match
from pram_tpu.models.segnetvit import SegNetViT as JaxSegNetViT
from pram_tpu.models.segnetvit import SegNetViTConfig as JaxSegNetViTConfig
from pram_tpu_torch.engine.localizer import LocConfig, Localizer
from pram_tpu_torch.engine.matching import make_gml_match_fn, make_nn_match_fn
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.maps.device import to_device
from pram_tpu_torch.maps.packed import PackedMap
from pram_tpu_torch.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.models.convert import load_gml, load_segnetvit
from pram_tpu_torch.models.segnetvit import SegNetViTConfig

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "segnetvit_synthetic.msgpack",
)
GML_WEIGHTS = os.path.join(os.path.dirname(WEIGHTS), "gml_synthetic.msgpack")
SCENE = dict(
    n_cluster=16, points_per_cluster=400, n_ref_frames=12, desc_dim=128,
    width=640, height=480, max_kp_per_frame=1024, max_ref_points=2048,
)
LOC = dict(
    seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
    do_refinement=False, gn_iters=5, lo_rounds=1,
)
T = torch.from_numpy


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, **SCENE)
    queries = [scene.render_query(rng, noise_px=0.3) for _ in range(4)]
    rng = np.random.RandomState(0)
    jscene = jax_make_scene(rng, **SCENE)

    def stack(key):
        return np.stack([q[key] for q in queries])

    return scene, jscene, {k: stack(k) for k in ("keypoints", "descriptors", "scores", "mask", "qvec", "tvec")}


def test_synthetic_scene_is_the_same(slice_inputs):
    scene, jscene, _ = slice_inputs
    for f in PackedMap.__dataclass_fields__:
        a, b = getattr(scene.map, f), getattr(jscene.map, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    dmap = to_device(scene.map, "cpu", desc_dtype=torch.bfloat16)
    assert dmap.point_desc.dtype == torch.bfloat16 and dmap.point_xyz.dtype == torch.float32
    np.testing.assert_array_equal(dmap.vrf_ref_point_idx.numpy(), scene.map.vrf_ref_point_idx)


def _jax_matches(dmap, cfg, logits, kpts, descs, mask):
    """pram_tpu's candidate ranks and NN matches for each query, unjitted."""
    n_seg = dmap.seg_vrf_slot.shape[0]
    sids, matches = [], []
    for i in range(kpts.shape[0]):
        rank = jloc.rank_candidates(dmap.seg_vrf_slot, dmap.vrf_frame_idx, logits[i], mask[i], cfg)
        tabs = jloc.gather_vrf_tables(dmap, rank.frames)
        ref_mask = tabs.mask & rank.cand_valid[:, None]
        consistent = jax.vmap(lambda rs, rm: jloc._semantic_consistency(
            rank.q_sids, rank.mask, rs, rm, n_seg))(tabs.sids, ref_mask)
        enough = jnp.sum(rank.kpt_masks.astype(jnp.int32), -1) >= cfg.min_kpts
        use = consistent & enough & (rank.sids >= 0)
        q_m = jnp.where(use[:, None], rank.kpt_masks & rank.mask[None], rank.mask[None])
        r_m = jnp.where(use[:, None], ref_mask & (tabs.sids == rank.sids[:, None]), ref_mask)
        d0 = jnp.broadcast_to(descs[i][None], (cfg.seg_k,) + descs[i].shape)
        sids.append(np.asarray(rank.sids))
        matches.append(np.asarray(jax_mutual_nn_match(d0, tabs.desc, q_m, r_m).matches0))
    return np.stack(sids), np.stack(matches)


def test_full_width_slice_matches_pram_tpu(slice_inputs):
    scene, jscene, q = slice_inputs
    b = q["keypoints"].shape[0]
    n_class = scene.map.n_class
    nk = (q["keypoints"] / np.array([640, 480], np.float32) - 0.5).astype(np.float32)
    cam_p = np.tile(np.array([500, 500, 320, 240, 0, 0, 0, 0], np.float32), (b, 1))
    cam_s = np.tile(np.array([640, 480], np.float32), (b, 1))

    # ---- pram_tpu (XLA path on the CPU, f32)
    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    jm = JaxSegNetViT(JaxSegNetViTConfig(descriptor_dim=128, n_class=113))
    logits_j = np.asarray(jax.jit(lambda d, k, m: jm.apply({"params": params}, d, k, m)["prediction"])(
        q["descriptors"], nk, q["mask"]))[:, :, :n_class]
    jcfg = jloc.LocConfig(**LOC)
    jdmap = jax_to_device(jscene.map)
    jres = jloc.Localizer(jdmap, jax_make_nn_match_fn(), jcfg).localize_batch(
        jax.random.PRNGKey(7), JaxCamera(jnp.asarray(cam_p), jnp.asarray(cam_s)),
        q["keypoints"], q["scores"], q["descriptors"], q["mask"], logits_j,
    )
    jq_err, jt_err = (np.asarray(a) for a in jax_pose_error(jres.qvec, jres.tvec, q["qvec"], q["tvec"]))
    j_sids, j_matches = _jax_matches(jdmap, jcfg, jnp.asarray(logits_j), jnp.asarray(q["keypoints"]),
                                     jnp.asarray(q["descriptors"]), jnp.asarray(q["mask"]))

    # ---- the port (plain versions on the CPU, f32)
    model = load_segnetvit(WEIGHTS, SegNetViTConfig(descriptor_dim=128, n_class=113), device="cpu")
    with torch.no_grad():
        logits_t = model(T(q["descriptors"]), T(nk), T(q["mask"]))["prediction"][:, :, :n_class]
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=2e-4, atol=2e-4)

    recorded = []
    nn = make_nn_match_fn()

    def match_fn(*args):
        out = nn(*args)
        recorded.append(out)
        return out

    loc = Localizer(to_device(scene.map, "cpu"), match_fn, LocConfig(**LOC))
    res = loc.localize_batch(
        torch.Generator().manual_seed(7), Camera(T(cam_p), T(cam_s)),
        T(q["keypoints"]), T(q["scores"]), T(q["descriptors"]), T(q["mask"]), logits_t,
    )
    np.testing.assert_array_equal(res.matched_sid.numpy(), np.where(np.asarray(jres.success), j_sids[:, 0], -1))
    np.testing.assert_array_equal(recorded[0].numpy(), j_matches.reshape(recorded[0].shape))
    assert (recorded[0].numpy() >= 0).sum(-1).min() >= 32

    q_err, t_err = compute_pose_error(res.qvec, res.tvec, T(q["qvec"]).float(), T(q["tvec"]))
    succ, jsucc = res.success.numpy(), np.asarray(jres.success)
    assert (succ == jsucc).sum() >= 3
    both = succ & jsucc
    assert both.any()
    assert (q_err.numpy()[both] < 5.0).all() and (t_err.numpy()[both] < 0.05).all()
    assert (jq_err[both] < 5.0).all() and (jt_err[both] < 0.05).all()


def test_full_width_gml_refinement_slice_matches_pram_tpu(slice_inputs):
    scene, jscene, q = slice_inputs
    b = q["keypoints"].shape[0]
    n_class = scene.map.n_class
    nk = (q["keypoints"] / np.array([640, 480], np.float32) - 0.5).astype(np.float32)
    cam_p = np.tile(np.array([500, 500, 320, 240, 0, 0, 0, 0], np.float32), (b, 1))
    cam_s = np.tile(np.array([640, 480], np.float32), (b, 1))
    loc = dict(LOC, do_refinement=True)

    def restore(path):
        with open(path, "rb") as f:
            params = serialization.msgpack_restore(f.read())
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)

    # ---- pram_tpu (XLA path on the CPU, f32)
    jm = JaxSegNetViT(JaxSegNetViTConfig(descriptor_dim=128, n_class=113))
    rparams = restore(WEIGHTS)
    logits_j = np.asarray(jax.jit(lambda d, k, m: jm.apply({"params": rparams}, d, k, m)["prediction"])(
        q["descriptors"], nk, q["mask"]))[:, :, :n_class]
    jgml = JaxGML(JaxGMLConfig())
    gvars = {"params": restore(GML_WEIGHTS)}
    jres = jloc.Localizer(jax_to_device(jscene.map), jax_make_gml_match_fn(jgml, gvars), jloc.LocConfig(**loc)).localize_batch(
        jax.random.PRNGKey(7), JaxCamera(jnp.asarray(cam_p), jnp.asarray(cam_s)),
        q["keypoints"], q["scores"], q["descriptors"], q["mask"], logits_j,
    )
    jq_err, jt_err = (np.asarray(a) for a in jax_pose_error(jres.qvec, jres.tvec, q["qvec"], q["tvec"]))

    # ---- the port (plain versions on the CPU, f32)
    model = load_segnetvit(WEIGHTS, SegNetViTConfig(descriptor_dim=128, n_class=113), device="cpu")
    with torch.no_grad():
        logits_t = model(T(q["descriptors"]), T(nk), T(q["mask"]))["prediction"][:, :, :n_class]
    recorded = []
    gml_fn = make_gml_match_fn(load_gml(GML_WEIGHTS, device="cpu"))

    def match_fn(*args):
        recorded.append(([a.numpy() for a in args], gml_fn(*args)))
        return recorded[-1][1]

    res = Localizer(to_device(scene.map, "cpu"), match_fn, LocConfig(**loc)).localize_batch(
        torch.Generator().manual_seed(7), Camera(T(cam_p), T(cam_s)),
        T(q["keypoints"]), T(q["scores"]), T(q["descriptors"]), T(q["mask"]), logits_t,
    )

    # GML's matches on the matcher's inputs, against pram_tpu's GML on the same inputs
    args, matches = recorded[0]
    jmatches = jax_make_gml_match_fn(jgml, gvars)(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(matches.numpy(), np.asarray(jmatches))
    assert (matches.numpy() >= 0).sum(-1).min() >= 32

    q_err, t_err = compute_pose_error(res.qvec, res.tvec, T(q["qvec"]).float(), T(q["tvec"]))
    succ, jsucc = res.success.numpy(), np.asarray(jres.success)
    assert (succ == jsucc).sum() >= 3
    both = succ & jsucc
    assert both.any()
    assert (q_err.numpy()[both] < 5.0).all() and (t_err.numpy()[both] < 0.05).all()
    assert (jq_err[both] < 5.0).all() and (jt_err[both] < 0.05).all()
    # refinement ran and was taken: more inliers than the first pose had
    assert (res.num_inliers.numpy()[succ] > res.initial_num_inliers.numpy()[succ]).all()
    assert (np.asarray(jres.num_inliers)[jsucc] > np.asarray(jres.initial_num_inliers)[jsucc]).all()
