"""Matching refinement, auto refinement and the adaptive two-phase step of
the port against pram_tpu on the CPU, in f32.

- ``LocConfig``: the same fields, in the same order, with the same defaults.
- ``refine_matching_core`` on tests/test_refinement_paths.py's scene and
  query (its keypoints of the top-ranked landmark shifted by 27 px, so the
  stacked RANSAC must side with the covisible frames' unbiased majority)
  and on the same query unshifted, batched, covisibility_frame=8, the NN
  matcher, RANSAC fed pram_tpu's own triplet draws: the same matches and
  ``success``, poses within 0.25 deg / 1 cm of each other (as
  tests/test_torch_geometry.py holds RANSAC), equal ``kpt_point_idx`` on
  >= 95% of pram_tpu's inlier keypoints.
- ``Localizer.localize_batch`` with ``refinement_method="matching"`` on a
  2-layer GML (the trained checkpoint's first layers and its output
  projection): GML's matches on every matcher call's inputs equal to
  pram_tpu's GML on the same inputs; outcomes as pram_tpu's.
- tests/test_adaptive.py's cases on the port (an easy batch, a bad top-1
  landmark, a mixed batch merged per frame, the auto-refine dispatch),
  held by outcome against pram_tpu's Localizer on the same batch: RANSAC
  draws from jax.random on one side and a torch.Generator on the other.
"""

import dataclasses
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
from pram_tpu.geometry import pnp as jpnp
from pram_tpu.geometry.camera import Camera as JaxCamera
from pram_tpu.maps.device import to_device as jax_to_device
from pram_tpu.maps.synthetic import make_synthetic_scene as jax_make_scene
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu_torch.engine import localizer as tloc
from pram_tpu_torch.engine.localizer import LocConfig, Localizer
from pram_tpu_torch.engine.matching import make_gml_match_fn, make_nn_match_fn
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error, rotmat2qvec
from pram_tpu_torch.maps.device import to_device
from pram_tpu_torch.models.convert import load_gml
from pram_tpu_torch.models.gml import GMLConfig
from tests.test_engine import perfect_logits
from tests.test_refinement_paths import _build_case

T = torch.from_numpy
GML_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights", "gml_synthetic.msgpack",
)
CAM_P = np.array([500, 500, 320, 240, 0, 0, 0, 0], np.float32)
CAM_S = np.array([640, 480], np.float32)


def _cams(b):
    return (Camera(T(np.tile(CAM_P, (b, 1))), T(np.tile(CAM_S, (b, 1)))),
            JaxCamera(jnp.asarray(np.tile(CAM_P, (b, 1))), jnp.asarray(np.tile(CAM_S, (b, 1)))))


def _near_truth(res, qvec, tvec, i, t_tol=0.05, q_tol=5.0):
    dq, dt = compute_pose_error(T(np.array(res.qvec[i])), T(np.array(res.tvec[i])),
                                T(np.asarray(qvec, np.float32)), T(np.asarray(tvec, np.float32)))
    return float(dq) < q_tol and float(dt) < t_tol


def test_loc_config_fields_and_defaults_match_pram_tpu():
    ours = [(f.name, f.default) for f in dataclasses.fields(LocConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jloc.LocConfig)]
    assert ours == theirs
    cfg = LocConfig(max_vrf_kpts=1024, match_threshold=0.1, covisibility_frame=8)
    assert (cfg.max_vrf_kpts, cfg.match_threshold, cfg.covisibility_frame) == (1024, 0.1, 8)


@pytest.fixture(scope="module")
def biased_case():
    scene, q, kpts, logits, biased = _build_case(np.random.RandomState(0))
    return scene, q, kpts, logits, biased


def test_refine_matching_core_matches_pram_tpu(biased_case):
    scene, q, kpts_biased, _, biased = biased_case
    m = scene.map
    gt_seg, mask = q["gt_seg"], q["mask"]
    top_sid = int(np.argmax(np.bincount(gt_seg[mask & (gt_seg >= 0)], minlength=m.n_class)))
    slot = int(m.seg_vrf_slot[top_sid])
    kpts = np.stack([kpts_biased, q["keypoints"]]).astype(np.float32)  # shifted, then as rendered
    descs = np.stack([q["descriptors"]] * 2)
    scores = np.stack([q["scores"]] * 2)
    masks = np.stack([mask] * 2)
    kw = dict(seg_k=1, min_inliers=8, min_kpts=8, threshold=5.0, num_hypotheses=256,
              refinement_method="matching", covisibility_frame=8)
    jcfg, cfg = jloc.LocConfig(**kw), LocConfig(**kw)
    jdmap = jax_to_device(m)
    camera, _ = _cams(2)
    jcam = JaxCamera(jnp.asarray(CAM_P), jnp.asarray(CAM_S))
    jnn = jax_make_nn_match_fn()

    jout, trips, jmatches = [], [], []
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    for i in range(2):
        args = (jnp.asarray(kpts[i]), jnp.asarray(scores[i]), jnp.asarray(descs[i]), jnp.asarray(masks[i]))
        jout.append([np.asarray(a) for a in jloc._refine_by_matching(
            keys[i], jdmap, jnn, jcam, *args, jnp.asarray(slot), jcfg)])
        # pram_tpu's matches and the triplets its RANSAC drew over them
        covis = jdmap.vrf_covis[slot][: jcfg.covisibility_frame]
        tabs = jloc.gather_vrf_tables(jdmap, jnp.clip(covis, 0, jdmap.frame_R.shape[0] - 1))
        c = covis.shape[0]
        nk0 = jnp.broadcast_to(jloc.normalize_kpts_like_reference(args[0], 640.0, 480.0)[None], (c,) + kpts[i].shape)
        nk1 = jax.vmap(jloc.normalize_kpts_like_reference)(tabs.uv, tabs.w, tabs.h)
        mt = jnn(jnp.broadcast_to(args[2][None], (c,) + descs[i].shape), nk0,
                 jnp.broadcast_to(args[1][None], (c, kpts.shape[1])), jnp.broadcast_to(args[3][None], (c, kpts.shape[1])),
                 tabs.desc, nk1, tabs.score, tabs.mask & (covis >= 0)[:, None])
        jmatches.append(np.asarray(mt))
        valid_all = ((mt >= 0) & args[3][None]).reshape(-1)
        trips.append(np.asarray(jpnp._sample_triplets(keys[i], valid_all, jcfg.num_hypotheses)))

    dmap = to_device(m, "cpu")
    cvalid, tabs = tloc.gather_covis_tables(dmap, torch.tensor([slot, slot]), cfg)
    recorded = []
    nn = make_nn_match_fn()

    def match_fn(*a):
        recorded.append(nn(*a))
        return recorded[-1]

    got = tloc.refine_matching_core(match_fn, camera, T(kpts), T(scores), T(descs), T(masks), cvalid, tabs, cfg,
                                    triplets=T(np.stack(trips)))
    R, t, num, ok, pidx, kxyz = (a.numpy() for a in got)
    assert len(recorded) == 1 and recorded[0].shape[0] == 2 * cvalid.shape[1]  # one call over B * C
    for i in range(2):
        jR, jt, jnum, jok, jpidx, jxyz = jout[i]
        np.testing.assert_array_equal(recorded[0].numpy().reshape(2, -1, kpts.shape[1])[i], jmatches[i])
        assert bool(ok[i]) == bool(jok)
        assert abs(int(num[i]) - int(jnum)) <= 3
        dq, dt = compute_pose_error(rotmat2qvec(T(R[i])), T(t[i]), rotmat2qvec(T(np.array(jR))), T(np.array(jt)))
        assert float(dq) < 0.25 and float(dt) < 0.01
        dq, dt = compute_pose_error(rotmat2qvec(T(R[i])), T(t[i]), T(q["qvec"]).float(), T(q["tvec"]))
        assert float(dq) < 5.0 and float(dt) < 0.05
        inl = jpidx >= 0
        assert inl.sum() > 50
        assert (pidx[i][inl] == jpidx[inl]).mean() >= 0.95
        kept = pidx[i] >= 0
        np.testing.assert_array_equal(kxyz[i][kept & inl], jxyz[kept & inl])
    # the unbiased covisible majority wins for the shifted query too
    gt_pt = q["point_idx"]
    sel = (pidx[0] >= 0) & ~biased
    assert (pidx[0][sel] == gt_pt[sel]).mean() > 0.95


def _gml_pair():
    """pram_tpu's GML and the port's, 2 layers: the trained checkpoint's
    first two layers and its output projection."""
    with open(GML_WEIGHTS, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    keep = {k: v for k, v in tree.items() if not k.startswith(("self_attn_", "cross_attn_", "out_proj_"))}
    for i in range(2):
        keep[f"self_attn_{i}"], keep[f"cross_attn_{i}"] = tree[f"self_attn_{i}"], tree[f"cross_attn_{i}"]
    keep["out_proj_1"] = tree["out_proj_8"]
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), keep)
    jfn = jax_make_gml_match_fn(JaxGML(JaxGMLConfig(n_layers=2)), {"params": params})
    return jfn, make_gml_match_fn(load_gml(GML_WEIGHTS, GMLConfig(n_layers=2), device="cpu"))


def test_localize_batch_matching_refinement_small_gml():
    rng = np.random.RandomState(0)
    kw = dict(n_cluster=8, points_per_cluster=200, n_ref_frames=8, desc_dim=128, max_kp_per_frame=1024,
              max_ref_points=2048)
    scene = jax_make_scene(rng, **kw)
    queries = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
    st = {k: np.stack([qq[k] for qq in queries]) for k in ("keypoints", "scores", "descriptors", "mask", "qvec", "tvec")}
    logits = np.stack([perfect_logits(qq["gt_seg"], scene.map.n_class, qq["mask"]) for qq in queries])
    loc_kw = dict(seg_k=1, min_inliers=16, min_kpts=32, threshold=5.0, num_hypotheses=128, gn_iters=5, lo_rounds=1,
                  refinement_method="matching", covisibility_frame=4)
    jfn, gml_fn = _gml_pair()
    camera, jcamera = _cams(2)
    jres = jloc.Localizer(jax_to_device(scene.map), jfn, jloc.LocConfig(**loc_kw)).localize_batch(
        jax.random.PRNGKey(2), jcamera, *(st[k] for k in ("keypoints", "scores", "descriptors", "mask")), logits)

    recorded = []

    def match_fn(*args):
        recorded.append(([a.numpy() for a in args], gml_fn(*args)))
        return recorded[-1][1]

    res = Localizer(to_device(scene.map, "cpu"), match_fn, LocConfig(**loc_kw)).localize_batch(
        torch.Generator().manual_seed(2), camera,
        *(T(st[k]) for k in ("keypoints", "scores", "descriptors", "mask")), T(logits))
    # the first stage's matcher call over B * seg_k problems, then the
    # refinement's over B * C: each equal to pram_tpu's GML on its inputs
    assert [r[1].shape[0] for r in recorded] == [2, 2 * 4]
    for args, matches in recorded:
        np.testing.assert_array_equal(matches.numpy(), np.asarray(jfn(*(jnp.asarray(a) for a in args))))
        assert (matches.numpy() >= 0).sum(-1).max() >= 32
    assert res.success.tolist() == np.asarray(jres.success).tolist() == [True, True]
    for i in range(2):
        assert _near_truth(res, st["qvec"][i], st["tvec"][i], i)
        assert _near_truth(jres, st["qvec"][i], st["tvec"][i], i)
    # refinement by matching ran and was taken: it stacks C frames' matches
    assert (res.num_inliers > res.initial_num_inliers).all()
    assert (np.asarray(jres.num_inliers) > np.asarray(jres.initial_num_inliers)).all()


@pytest.fixture(scope="module")
def adaptive_scene():
    """tests/test_adaptive.py's scene and localizer configuration, on both
    sides, and its queries: easy ones, and hard ones whose rank-1 landmark
    is wrong (the true one ranks second)."""
    rng = np.random.RandomState(0)
    scene = jax_make_scene(rng, n_cluster=4, points_per_cluster=150, n_ref_frames=6, desc_dim=64)
    n_class = scene.map.n_class
    kw = dict(seg_k=4, min_inliers=16, min_kpts=32, threshold=5.0, num_hypotheses=128, covisibility_frame=4)
    easy = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
    hard = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
    frames = {}
    for name, qs, corrupt in (("e", easy, False), ("h", hard, True)):
        for i, qq in enumerate(qs):
            lg = perfect_logits(qq["gt_seg"], n_class, qq["mask"])
            if corrupt:
                wrong = (np.asarray(qq["gt_seg"]) + 2) % 4
                lg[:, :] -= 1.0
                lg[np.arange(len(lg)), wrong + 1] = 30.0
            frames[f"{name}{i}"] = dict(qq, logits=lg)
    jloc_ = jloc.Localizer(jax_to_device(scene.map), jax_make_nn_match_fn(), jloc.LocConfig(**kw))
    return scene, frames, kw, jloc_


def _batch(frames, names):
    return [np.stack([frames[n][k] for n in names]) for k in ("keypoints", "scores", "descriptors", "mask", "logits")]


class CountingNN:
    """The NN matcher, counting the problems of each call."""

    def __init__(self):
        self.fn, self.calls = make_nn_match_fn(), []

    def __call__(self, *args):
        self.calls.append(args[0].shape[0])
        return self.fn(*args)


@pytest.mark.parametrize("names", [("e0", "e1"), ("h0", "h1"), ("e0", "h0")], ids=["easy", "bad_top1", "mixed"])
def test_adaptive_matches_pram_tpu(adaptive_scene, names):
    """Phase 1 (seg_k = 1) alone where every frame succeeds; the full sweep
    where some frame fails, merged per frame: a frame phase 1 localized
    keeps phase 1's result."""
    scene, frames, kw, jl = adaptive_scene
    arrays = _batch(frames, names)
    camera, jcamera = _cams(2)
    jres = jl.localize_batch_adaptive(jax.random.PRNGKey(3), jcamera, *arrays)
    nn = CountingNN()
    loc = Localizer(to_device(scene.map, "cpu"), nn, LocConfig(**kw))
    res = loc.localize_batch_adaptive(torch.Generator().manual_seed(3), camera, *(T(a) for a in arrays))
    phase1 = Localizer(to_device(scene.map, "cpu"), make_nn_match_fn(), LocConfig(**dict(kw, seg_k=1)))
    r1 = phase1.localize_batch(torch.Generator().manual_seed(3), camera, *(T(a) for a in arrays))
    hard = [n.startswith("h") for n in names]
    assert r1.success.tolist() == [not h for h in hard]  # the corrupted rank-1 landmark fails phase 1
    # matcher calls: phase 1 over B problems, the sweep over B * seg_k only if a frame failed
    assert nn.calls == ([2] if not any(hard) else [2, 2 * kw["seg_k"]])
    for i, n in enumerate(names):
        assert bool(res.success[i]) and bool(jres.success[i])
        assert _near_truth(res, frames[n]["qvec"], frames[n]["tvec"], i)
        assert _near_truth(jres, frames[n]["qvec"], frames[n]["tvec"], i)
        if not hard[i]:
            for a, b in zip(res, r1):
                assert torch.equal(a[i], b[i])
        else:
            # the sweep's first landmark to localize it, past the wrong ones
            assert int(res.matched_order[i]) == int(np.asarray(jres.matched_order)[i]) >= 1


def test_auto_refine_dispatch_matches_pram_tpu(adaptive_scene):
    """Nothing trusted: the rerun with matching refinement, drawn from the
    same generator after the first pass, is the result for every frame;
    everything trusted: the first pass's result, and no rerun."""
    scene, frames, kw, jl = adaptive_scene
    arrays = _batch(frames, ("e0", "e1"))
    tarrays = [T(a) for a in arrays]
    camera, jcamera = _cams(2)
    dmap = to_device(scene.map, "cpu")
    nn = CountingNN()
    loc = Localizer(dmap, nn, LocConfig(**kw))
    res = loc.localize_batch_auto_refine(torch.Generator().manual_seed(4), camera, *tarrays, trust_inliers=10**6)
    assert nn.calls == [2 * 4, 2 * 4, 2 * 4]  # first pass; the rerun's first stage and its refinement
    g = torch.Generator().manual_seed(4)
    loc.localize_batch(g, camera, *tarrays)
    by_matching = Localizer(dmap, make_nn_match_fn(), LocConfig(**dict(kw, refinement_method="matching")))
    rerun = by_matching.localize_batch(g, camera, *tarrays)
    for a, b in zip(res, rerun):
        assert torch.equal(a, b)
    jres = jl.localize_batch_auto_refine(jax.random.PRNGKey(4), jcamera, *arrays, trust_inliers=10**6)
    for i, n in enumerate(("e0", "e1")):
        assert bool(res.success[i]) and bool(jres.success[i])
        assert _near_truth(res, frames[n]["qvec"], frames[n]["tvec"], i)
        assert _near_truth(jres, frames[n]["qvec"], frames[n]["tvec"], i)

    nn.calls.clear()
    trusted = loc.localize_batch_auto_refine(torch.Generator().manual_seed(4), camera, *tarrays, trust_inliers=1)
    plain = loc.localize_batch(torch.Generator().manual_seed(4), camera, *tarrays)
    for a, b in zip(trusted, plain):
        assert torch.equal(a, b)
    assert nn.calls == [2 * 4] * 2
    jtrusted = jl.localize_batch_auto_refine(jax.random.PRNGKey(4), jcamera, *arrays, trust_inliers=1)
    assert np.asarray(jtrusted.success).all() and trusted.success.all()
