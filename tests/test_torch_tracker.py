"""The port's tracker (pram_tpu_torch/engine/tracker.py) against pram_tpu's,
on the CPU in f32.

- ``track_frame`` on tests/test_tracker.py's scene with the NN matcher, the
  port's RANSAC fed pram_tpu's own Gumbel noise for its two draws (the
  tracking PnP's and the projection refinement's, from the two halves of
  the step's key): matches exactly equal, ``success`` equal, inlier counts
  within 3, poses within 5 mm / 0.1 deg of each other, with the
  refinement taken (trigger 1000, above the step's ~375 tracked inliers)
  and not taken (the default trigger, 256).
- ``Tracker``'s state machine as tests/test_tracker.py:46 has it: lost at
  the start (``track`` returns None), seeded by a localization, tracking a
  new frame within 5 cm, and lost again after a frame it cannot track.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.engine.localizer import LocConfig as JLocConfig
from pram_tpu.engine.matching import make_nn_match_fn as j_nn
from pram_tpu.engine.tracker import track_frame as j_track_frame
from pram_tpu.geometry.camera import Camera as JCamera
from pram_tpu.maps.device import to_device as j_to_device
from pram_tpu.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.engine.localizer import LocConfig, LocResult
from pram_tpu_torch.engine.matching import make_nn_match_fn
from pram_tpu_torch.engine.tracker import Tracker, track_frame
from pram_tpu_torch.geometry import pnp as tpnp
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.maps.device import to_device

T = torch.from_numpy
CFG = dict(min_inliers=16, threshold=5.0, num_hypotheses=128)
CAM_P = np.array([500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
CAM_S = np.array([640.0, 480.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is on small tensors: one intra-op thread
    keeps it from oversubscribing the cores that parallel test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_gumbel_sampler(keys):
    """Stands in for the port's _sample_triplets: the top 3 of pram_tpu's
    Gumbel noise from each key in turn (one call a key), over the port's
    mask."""
    keys = iter(keys)

    def sample(generator, mask, num_hyps):
        g = np.array(jax.random.gumbel(next(keys), (num_hyps, mask.shape[1])))
        g = torch.where(mask[:, None, :], T(g)[None], float("-inf"))
        return torch.topk(g, 3, dim=-1).indices

    return sample


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, n_cluster=4, points_per_cluster=150, n_ref_frames=6, desc_dim=64)
    last = scene.render_query(rng, noise_px=0.2)
    curr = scene.render_query(rng, noise_px=0.2)
    return scene, last, curr


@pytest.mark.parametrize("refine_below", [1000, 256])
def test_track_frame_matches_pram_tpu(case, monkeypatch, refine_below):
    scene, last, curr = case
    key = jax.random.PRNGKey(3)
    jres = j_track_frame(
        key, j_to_device(scene.map), j_nn(), JCamera(jnp.asarray(CAM_P), jnp.asarray(CAM_S)),
        *(jnp.asarray(curr[k]) for k in ("keypoints", "scores", "descriptors", "mask")),
        *(jnp.asarray(last[k]) for k in ("keypoints", "scores", "descriptors", "mask")),
        jnp.asarray(last["point_idx"], jnp.int32), jnp.asarray(0, jnp.int32), JLocConfig(**CFG),
        refine_below=refine_below,
    )
    jmatches = np.asarray(j_nn()(
        *(jnp.asarray(curr[k])[None] for k in ("descriptors",)),
        None, None, jnp.asarray(curr["mask"])[None],
        jnp.asarray(last["descriptors"])[None], None, None, jnp.asarray(last["mask"])[None],
    ))[0]

    monkeypatch.setattr(tpnp, "_sample_triplets", jax_gumbel_sampler(jax.random.split(key, 2)))
    recorded = []
    nn = make_nn_match_fn()

    def match_fn(*a):
        recorded.append(nn(*a))
        return recorded[-1]

    res = track_frame(
        to_device(scene.map, "cpu"), match_fn, Camera(T(CAM_P), T(CAM_S)),
        *(T(np.asarray(curr[k])) for k in ("keypoints", "scores", "descriptors", "mask")),
        *(T(np.asarray(last[k])) for k in ("keypoints", "scores", "descriptors", "mask")),
        T(np.asarray(last["point_idx"])), torch.tensor(0), LocConfig(**CFG), refine_below=refine_below,
        generator=torch.Generator().manual_seed(0),
    )
    assert len(recorded) == 1
    np.testing.assert_array_equal(recorded[0][0].numpy(), jmatches)
    assert bool(res.success) == bool(jres.success)
    assert abs(int(res.num_inliers) - int(jres.num_inliers)) <= 3
    dq, dt = compute_pose_error(res.qvec, res.tvec, T(np.asarray(jres.qvec)), T(np.asarray(jres.tvec)))
    assert float(dq) < 0.1 and float(dt) < 0.005
    agree = (res.kpt_point_idx.numpy() == np.asarray(jres.kpt_point_idx))[np.asarray(jres.kpt_point_idx) >= 0]
    assert agree.mean() >= 0.95
    gq, gt = compute_pose_error(res.qvec, res.tvec, T(curr["qvec"]).float(), T(curr["tvec"]))
    assert float(gq) < 5.0 and float(gt) < 0.05


def test_tracker_state_machine(case):
    scene, q0, q1 = case
    tracker = Tracker(to_device(scene.map, "cpu"), make_nn_match_fn(), LocConfig(**CFG))
    cam = Camera(T(CAM_P), T(CAM_S))

    def frame(q):
        return tuple(T(np.asarray(q[k])) for k in ("keypoints", "scores", "descriptors", "mask"))

    gen = torch.Generator().manual_seed(0)
    assert tracker.lost
    assert tracker.track(gen, cam, *frame(q0)) is None

    n = len(q0["mask"])
    loc = LocResult(
        qvec=T(q0["qvec"]).float(), tvec=T(q0["tvec"]), R=T(q0["R"]), success=torch.tensor(True),
        num_inliers=torch.tensor(100), matched_order=torch.tensor(0), matched_sid=torch.tensor(0),
        initial_num_inliers=torch.tensor(100), kpt_point_idx=T(np.asarray(q0["point_idx"])),
        kpt_xyz=torch.zeros(n, 3),
    )
    tracker.update_from_localization(*frame(q0), loc, 0)
    assert not tracker.lost

    res = tracker.track(gen, cam, *frame(q1))
    assert res is not None and bool(res.success)
    _, te = compute_pose_error(res.qvec, res.tvec, T(q1["qvec"]).float(), T(q1["tvec"]))
    assert float(te) < 0.05 and not tracker.lost

    # a frame whose descriptors match nothing of the last one: lost
    rng = np.random.RandomState(5)
    kp, sc, de, mk = frame(q1)
    junk = torch.nn.functional.normalize(torch.from_numpy(rng.randn(*de.shape).astype(np.float32)), dim=-1)
    res = tracker.track(gen, cam, kp, sc, junk, mk)
    assert not bool(res.success) and tracker.lost
    assert tracker.track(gen, cam, *frame(q1)) is None
