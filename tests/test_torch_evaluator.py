"""The port's evaluator (pram_tpu_torch/engine/evaluator.py) against
pram_tpu's, on the CPU in f32.

tests/test_evaluator_config.py's streaming case (3 batches of 2 rendered
queries of a 3-landmark scene, the NN matcher, ground-truth logits, seg_k 3)
plus a query a batch whose descriptors match nothing, through
``evaluate_queries`` in each of its three methods (plain, adaptive,
auto_refine), pipelined and synchronous: ``n_total``, ``n_success``, the
bucket counts and the failed cases equal to pram_tpu's, the recall
fractions within 1e-6, and each localized query's errors within 0.1 deg /
5 mm of pram_tpu's (RANSAC draws from jax.random on one side and a seeded
torch.Generator on the other). The JAX report has no segmentation metrics,
so neither has the port's. Also: the buckets of the fake localizer of
tests/test_evaluator_config.py, the producer's exception surfacing in the
consumer, and ``prepare`` running on the consuming thread.
"""

import threading

import numpy as np
import pytest
import torch

from pram_tpu.engine.evaluator import evaluate_queries as j_evaluate
from pram_tpu.engine.localizer import LocConfig as JLocConfig
from pram_tpu.engine.localizer import Localizer as JLocalizer
from pram_tpu.engine.matching import make_nn_match_fn as j_nn
from pram_tpu.maps.device import to_device as j_to_device
from pram_tpu.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.engine.evaluator import EvalReport, evaluate_queries
from pram_tpu_torch.engine.localizer import LocConfig, Localizer, LocResult
from pram_tpu_torch.engine.matching import make_nn_match_fn
from pram_tpu_torch.maps.device import to_device
from tests.test_engine import perfect_logits

CFG = dict(seg_k=3, min_inliers=12, min_kpts=16, threshold=5.0, num_hypotheses=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is on small tensors: one intra-op thread
    keeps it from oversubscribing the cores that parallel test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, n_cluster=3, points_per_cluster=80, n_ref_frames=4, desc_dim=32)
    batches = []
    for bi in range(3):
        qs = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
        desc = np.stack([q["descriptors"] for q in qs])
        desc[1] = rng.randn(*desc[1].shape).astype(np.float32)  # the second query matches nothing
        batches.append({
            "camera_params": np.stack([[500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0]] * 2).astype(np.float32),
            "camera_size": np.stack([[640.0, 480.0]] * 2).astype(np.float32),
            "keypoints": np.stack([q["keypoints"] for q in qs]),
            "scores": np.stack([q["scores"] for q in qs]),
            "descriptors": desc,
            "mask": np.stack([q["mask"] for q in qs]),
            "seg_logits": np.stack([perfect_logits(q["gt_seg"], scene.map.n_class, q["mask"]) for q in qs]),
            "gt_qvec": np.stack([q["qvec"] for q in qs]).astype(np.float32),
            "gt_tvec": np.stack([q["tvec"] for q in qs]),
            "names": [f"b{bi}_good", f"b{bi}_bad"],
        })
    loc = JLocalizer(j_to_device(scene.map), j_nn(), JLocConfig(**CFG))  # shared: its compiled steps too
    theirs = {method: j_evaluate(loc, iter(batches), log_fn=None, method=method)
              for method in ("plain", "adaptive", "auto_refine")}
    return scene, batches, theirs


@pytest.mark.parametrize("method", ["plain", "adaptive", "auto_refine"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_evaluate_queries_matches_pram_tpu(case, method, pipelined):
    scene, batches, theirs = case
    ref = theirs[method]
    loc = Localizer(to_device(scene.map, "cpu"), make_nn_match_fn(), LocConfig(**CFG))
    kw = {} if pipelined else dict(pipeline_depth=0, prefetch=0)
    rep = evaluate_queries(loc, iter([dict(b) for b in batches]), log_fn=None, method=method,
                           generator=torch.Generator().manual_seed(0), **kw)
    assert (rep.n_total, rep.n_success) == (ref.n_total, ref.n_success) == (6, 3)
    assert rep.bucket_counts == ref.bucket_counts
    assert rep.failed_cases == ref.failed_cases == ["b0_bad", "b1_bad", "b2_bad"]
    for k, v in ref.recall().items():
        assert abs(rep.recall()[k] - v) <= 1e-6
    ok = np.asarray(ref.q_errors) < 180.0
    np.testing.assert_array_equal(np.asarray(rep.q_errors) < 180.0, ok)
    np.testing.assert_allclose(np.asarray(rep.q_errors)[ok], np.asarray(ref.q_errors)[ok], atol=0.1)
    np.testing.assert_allclose(np.asarray(rep.t_errors)[ok], np.asarray(ref.t_errors)[ok], atol=0.005)
    assert len(rep.time_results["total"]) == 6 and rep.warmup_frames == 2
    assert rep.steady_fps() > 0 and "recall" in rep.summary()


class _FakeLocalizer:
    """Ground-truth poses for even queries, failures for odd ones."""

    def __init__(self, q, t):
        self._q, self._t = torch.from_numpy(q), torch.from_numpy(t)
        self.dmap = type("M", (), {"point_xyz": torch.zeros(1, 3), "point_desc": torch.zeros(1, 8)})

    def localize_batch(self, generator, camera, kpts, scores, descs, mask, logits):
        from pram_tpu_torch.geometry.rotations import qvec2rotmat

        b, n = kpts.shape[:2]
        return LocResult(
            qvec=self._q, tvec=self._t, R=qvec2rotmat(self._q),
            success=torch.tensor([(i % 2) == 0 for i in range(b)]),
            num_inliers=torch.full((b,), 50), matched_order=torch.zeros(b, dtype=torch.int64),
            matched_sid=torch.zeros(b, dtype=torch.int64), initial_num_inliers=torch.full((b,), 50),
            kpt_point_idx=torch.full((b, n), -1), kpt_xyz=torch.zeros(b, n, 3),
        )


def _fake_batch(b=4, n=16):
    rng = np.random.RandomState(0)
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (b, 1))
    t = rng.randn(b, 3).astype(np.float32)
    return q, t, {
        "camera_params": np.tile(np.array([500, 500, 320, 240, 0, 0, 0, 0], np.float32), (b, 1)),
        "camera_size": np.tile(np.array([640, 480], np.float32), (b, 1)),
        "keypoints": np.zeros((b, n, 2), np.float32), "scores": np.zeros((b, n), np.float32),
        "descriptors": np.zeros((b, n, 8), np.float32), "mask": np.ones((b, n), bool),
        "gt_qvec": q, "gt_tvec": t, "names": [f"q{i}" for i in range(b)],
    }


def test_buckets_and_prepare_on_the_consuming_thread():
    q, t, batch = _fake_batch()
    threads = []

    def prepare(b):
        threads.append(threading.current_thread())
        return {**b, "seg_logits": torch.zeros(4, 16, 4)}

    report = evaluate_queries(_FakeLocalizer(q, t), [batch], log_fn=None, prepare=prepare)
    assert threads == [threading.main_thread()]
    assert (report.n_total, report.n_success) == (4, 2)
    assert report.bucket_counts == [2, 2, 2, 2]
    assert report.recall()["0.05m/5.0deg"] == 0.5
    assert report.failed_cases == ["q1", "q3"]
    assert isinstance(report, EvalReport)


def test_producer_errors_surface_in_the_consumer():
    q, t, batch = _fake_batch()

    def batches():
        yield {**batch, "seg_logits": np.zeros((4, 16, 4), np.float32)}
        raise OSError("unreadable feature file")

    with pytest.raises(OSError, match="unreadable"):
        evaluate_queries(_FakeLocalizer(q, t), batches(), log_fn=None)
