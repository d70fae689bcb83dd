"""The port's map-building CLI (pram_tpu_torch/cli/build_map.py) on the CPU:
against ``pram_tpu.cli.build_map`` on the same npy feature directory and
triangulated model with Birch, every artifact equal (the cluster,
descriptor and VRF ``.npy`` files, the compressed model and ``feats/``);
then the port's counterpart of tests/test_full_pipeline.py: triangulation,
``cli.build_map`` with KMeans, ``load_scene_map`` and the port's
``Localizer``, a novel query within 5 cm / 5 deg.
"""

import os

import numpy as np
import pytest
import torch

from pram_tpu_torch.cli.build_map import main as build_map
from pram_tpu_torch.maps.colmap_io import read_model
from pram_tpu_torch.mapping.triangulate import triangulate_model
from tests.test_torch_mapping import assert_same_tree
from tests.torch_mapping_scene import (
    FOCAL,
    H,
    W,
    keypoints_by_name,
    make_scene,
    matches_by_pair,
    render,
    write_inputs,
)


@pytest.fixture(scope="module")
def triangulated(tmp_path_factory):
    """The mapping scene's inputs on disk and its model triangulated by the port."""
    root = tmp_path_factory.mktemp("build_map")
    scene = make_scene(np.random.RandomState(0))
    paths = write_inputs(scene, str(root))
    cameras, images, _ = read_model(paths["ref"], ".bin")
    paths["model"] = str(root / "model")
    stats = triangulate_model(cameras, images, keypoints_by_name(scene), scene["pairs"], matches_by_pair(scene),
                              paths["model"])
    assert stats["num_points"] > 200
    return scene, paths, root


def _flags(paths, method, out):
    return ["--model", paths["model"], "--features", paths["npy"], "--output", out, "--n_cluster", "4",
            "--cluster_method", method, "--vrf_min_obs", "10", "--compress_radius", "8", "--export_descriptors"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_build_map_birch_artifacts_match_pram_tpu(triangulated):
    from pram_tpu.cli.build_map import main as jax_build_map

    _, paths, root = triangulated
    jax_out, port_out = str(root / "jax_landmarks"), str(root / "port_landmarks")
    jax_build_map(_flags(paths, "birch", jax_out))
    stages = build_map(_flags(paths, "birch", port_out) + ["--device", "cpu"])
    assert set(stages) == {"load", "outliers", "clustering", "descriptors", "vrf", "compression", "export"}
    files = _files(jax_out)
    assert files == _files(port_out)
    assert "point3D_cluster_n4_xz_birch.npy" in files and "point3D_vrf_n4_xz_birch.npy" in files
    assert "compress_model_birch/points3D.bin" in files and "feats/db+v0.png.npy" in files
    for rel in files:
        a, b = os.path.join(jax_out, rel), os.path.join(port_out, rel)
        if rel.endswith(".npy"):
            assert_same_tree(np.load(b, allow_pickle=True)[()], np.load(a, allow_pickle=True)[()], rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel
    labels = np.load(os.path.join(port_out, "point3D_cluster_n4_xz_birch.npy"), allow_pickle=True)[()]["label"]
    assert sorted(np.unique(labels).tolist()) == [0, 1, 2, 3]


def test_build_map_on_cuda_without_a_card_raises(triangulated, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    _, paths, _ = triangulated
    with pytest.raises((RuntimeError, AssertionError)):
        build_map(_flags(paths, "kmeans", str(tmp_path / "out")) + ["--device", "cuda"])


def test_offline_to_online_pipeline_on_cpu(triangulated):
    from pram_tpu_torch.engine.localizer import LocConfig, Localizer
    from pram_tpu_torch.engine.matching import make_nn_match_fn
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.loader import load_scene_map
    from pram_tpu_torch.maps.synthetic import _look_at, _rotmat2qvec_np
    from tests.test_engine import perfect_logits

    scene, paths, root = triangulated
    out = str(root / "kmeans_landmarks")
    build_map(_flags(paths, "kmeans", out)[:-1] + ["--cluster_mode", "xyz", "--device", "cpu"])
    pmap = load_scene_map(out, n_cluster=4, cluster_mode="xyz", cluster_method="kmeans", with_compress=True)
    assert pmap.num_points > 100

    rng = np.random.RandomState(1)
    center, xyz, desc = scene["center"], scene["xyz"], scene["desc"]
    Rq, tq = _look_at(center + np.array([0.3, -0.2, -7.0]), center + [0.1, 0, 0])
    uv, vis = render(xyz, Rq, tq)
    sel = np.nonzero(vis)[0][:512]
    nq, K = len(sel), 512
    kpts = np.zeros((K, 2), np.float32)
    descs = np.zeros((K, desc.shape[1]), np.float32)
    mask = np.zeros((K,), bool)
    kpts[:nq] = uv[sel] + rng.randn(nq, 2) * 0.3
    descs[:nq] = desc[sel]
    mask[:nq] = True
    # recognition logits from the map's own labels (nearest-descriptor lookup)
    sim = descs @ pmap.point_desc.T
    nn = np.argmax(sim, -1)
    gt_seg = np.where(mask & (np.max(sim, -1) > 0.99), pmap.point_seg[nn], -1)
    logits = perfect_logits(gt_seg, pmap.n_class, mask)

    cfg = LocConfig(seg_k=4, min_inliers=16, min_kpts=32, threshold=5.0, num_hypotheses=128)
    loc = Localizer(to_device(pmap, "cpu"), make_nn_match_fn(), cfg)
    cam = Camera(torch.tensor([[FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0, 0]]), torch.tensor([[float(W), float(H)]]))
    t = lambda a: torch.from_numpy(a[None])
    res = loc.localize_batch(torch.Generator().manual_seed(0), cam, t(kpts), t(mask.astype(np.float32)),
                             t(descs), t(mask), t(logits))
    assert bool(res.success[0])
    qe, te = compute_pose_error(res.qvec, res.tvec, torch.from_numpy(_rotmat2qvec_np(Rq)[None]).float(),
                                torch.from_numpy(tq[None]).float())
    assert float(qe[0]) < 5.0, f"rotation err {float(qe[0])}"
    assert float(te[0]) < 0.05, f"translation err {float(te[0])}"
