"""The port's hloc file pipeline against pram_tpu's on the CPU, on the same
inputs: ``extract_to_h5`` on two small rendered PNGs (SFD2, f32, the
rendered weights; the tolerances of tests/test_torch_extractor.py),
``match_from_paths`` with mutual NN and with a 2-layer GML at a small
``pad_to`` (appending and skipping pairs already written),
``run_triangulation`` and ``cli.triangulate`` (model files equal byte for
byte), ``FeatureSource`` on h5 and ``cli.build_map --features x.h5``
(every artifact equal), and ``run_localizer`` on
tests/test_hloc_localizer.py's world with the port's RANSAC fed pram_tpu's
hypotheses (``_sample_triplets`` patched as tests/test_torch_aachen.py
does). The JAX side writes and reads its h5 files with h5py; the port
with its own ``io/h5.py``.
"""

import os
import re
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.cli import extract_features as j_extract
from pram_tpu.cli import match_features as j_match
from pram_tpu.engine import hloc_localizer as j_hloc
from pram_tpu.engine.matching import make_nn_match_fn as j_make_nn_match_fn
from pram_tpu.engine.matching import with_scores as j_with_scores
from pram_tpu.mapping import recmap as jrm
from pram_tpu.mapping import triangulate as jtri
from pram_tpu.maps.rendered import make_world, ref_poses
from pram_tpu.maps.synthetic import _look_at, _rotmat2qvec_np
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.models.sfd2 import extract as jax_extract
from pram_tpu.models.sfd2 import preprocess_image as jax_preprocess
from pram_tpu_torch.cli import extract_features as t_extract
from pram_tpu_torch.cli import match_features as t_match
from pram_tpu_torch.cli import triangulate as t_triangulate
from pram_tpu_torch.engine import hloc_localizer as t_hloc
from pram_tpu_torch.engine.matching import make_nn_match_fn
from pram_tpu_torch.engine.rendered_guard import extraction_agreement
from pram_tpu_torch.geometry import pnp as tpnp
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.io import h5
from pram_tpu_torch.mapping import recmap as trm
from pram_tpu_torch.mapping import triangulate as ttri
from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, ColmapPoint3D, read_model, write_model
from pram_tpu_torch.models.convert import load_gml
from pram_tpu_torch.models.gml import GMLConfig
from pram_tpu_torch.ops import keypoints as tkp
from tests.test_full_pipeline import build_world, render
from tests.test_torch_mapping import assert_same_tree
from tests.torch_mapping_scene import make_scene, write_inputs

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")
SFD2_W = os.path.join(WEIGHTS, "sfd2_rendered.msgpack")
GML_W = os.path.join(WEIGHTS, "gml_rendered.msgpack")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h5_tree(path, reader) -> dict:
    out = {}

    def visit(name, obj):
        if isinstance(obj, (h5py.Dataset, h5.Dataset)):
            out[name] = np.asarray(obj[()])

    with reader.File(path, "r") as f:
        f.visititems(visit)
    return out


# ---- extract_to_h5


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Two rendered 96 x 128 views as PNGs, through both packages'
    extract_to_h5 (SFD2 with the rendered weights, f32, the sfd2 config)."""
    import chip_smoke

    root = tmp_path_factory.mktemp("extract")
    rng = np.random.RandomState(0)
    world = make_world(rng)
    poses = ref_poses(12, rng)
    imgs = root / "images"
    os.makedirs(imgs / "db")
    for i in (1, 7):
        img = world.render(*poses[i], (100.0, 100.0, 64.0, 48.0), 128, 96)
        chip_smoke.write_png(str(imgs / "db" / f"v{i}.png"), (np.clip(img, 0, 1) * 255).round().astype(np.uint8))

    jm = JaxResNet4x()
    tmpl = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 96, 128, 3), jnp.float32))
    with open(SFD2_W, "rb") as f:
        variables = serialization.from_bytes(tmpl, f.read())
    mp = pytest.MonkeyPatch()
    mp.setattr(j_extract, "build_extractor", lambda conf, w: (jm, variables, jax_extract, jax_preprocess))
    try:
        j_extract.extract_to_h5(str(imgs), str(root / "jax.h5"), "sfd2")
    finally:
        mp.undo()
    t_extract.main(["--image_dir", str(imgs), "--export_fn", str(root / "port.h5"), "--conf", "sfd2",
                    "--weight_path", SFD2_W, "--device", "cpu"])
    return root


def _as_extract(tree, name):
    k = torch.from_numpy(tree[f"{name}/keypoints"])[None]
    return {"keypoints": tkp.Keypoints(k, torch.from_numpy(tree[f"{name}/scores"])[None],
                                       torch.ones(k.shape[:2], dtype=torch.bool)),
            "descriptors": torch.from_numpy(tree[f"{name}/descriptors"].T)[None]}


def test_extract_to_h5_matches_pram_tpu(extracted):
    jax_t = _h5_tree(str(extracted / "jax.h5"), h5py)
    port_t = _h5_tree(str(extracted / "port.h5"), h5)
    assert sorted(jax_t) == sorted(port_t)
    assert sorted({k.rsplit("/", 1)[0] for k in port_t}) == ["db/v1.png", "db/v7.png"]
    for k, v in port_t.items():
        assert v.dtype == jax_t[k].dtype, k
    for name in ("db/v1.png", "db/v7.png"):
        np.testing.assert_array_equal(port_t[f"{name}/image_size"], [128, 96])
        np.testing.assert_array_equal(port_t[f"{name}/image_size"], jax_t[f"{name}/image_size"])
        ab = extraction_agreement(_as_extract(port_t, name), _as_extract(jax_t, name))
        assert ab["kpt_set_agreement"] >= 0.99 and ab["desc_cos_min"] >= 0.999, ab
        assert port_t[f"{name}/descriptors"].shape == (128, len(port_t[f"{name}/keypoints"]))
        assert len(port_t[f"{name}/keypoints"]) >= 128


def test_extract_to_h5_file_reads_in_h5py_and_the_parsers(extracted):
    from pram_tpu_torch.maps import parsers

    port = str(extracted / "port.h5")
    assert parsers.list_h5_names(port) == ["db/v1.png", "db/v7.png"]
    with h5py.File(port, "r") as f:
        np.testing.assert_array_equal(parsers.get_keypoints(port, "db/v7.png"), f["db/v7.png/keypoints"][()])
    assert _h5_tree(port, h5py).keys() == _h5_tree(port, h5).keys()
    for k, v in _h5_tree(port, h5py).items():
        np.testing.assert_array_equal(v, _h5_tree(port, h5)[k])


# ---- match_from_paths


@pytest.fixture(scope="module")
def scene_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    scene = make_scene(np.random.RandomState(0), desc_dim=128)
    paths = write_inputs(scene, str(root))
    return scene, paths, root


def _gml_pair():
    """pram_tpu's and the port's GML at 2 layers: the rendered checkpoint's
    first two layers and its output projection."""
    with open(GML_W, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    keep = {k: v for k, v in tree.items() if not k.startswith(("self_attn_", "cross_attn_", "out_proj_"))}
    for i in range(2):
        keep[f"self_attn_{i}"], keep[f"cross_attn_{i}"] = tree[f"self_attn_{i}"], tree[f"cross_attn_{i}"]
    keep["out_proj_1"] = tree["out_proj_8"]
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), keep)
    return {"params": params}, load_gml(GML_W, GMLConfig(n_layers=2), device="cpu")


@pytest.mark.parametrize("conf,pad_to", [("NNM", 512), ("gml", 256)])
def test_match_from_paths_matches_pram_tpu(scene_inputs, tmp_path, monkeypatch, conf, pad_to):
    scene, paths, _ = scene_inputs
    pairs = t_match.read_pairs(paths["pairs"])
    assert pairs == j_match.read_pairs(paths["pairs"]) == [tuple(p) for p in scene["pairs"]]
    if conf == "gml":
        variables, model = _gml_pair()
        monkeypatch.setattr(j_match, "build_match_fn",
                            lambda c, w: j_with_scores(JaxGML(JaxGMLConfig(n_layers=2)), variables))
        monkeypatch.setattr(t_match, "load_matcher", lambda name, w, device: model)
    jax_fn, port_fn = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    j_match.match_from_paths(pairs, paths["feats_h5"], jax_fn, conf, batch_size=4, pad_to=pad_to)
    # the port in two runs: the first half, then all pairs (the first half skipped)
    half = len(pairs) // 2
    t_match.match_from_paths(pairs[:half], paths["feats_h5"], port_fn, conf, batch_size=4, pad_to=pad_to,
                             device="cpu")
    before = _h5_tree(port_fn, h5)
    t_match.match_from_paths(pairs, paths["feats_h5"], port_fn, conf, batch_size=4, pad_to=pad_to, device="cpu")
    after = _h5_tree(port_fn, h5)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)
    want = _h5_tree(jax_fn, h5py)
    got = _h5_tree(port_fn, h5py)
    assert sorted(got) == sorted(want) and len(got) == 2 * len(pairs)
    agree, n = 0, 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if k.endswith("matches0") and not k.endswith("scores0"):
            agree += int((got[k] == want[k]).sum())
            n += got[k].size
            same = got[k] == want[k]
            s = k.replace("matches0", "matching_scores0")
            np.testing.assert_allclose(got[s][same], want[s][same], rtol=1e-4, atol=1e-5)
    if conf == "NNM":
        assert agree == n
    else:
        assert agree >= 0.995 * n, (agree, n)
    assert sum(int((v >= 0).sum()) for k, v in got.items() if k.endswith("/matches0")) > 100 * len(pairs)


def test_match_features_main_on_the_cpu(scene_inputs, tmp_path):
    _, paths, _ = scene_inputs
    out = str(tmp_path / "m.h5")
    t_match.main(["--pairs", paths["pairs"], "--features", paths["feats_h5"], "--export_fn", out,
                  "--conf", "NNM", "--batch_size", "16", "--device", "cpu"])
    got = _h5_tree(out, h5py)
    pairs = t_match.read_pairs(paths["pairs"])
    assert len(got) == 2 * len(pairs)
    with h5py.File(paths["feats_h5"], "r") as f:
        n0 = len(f[pairs[0][0]]["keypoints"])
    from pram_tpu_torch.maps.parsers import names_to_pair

    assert got[names_to_pair(*pairs[0]) + "/matches0"].shape == (n0,)
    assert got[names_to_pair(*pairs[0]) + "/matches0"].dtype == np.int32


# ---- triangulation, FeatureSource, build_map


def test_cli_triangulate_writes_the_jax_model(scene_inputs, tmp_path):
    _, paths, _ = scene_inputs
    jax_dir, port_dir, port2_dir = (str(tmp_path / d) for d in ("jax", "port", "port_from_port_h5"))
    want = jtri.run_triangulation(paths["ref"], paths["feats_h5"], paths["pairs"], paths["matches_h5"], jax_dir)
    got = t_triangulate.main(["--reference_model", paths["ref"], "--features", paths["feats_h5"], "--pairs",
                              paths["pairs"], "--matches", paths["matches_h5"], "--output", port_dir])
    assert got == want and got["num_points"] > 200
    # the same files rewritten by the port's writer give the same model
    feats2, matches2 = str(tmp_path / "feats2.h5"), str(tmp_path / "matches2.h5")
    for src, dst in ((paths["feats_h5"], feats2), (paths["matches_h5"], matches2)):
        with h5.File(dst, "w") as f:
            for k, v in _h5_tree(src, h5py).items():
                f.create_dataset(k, data=v)
    assert ttri.run_triangulation(paths["ref"], feats2, paths["pairs"], matches2, port2_dir) == want
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        ref = open(os.path.join(jax_dir, fn), "rb").read()
        assert open(os.path.join(port_dir, fn), "rb").read() == ref, fn
        assert open(os.path.join(port2_dir, fn), "rb").read() == ref, fn


def test_feature_source_h5_matches_pram_tpu(scene_inputs, tmp_path):
    _, paths, _ = scene_inputs
    got, want = trm.FeatureSource(paths["feats_h5"]), jrm.FeatureSource(paths["feats_h5"])
    assert got.names() == want.names() and len(got.names()) == 8
    for name in want.names():
        assert_same_tree(got.get(name), want.get(name), name)
        assert got.get(name)["descriptors"].shape[1] == 128
    trm.RecMap().export_features_to_directory(paths["feats_h5"], str(tmp_path / "port"), with_descriptors=True)
    jrm.RecMap().export_features_to_directory(paths["feats_h5"], str(tmp_path / "jax"), with_descriptors=True)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 8
    for fn in files:
        assert_same_tree(np.load(tmp_path / "port" / fn, allow_pickle=True)[()],
                         np.load(tmp_path / "jax" / fn, allow_pickle=True)[()], fn)


def test_build_map_from_h5_matches_pram_tpu(scene_inputs, tmp_path):
    from pram_tpu.cli.build_map import main as jax_build_map
    from pram_tpu_torch.cli.build_map import main as build_map

    _, paths, _ = scene_inputs
    model = str(tmp_path / "model")
    t_triangulate.main(["--reference_model", paths["ref"], "--features", paths["feats_h5"], "--pairs",
                        paths["pairs"], "--matches", paths["matches_h5"], "--output", model])
    flags = lambda out: ["--model", model, "--features", paths["feats_h5"], "--output", out, "--n_cluster", "4",
                         "--cluster_method", "birch", "--vrf_min_obs", "10", "--compress_radius", "8",
                         "--export_descriptors"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_build_map(flags(jax_out))
    build_map(flags(port_out) + ["--device", "cpu"])
    walk = lambda r: sorted(os.path.relpath(os.path.join(d, f), r) for d, _, fs in os.walk(r) for f in fs)
    files = walk(jax_out)
    assert files == walk(port_out) and "feats/db+v0.png.npy" in files
    for rel in files:
        a, b = os.path.join(jax_out, rel), os.path.join(port_out, rel)
        if rel.endswith(".npy"):
            assert_same_tree(np.load(b, allow_pickle=True)[()], np.load(a, allow_pickle=True)[()], rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


# ---- the hloc localizer


@pytest.fixture(scope="module")
def hloc_world(tmp_path_factory):
    """tests/test_hloc_localizer.py's world (6 db views of 300 points, NN
    matching) with three queries: two retrieving 3 db views, one with no
    retrieval (a failure)."""
    root = tmp_path_factory.mktemp("hloc")
    rng = np.random.RandomState(0)
    xyz, desc = build_world(rng, n_pts=300)
    center = xyz.mean(0)
    cameras = {1: ColmapCamera(1, "SIMPLE_PINHOLE", 640, 480, np.array([500.0, 320.0, 240.0]))}
    images, points3D, obs = {}, {}, {}
    feats_fn = str(root / "feats.h5")
    gt = {}
    with h5py.File(feats_fn, "w") as f:
        for i in range(6):
            ang = 2 * np.pi * i / 6
            R, t = _look_at(center + np.array([np.sin(ang), 0.2, -8 - np.cos(ang)]), center)
            uv, vis = render(xyz, R, t)
            sel = np.nonzero(vis)[0]
            name = f"db/v{i}.jpg"
            images[i + 1] = ColmapImage(i + 1, _rotmat2qvec_np(R), t, 1, name, uv[sel],
                                        (sel + 500).astype(np.int64))
            obs[i + 1] = sel
            g = f.create_group(name)
            g.create_dataset("keypoints", data=uv[sel].astype(np.float32))
            g.create_dataset("scores", data=np.ones(len(sel), np.float32))
            g.create_dataset("descriptors", data=desc[sel].T)
            g.create_dataset("image_size", data=np.array([640, 480]))
        for qi, eye in enumerate(([0.2, -0.1, -7.5], [-0.5, 0.3, -7.8], [0.1, 0.0, -7.0])):
            Rq, tq = _look_at(center + eye, center)
            uv, vis = render(xyz, Rq, tq)
            sel = np.nonzero(vis)[0]
            g = f.create_group(f"q/q{qi}.jpg")
            g.create_dataset("keypoints", data=(uv[sel] + rng.randn(len(sel), 2) * 0.3).astype(np.float32))
            g.create_dataset("scores", data=np.ones(len(sel), np.float32))
            g.create_dataset("descriptors", data=desc[sel].T)
            g.create_dataset("image_size", data=np.array([640, 480]))
            gt[f"q/q{qi}.jpg"] = {"qvec": _rotmat2qvec_np(Rq), "tvec": tq}
    track = {p: [] for p in range(len(xyz))}
    for iid, sel in obs.items():
        for k, p in enumerate(sel):
            track[p].append((iid, k))
    for p, tr in track.items():
        if tr:
            points3D[p + 500] = ColmapPoint3D(p + 500, xyz[p], np.zeros(3, np.uint8), 0.4,
                                              np.array([t[0] for t in tr], np.int32),
                                              np.array([t[1] for t in tr], np.int64))
    model_dir = str(root / "model")
    write_model(cameras, images, points3D, model_dir, ".bin")
    with open(root / "pairs.txt", "w") as f:
        f.write("".join(f"q/q0.jpg db/v{i}.jpg\n" for i in range(3)))
        f.write("".join(f"q/q1.jpg db/v{i}.jpg\n" for i in (5, 4, 0)))
    with open(root / "queries.txt", "w") as f:
        f.write("".join(f"q/q{qi}.jpg SIMPLE_PINHOLE 640 480 500 320 240\n" for qi in range(3)))
    args = (model_dir, feats_fn, str(root / "pairs.txt"), str(root / "queries.txt"))
    return args, gt, root


KW = dict(ransac_thresh=5.0, inlier_th=30, obs_th=1, covisibility_frame=4, max_db_kpts=512, num_hypotheses=128)


def _jax_sampler(recorded):
    """pram_tpu's hypotheses for the port's ransac_pnp calls: its
    run_localizer folds query qi into PRNGKey(0), each candidate's RANSAC
    folds in the candidate's retrieval order, the covisibility RANSAC
    10007; ``_sample_triplets`` there draws Gumbel noise from that key. The
    port's per-query generator is seeded with qi (seed 0), and its first
    call of a query solves the candidates with 8 matches (read from the
    match call just before), its second the covisibility stack."""
    calls = {}

    def sample(generator, mask, num_hyps):
        qi = generator.initial_seed()
        qkey = jax.random.fold_in(jax.random.PRNGKey(0), qi)
        k = calls.get(qi, 0)
        calls[qi] = k + 1
        if k == 0:
            matches = recorded[-1]
            orders = [o for o in range(matches.shape[0]) if (matches[o] >= 0).sum() >= 8]
            keys = [jax.random.fold_in(qkey, o) for o in orders]
        else:
            keys = [jax.random.fold_in(qkey, 10007)]
        assert len(keys) == mask.shape[0]
        g = np.stack([np.asarray(jax.random.gumbel(key, (num_hyps, mask.shape[1]))) for key in keys])
        g = torch.where(mask[:, None, :], torch.from_numpy(g), float("-inf"))
        return torch.topk(g, 3, dim=-1).indices

    return sample


def _poses_lines(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines() if ln]


def test_run_localizer_matches_pram_tpu(hloc_world, tmp_path, monkeypatch):
    args, gt, _ = hloc_world
    want = j_hloc.run_localizer(*args, j_make_nn_match_fn(), str(tmp_path / "jax"), gt_poses=gt, **KW)
    recorded = []
    nn = make_nn_match_fn()

    def match_fn(*a):
        m = nn(*a)
        recorded.append(m.numpy())
        return m

    monkeypatch.setattr(tpnp, "_sample_triplets", _jax_sampler(recorded))
    got = t_hloc.run_localizer(*args, match_fn, str(tmp_path / "port"), gt_poses=gt, device="cpu", **KW)
    assert got["failed"] == want["failed"] == ["q/q2.jpg"]
    assert got["recall"] == want["recall"]
    assert got["recall"]["0.25m/2.0deg"] == 2 / 3
    assert list(got["poses"]) == list(want["poses"]) == ["q/q0.jpg", "q/q1.jpg"]
    for q in want["poses"]:
        (gq, gt_), (wq, wt) = got["poses"][q], want["poses"][q]
        dq, dt = compute_pose_error(*(torch.tensor(np.array(v), dtype=torch.float32) for v in (gq, gt_, wq, wt)))
        assert float(dq) < 0.1 and float(dt) < 0.005, (q, float(dq), float(dt))
    pl, wl = _poses_lines(tmp_path / "port" / "poses.txt"), _poses_lines(tmp_path / "jax" / "poses.txt")
    assert [ln[0] for ln in pl] == [ln[0] for ln in wl]
    np.testing.assert_array_almost_equal(np.array([ln[1:] for ln in pl], float),
                                         np.array([ln[1:] for ln in wl], float), decimal=4)
    for fn in ("poses.txt.failed",):
        assert (tmp_path / "port" / fn).read_text() == (tmp_path / "jax" / fn).read_text()
    plog = (tmp_path / "port" / "poses_full.log").read_text().splitlines()
    wlog = (tmp_path / "jax" / "poses_full.log").read_text().splitlines()
    assert len(plog) == len(wlog) == 2
    # the lines without their times and errors: the failure and recall tallies, the keypoint counts
    strip = lambda ln: re.sub(r"(time\[cs/fn\]: |time: |q_error:|t_error:)[\d./-]+", "", ln)
    assert [strip(a) for a in plog] == [strip(a) for a in wlog]
    assert strip(plog[-1]).startswith("All 0/2 failed cases, ,   2/2/2/2, , ")
    plog_npy = np.load(tmp_path / "port" / "loc_log.npy", allow_pickle=True)[()]
    wlog_npy = np.load(tmp_path / "jax" / "loc_log.npy", allow_pickle=True)[()]
    assert list(plog_npy) == list(wlog_npy)
    for q in wlog_npy:
        assert set(plog_npy[q]) == {"keypoints_query", "points3D_ids"}
        a, b = set(plog_npy[q]["points3D_ids"].tolist()), set(wlog_npy[q]["points3D_ids"].tolist())
        assert len(a & b) >= 0.98 * max(len(a), len(b)) and len(b) >= 30


def test_db_3d_keypoints_and_covisible_frames_match_pram_tpu(hloc_world):
    args, _, _ = hloc_world
    _, images, points3D = read_model(args[0], ".bin")
    jf, tf = j_hloc.H5Features(args[1]), t_hloc.H5Features(args[1])
    for name in ("db/v0.jpg", "q/q1.jpg"):
        assert_same_tree(tf.get(name), jf.get(name), name)
    loc = t_hloc.HlocLocalizer(images, points3D, tf, None, device="cpu", covisibility_frame=4)
    for iid, im in images.items():
        for obs_th in (0, 1, 3):
            got = t_hloc.db_3d_keypoints(im, points3D, tf, obs_th)
            want = j_hloc.db_3d_keypoints(im, points3D, jf, obs_th)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        # pram_tpu/engine/hloc_localizer.py:_covisibility_refine's ordering, inline
        from collections import defaultdict

        covis = defaultdict(int)
        for pid in images[iid].point3D_ids:
            if pid < 0 or pid not in points3D:
                continue
            for j in points3D[pid].image_ids:
                covis[j] += 1
        ids = [i for i, _ in sorted(covis.items(), key=lambda kv: -kv[1])][:4]
        if iid not in ids:
            ids = [iid] + ids
        assert loc.covisible_frames(iid) == ids


def test_early_exit_selects_as_the_candidate_loop(hloc_world, monkeypatch):
    """The batched candidates pick what the per-candidate loop picks: the
    first to reach ``inlier_th``, else the first with the most inliers;
    with no success the first retrieved frame's pose."""
    args, _, _ = hloc_world
    _, images, points3D = read_model(args[0], ".bin")
    feats = t_hloc.H5Features(args[1])
    qinfo = ("SIMPLE_PINHOLE", 640, 480, np.array([500.0, 320.0, 240.0]))
    base = t_hloc.HlocLocalizer(images, points3D, feats, make_nn_match_fn(), device="cpu",
                                do_covisibility_opt=False, **{k: v for k, v in KW.items() if k != "covisibility_frame"})
    counts = {}

    def fake(inliers, success=True):
        def ransac(camera, uv, xyz, mask, **kw):
            p, n = mask.shape
            counts["p"] = p
            ninl = torch.tensor(inliers[:p], dtype=torch.int32)
            return tpnp.PnPResult(torch.eye(3).expand(p, 3, 3), torch.arange(p, dtype=torch.float32)[:, None]
                                  .expand(p, 3), ninl, torch.zeros(p, n, dtype=torch.bool),
                                  torch.full((p,), success))
        return ransac

    for inliers, want_order in (([10, 40, 35], 1), ([10, 20, 25], 2), ([31, 50, 60], 0), ([20, 20, 5], 0)):
        monkeypatch.setattr(t_hloc, "ransac_pnp", fake(inliers))
        out = base.localize("q/q0.jpg", qinfo, [1, 2, 3], torch.Generator().manual_seed(0))
        assert counts["p"] == 3 and out["order"] == want_order and out["db_id"] == want_order + 1
        np.testing.assert_array_equal(out["tvec"], [want_order] * 3)
    monkeypatch.setattr(t_hloc, "ransac_pnp", fake([3, 2, 1], success=False))
    out = base.localize("q/q0.jpg", qinfo, [2, 1, 3], torch.Generator().manual_seed(0))
    assert out["order"] == -1 and not out["success"] and out["num_inliers"] == 0
    np.testing.assert_array_equal(out["tvec"], images[2].tvec)


def test_hloc_localizer_defaults_match_pram_tpu():
    import inspect

    jp = inspect.signature(j_hloc.HlocLocalizer.__init__).parameters
    tp = inspect.signature(t_hloc.HlocLocalizer.__init__).parameters
    for k, v in jp.items():
        if v.default is not inspect.Parameter.empty:
            assert tp[k].default == v.default, k
    assert t_hloc.ERROR_THRESHOLDS == j_hloc.ERROR_THRESHOLDS
    assert "h5py" not in sys.modules.get("pram_tpu_torch.engine.hloc_localizer").__dict__
