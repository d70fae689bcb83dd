"""The port's serving CLIs and their readers against pram_tpu's, on the CPU.

- ``cli.inference.main`` and ``cli.online_localization.main`` with
  ``--device cpu`` on tiny scenes written in the reference layout (a
  2-layer recognizer), the port reading the weights of the JAX CLIs' own
  flax init (PRNGKey 0 / 1) from ``.msgpack`` files under tmp_path, the JAX
  CLIs initializing them: the same success flags, bucket counts and
  failed cases, and poses within 0.1 deg / 5 mm of each other (offline;
  RANSAC draws from jax.random on one side and a seeded torch.Generator on
  the other), or, fed the JAX CLI's own RANSAC noise, the same tracked /
  relocalized frames and inlier counts and poses within 0.25 deg / 2 cm
  (online, random-init features at 160 x 120). The JAX CLIs hand ``build_match_fn``'s ``(matches, scores)``
  closure to the localizer, which compares it with 0 and raises; the test
  gives them the matches alone, as the port's CLIs take them.
- Reference-named state dicts (tests/torch_mirrors.py) converted by both
  packages' ``convert_*``: equal flax trees, and the port's models loaded
  from them (directly and through the CLIs' checkpoint loaders) giving
  pram_tpu's outputs within 1e-4.
- The PNG reader against ``cv2.imread``, bit for bit, on gray / RGB / RGBA
  PNGs of every filter type and on cv2's own; ``resize_linear`` against
  ``cv2.resize`` within one grey level (uint8) and 1e-6 (float); JPEG input
  raises naming its format; the unported flags raise naming their queue
  item.
"""

import os
import struct
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from pram_tpu.cli import extract_features as j_extract_features
from pram_tpu.cli import inference as j_inference
from pram_tpu.cli import match_features as j_match_features
from pram_tpu.cli import online_localization as j_online
from pram_tpu.maps.synthetic import make_synthetic_scene
from pram_tpu.models import convert as jconvert
from pram_tpu_torch.cli import extract_features, inference, online_localization
from pram_tpu_torch.cli.match_features import load_matcher
from pram_tpu_torch.io.image import read_image, read_png, resize_linear
from pram_tpu_torch.models import convert as tconvert
from tests.torch_mirrors import TorchAdaGML, TorchGML, TorchSegNetViT, TorchSFD2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is on small tensors: one intra-op thread
    keeps it from oversubscribing the cores that parallel test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_matches_only(monkeypatch):
    """pram_tpu's build_match_fn, its closure giving the matches alone."""
    build = j_match_features.build_match_fn

    def matches_only(*args, **kwargs):
        fn = build(*args, **kwargs)
        return lambda *a: fn(*a)[0]

    monkeypatch.setattr(j_match_features, "build_match_fn", matches_only)


def _write_msgpack(path, variables):
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(jax.tree_util.tree_map(np.asarray, variables)))
    return str(path)


LOC = {"seg_k": 3, "threshold": 5.0, "min_inliers": 12, "min_kpts": 16, "do_refinement": True,
       "refinement_method": "projection", "with_compress": True}


def _offline_scene(tmp_path, n_q=6):
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, n_cluster=3, points_per_cluster=80, n_ref_frames=4, desc_dim=128,
                                 max_kp_per_frame=128, max_ref_points=256)
    queries = [scene.render_query(rng, noise_px=0.3, max_kpts=128) for _ in range(n_q)]
    queries[1]["descriptors"] = rng.randn(*queries[1]["descriptors"].shape).astype(np.float32)
    names = [f"seq/q{i}.png" for i in range(n_q)]
    return scene, queries, names


def _same_reports(ours, theirs):
    assert (ours.n_total, ours.n_success) == (theirs.n_total, theirs.n_success)
    assert ours.bucket_counts == theirs.bucket_counts and ours.failed_cases == theirs.failed_cases
    ok = np.asarray(theirs.q_errors) < 180.0
    np.testing.assert_array_equal(np.asarray(ours.q_errors) < 180.0, ok)
    np.testing.assert_allclose(np.asarray(ours.q_errors)[ok], np.asarray(theirs.q_errors)[ok], atol=0.1)
    np.testing.assert_allclose(np.asarray(ours.t_errors)[ok], np.asarray(theirs.t_errors)[ok], atol=0.005)


def test_inference_main_matches_pram_tpu(tmp_path, jax_matches_only, monkeypatch):
    """The JAX CLI prints its report and returns nothing: the report is
    caught on its way out of its evaluate_queries."""
    import pram_tpu.engine.evaluator as jev
    from pram_tpu.models.segnetvit import SegNetViT, SegNetViTConfig

    scene, queries, names = _offline_scene(tmp_path)
    top = {"network": "segnetvit", "feat_dim": 128, "use_mid_feature": False, "layers": 2,
           "eval_max_keypoints": 128, "localization": {**LOC, "matching_method": "NNM"}}
    cfg = str(chip_smoke.synthetic_layout(tmp_path, scene, queries, names, 3, top))
    # the JAX CLI's recognizer init, carried across as a msgpack file
    jrec = SegNetViT(SegNetViTConfig(descriptor_dim=128, n_class=4, n_layers=2))
    rec_w = _write_msgpack(tmp_path / "rec.msgpack",
                           jrec.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 128)), jnp.zeros((1, 8, 2))))
    caught = []
    evaluate = jev.evaluate_queries
    monkeypatch.setattr(jev, "evaluate_queries", lambda *a, **k: caught.append(evaluate(*a, **k)) or caught[-1])
    j_inference.main(["--config", cfg, "--batch", "4"])
    ours = inference.main(["--config", cfg, "--batch", "4", "--rec_weight_path", rec_w, "--device", "cpu"])
    _same_reports(ours, caught[0])
    assert ours.n_total == len(names) and ours.failed_cases == ["seq/q1.png"]
    assert ours.bucket_counts[0] == len(names) - 1


def test_online_main_matches_pram_tpu(tmp_path, jax_matches_only, monkeypatch):
    """A rendered world at 160 x 120, its map built by the JAX CLI's SFD2
    init (read by the port from msgpack), four frames with a jump after the
    second, the NN matcher, the port's RANSAC fed the JAX CLI's Gumbel
    noise: both CLIs localize every frame the same way (relocalizing the
    first frame and the one after the jump, where tracking fails), with
    equal inlier counts and poses within 0.25 deg / 2 cm."""
    from pram_tpu.models.segnetvit import SegNetViT, SegNetViTConfig
    from pram_tpu.models.sfd2 import ResNet4x
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.rendered import build_rendered_scene
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    w, h, f = 160, 120, 125.0
    sfd2_w = _write_msgpack(tmp_path / "sfd2.msgpack",
                            ResNet4x().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    sfd2 = load_sfd2(sfd2_w, device="cpu")

    def extract_np(images):
        with torch.no_grad():
            out = extract(sfd2, preprocess_image(torch.as_tensor(images)), max_keypoints=256, conf_th=1e-4)
        k = out["keypoints"]
        return k.xy.numpy(), k.scores.numpy(), out["descriptors"].numpy(), k.mask.numpy()

    scene = build_rendered_scene(extract_np, np.random.RandomState(0), width=w, height=h, focal=f, n_ref=12,
                                 kp_per_ref=256, max_ref_points=1024)
    n_seg = scene.map.seg_vrf_slot.shape[0]
    jrec = SegNetViT(SegNetViTConfig(descriptor_dim=256, n_class=n_seg + 1, n_layers=2))
    rec_w = _write_msgpack(tmp_path / "rec.msgpack",
                           jrec.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 256)), jnp.zeros((1, 8, 2))))
    top = {"network": "segnetvit", "use_mid_feature": True, "layers": 2,
           "localization": {**LOC, "seg_k": 8, "matching_method": "NNM", "with_compress": False}}
    cfg = chip_smoke.rendered_layout(tmp_path, scene, n_seg, top)
    imgs, qvecs, tvecs = chip_smoke.rendered_path(scene.world, 4, jumps=(2,), width=w, height=h, focal=f)
    names = [f"f{i}.png" for i in range(4)]
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for name, img in zip(names, imgs):
        chip_smoke.write_png(img_dir / name, np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))
    chip_smoke.write_queries(img_dir, names, qvecs, tvecs, ("PINHOLE", w, h, (f, f, w / 2, h / 2)))
    argv = ["--config", str(cfg), "--image_dir", str(img_dir), "--max_keypoints", "128",
            "--queries", str(img_dir / "queries_with_intrinsics.txt")]
    # pram_tpu's poses: the last tracking or relocalization result of each
    # frame, cut at the frame's printed line
    from pram_tpu.engine.localizer import Localizer as JLocalizer
    from pram_tpu.engine.tracker import Tracker as JTracker

    events, frames = [], []
    for cls, attr in ((JTracker, "track"), (JLocalizer, "localize_batch")):
        def wrapped(self, *a, _f=getattr(cls, attr), _loc=cls is JLocalizer, **k):
            res = _f(self, *a, **k)
            if res is not None:
                q, t = np.asarray(res.qvec), np.asarray(res.tvec)
                events.append(("relocalized" if _loc else "tracked", q[0] if _loc else q, t[0] if _loc else t))
            return res
        monkeypatch.setattr(cls, attr, wrapped)

    def frame_print(line, *a, **k):
        if line.startswith("["):
            frames.append((line, events[-1]))

    monkeypatch.setattr(j_online, "print", frame_print, raising=False)
    j_online.main(argv)

    # the port's RANSAC fed pram_tpu's Gumbel noise: the JAX CLI keys a
    # frame's tracking by fold_in(PRNGKey(0), i) and its relocalization by
    # fold_in(PRNGKey(0), 100000 + i), the seeds of the port's generators
    from pram_tpu_torch.engine.localizer import Localizer
    from pram_tpu_torch.engine.tracker import Tracker
    from pram_tpu_torch.geometry import pnp as tpnp

    queue = []

    def sample(generator, mask, num_hyps):
        g = np.stack([np.array(jax.random.gumbel(k, (num_hyps, mask.shape[1]))) for k in queue.pop(0)])
        return torch.topk(torch.where(mask[:, None, :], torch.from_numpy(g), float("-inf")), 3, dim=-1).indices

    def track(self, generator, *a, _f=Tracker.track, **k):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), generator.initial_seed()), 2)
        queue.extend([[keys[0]], [keys[1]]])
        return _f(self, generator, *a, **k)

    def localize(self, generator, *a, _f=Localizer.localize_batch, **k):
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), generator.initial_seed()), 1)[0]
        first, refine = jax.random.split(key, 2)
        queue.extend([list(jax.random.split(first, self.cfg.seg_k)), [refine]])
        return _f(self, generator, *a, **k)

    monkeypatch.setattr(tpnp, "_sample_triplets", sample)
    monkeypatch.setattr(Tracker, "track", track)
    monkeypatch.setattr(Localizer, "localize_batch", localize)
    recs = online_localization.main(argv + ["--rec_weight_path", rec_w, "--feat_weight_path", sfd2_w,
                                            "--device", "cpu"])
    assert [r["success"] for r in recs] == [" ok " in line for line, _ in frames] == [True] * 4
    assert [r["mode"] for r in recs] == [e[0] for _, e in frames]
    assert [r["mode"] for r in recs] == ["relocalized", "tracked", "relocalized", "tracked"]
    assert [r["inliers"] for r in recs] == [int(line.split("inliers=")[1].split()[0]) for line, _ in frames]
    dq, dt = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in recs])).double(),
                                torch.tensor(np.stack([r["tvec"] for r in recs])).double(),
                                torch.tensor(np.stack([e[1] for _, e in frames])).double(),
                                torch.tensor(np.stack([e[2] for _, e in frames])).double())
    assert not queue
    # equal inlier sets of random-init features at 160 x 120 leave a
    # tracked pose in a shallow valley: its polish lands up to ~1.3 cm /
    # 0.1 deg apart on the two sides, the other frames within 1e-4
    assert float(dq.max()) < 0.25 and float(dt.max()) < 0.02


def test_inference_main_runs_gml_from_msgpack(tmp_path):
    scene, queries, names = _offline_scene(tmp_path, n_q=2)
    top = {"network": "segnetvit", "feat_dim": 128, "use_mid_feature": False, "layers": 2,
           "eval_max_keypoints": 128, "localization": {**LOC, "matching_method": "gml"}}
    cfg = str(chip_smoke.synthetic_layout(tmp_path, scene, queries, names, 3, top))
    gml_w = os.path.join(ROOT, "weights", "gml_synthetic.msgpack")
    rep = inference.main(["--config", cfg, "--batch", "2", "--matcher_weight_path", gml_w, "--device", "cpu"])
    assert rep.n_total == 2 and len(rep.time_results["total"]) == 2


def test_unported_flags_raise_naming_their_queue_item(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        inference.main(["--config", "unused.yaml", "--mesh"])
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        inference.main(["--config", "unused.yaml", "--shard_map"])
    base = ["--config", "c.yaml", "--image_dir", ".", "--queries", "q.txt"]
    with pytest.raises(NotImplementedError, match="viz/server.py.*queue 1 item 4"):
        online_localization.main(base + ["--viewer_port", "0"])
    with pytest.raises(NotImplementedError, match="visualization.py.*queue 1 item 4"):
        online_localization.main(base + ["--save_vis", str(tmp_path)])
    with pytest.raises(ImportError, match="h5py"):
        extract_features.extract_to_h5("d", "out.h5")
    from pram_tpu_torch.maps import parsers

    with pytest.raises(ImportError, match="h5py"):
        parsers.get_keypoints("f.h5", "a")


# ---- reference checkpoints


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_reference_checkpoints_convert_as_pram_tpu(tmp_path):
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    # SegNetViT
    sd = _sd(TorchSegNetViT(desc_dim=128, n_layers=2, n_class=9).eval())
    ours, theirs = tconvert.convert_segnetvit(sd, n_layers=2), jconvert.convert_segnetvit(sd, n_layers=2)
    _assert_same_tree(ours, theirs)
    from pram_tpu.models.segnetvit import SegNetViT as JSegNetViT
    from pram_tpu.models.segnetvit import SegNetViTConfig as JSegCfg

    desc = rng.randn(2, 64, 128).astype(np.float32)
    nk = (rng.rand(2, 64, 2) - 0.5).astype(np.float32)
    mask = np.ones((2, 64), bool)
    mask[1, 50:] = False
    ref = JSegNetViT(JSegCfg(descriptor_dim=128, n_class=9, n_layers=2)).apply(
        theirs, jnp.asarray(desc), jnp.asarray(nk), jnp.asarray(mask))["prediction"]
    path = str(tmp_path / "segnetvit.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    model = inference.load_recognizer(
        "segnetvit", {"descriptor_dim": 128, "output_dim": 1024, "n_class": 9, "n_layers": 2}, path, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(desc), torch.from_numpy(nk), torch.from_numpy(mask))["prediction"]
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(ref)[mask], atol=1e-4, rtol=1e-4)

    # GML: a reference checkpoint holds an output projection a layer; the
    # last is the one applied
    sd = _sd(TorchGML(n_layers=2).eval())
    ours, theirs = tconvert.convert_gml(sd, n_layers=2), jconvert.convert_gml(sd, n_layers=2)
    _assert_same_tree(ours, theirs)
    from pram_tpu.models.gml import GML as JGML
    from pram_tpu.models.gml import GMLConfig as JGMLConfig
    from pram_tpu_torch.models.gml import GML, GMLConfig

    d0, d1 = rng.randn(1, 128, 128).astype(np.float32), rng.randn(1, 128, 128).astype(np.float32)
    k0, k1 = (rng.rand(1, 128, 2) - 0.5).astype(np.float32), (rng.rand(1, 128, 2) - 0.5).astype(np.float32)
    ref = JGML(JGMLConfig(n_layers=2)).apply(theirs, *map(jnp.asarray, (d0, d1, k0, k1)))["plan"]
    model = GML(GMLConfig(n_layers=2))
    model.load_state_dict(tconvert.gml_state_dict(ours["params"], 2), strict=True)
    with torch.no_grad():
        plan = model(*map(torch.from_numpy, (d0, d1, k0, k1)))["plan"]
    np.testing.assert_allclose(plan.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)

    # AdaGML: trees equal, and the port's model takes them
    sd = _sd(TorchAdaGML(n_layers=2).eval())
    ours, theirs = tconvert.convert_adagml(sd, n_layers=2), jconvert.convert_adagml(sd, n_layers=2)
    _assert_same_tree(ours, theirs)
    from pram_tpu_torch.models.adagml import AdaGML, AdaGMLConfig

    AdaGML(AdaGMLConfig(n_layers=2)).load_state_dict(tconvert.adagml_state_dict(ours["params"], 2), strict=True)

    # SFD2, through build_extractor's checkpoint path
    sd = _sd(TorchSFD2().eval())
    ours, theirs = tconvert.convert_sfd2(sd), jconvert.convert_sfd2(sd)
    _assert_same_tree(ours, theirs)
    from pram_tpu.models.sfd2 import ResNet4x as JResNet4x

    img = rng.rand(1, 32, 48, 3).astype(np.float32)
    ref = JResNet4x().apply(theirs, jnp.asarray(img))
    path = str(tmp_path / "sfd2.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model, _, _ = extract_features.build_extractor(extract_features.CONFS["sfd2"], path, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    for k in ("score_map", "desc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4, err_msg=k)


def test_matcher_checkpoint_through_the_cli_loader(tmp_path):
    torch.manual_seed(1)
    sd = TorchGML().eval().state_dict()
    path = str(tmp_path / "gml.pth")
    torch.save(sd, path)
    model = load_matcher("gml", path, "cpu")
    ref = tconvert.gml_state_dict(tconvert.convert_gml({k: v.numpy() for k, v in sd.items()})["params"], 9)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


# ---- images


def _png(path, img, ftype):
    """A PNG of uint8 ``img`` with every row in filter ``ftype`` (-1: the row
    index mod 5)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out, prev = [], np.zeros(w * ch, np.int32)
    for r in range(h):
        x = rows[r]
        a = np.concatenate([np.zeros(ch, np.int32), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        ft = ftype if ftype >= 0 else r % 5
        pred = [0, a, prev, (a + prev) >> 1, None][ft]
        if ft == 4:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([ft]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, -1])
def test_png_reader_bit_equal_to_cv2(tmp_path, channels, ftype):
    rng = np.random.RandomState(channels * 10 + ftype)
    img = rng.randint(0, 256, (23, 37) if channels == 1 else (23, 37, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    _png(path, img, ftype)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels >= 3:
        ref = ref[..., [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(read_image(path), cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int)
    assert np.abs(read_image(path, grayscale=True).astype(int) - gray).max() <= (0 if channels == 1 else 1)


def test_cv2_written_png_and_load_image(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (61, 83, 3)).astype(np.uint8)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(read_image(path), img[..., ::-1])
    for resize_max in (None, 50, 40):
        ours = extract_features.load_image(path, False, resize_max)
        theirs = j_extract_features.load_image(path, False, resize_max)
        assert ours[2] == theirs[2] and np.array_equal(ours[1], theirs[1])
        assert ours[0].shape == theirs[0].shape
        assert np.abs(ours[0] - theirs[0]).max() <= 1.0 / 255 + 1e-7
    np.save(tmp_path / "img.npy", img[..., ::-1])
    np.testing.assert_array_equal(read_image(str(tmp_path / "img.npy")), img[..., ::-1])


@pytest.mark.parametrize("size", [(41, 30), (20, 15), (100, 70), (83, 61)])
def test_resize_linear_as_cv2(size):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (61, 83, 3)).astype(np.uint8)
    assert np.abs(resize_linear(img, size).astype(int) - cv2.resize(img, size).astype(int)).max() <= 1
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(resize_linear(f, size), cv2.resize(f, size), atol=1e-6, rtol=0)


def test_jpeg_raises_naming_its_format(tmp_path):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="JPEG"):
        read_image(path)
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.png"))
