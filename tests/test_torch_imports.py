"""Dependency fence: the port runs with only torch, numpy and the stdlib.

The card's machine has torch, triton, numpy, scipy and einops, but no jax,
flax, msgpack, ml_dtypes, yaml, ninja, cv2, matplotlib or tensorboard. A
fresh interpreter refuses those (and the JAX package itself) through a
``sys.meta_path`` finder, then
imports every module of ``pram_tpu_torch`` and ``chip_smoke``, reads the
flax weights, and runs the four slices on the CPU: a 2-layer SegNetViT
with the NN matcher, then a 2-layer GML with projection refinement, the
same with the first 2 layers of the trained Aachen AdaGML
(weights/adagml_aachen.msgpack), then SFD2 extraction
(weights/sfd2_rendered.msgpack) on one small rendered view, then two
augmented training steps of the first layer of the rendered SegNetViT on
that view through ``Trainer``; and the int8 path on that view: the int8
extractor quantized and calibrated there, and the 2-layer GML with int8
projections and MLPs; SuperPoint, SegNet and GM at one layer on the view,
RetNet and the descriptor compressor on SFD2's outputs; then both serving
CLIs' ``main`` on the CPU with
2-layer recognizers, on the synthetic scene's map and features and on a
160 x 120 rendered map with a PNG and a JPEG frame, written by
chip_smoke.py's writers (the config, COLMAP, feature, image and weight
readers of their paths; the online CLI with its viewer); the runtime remainder (the JPEG fixtures against
their digests, MetricsLogger without TensorBoard, the YAML snapshot, the
viewer over loopback, a drawing, and plot_landmarks_3d raising without
matplotlib); then both training CLIs' ``main`` on the CPU: the GML fit at one
layer, and cli.train at two layers on a tiny layout written by
chip_smoke.training_layout; then map building: the mapping scene of
tests/torch_mapping_scene.py triangulated through the port's
``triangulate_model`` (the COLMAP database in sqlite3), and
``cli.build_map``'s ``main`` on the CPU on its npy features and model with
KMeans and with Birch (the port's own, in numpy and scipy: no sklearn, and
no h5py on the path).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = (
    "jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "yaml", "optax", "orbax",
    "cv2", "h5py", "sklearn", "triton", "pram_tpu",
)
# optional packages the card's machine lacks: fenced in the run as well, but
# a function may import them lazily and raise without them, as the JAX
# package's do (utils/visualization.py:plot_landmarks_3d, core/logging.py)
OPTIONAL = ("matplotlib", "tensorboard")

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = set(%r)

    class Fence(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"fenced: {name}")
            return None

    # torch's optimizers import torch._dynamo, which asks find_spec about
    # optional packages (sklearn among them): a missing package answers None
    # there, the fence would raise, so it is imported first; the check
    # below still sees anything it loads
    import torch._dynamo

    sys.meta_path.insert(0, Fence())
    preloaded = BLOCKED & {m.split(".")[0] for m in sys.modules}
    assert not preloaded, preloaded

    import numpy as np
    import torch
    import pram_tpu_torch

    names = sorted(
        m.name for m in pkgutil.walk_packages(pram_tpu_torch.__path__, "pram_tpu_torch.")
    )
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # its work sits under __main__

    from pram_tpu_torch.engine.localizer import LocConfig, Localizer
    from pram_tpu_torch.engine.matching import make_gml_match_fn, make_nn_match_fn
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.synthetic import make_synthetic_scene
    from pram_tpu_torch.models.convert import load_gml, load_segnetvit
    from pram_tpu_torch.models.gml import GMLConfig
    from pram_tpu_torch.models.segnetvit import SegNetViTConfig

    weights = "weights/segnetvit_synthetic.msgpack"
    assert len(read_flax_msgpack(weights)) == 15 + 5  # gnn_0..14, input_proj, kenc, seg_*
    rng = np.random.RandomState(0)
    scene = make_synthetic_scene(rng, n_cluster=16, points_per_cluster=400, n_ref_frames=12,
                                 desc_dim=128, max_kp_per_frame=1024, max_ref_points=2048)
    qs = [scene.render_query(rng, noise_px=0.3) for _ in range(2)]
    st = lambda k: torch.from_numpy(np.stack([q[k] for q in qs]))
    kp, de, sc, mk = st("keypoints"), st("descriptors"), st("scores"), st("mask")
    model = load_segnetvit(weights, SegNetViTConfig(descriptor_dim=128, n_class=113, n_layers=2),
                           device="cpu")
    with torch.no_grad():
        logits = model(de, kp / torch.tensor([640.0, 480.0]) - 0.5, mk)["prediction"]
    logits = logits[:, :, : scene.map.n_class]
    assert torch.isfinite(logits).all()
    cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
                    gn_iters=5, lo_rounds=1, do_refinement=False)
    loc = Localizer(to_device(scene.map, "cpu"), make_nn_match_fn(), cfg)
    cam = Camera(torch.tensor([[500.0, 500, 320, 240, 0, 0, 0, 0]] * 2),
                 torch.tensor([[640.0, 480.0]] * 2))
    res = loc.localize_batch(torch.Generator().manual_seed(7), cam, kp, sc, de, mk, logits)
    assert res.qvec.shape == (2, 4) and torch.isfinite(res.tvec).all()
    compute_pose_error(res.qvec, res.tvec, st("qvec").float(), st("tvec"))

    gml_weights = "weights/gml_synthetic.msgpack"
    assert len(read_flax_msgpack(gml_weights)) == 2 * 9 + 4  # layers, input/out_proj, poseenc, bin
    gml = load_gml(gml_weights, GMLConfig(n_layers=2), device="cpu")
    cfg = LocConfig(seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
                    gn_iters=5, lo_rounds=1, do_refinement=True)
    loc = Localizer(to_device(scene.map, "cpu"), make_gml_match_fn(gml), cfg)
    res = loc.localize_batch(torch.Generator().manual_seed(7), cam, kp, sc, de, mk, logits)
    assert res.qvec.shape == (2, 4) and torch.isfinite(res.tvec).all()
    assert res.kpt_point_idx.shape == (2, 512) and torch.isfinite(res.kpt_xyz).all()
    compute_pose_error(res.qvec, res.tvec, st("qvec").float(), st("tvec"))

    from pram_tpu_torch.engine.matching import make_adagml_match_fn
    from pram_tpu_torch.models.adagml import AdaGMLConfig
    from pram_tpu_torch.models.convert import load_adagml

    ada_weights = "weights/adagml_aachen.msgpack"
    assert len(read_flax_msgpack(ada_weights)) == 3 + 4 * 9  # input_proj, poseenc, bin; 4 per layer
    ada = load_adagml(ada_weights, AdaGMLConfig(n_layers=2), device="cpu")
    loc = Localizer(to_device(scene.map, "cpu"), make_adagml_match_fn(ada), cfg)
    res = loc.localize_batch(torch.Generator().manual_seed(7), cam, kp, sc, de, mk, logits)
    assert res.qvec.shape == (2, 4) and torch.isfinite(res.tvec).all()

    from pram_tpu_torch.maps.rendered import make_world, ref_poses
    from pram_tpu_torch.models.convert import load_sfd2
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    wrng = np.random.RandomState(0)
    world = make_world(wrng)
    R, t = ref_poses(12, wrng)[3]
    img = world.render(R, t, (125.0, 125.0, 80.0, 60.0), 160, 120).astype(np.float32)
    sfd2 = load_sfd2("weights/sfd2_rendered.msgpack", device="cpu")
    with torch.no_grad():
        feats = extract(sfd2, preprocess_image(torch.from_numpy(img[None])), max_keypoints=64,
                        conf_th=1e-4)
    assert feats["score_map"].shape == (1, 120, 160)
    assert feats["descriptors"].shape == (1, 64, 128) and feats["seg_descriptors"].shape == (1, 64, 256)
    assert int(feats["keypoints"].mask.sum()) > 0 and torch.isfinite(feats["descriptors"]).all()

    from pram_tpu_torch.models.sfd2_int8 import cast_stem, quantize_extractor

    x = preprocess_image(torch.from_numpy(img[None]))
    sfd2_8 = cast_stem(quantize_extractor(sfd2, x, conv_kernel=True), torch.float32)
    gml.int8_proj = gml.int8_mlp = True
    with torch.no_grad():
        feats8 = extract(sfd2_8, x, max_keypoints=64, conf_th=1e-4)
        plan = gml(de[:, :128], de[:, 128:384], kp[:, :128] / 640, kp[:, 128:384] / 640)["plan"]
    assert feats8["descriptors"].shape == (1, 64, 128) and torch.isfinite(feats8["descriptors"]).all()
    assert plan.shape == (2, 129, 257) and torch.isfinite(plan).all()

    from pram_tpu_torch.train.augmented import make_augmented_train_step
    from pram_tpu_torch.train.trainer import TrainConfig, Trainer

    rec = load_segnetvit("weights/segnetvit_rendered.msgpack", SegNetViTConfig(n_class=113, n_layers=1),
                         device="cpu")
    tcfg = TrainConfig(lr=1e-3)
    trainer = Trainer(rec, tcfg, log_fn=lambda s: None, step_fn=make_augmented_train_step(rec, sfd2, tcfg))
    kp = feats["keypoints"]
    batch = {"image": torch.from_numpy(img[None]), "keypoints": kp.xy,
             "norm_keypoints": kp.xy / torch.tensor([160.0, 120.0]) - 0.5,
             "gt_seg": torch.arange(64)[None], "mask": kp.mask}
    means = trainer.process_epoch([batch, batch])
    assert trainer.state.iteration == 2 and np.isfinite(means["loss"])

    # the second model family on the view: SuperPoint (radius 3), SegNet and
    # GM at one layer (pair), RetNet and the compressor on SFD2's outputs
    from pram_tpu_torch.engine.matching import make_gm_match_fn
    from pram_tpu_torch.models.registry import build_extractor, build_matcher, build_recognizer
    from pram_tpu_torch.models.retnet import RetNet
    from pram_tpu_torch.models.sfd2 import DescriptorCompressor
    from pram_tpu_torch.models.superpoint import extract as sp_extract
    from pram_tpu_torch.models.superpoint import preprocess_image as sp_pre

    torch.manual_seed(0)
    sp = build_extractor("superpoint").eval()
    with torch.no_grad():
        fsp = sp_extract(sp, sp_pre(torch.from_numpy(img[None])), max_keypoints=64, conf_th=0.005)
        ksp = fsp["keypoints"]
        nksp = ksp.xy / torch.tensor([160.0, 120.0]) - 0.5
        pred = build_recognizer("segnet", {"n_layers": 1, "n_class": 5}).eval()(
            fsp["seg_descriptors"], nksp, mask=ksp.mask)["prediction"]
        gm = build_matcher("gm", {"n_layers": 1, "descriptor_dim": 256}).eval()
        gm_m = make_gm_match_fn(gm, 0.0)(fsp["descriptors"], nksp, ksp.scores, ksp.mask,
                                         fsp["descriptors"], nksp, ksp.scores, ksp.mask)
        glob = RetNet().eval()(feats["mid_features"])
        comp = DescriptorCompressor(64)(feats["descriptors"])
    assert fsp["descriptors"].shape == (1, 64, 256) and fsp["seg_descriptors"].shape == (1, 64, 256)
    assert pred.shape == (1, 64, 5) and torch.isfinite(pred).all() and gm_m.shape == (1, 64)
    assert glob.shape == (1, 1024) and comp.shape == (1, 64, 64)

    # the two serving CLIs, through main(argv) on the CPU at 2 layers: the
    # config, map, feature, image and weight readers of their paths
    import tempfile
    from pathlib import Path

    from pram_tpu_torch.cli import inference as cli_inference
    from pram_tpu_torch.cli import online_localization as cli_online
    from pram_tpu_torch.maps.rendered import build_rendered_scene

    loc = {"seg_k": 1, "threshold": 8.0, "min_inliers": 32, "matching_method": "gml"}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        top = {"network": "segnetvit", "feat_dim": 128, "use_mid_feature": False, "layers": 2,
               "eval_max_keypoints": 512, "localization": loc}
        cfg = chip_smoke.synthetic_layout(tmp / "offline", scene, qs, ["q0.png", "q1.png"], 112, top)
        rep = cli_inference.main(["--config", str(cfg), "--rec_weight_path", weights, "--matcher_weight_path",
                                  gml_weights, "--batch", "2", "--device", "cpu"])
        assert rep.n_total == 2 and len(rep.t_errors) == 2

        def extract_np(images):
            with torch.no_grad():
                f = extract(sfd2, preprocess_image(torch.from_numpy(images)), max_keypoints=256, conf_th=1e-4)
            k = f["keypoints"]
            return k.xy.numpy(), k.scores.numpy(), f["descriptors"].numpy(), k.mask.numpy()

        rscene = build_rendered_scene(extract_np, np.random.RandomState(0), width=160, height=120, focal=125.0,
                                      n_ref=12, kp_per_ref=256, max_ref_points=1024)
        top = {"network": "segnetvit", "use_mid_feature": True, "layers": 2,
               "localization": {**loc, "with_compress": False}}
        cfg = chip_smoke.rendered_layout(tmp / "online", rscene, 112, top)
        imgs, qv, tv = chip_smoke.rendered_path(rscene.world, 2, jumps=(), width=160, height=120, focal=125.0)
        for i, im in enumerate(imgs):
            chip_smoke.write_png(tmp / f"f{i}.png", np.clip(np.round(im * 255), 0, 255).astype(np.uint8))
        chip_smoke.write_queries(tmp, ["f0.png", "f1.png"], qv, tv, ("PINHOLE", 160, 120, (125.0, 125.0, 80.0, 60.0)))
        chip_smoke.write_jpeg(tmp / "f1.jpg", np.clip(np.round(imgs[1] * 255), 0, 255).astype(np.uint8))
        chip_smoke.write_queries(tmp, ["f0.png", "f1.jpg"], qv, tv, ("PINHOLE", 160, 120, (125.0, 125.0, 80.0, 60.0)))
        recs = cli_online.main(["--config", str(cfg), "--image_dir", str(tmp), "--queries",
                                str(tmp / "queries_with_intrinsics.txt"), "--max_keypoints", "128",
                                "--rec_weight_path", "weights/segnetvit_rendered.msgpack",
                                "--feat_weight_path", "weights/sfd2_rendered.msgpack",
                                "--matcher_weight_path", "weights/gml_rendered.msgpack", "--device", "cpu",
                                "--viewer_port", "0", "--save_vis", str(tmp / "vis")])
        assert len(recs) == 2 and all(np.isfinite(r["tvec"]).all() for r in recs)

        # the runtime remainder: the JPEG fixtures against their digests, the
        # logger without TensorBoard, the YAML snapshot read back, the viewer
        # over loopback, a drawing; matplotlib is fenced, so the 3D plot raises
        import hashlib
        import json
        import urllib.request

        from pram_tpu_torch.core.config import load_yaml
        from pram_tpu_torch.core.logging import MetricsLogger
        from pram_tpu_torch.io.image import read_image
        from pram_tpu_torch.utils.common import save_args_yaml
        from pram_tpu_torch.utils.visualization import plot_landmarks_3d, vis_inlier
        from pram_tpu_torch.viz import ViewerServer

        table = json.loads(Path("tests/jpeg_fixtures/digests.json").read_text())
        for name, want in table.items():
            got = read_image(f"tests/jpeg_fixtures/{name}")
            assert hashlib.sha256(got.tobytes()).hexdigest() == want["color"], name
        logger = MetricsLogger(str(tmp / "log"))
        assert logger._tb is None
        logger.log_scalars({"loss": 1.5}, 3)
        logger.close()
        assert json.loads((tmp / "log" / "metrics.jsonl").read_text())["loss"] == 1.5
        save_args_yaml({"a": [1, "x"], "b": None, "c": "off"}, str(tmp / "args"))
        assert load_yaml(str(tmp / "args" / "args.yaml")) == {"a": [1, "x"], "b": None, "c": "off"}
        viewer = ViewerServer(rscene.map, port=0)
        viewer.update(R=np.eye(3), tvec=np.zeros(3), success=True, name="f0")
        state = json.loads(urllib.request.build_opener(urllib.request.ProxyHandler({})).open(
            f"http://127.0.0.1:{viewer.port}/state", timeout=10).read())
        viewer.close()
        assert state["seq"] == 1 and state["frames"][0]["center"] == [0.0, 0.0, 0.0]
        drawn = vis_inlier(np.zeros((20, 20, 3), np.uint8), np.array([[10.0, 10.0]]), [True])
        assert (drawn[..., 1] == 255).sum() > 20
        try:
            plot_landmarks_3d(np.zeros((4, 3)), np.zeros(4, int))
            raise AssertionError("plot_landmarks_3d ran without matplotlib")
        except ImportError:
            pass

        # the two training CLIs, through main(argv) on the CPU: the GML fit
        # at one layer (its config cut here; one step, its checkpoint and
        # validation), and cli.train at two layers on a tiny training layout
        import functools

        from pram_tpu_torch.cli import train as cli_train
        from pram_tpu_torch.cli import train_synthetic_gml as cli_gml
        from pram_tpu_torch.core.config import load_yaml
        from pram_tpu_torch.models import gml as gml_mod

        gml_mod.GMLConfig = functools.partial(GMLConfig, n_layers=1)
        res = cli_gml.main(["--device", "cpu", "--steps", "1", "--batch", "1", "--out", str(tmp / "gml.pt")])
        gml_mod.GMLConfig = GMLConfig
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all() and (tmp / "gml.pt").exists()
        assert 0.0 <= res["validation"]["recall_5cm5deg_gml"] <= 1.0
        top = load_yaml("configs/config_train_7scenes_sfd2.yaml")
        for k in ("dataset", "landmark_path", "dataset_path", "config_path"):
            top.pop(k)
        top.update(layers=2, batch_size=4, max_keypoints=64, min_inliers=8, max_inliers=32, epochs=1,
                   its_per_epoch=2, workers=2, output_dim=64)
        small = make_synthetic_scene(np.random.RandomState(2), n_cluster=3, points_per_cluster=60, n_ref_frames=4,
                                     desc_dim=32)
        cfg = chip_smoke.training_layout(tmp / "train", small, 6, 3, top, n_kpts=48, n_outliers=32)
        run = cli_train.main(["--config", str(cfg), "--device", "cpu", "--save_dir", str(tmp / "ck")])
        assert run.state.iteration == 2 and (tmp / "ck" / "epoch_0001.pt").exists()

        # map building: triangulation with known poses, then cli.build_map with
        # both clustering methods, on the CPU
        from pram_tpu_torch.cli import build_map as cli_build_map
        from pram_tpu_torch.maps.colmap_io import read_model
        from pram_tpu_torch.mapping.triangulate import triangulate_model
        from tests.torch_mapping_scene import keypoints_by_name, make_scene, matches_by_pair, write_inputs

        mscene = make_scene(np.random.RandomState(0), n_pts=200, n_views=6)
        paths = write_inputs(mscene, str(tmp / "mapping"))
        assert not os.path.exists(paths["feats_h5"])
        cams, ims, _ = read_model(paths["ref"], ".bin")
        stats = triangulate_model(cams, ims, keypoints_by_name(mscene), mscene["pairs"], matches_by_pair(mscene),
                                  str(tmp / "mapping" / "model"))
        assert stats["num_points"] > 100
        for method in ("kmeans", "birch"):
            out = tmp / "mapping" / method
            stages = cli_build_map.main(["--model", str(tmp / "mapping" / "model"), "--features", paths["npy"],
                                         "--output", str(out), "--n_cluster", "4", "--cluster_method", method,
                                         "--vrf_min_obs", "10", "--compress_radius", "8", "--device", "cpu"])
            assert (out / f"compress_model_{method}" / "points3D.bin").exists() and "descriptors" in stages
    leaked = BLOCKED & {m.split(".")[0] for m in sys.modules}
    assert not leaked, leaked
    print("FENCE OK", len(names))
    """
) % (BLOCKED + OPTIONAL,)


def test_port_runs_without_jax_flax_msgpack_yaml():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FENCE OK" in proc.stdout


def test_no_forbidden_import_lines():
    """No source line of the port imports a fenced package, not even lazily."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(BLOCKED))
    offenders = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "pram_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.match(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders
