"""The port's runtime remainder against pram_tpu on the CPU.

- ``core/logging.py``: ``MetricsLogger`` writes the same log.txt and
  metrics.jsonl as the JAX one (the records' wall times aside) and makes
  the same TensorBoard calls (a recording stand-in for the writer), with
  and without TensorBoard; ``run_name_tag`` is the same string.
- ``utils/common.py``: ``resize_img`` equal to ``cv2.resize`` with
  ``INTER_NEAREST`` and within one grey level with ``INTER_LINEAR`` (the
  bound tests/test_torch_cli.py holds ``resize_linear`` to), as the JAX
  function calls it; ``pad_to_multiple`` equal; ``save_args_yaml``'s file
  read by ``yaml.safe_load`` equal to the JAX one's and read back by
  ``core/config.py``; ``puttext_with_background`` raises naming cv2's
  Hershey fonts.
- ``utils/visualization.py``: ``generate_color_dic`` equal; the drawings
  against the JAX package's cv2 output: every mark's pixels with IoU >= 0.9
  (each mark drawn alone), the drawn colours exact and the untouched pixels
  exact; ``plot_landmarks_3d`` the same figure, and without matplotlib it
  raises, as the JAX function does.
- ``viz/server.py``: the two viewers' ``/``, ``/map`` and ``/state`` (whole
  and ``?since=``) equal on the same map and updates; the online CLI with
  ``--viewer_port 0 --save_vis DIR`` against the JAX CLI with the same
  flags (tests/test_torch_cli.py's run, with its patches): the same frames
  in both viewers, poses within the run's 0.25 deg / 2 cm, the port's last
  frame the CLI's last result, nothing written under DIR.
- ``scripts/reconstruct_scene_torch.sh`` run with a stub ``python`` on
  PATH that records its argv: each call the JAX script's, flag for flag,
  with ``--device`` added where DEVICE is set, and each parsed by the port
  CLI's own parser.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from pram_tpu.core import logging as jlog
from pram_tpu.utils import common as jcommon
from pram_tpu.utils import visualization as jvis
from pram_tpu.viz.server import ViewerServer as JaxViewer
from pram_tpu_torch.core import config as tcfg
from pram_tpu_torch.core import logging as tlog
from pram_tpu_torch.utils import common as tcommon
from pram_tpu_torch.utils import visualization as tvis
from pram_tpu_torch.viz.server import ViewerServer
from test_torch_cli import jax_matches_only, one_torch_thread, run_online_against_jax  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


class _Writer:
    """A SummaryWriter that records its calls (the real one imports
    TensorFlow here, seconds a process)."""

    calls = []

    def __init__(self, logdir):
        self.calls.append(("init", os.path.basename(os.path.dirname(logdir)), os.path.basename(logdir)))

    def add_scalar(self, *a):
        self.calls.append(("add_scalar",) + a)

    def close(self):
        self.calls.append(("close",))


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metrics_logger_as_pram_tpu(tmp_path, tensorboard, monkeypatch):
    import types

    # TensorBoard missing (the card's machine), or a recording writer
    fake = types.SimpleNamespace(SummaryWriter=_Writer) if tensorboard else None
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    writes = {}
    for mod, name in ((jlog, "jax"), (tlog, "port")):
        _Writer.calls = []
        logger = mod.MetricsLogger(str(tmp_path / name), use_tensorboard=True)
        assert (logger._tb is not None) == tensorboard
        logger.log_text("epoch 1")
        logger.log_scalars({"loss": np.float32(0.5), "acc": 3}, step=7)
        logger.log_scalars({"loss": 0.25}, step=8)
        logger.close()
        writes[name] = [c if c[0] != "init" else c[:1] + c[2:] for c in _Writer.calls]
    assert writes["jax"] == writes["port"] == ([("init", "tb"), ("add_scalar", "loss", 0.5, 7), ("add_scalar", "acc", 3.0, 7),
                                               ("add_scalar", "loss", 0.25, 8), ("close",)] if tensorboard else [])
    read = {}
    for name in ("jax", "port"):
        txt = (tmp_path / name / "log.txt").read_text()
        recs = [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        assert all(isinstance(r.pop("time"), float) for r in recs)
        read[name] = (txt, recs)
    assert read["jax"] == read["port"] == ("epoch 1\n", [{"step": 7, "loss": 0.5, "acc": 3.0}, {"step": 8, "loss": 0.25}])
    monkeypatch.setattr("time.strftime", lambda fmt: "20261019_120000")
    for cfg in ({}, {"network": "gml", "layers": 2, "batch_size": 4, "max_keypoints": 1000, "n_class": 113}):
        assert tlog.run_name_tag(cfg) == jlog.run_name_tag(cfg)


@pytest.mark.parametrize("nh,nw", [(30, -1), (-1, 50), (23, 41), (-1, -1), (200, -1)])
@pytest.mark.parametrize("mode", [None, cv2.INTER_NEAREST, cv2.INTER_LINEAR])
def test_resize_img_as_cv2(nh, nw, mode):
    rng = np.random.RandomState(abs(nh + 3 * nw))
    for img in (rng.randint(0, 256, (61, 83, 3)).astype(np.uint8), rng.randint(0, 256, (61, 83)).astype(np.uint8)):
        ours = tcommon.resize_img(img, nh, nw, mode)
        theirs = jcommon.resize_img(img, nh, nw, mode)
        assert ours.shape == theirs.shape
        if mode == cv2.INTER_LINEAR:
            assert np.abs(ours.astype(int) - theirs).max() <= 1
        else:
            np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(NotImplementedError, match="INTER_NEAREST"):
        tcommon.resize_img(img, 10, 10, cv2.INTER_CUBIC)


@pytest.mark.parametrize("shape", [(37, 45, 3), (40, 48), (1, 9, 2)])
def test_pad_to_multiple_as_pram_tpu(shape):
    img = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ours, theirs = tcommon.pad_to_multiple(img), jcommon.pad_to_multiple(img)
    assert ours[1] == theirs[1] and np.array_equal(ours[0], theirs[0])


ARGS = {
    "config": "configs/config_train_7scenes_sfd2.yaml", "name": "run 1: a/b", "quote": "it's",
    "empty": "", "yes_word": "yes", "null_word": "null", "number_word": "1.5", "int_word": "12",
    "hex_word": "0x10", "hash": "a #b", "dash": "-x", "colon_end": "x:", "lr": 1e-05, "big": 1e20,
    "neg": -0.25, "whole": 2.0, "inf": math.inf, "steps": 20, "flag": True, "off": False, "none": None,
    "layers": [1, 2.5, "x", None, True], "no_list": [], "nested": {"a": 1, "b": {"c": "d"}}, "no_dict": {},
}


def test_save_args_yaml_reads_back_as_pram_tpu(tmp_path):
    ns = argparse.Namespace(**ARGS)
    jcommon.save_args_yaml(ns, str(tmp_path / "jax"))
    tcommon.save_args_yaml(ns, str(tmp_path / "port"))
    ours = (tmp_path / "port" / "args.yaml").read_text()
    theirs = yaml.safe_load((tmp_path / "jax" / "args.yaml").read_text())
    assert yaml.safe_load(ours) == theirs == ARGS
    assert list(yaml.safe_load(ours)) == list(ARGS)
    assert tcfg.safe_load(ours) == ARGS
    tcommon.save_args_yaml({"x": 1}, str(tmp_path / "port"), name="other.yaml")
    assert tcfg.load_yaml(str(tmp_path / "port" / "other.yaml")) == {"x": 1}
    with pytest.raises(ValueError, match="one-line"):
        tcommon.save_args_yaml({"x": "a\nb"}, str(tmp_path / "bad"))


def test_puttext_raises_naming_the_hershey_fonts():
    with pytest.raises(NotImplementedError, match="Hershey"):
        tcommon.puttext_with_background(np.zeros((8, 8, 3), np.uint8), "x", (1, 6))


def test_generate_color_dic_as_pram_tpu():
    assert tvis.generate_color_dic() == jvis.generate_color_dic()
    assert tvis.generate_color_dic(37, seed=5) == jvis.generate_color_dic(37, seed=5)


def _changed(out, img):
    return np.any(out != img, axis=-1) if out.ndim == 3 else out != img


def _same_marks(ours, theirs, base):
    """Drawn pixels' IoU >= 0.9, their colours exact where both drew, the
    untouched pixels exact."""
    a, b = _changed(ours, base), _changed(theirs, base)
    assert (a & b).sum() >= 0.9 * (a | b).sum()
    both = a & b
    np.testing.assert_array_equal(ours[both], theirs[both])
    np.testing.assert_array_equal(ours[~(a | b)], base[~(a | b)])


def _marks_case(rng, n=24, h=90, w=120):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    kpts = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n), rng.rand(n)], 1)
    return img, kpts


@pytest.mark.parametrize("radius,thickness", [(5, -1), (3, -1), (5, 2), (8, 3), (4, 1)])
def test_drawings_as_pram_tpu(radius, thickness):
    rng = np.random.RandomState(radius * 10 + thickness)
    img, kpts = _marks_case(rng)
    segs = rng.randint(0, 40, len(kpts))
    colors = jvis.generate_color_dic(50)
    for i in range(len(kpts)):  # each mark alone, on a blank canvas
        blank = np.zeros_like(img)
        ours = tvis.vis_seg_point(blank, kpts[i : i + 1], segs[i : i + 1], colors, radius, thickness)
        _same_marks(ours, jvis.vis_seg_point(blank, kpts[i : i + 1], segs[i : i + 1], colors, radius, thickness),
                    blank)
    _same_marks(tvis.vis_seg_point(img, kpts, segs, colors, radius, thickness),
                jvis.vis_seg_point(img, kpts, segs, colors, radius, thickness), img)
    inl = rng.rand(len(kpts)) > 0.4
    t = max(thickness, 1)
    _same_marks(tvis.vis_inlier(img, kpts, inl, radius, t), jvis.vis_inlier(img, kpts, inl, radius, t), img)
    img2, kpts2 = _marks_case(rng, h=70, w=100)
    ours = tvis.plot_matches(img, img2, kpts, kpts2, inl, radius, t)
    theirs = jvis.plot_matches(img, img2, kpts, kpts2, inl, radius, t)
    base = np.zeros_like(theirs)
    base[: img.shape[0], : img.shape[1]], base[: img2.shape[0], img.shape[1] :] = img, img2
    _same_marks(ours, theirs, base)
    for i in range(len(kpts)):  # each match's circles and line alone
        blank1, blank2 = np.zeros_like(img), np.zeros_like(img2)
        ours = tvis.plot_matches(blank1, blank2, kpts[i : i + 1], kpts2[i : i + 1], inl[i : i + 1], radius, t)
        theirs = jvis.plot_matches(blank1, blank2, kpts[i : i + 1], kpts2[i : i + 1], inl[i : i + 1], radius, t)
        _same_marks(ours, theirs, np.zeros_like(theirs))


def test_plot_landmarks_3d_as_pram_tpu(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    xyz, segs = rng.randn(300, 3), rng.randint(0, 9, 300)
    poses = [rng.randn(3) for _ in range(4)]
    for mod, name in ((jvis, "jax"), (tvis, "port")):
        assert mod.plot_landmarks_3d(xyz, segs, str(tmp_path / f"{name}.png"), max_points=200,
                                     frame_poses=poses) == str(tmp_path / f"{name}.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "jax.png")))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the card's machine has none
    for mod in (jvis, tvis):
        with pytest.raises(ImportError):
            mod.plot_landmarks_3d(xyz, segs, str(tmp_path / "none.png"))


def _get(port, path):
    # loopback, past any proxy the environment names
    with urllib.request.build_opener(urllib.request.ProxyHandler({})).open(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _get_json(port, path):
    return json.loads(_get(port, path))


def test_viewer_endpoints_as_pram_tpu():
    from pram_tpu_torch.maps.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(np.random.RandomState(0), n_cluster=3, points_per_cluster=60, n_ref_frames=4,
                                 desc_dim=32, max_kp_per_frame=64, max_ref_points=128)
    rng = np.random.RandomState(1)
    servers = [JaxViewer(scene.map, port=0, max_points=100), ViewerServer(scene.map, port=0, max_points=100)]
    try:
        for i in range(5):
            r = cv2.Rodrigues(rng.randn(3) * 0.3)[0]
            kw = dict(R=r, tvec=rng.randn(3), success=i != 2, tracking=i > 0, matched_sid=i - 1, num_inliers=30 + i,
                      times={"feat": 0.01 * i, "total": 0.05}, name=f"f{i}.jpg")
            if i == 3:
                kw.update(gt_R=r.T, gt_tvec=rng.randn(3))
            for s in servers:
                s.update(**kw)
        servers[0].update(success=True)
        servers[1].update(success=True)
        for path in ("/", "/map", "/state", "/state?since=3", "/state?since=x", "/nothing"):
            if path == "/nothing":
                for s in servers:
                    with pytest.raises(urllib.error.HTTPError, match="404"):
                        _get(s.port, path)
            else:
                assert _get(servers[1].port, path) == _get(servers[0].port, path), path
        state = _get_json(servers[1].port, "/state?since=3")
        assert state["seq"] == 6 and [f["seq"] for f in state["frames"]] == [4, 5, 6]
        assert len(_get_json(servers[1].port, "/map")["points"]) == 100
    finally:
        for s in servers:
            s.close()


class _Recorded:
    """ViewerServer subclasses that keep their instances."""

    def __init__(self, monkeypatch):
        import pram_tpu.viz as jviz
        import pram_tpu_torch.viz as tviz

        self.made = {"jax": [], "port": []}
        for mod, key in ((jviz, "jax"), (tviz, "port")):
            base = mod.ViewerServer

            def make(*a, _base=base, _key=key, **k):
                s = _base(*a, **k)
                self.made[_key].append(s)
                return s

            monkeypatch.setattr(mod, "ViewerServer", make)

    def close(self):
        for servers in self.made.values():
            for s in servers:
                s.close()


def test_online_viewer_and_save_vis_as_the_jax_cli(tmp_path, jax_matches_only, monkeypatch, capsys):  # noqa: F811
    rec = _Recorded(monkeypatch)
    vis_dir = tmp_path / "vis"
    try:
        recs, frames = run_online_against_jax(tmp_path, monkeypatch,
                                              ["--viewer_port", "0", "--save_vis", str(vis_dir)])
        assert not vis_dir.exists()  # accepted and unused in both packages
        (jv,), (tv,) = rec.made["jax"], rec.made["port"]
        assert f"viewer: http://127.0.0.1:{tv.port}/" in capsys.readouterr().out
        assert _get(tv.port, "/map") == _get(jv.port, "/map")
        ours, theirs = _get_json(tv.port, "/state"), _get_json(jv.port, "/state")
    finally:
        rec.close()
    assert ours["seq"] == theirs["seq"] == len(recs) == 4
    for r, a, b in zip(recs, ours["frames"], theirs["frames"]):
        for key in ("seq", "success", "tracking", "matched_sid", "num_inliers", "name"):
            assert a[key] == b[key], key
        assert sorted(a["times"]) == sorted(b["times"]) == ["feat", "loc", "rec", "total"]
        np.testing.assert_allclose(a["center"], b["center"], atol=0.02)
        np.testing.assert_allclose(a["frustum"], b["frustum"], atol=0.025)
        assert a["matched_sid"] == -1  # the JAX records carry no landmark
    last = recs[-1]
    from pram_tpu_torch.geometry.rotations import qvec2rotmat
    import torch

    rot = qvec2rotmat(torch.from_numpy(last["qvec"]).float()).numpy()
    np.testing.assert_allclose(ours["frames"][-1]["center"], -(rot.T @ last["tvec"]), atol=1e-5)
    assert ours["frames"][-1]["num_inliers"] == last["inliers"]


def _stub_python(tmp_path):
    """A ``python`` that records its argv (one JSON list a line) and exits 0."""
    stub = tmp_path / "bin"
    stub.mkdir()
    (stub / "python").write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        "with open(__import__('os').environ['CALLS'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    (stub / "python").chmod(0o755)
    return stub


def _run_script(tmp_path, stub, script, env_extra, tag):
    calls = tmp_path / f"{tag}.jsonl"
    env = {"PATH": f"{stub}:{os.environ['PATH']}", "CALLS": str(calls), **env_extra}
    args = ["data/scene", str(tmp_path / "lm"), "sfm/model", "pairs.txt", "8", "xyz", "kmeans"]
    subprocess.run(["bash", str(ROOT / "scripts" / script), *args], env=env, check=True, cwd=tmp_path)
    return [json.loads(line) for line in calls.read_text().splitlines()]


def _parsed_by_the_port_cli(module, argv):
    """The namespace the port CLI's own parser gives ``argv`` (main stops
    right after parsing)."""
    import importlib

    class Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise Parsed(real(self, args, namespace))

    mod = importlib.import_module(module)
    argparse.ArgumentParser.parse_args = parse
    try:
        mod.main(argv)
    except Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError(f"{module}.main did not parse its arguments")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_reconstruct_script_calls_as_the_jax_script(tmp_path, device):
    stub = _stub_python(tmp_path)
    weights = {"SFD2_WEIGHTS": "w/sfd2.pth", "GML_WEIGHTS": "w/gml.pth"}
    theirs = _run_script(tmp_path, stub, "reconstruct_scene.sh", weights, "jax")
    ours = _run_script(tmp_path, stub, "reconstruct_scene_torch.sh",
                       {**weights, **({"DEVICE": device} if device else {})}, "port")
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a[:2] == ["-m", b[1].replace("pram_tpu.", "pram_tpu_torch.")] and b[0] == "-m"
        step = b[1].rsplit(".", 1)[1]
        want = b[2:] + (["--device", device] if device and step != "triangulate" else [])
        assert a[2:] == want
        ns = _parsed_by_the_port_cli(a[1], a[2:])
        if device and step != "triangulate":
            assert ns.device == device
        flags = [x for x in a[2:] if x.startswith("--")]
        assert all(getattr(ns, f[2:]) is not None for f in flags)
