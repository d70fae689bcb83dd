"""The training half of the port's data readers and its training CLI
against pram_tpu on the CPU.

``SceneDataset.get_train_item`` (token sampling, jittered padding, the
``with_image`` read and scale augmentation), ``MultiSceneDataset``,
``BatchLoader``'s training order (reseeded per epoch, ``its_per_epoch``
tiling, per-batch generators, workers delivering in order) and
``compose_scenes(train=True)`` are held bit for bit against the JAX
package from the same ``np.random.RandomState``; the one exception is an
image the scale augmentation resized, within 1e-6 (the port's bilinear
resize sums in f64 where cv2's sums in f32). The first recognition step on
a ``BatchLoader`` batch, from the same flax-initialised params, matches
``pram_tpu/train/trainer.py``'s: loss and accuracies within 1e-5 relative.
``cli.train.main`` runs on the CPU on a tiny layout written by
``chip_smoke.training_layout``: its checkpoints, a resume from the first
that ends at the same iteration with the same weights, and what raises:
the unported flags and feature caches without descriptors.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pram_tpu.data import BatchLoader as JBatchLoader
from pram_tpu.data import MultiSceneDataset as JMulti
from pram_tpu.data import SceneDataset as JSceneDataset
from pram_tpu.data.scenes import compose_scenes as j_compose
from pram_tpu.models.segnetvit import SegNetViT as JaxSegNetViT
from pram_tpu.models.segnetvit import SegNetViTConfig as JaxSegConfig
from pram_tpu.train import trainer as jtr
from pram_tpu_torch.cli import train as cli_train
from pram_tpu_torch.core.config import load_yaml
from pram_tpu_torch.data import BatchLoader, MultiSceneDataset, SceneDataset, SceneSpec
from pram_tpu_torch.data.scenes import compose_scenes
from pram_tpu_torch.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.models.convert import segnetvit_state_dict
from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
from pram_tpu_torch.train import trainer as ttr
from tests.test_data import build_disk_scene

CONFIG = "configs/config_train_7scenes_sfd2.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_spec(spec, **kw):
    return SceneSpec(**{f: getattr(spec, f) for f in SceneSpec.__dataclass_fields__}, **kw)


def _assert_items_equal(a, b, close=()):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        if k in close:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("nfeatures,min_inliers,max_inliers", [(128, 0, 4096), (256, 8, 64), (64, 200, 256)],
                         ids=["sampled", "padded", "few_inliers"])
def test_train_items_match(tmp_path, rng, nfeatures, min_inliers, max_inliers):
    spec = build_disk_scene(tmp_path, rng)
    kw = dict(nfeatures=nfeatures, train=True, min_inliers=min_inliers, max_inliers=max_inliers)
    ours, theirs = SceneDataset(_port_spec(spec), **kw), JSceneDataset(spec, **kw)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        _assert_items_equal(ours.get_train_item(i, np.random.RandomState(i)),
                            theirs.get_train_item(i, np.random.RandomState(i)))


def test_train_items_with_images_and_scale_augmentation(tmp_path, rng):
    spec = build_disk_scene(tmp_path, rng)
    img_dir = tmp_path / "images"
    for name in spec.image_names:
        (img_dir / name).parent.mkdir(parents=True, exist_ok=True)
        chip_smoke.write_png(img_dir / name, rng.randint(0, 256, (48, 64, 3)).astype(np.uint8))
    spec.image_dir = str(img_dir)
    kw = dict(nfeatures=128, train=True, with_image=True, scale_params=(0.5, 1.0))
    ours, theirs = SceneDataset(_port_spec(spec), **kw), JSceneDataset(spec, **kw)
    scaled = 0
    for seed in range(12):
        a = ours.get_train_item(seed % len(ours), np.random.RandomState(seed))
        b = theirs.get_train_item(seed % len(ours), np.random.RandomState(seed))
        scaled += int(not np.array_equal(a["image_size"], [480, 640]))  # the cached size unless scaled
        _assert_items_equal(a, b, close=("image",))
    assert 0 < scaled < 12  # both branches of the augmentation ran


def test_multiscene_train_items_and_loader_order(tmp_path, rng):
    specs = [build_disk_scene(tmp_path, rng, name=f"s{i}") for i in range(2)]
    ours = MultiSceneDataset([SceneDataset(_port_spec(s), nfeatures=64, train=True) for s in specs])
    theirs = JMulti([JSceneDataset(s, nfeatures=64, train=True) for s in specs])
    for i in range(len(ours)):
        _assert_items_equal(ours.get_train_item(i, np.random.RandomState(i)),
                            theirs.get_train_item(i, np.random.RandomState(i)))
    for kw in (dict(num_workers=0), dict(num_workers=3, its_per_epoch=7), dict(its_per_epoch=2, seed=5)):
        for epoch in (0, 1):
            a = list(BatchLoader(ours, batch_size=5, train=True, **kw).epoch(epoch))
            b = list(JBatchLoader(theirs, batch_size=5, train=True, **kw).epoch(epoch))
            assert len(a) == len(b) > 0
            if "its_per_epoch" in kw:
                assert len(a) == kw["its_per_epoch"]
            for x, y in zip(a, b):
                _assert_items_equal(x, y)


def _layout(tmp_path, **top):
    """A tiny training layout (3 clusters, 6 frames of 48 + 32 keypoints)
    with the repo's training config cut to 2 layers, batch 4, 64 tokens."""
    scene = make_synthetic_scene(np.random.RandomState(2), n_cluster=3, points_per_cluster=60, n_ref_frames=4,
                                 desc_dim=32)
    cfg = load_yaml(CONFIG)
    for k in ("dataset", "landmark_path", "dataset_path", "config_path"):
        cfg.pop(k)
    cfg.update(layers=2, batch_size=4, max_keypoints=64, min_inliers=8, max_inliers=32, epochs=2,
               its_per_epoch=2, workers=2, output_dim=64, save_path=str(tmp_path / "exp"), **top)
    return chip_smoke.training_layout(tmp_path, scene, 6, 3, cfg, n_kpts=48, n_outliers=32)


def test_compose_scenes_for_training_and_the_first_step(tmp_path):
    cfg_path = _layout(tmp_path)
    cfg = load_yaml(str(cfg_path))
    ours = compose_scenes(cfg["dataset"], cfg, train=True)
    theirs = j_compose(cfg["dataset"], cfg, train=True)
    assert (len(ours), ours.n_class) == (len(theirs), theirs.n_class) == (6, 4)
    for i in range(len(ours)):
        _assert_items_equal(ours.get_train_item(i, np.random.RandomState(i)),
                            theirs.get_train_item(i, np.random.RandomState(i)))
    kw = dict(batch_size=4, train=True, its_per_epoch=2)
    batch = next(BatchLoader(ours, **kw).epoch(0))
    _assert_items_equal(batch, next(JBatchLoader(theirs, **kw).epoch(0)))

    import jax

    model_cfg = dict(descriptor_dim=256, output_dim=64, n_class=4, n_layers=2)
    jmodel = JaxSegNetViT(JaxSegConfig(**model_cfg))
    tcfg = jtr.TrainConfig(batch_size=4)
    jbatch = {k: batch[k] for k in ("seg_descriptors", "norm_keypoints", "gt_seg", "mask")}
    state = jtr.init_train_state(jmodel, tcfg, jbatch)
    _, jmetrics = jtr.make_train_step(jmodel, tcfg, donate=False)(state, jbatch)

    model = SegNetViT(SegNetViTConfig(**model_cfg))
    model.load_state_dict(segnetvit_state_dict(jax.tree_util.tree_map(np.asarray, state.params)))
    tstate = ttr.init_train_state(model, ttr.TrainConfig(batch_size=4))
    metrics = ttr.make_train_step(model, ttr.TrainConfig(batch_size=4))(
        tstate, next(cli_train.batches_on("cpu", [batch])))
    for k in ("loss", "acc_corr", "acc_incorr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def test_train_cli_checkpoints_resume_and_raising_flags(tmp_path):
    cfg = _layout(tmp_path)
    run = cli_train.main(["--config", str(cfg), "--device", "cpu", "--save_dir", str(tmp_path / "a"), "--no_mesh"])
    assert run.state.iteration == 4 and run.state.epoch == 2
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["best.pt", "epoch_0001.pt", "epoch_0002.pt"]
    first = torch.load(tmp_path / "a" / "epoch_0001.pt", weights_only=True)
    assert (first["epoch"], first["iteration"]) == (1, 2)

    resumed = _layout(tmp_path / "b", resume_path=str(tmp_path / "a" / "epoch_0001.pt"))
    again = cli_train.main(["--config", str(resumed), "--device", "cpu", "--save_dir", str(tmp_path / "b" / "ck")])
    names = {p.name for p in (tmp_path / "b" / "ck").iterdir()}
    assert again.state.iteration == 4 and "epoch_0002.pt" in names and "epoch_0001.pt" not in names
    want = torch.load(tmp_path / "a" / "epoch_0002.pt", weights_only=True)["model"]
    got = again.state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())

    argv = ["--config", str(cfg), "--device", "cpu"]
    feats = sorted((tmp_path / "landmarks" / "Synthetic" / "scene" / "feats").iterdir())
    for fn in feats:  # caches without descriptors: the JAX CLI's SystemExit
        feat = np.load(fn, allow_pickle=True)[()]
        feat.pop("descriptors")
        np.save(fn, feat)
    with pytest.raises(SystemExit, match="descriptors"):
        cli_train.main(argv)
    for flags, item in ((["--tp", "2"], "item 9"), (["--sp", "2"], "item 9"), (["--pp", "2"], "item 9"),
                        (["--packs", str(tmp_path / "packs")], "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            cli_train.main(argv + flags)
