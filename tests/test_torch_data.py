"""The port's data pipeline and map loader against pram_tpu's, on the CPU.

On tests/test_data.py's disk scene (build_disk_scene): SceneDataset test
items, MultiSceneDataset test items and BatchLoader batches (with and
without worker threads, host shards, a last short batch), and on
a two-scene landmark layout written by chip_smoke.py's writers:
load_scene_map / load_multi_map / concat_maps tables, and compose_scenes
items through the YAML reader, all equal.
"""

import numpy as np
import pytest

import chip_smoke
from pram_tpu.data import BatchLoader as JBatchLoader
from pram_tpu.data import MultiSceneDataset as JMulti
from pram_tpu.data import SceneDataset as JSceneDataset
from pram_tpu.data.scenes import compose_scenes as j_compose
from pram_tpu.maps.loader import load_multi_map as j_load_multi_map
from pram_tpu.maps.packed import concat_maps as j_concat
from pram_tpu.maps.synthetic import make_synthetic_scene
from pram_tpu_torch.data import BatchLoader, MultiSceneDataset, SceneDataset, SceneSpec, collate
from pram_tpu_torch.data.scenes import compose_scenes
from pram_tpu_torch.maps.loader import load_multi_map, load_scene_map
from pram_tpu_torch.maps.packed import PackedMap, concat_maps
from tests.test_data import build_disk_scene

MAP_FIELDS = [f for f in PackedMap.__dataclass_fields__]


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port_spec(spec):
    return SceneSpec(**{f: getattr(spec, f) for f in SceneSpec.__dataclass_fields__})


@pytest.mark.parametrize("nfeatures", [128, 16])
def test_scene_test_items(tmp_path, rng, nfeatures):
    spec = build_disk_scene(tmp_path, rng)
    ours = SceneDataset(_port_spec(spec), nfeatures=nfeatures)
    theirs = JSceneDataset(spec, nfeatures=nfeatures, train=False)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        _assert_items_equal(ours.get_test_item(i), theirs.get_test_item(i))
        _assert_items_equal(ours[i], theirs.get_test_item(i))


@pytest.mark.parametrize("kw", [
    dict(num_workers=0), dict(num_workers=2), dict(drop_last=False, num_workers=2),
    dict(num_hosts=2, host_id=1),
], ids=["sync", "workers", "last_short", "host_shard"])
def test_multiscene_and_batch_loader(tmp_path, rng, kw):
    specs = [build_disk_scene(tmp_path, rng, name=f"s{i}") for i in range(2)]
    ours = MultiSceneDataset([SceneDataset(_port_spec(s), nfeatures=64) for s in specs])
    theirs = JMulti([JSceneDataset(s, nfeatures=64, train=False) for s in specs])
    assert (len(ours), ours.n_class, ours.seg_offset) == (len(theirs), theirs.n_class, theirs.seg_offset)
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs.get_test_item(i))
    a = list(BatchLoader(ours, batch_size=5, **kw).epoch())
    b = list(JBatchLoader(theirs, batch_size=5, train=False, **kw).epoch(0))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        _assert_items_equal(x, y)
    assert collate([{"a": np.ones(2), "n": "x"}] * 2)["n"] == ["x", "x"]


def _write_scene(root, scene, dataset, name, compressed, n_cluster):
    m = scene.map
    seg = dict(zip(m.point_ids.tolist(), m.point_seg.tolist()))
    chip_smoke.write_landmarks(
        root / "landmarks" / dataset / name, scene.cameras, scene.images, scene.points3D, scene.point_descs,
        seg, chip_smoke.seg_vrf_of(m, scene.images), n_cluster, compressed, {}, {},
    )


@pytest.mark.parametrize("compressed", [True, False])
def test_load_multi_map_and_concat(tmp_path, compressed):
    rng = np.random.RandomState(1)
    scenes = [make_synthetic_scene(rng, n_cluster=3, points_per_cluster=60, n_ref_frames=4, desc_dim=32)
              for _ in range(2)]
    cfgs = []
    for i, scene in enumerate(scenes):
        _write_scene(tmp_path, scene, "Synth", f"s{i}", compressed, 3)
        cfgs.append({"landmark_path": str(tmp_path / "landmarks" / "Synth" / f"s{i}"), "n_cluster": 3,
                     "cluster_mode": "xz", "cluster_method": "birch", "scene_name": f"Synth/s{i}"})
    ours = load_multi_map(cfgs, with_compress=compressed, covisibility_frame=3)
    theirs = j_load_multi_map(cfgs, with_compress=compressed, covisibility_frame=3)
    for f in MAP_FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a == b) if not isinstance(a, np.ndarray) else np.array_equal(a, b), f
    one = load_scene_map(cfgs[0]["landmark_path"], n_cluster=3, with_compress=compressed, covisibility_frame=3)
    assert np.array_equal(one.point_xyz, scenes[0].map.point_xyz)
    both = concat_maps([s.map for s in scenes])
    ref = j_concat([s.map for s in scenes])
    for f in MAP_FIELDS:
        a, b = getattr(both, f), getattr(ref, f)
        assert (a == b) if not isinstance(a, np.ndarray) else np.array_equal(a, b), f


def test_compose_scenes_through_the_yaml_reader(tmp_path):
    rng = np.random.RandomState(2)
    scene = make_synthetic_scene(rng, n_cluster=3, points_per_cluster=60, n_ref_frames=4, desc_dim=32)
    queries = [scene.render_query(rng, noise_px=0.3, max_kpts=64) for _ in range(5)]
    names = [f"q/{i}.png" for i in range(5)]
    chip_smoke.synthetic_layout(tmp_path, scene, queries, names, 3, {"network": "segnetvit"})
    config = {"landmark_path": str(tmp_path / "landmarks"), "dataset_path": str(tmp_path / "datasets"),
              "config_path": str(tmp_path / "configs"), "max_keypoints": 64, "eval_max_keypoints": 64}
    ours = compose_scenes(["Synthetic"], config)
    theirs = j_compose(["Synthetic"], config, train=False)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        _assert_items_equal(ours.get_test_item(i), theirs.get_test_item(i))
