"""The port's mapping modules (pram_tpu_torch/mapping/) against pram_tpu's on
the CPU: every case of tests/test_mapping.py as a parity case (the same
seeded inputs on both sides), then KMeans against ``kmeans_jax`` from the
JAX side's own initial centres, Birch against scikit-learn, the track
descriptor choice and the feature reader.

The numpy copies' outputs are held exactly. KMeans sums its f32 products in
another order than XLA, so its labels are held equal on separated blobs and
on >= 99.9% of uniform points. The descriptor choice is held exactly on
bf16-valued descriptors; on f32-normalized ones a two-view track's two
medians tie within the rounding of the self-similarities, and there the
choice is held by the medians (within 1e-5 in f64).
"""

import sys

import numpy as np
import pytest
import torch

from pram_tpu.mapping import clustering as jcl
from pram_tpu.mapping import recmap as jrm
from pram_tpu.mapping.outliers import statistical_outlier_removal as j_outliers
from pram_tpu_torch.mapping import clustering as tcl
from pram_tpu_torch.mapping import recmap as trm
from pram_tpu_torch.mapping.birch import Birch
from pram_tpu_torch.mapping.outliers import statistical_outlier_removal as t_outliers
from tests.test_mapping import build_recmap
from tests.torch_mapping_scene import bf16_values, keypoints_by_name, make_scene, matches_by_pair


@pytest.fixture(scope="module")
def kmeans_jax():
    """``kmeans_jax`` and the JAX side's initial centres
    (``jax.random.choice(PRNGKey(seed), n, (k,), replace=False)``, as it draws
    them), jitted once for the module."""
    import jax
    import jax.numpy as jnp

    def run(x, k, seed=0):
        key = jax.random.PRNGKey(seed)
        idx = np.asarray(jax.random.choice(key, x.shape[0], (k,), replace=False))
        labels, centers = jcl.kmeans_jax(key, jnp.asarray(x, jnp.float32), k)
        return np.asarray(labels), np.asarray(centers), idx

    return run


def port_recmap(m):
    """The port's RecMap on the CPU over ``m``'s model."""
    p = trm.RecMap("cpu")
    p.cameras, p.images, p.points3D = m.cameras, m.images, m.points3D
    return p


def assert_same_tree(a, b, path="root"):
    """Nested dicts / lists / arrays equal: keys, order of dict items,
    dtypes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


# ---- tests/test_mapping.py, each as a parity case


def test_outlier_removal_matches_pram_tpu(rng):
    core = rng.randn(500, 3) * 0.5
    outliers = rng.randn(10, 3) * 0.5 + 50.0
    xyz = np.vstack([core, outliers])
    keep = t_outliers(xyz, nb_neighbors=20, std_ratio=2.0)
    np.testing.assert_array_equal(keep, j_outliers(xyz, nb_neighbors=20, std_ratio=2.0))
    assert all(i < 500 for i in keep)
    assert len(keep) >= 490


def test_kmeans_separates_blobs_like_kmeans_jax(rng, kmeans_jax):
    blobs = np.vstack(
        [rng.randn(100, 3) * 0.2 + c for c in ([0, 0, 0], [5, 0, 0], [0, 5, 0])]
    ).astype(np.float32)
    jl, jc, idx = kmeans_jax(blobs, 3)
    labels, centers = tcl.kmeans(torch.from_numpy(blobs), 3, init_idx=idx)
    labels = labels.numpy()
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(centers.numpy(), jc, rtol=0, atol=1e-5)
    for b in range(3):
        assert len(np.unique(labels[b * 100 : (b + 1) * 100])) == 1
    assert len(np.unique(labels)) == 3


def test_cluster_points_axis_masking_matches_pram_tpu(rng, kmeans_jax):
    g1 = rng.randn(80, 3) * 0.1
    g2 = g1 + [0, 10.0, 0]
    xyz = np.vstack([g1, g2])
    _, _, idx = kmeans_jax(np.zeros((160, 3), np.float32), 2)  # seed 0's draw, as cluster_points makes it
    for mode in ("xyz", "xz"):
        want = jcl.cluster_points(xyz, 2, mode=mode, method="kmeans")
        got = tcl.cluster_points(xyz, 2, mode=mode, method="kmeans", device="cpu", init_idx=idx)
        np.testing.assert_array_equal(got, want)
        if mode == "xyz":
            assert len(np.unique(got[:80])) == 1 and len(np.unique(got[80:])) == 1
            assert got[0] != got[100]
        else:
            np.testing.assert_array_equal(got[:80], got[80:160])


def median_gap(track: np.ndarray, i: int, j: int) -> float:
    """|median distance of descriptor i - that of j| over the track, in f64."""
    t = track.astype(np.float64)
    d = 2.0 - 2.0 * t @ t.T
    return abs(float(np.median(d[i]) - np.median(d[j])))


def test_descriptor_assignment_matches_pram_tpu(rng):
    m, src, pdesc = build_recmap(rng)
    want = m.assign_point3D_descriptors(src)
    got = port_recmap(m).assign_point3D_descriptors(src)
    assert list(got) == list(want)
    differ = 0
    for pid, d in got.items():
        if np.array_equal(d, want[pid]):
            continue
        differ += 1
        pt = m.points3D[pid]
        track = np.stack([src.get(m.images[i].name)["descriptors"][k] for i, k in zip(pt.image_ids, pt.point2D_idxs)])
        i = int(np.nonzero((track == d).all(1))[0][0])
        j = int(np.nonzero((track == want[pid]).all(1))[0][0])
        assert median_gap(track, i, j) <= 1e-5, pid
    assert differ <= len(got) // 4
    sims = [float(d @ pdesc[pid - 100]) for pid, d in got.items()]
    assert np.mean(sims) > 0.95


def _labelled(rng, halves: bool):
    m, src, _ = build_recmap(rng)
    pids = sorted(m.points3D.keys())
    labels = np.zeros(len(pids), int)
    if halves:
        labels[len(pids) // 2 :] = 1
    data = {"id": np.asarray(pids), "label": labels}
    p = port_recmap(m)
    m.load_segmentation_data(data)
    p.load_segmentation_data(data)
    return m, p, src


def test_vrf_selection_matches_pram_tpu(rng):
    m, p, _ = _labelled(rng, halves=True)
    want = m.create_virtual_frames(min_obs=1, n_vrf=3, min_cover_ratio=0.9)
    got = p.create_virtual_frames(min_obs=1, n_vrf=3, min_cover_ratio=0.9)
    assert_same_tree(got, want)
    assert set(got.keys()) == {0, 1}
    for recs in got.values():
        assert len(recs) >= 1 and recs[0]["image_id"] in m.images
        assert len(recs[0]["original_points3d"]) > 0 and "covisible_frame_ids" in recs[0]


def test_compression_matches_pram_tpu(rng, tmp_path):
    m, p, src = _labelled(rng, halves=False)
    out = {}
    for name, rm in (("jax", m), ("port", p)):
        vrf = rm.create_virtual_frames(min_obs=1, n_vrf=1)
        descs = rm.assign_point3D_descriptors(src)
        out[name] = rm.compress_map_by_projection(vrf, descs, radius=40.0, save_dir=str(tmp_path / name))
    for a, b in zip(out["port"], out["jax"]):
        assert list(a) == list(b)
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "port" / fn).read_bytes() == (tmp_path / "jax" / fn).read_bytes(), fn
    from pram_tpu_torch.maps.colmap_io import read_compressed_model

    _, _, p2 = read_compressed_model(str(tmp_path / "port"), ".bin")
    assert set(p2.keys()) == set(out["port"][2].keys())
    assert len(out["port"][2]) <= len(m.points3D) and len(out["port"][1]) >= 1
    loaded = np.load(tmp_path / "port" / "point3D_desc.npy", allow_pickle=True)[()]
    assert set(loaded.keys()) == set(out["port"][2].keys())


def test_grid_sparsification_matches_pram_tpu():
    uvs = np.array([[1.0, 1.0], [2.0, 2.0], [50.0, 50.0]])
    scores = np.array([1.0, 5.0, 2.0])
    keep = trm._sparsify_by_grid(100, 100, uvs, scores, radius=20.0)
    np.testing.assert_array_equal(keep, jrm._sparsify_by_grid(100, 100, uvs, scores, radius=20.0))
    assert set(keep.tolist()) == {1, 2}


# ---- KMeans, Birch, the descriptor choice, the reader


@pytest.mark.parametrize("k", [16, 64])
def test_kmeans_on_uniform_points_agrees_with_kmeans_jax(k, kmeans_jax):
    x = (np.random.RandomState(1).rand(20000, 3) * [10, 7, 5]).astype(np.float32)
    jl, jc, idx = kmeans_jax(x, k)
    labels, centers = tcl.kmeans(torch.from_numpy(x), k, init_idx=idx)
    assert (labels.numpy() == jl).mean() >= 0.999
    np.testing.assert_allclose(centers.numpy(), jc, rtol=0, atol=1e-4)


def test_kmeans_init_is_seeded_randperm():
    x = torch.from_numpy(np.random.RandomState(2).rand(500, 3).astype(np.float32))
    idx = torch.randperm(500, generator=torch.Generator().manual_seed(5))[:8]
    a, ca = tcl.kmeans(x, 8, generator=torch.Generator().manual_seed(5))
    b, cb = tcl.kmeans(x, 8, init_idx=idx.numpy())
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert torch.equal(tcl.kmeans(x, 8, num_iters=0)[1], x[torch.randperm(500, generator=torch.Generator().manual_seed(0))[:8]])


def test_cluster_points_unknown_method_raises():
    xyz = np.zeros((4, 3))
    for fn in (jcl.cluster_points, tcl.cluster_points):
        with pytest.raises(ValueError, match="unknown clustering method"):
            fn(xyz, 2, method="dbscan")


def _sklearn_birch(x, threshold, k):
    import warnings

    from sklearn.cluster import Birch as SkBirch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return SkBirch(threshold=threshold, n_clusters=k).fit(x.copy())


def assert_birch_equal(x, threshold, k):
    want = _sklearn_birch(x, threshold, k)
    got = Birch(threshold=threshold, n_clusters=k).fit(x.copy())
    np.testing.assert_array_equal(got.subcluster_centers_, want.subcluster_centers_)
    np.testing.assert_array_equal(got.subcluster_labels_, want.subcluster_labels_)
    np.testing.assert_array_equal(got.labels_, want.labels_)  # scikit-learn's numbering too
    return got


def test_birch_matches_sklearn_on_blobs():
    rng = np.random.RandomState(3)
    x = np.vstack([rng.randn(300, 3) * 0.3 + c for c in rng.randn(8, 3) * 5])
    got = assert_birch_equal(x, 0.1, 8)
    assert len(np.unique(got.labels_)) == 8
    # more subclusters than the branching factor: the tree splits
    assert len(got.subcluster_centers_) > 50
    # fewer subclusters than clusters: each subcluster its own label
    assert_birch_equal(x[:3], 0.1, 8)


@pytest.fixture(scope="module")
def triangulated_xyz(tmp_path_factory):
    """The points of the mapping scene triangulated by the port."""
    from pram_tpu_torch.maps.colmap_io import read_model
    from pram_tpu_torch.mapping.triangulate import triangulate_model

    scene = make_scene(np.random.RandomState(0))
    out = str(tmp_path_factory.mktemp("tri"))
    triangulate_model(scene["cameras"], scene["images"], keypoints_by_name(scene), scene["pairs"],
                      matches_by_pair(scene), out)
    _, _, points = read_model(out, ".bin")
    return np.array([points[p].xyz for p in sorted(points)])


@pytest.mark.parametrize("threshold", [0.01, 0.2])
def test_birch_matches_sklearn_on_a_triangulated_map(threshold, triangulated_xyz):
    assert len(triangulated_xyz) > 200
    assert_birch_equal(triangulated_xyz, threshold, 16)
    want = jcl.cluster_points(triangulated_xyz, 16, mode="xz", birch_threshold=threshold)
    np.testing.assert_array_equal(
        tcl.cluster_points(triangulated_xyz, 16, mode="xz", birch_threshold=threshold, device="cpu"), want)


def test_best_of_matches_pram_tpu():
    """Tracks of 1 to 12 views of bf16-valued descriptors, 64 a call (the
    last call short), padded to the map's longest track."""
    rng = np.random.RandomState(4)
    m, src, _ = build_recmap(rng, n_points=100, n_imgs=12, desc_dim=32)

    class Bf16Source:
        def get(self, name):
            f = dict(src.get(name))
            f["descriptors"] = bf16_values(f["descriptors"])
            return f

    lens = {len(p.image_ids) for p in m.points3D.values()}
    assert min(lens) <= 2 and max(lens) >= 8
    want = m.assign_point3D_descriptors(Bf16Source(), batch_points=64)
    got = port_recmap(m).assign_point3D_descriptors(Bf16Source(), batch_points=64)
    assert_same_tree(got, want)


def test_best_of_takes_the_least_median():
    batch = torch.tensor(np.random.RandomState(5).randn(6, 5, 8), dtype=torch.float32)
    batch = batch / batch.norm(dim=-1, keepdim=True)
    mask = torch.arange(5)[None] < torch.tensor([5, 4, 3, 2, 1, 0])[:, None]
    got = trm.best_of(batch, mask)
    for b in range(5):
        n = int(mask[b].sum())
        t = batch[b, :n].double()
        sorted_d = (2 - 2 * t @ t.T).sort(-1).values
        med = 0.5 * (sorted_d[:, (n - 1) // 2] + sorted_d[:, n // 2])
        assert int(got[b]) == int(med.argmin()), b
    assert int(got[5]) == 0  # no valid row: all at 1e9, the first wins


@pytest.mark.parametrize("fn", ["kmeans", "best_of"])
def test_products_run_with_tf32_off(monkeypatch, fn):
    """KMeans's distance products and best_of's einsum see TF32 off even where
    the caller turned it on, and the caller's setting comes back after."""
    seen = []

    def spy(real):
        def call(*a, **kw):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return real(*a, **kw)
        return call

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.rand(32, 8)
    if fn == "kmeans":
        monkeypatch.setattr(tcl, "_sq_distances", spy(tcl._sq_distances))
        tcl.kmeans(x[:, :3], 4, 3)
    else:
        monkeypatch.setattr(torch, "einsum", spy(torch.einsum))
        trm.best_of(x.reshape(4, 8, 8), torch.ones(4, 8, dtype=torch.bool))
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_feature_source_reads_npy_and_refuses_h5(tmp_path, monkeypatch):
    """npy directories as pram_tpu reads them; h5 stores, which the port
    refused (naming h5py) before it had its own HDF5 reader, now read as
    pram_tpu reads them, with h5py unimportable on the port's side."""
    feats = {"keypoints": np.ones((3, 2), np.float32), "scores": np.ones(3, np.float32),
             "descriptors": np.eye(3, dtype=np.float32), "image_size": np.array([4, 4])}
    np.save(tmp_path / "db+a.png", feats)
    got, want = trm.FeatureSource(str(tmp_path)), jrm.FeatureSource(str(tmp_path))
    assert got.names() == want.names() == ["db/a.png"]
    assert_same_tree(got.get("db/a.png"), want.get("db/a.png"))
    from pram_tpu_torch.io import h5

    with h5.File(str(tmp_path / "feats.h5"), "w") as f:
        g = f.create_group("db/a.png")
        g.create_dataset("keypoints", data=feats["keypoints"])
        g.create_dataset("scores", data=feats["scores"])
        g.create_dataset("descriptors", data=feats["descriptors"][:, :2].T.copy())
    want = jrm.FeatureSource(str(tmp_path / "feats.h5"))
    ref = (want.names(), want.get("db/a.png"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = trm.FeatureSource(str(tmp_path / "feats.h5"))
    assert got.names() == ref[0] == ["db/a.png"]
    assert_same_tree(got.get("db/a.png"), ref[1])
    assert got.get("db/a.png")["image_size"] is None
