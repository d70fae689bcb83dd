"""The port's COLMAP database and triangulation (pram_tpu_torch/maps/
database.py, pram_tpu_torch/mapping/triangulate.py) against pram_tpu's on
the CPU: every case of tests/test_triangulation.py as a parity case, each
package reading the other's database, and the port's array-level
``triangulate_model`` against the JAX ``run_triangulation`` fed hloc h5
files that the test writes with h5py: the same model files byte for byte
and the same database rows. The numpy copies are held exactly.
"""

import sqlite3
import sys

import numpy as np
import pytest

from pram_tpu.maps import database as jdb
from pram_tpu.mapping import triangulate as jtri
from pram_tpu_torch.maps import database as tdb
from pram_tpu_torch.mapping import triangulate as ttri
from tests.test_triangulation import _make_views
from tests.torch_mapping_scene import keypoints_by_name, make_scene, matches_by_pair, write_inputs

DB = {"jax": jdb, "port": tdb}


def _write_db(pkg, path, rng):
    kp = rng.rand(100, 2).astype(np.float32) * 640
    m = rng.randint(0, 100, (40, 2))
    with pkg.ColmapDatabase.connect(path) as db:
        cid = db.add_camera("PINHOLE", 640, 480, [500, 500, 320, 240])
        db.add_image("a.png", cid, image_id=1)
        db.add_image("b.png", cid, image_id=2)
        db.add_keypoints(1, kp)
        db.add_matches(1, 2, m)
        db.add_two_view_geometry(2, 1, m[:25])
    return kp, m


def _rows(path):
    con = sqlite3.connect(path)
    try:
        return {
            t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
            for t in ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")
        }
    finally:
        con.close()


def _assert_same_points(a, b):
    assert list(a) == list(b)
    for pid in a:
        pa, pb = a[pid], b[pid]
        assert pa.id == pb.id and pa.error == pb.error
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            va, vb = getattr(pa, f), getattr(pb, f)
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)


# ---- tests/test_triangulation.py, each as a parity case


def test_database_roundtrip_matches_pram_tpu(tmp_path, rng):
    kp, m = _write_db(tdb, str(tmp_path / "port.db"), np.random.RandomState(0))
    _write_db(jdb, str(tmp_path / "jax.db"), np.random.RandomState(0))
    assert _rows(str(tmp_path / "port.db")) == _rows(str(tmp_path / "jax.db"))
    with tdb.ColmapDatabase.connect(str(tmp_path / "port.db")) as db:
        np.testing.assert_allclose(db.get_keypoints(1), kp)
        np.testing.assert_array_equal(db.get_matches(1, 2), m)
        np.testing.assert_array_equal(db.get_matches(2, 1), m[:, ::-1])
        np.testing.assert_array_equal(db.get_two_view_matches(1, 2), m[:25, ::-1])
        assert db.get_matches(1, 7).shape == (0, 2) and db.get_two_view_matches(2, 7).shape == (0, 2)


def test_pair_id_roundtrip_matches_pram_tpu():
    for a, b in ((17, 3), (3, 17), (1, 2**20)):
        pid = tdb.image_ids_to_pair_id(a, b)
        assert pid == jdb.image_ids_to_pair_id(a, b)
        assert tdb.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid) == (min(a, b), max(a, b))


def test_triangulate_tracks_recovers_points_like_pram_tpu(rng):
    cam, images, kpts, xyz = _make_views(rng)
    n_pts = xyz.shape[0]
    verified = {(i, i + 1): np.stack([np.arange(n_pts), np.arange(n_pts)], -1) for i in range(1, 4)}
    points3D, img_obs = ttri.triangulate_tracks({1: cam}, images, kpts, verified, max_reproj_error=2.0)
    j_points, j_obs = jtri.triangulate_tracks({1: cam}, images, kpts, verified, max_reproj_error=2.0)
    _assert_same_points(points3D, j_points)
    assert {k: dict(v) for k, v in img_obs.items()} == {k: dict(v) for k, v in j_obs.items()}
    assert len(points3D) >= n_pts * 0.95
    errs = []
    for p in points3D.values():
        errs.append(np.linalg.norm(p.xyz - xyz[p.point2D_idxs[0]]))
        assert len(p.image_ids) >= 2
    assert np.median(errs) < 1e-3


def test_triangulate_rejects_bad_matches_like_pram_tpu(rng):
    cam, images, kpts, xyz = _make_views(rng)
    n_pts = xyz.shape[0]
    wrong = {(1, 2): np.stack([np.arange(n_pts), (np.arange(n_pts) + 7) % n_pts], -1)}
    points3D, _ = ttri.triangulate_tracks({1: cam}, images, kpts, wrong, max_reproj_error=2.0)
    j_points, _ = jtri.triangulate_tracks({1: cam}, images, kpts, wrong, max_reproj_error=2.0)
    _assert_same_points(points3D, j_points)
    assert len(points3D) < n_pts * 0.2


def test_geometric_verification_matches_pram_tpu(tmp_path, rng):
    import h5py

    cam, images, kpts, xyz = _make_views(rng, n_views=2)
    n_pts = xyz.shape[0]
    good = np.arange(n_pts)
    m0 = np.concatenate([good[: n_pts // 2], (good[n_pts // 2 :] + 11) % n_pts])
    feats = {im.name: kpts[iid] - 0.5 for iid, im in images.items()}
    with h5py.File(tmp_path / "feats.h5", "w") as f:
        for name, k in feats.items():
            f.create_group(name).create_dataset("keypoints", data=k)
    with h5py.File(tmp_path / "matches.h5", "w") as f:
        g = f.create_group("v0.png/v1.png")
        g.create_dataset("matches0", data=m0)
        g.create_dataset("matching_scores0", data=np.ones(n_pts))
    matches = {("v0.png", "v1.png"): (np.stack([good, m0], -1), np.ones(n_pts))}
    image_ids = {"v0.png": 1, "v1.png": 2}
    kept = {}
    for name, pkg, tri, fs, ms in (
        ("jax", jdb, jtri, str(tmp_path / "feats.h5"), str(tmp_path / "matches.h5")),
        ("port", tdb, ttri, feats, matches),
    ):
        db_path = str(tmp_path / f"{name}.db")
        with pkg.ColmapDatabase.connect(db_path) as db:
            db.add_camera("PINHOLE", 640, 480, cam.params, camera_id=1)
            db.add_image("v0.png", 1, image_id=1)
            db.add_image("v1.png", 1, image_id=2)
        tri.geometric_verification({1: cam}, images, image_ids, db_path, [("v0.png", "v1.png")], fs, ms,
                                   max_error=4.0)
        with pkg.ColmapDatabase.connect(db_path) as db:
            kept[name] = db.get_two_view_matches(1, 2)
    np.testing.assert_array_equal(kept["port"], kept["jax"])
    assert len(set(kept["port"][:, 0].tolist()) & set(range(n_pts // 2))) >= n_pts // 2 - 2
    assert len(kept["port"]) < n_pts * 0.8


# ---- the database across packages, the array-level pipeline


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_database(tmp_path, writer, reader):
    path = str(tmp_path / "x.db")
    kp, m = _write_db(DB[writer], path, np.random.RandomState(1))
    with DB[reader].ColmapDatabase.connect(path) as db:
        np.testing.assert_array_equal(db.get_keypoints(1), kp)
        np.testing.assert_array_equal(db.get_matches(2, 1), m[:, ::-1])
        np.testing.assert_array_equal(db.get_two_view_matches(1, 2), m[:25, ::-1])
        db.add_keypoints(2, kp[:7])
    with DB[writer].ColmapDatabase.connect(path) as db:
        np.testing.assert_array_equal(db.get_keypoints(2), kp[:7])


@pytest.fixture(scope="module")
def mapping_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mapping_inputs")
    scene = make_scene(np.random.RandomState(0))
    return scene, write_inputs(scene, str(root)), root


def test_triangulate_model_matches_run_triangulation(mapping_inputs):
    scene, paths, root = mapping_inputs
    from pram_tpu_torch.maps.colmap_io import read_model

    jax_dir, port_dir = str(root / "jax_model"), str(root / "port_model")
    want = jtri.run_triangulation(paths["ref"], paths["feats_h5"], paths["pairs"], paths["matches_h5"], jax_dir)
    cameras, images, _ = read_model(paths["ref"], ".bin")
    got = ttri.triangulate_model(cameras, images, keypoints_by_name(scene), scene["pairs"],
                                 matches_by_pair(scene), port_dir)
    assert got == want
    assert got["num_points"] > 200 and got["mean_track_length"] > 3
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (root / "port_model" / fn).read_bytes() == (root / "jax_model" / fn).read_bytes(), fn
    assert _rows(port_dir + "/database.db") == _rows(jax_dir + "/database.db")
    # triangulate_tracks on the JAX database's verified matches, the same points
    _, j_images, j_points = read_model(jax_dir, ".bin")
    verified = {}
    with tdb.ColmapDatabase.connect(jax_dir + "/database.db") as db:
        ids = {im.name: iid for iid, im in j_images.items()}
        for a, b in scene["pairs"]:
            ia, ib = ids[a], ids[b]
            m = db.get_two_view_matches(ia, ib)
            if len(m):
                verified[(ia, ib)] = m
    kpts = {iid: keypoints_by_name(scene)[im.name] + 0.5 for iid, im in images.items()}
    points, _ = ttri.triangulate_tracks(cameras, images, kpts, verified, max_reproj_error=4.0)
    _assert_same_points(points, j_points)


def test_run_triangulation_raises_naming_h5py(mapping_inputs, tmp_path, monkeypatch):
    """run_triangulation, which raised ImportError naming h5py before the
    port had its own HDF5 reader, now reads the hloc files with h5py
    unimportable and writes pram_tpu's model byte for byte."""
    _, paths, root = mapping_inputs
    jax_dir = str(tmp_path / "jax")
    want = jtri.run_triangulation(paths["ref"], paths["feats_h5"], paths["pairs"], paths["matches_h5"], jax_dir)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = ttri.run_triangulation(paths["ref"], paths["feats_h5"], paths["pairs"], paths["matches_h5"],
                                 str(tmp_path / "out"))
    assert got == want
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "out" / fn).read_bytes() == (tmp_path / "jax" / fn).read_bytes(), fn


def test_pairs_in_both_orders_are_verified_once(mapping_inputs, tmp_path):
    """A retrieval list holding each pair in both orders (the JAX package's
    verification stops there on the database's unique pair id) gives the
    model of the list in one order."""
    scene, paths, _ = mapping_inputs
    from pram_tpu_torch.maps.colmap_io import read_model

    cameras, images, _ = read_model(paths["ref"], ".bin")
    kpts, matches = keypoints_by_name(scene), matches_by_pair(scene)
    both = [p for a, b in scene["pairs"] for p in ((a, b), (b, a))]
    ttri.triangulate_model(cameras, images, kpts, scene["pairs"], matches, str(tmp_path / "once"))
    ttri.triangulate_model(cameras, images, kpts, both, matches, str(tmp_path / "both"))
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "both" / fn).read_bytes() == (tmp_path / "once" / fn).read_bytes(), fn
    assert _rows(str(tmp_path / "both" / "database.db")) == _rows(str(tmp_path / "once" / "database.db"))
