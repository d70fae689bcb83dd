"""The port's HDF5 reader and writer (pram_tpu_torch/io/h5.py) against
h5py, both ways, on files written with ``libver="earliest"`` (h5py's
default: superblock v0, symbol-table groups) and ``"latest"`` (hloc's:
superblock v3, compact and dense link storage): groups of 1, 8, 9 and 5000
members, nested names, every integer and IEEE float type, empty and scalar
datasets, an attribute on a dataset, appending in mode ``"a"``, and the
layouts the port refuses. Every comparison is bit for bit.
"""

import h5py
import numpy as np
import pytest

from pram_tpu_torch.io import h5

DTYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8"]
LIBVERS = ["earliest", "latest"]


def _fill(f, n_members: int, rng):
    """The same tree through h5py's API or the port's."""
    g = f.create_group("grp")
    for i in range(n_members):
        g.create_dataset(f"m{i:05d}", data=np.array([i, -i], np.int32))
    for dt in DTYPES:
        f.create_dataset(f"dtypes/{dt}", data=(rng.randn(3, 4) * 60).astype(dt))
    f.create_dataset("empty", data=np.zeros((0,), np.float32))
    f.create_dataset("empty_2d", data=np.zeros((0, 2), np.int16))
    f.create_dataset("scalar", data=np.float64(2.5))
    f.create_dataset("scalar_int", data=np.int64(-7))
    kp = f.create_dataset("db/a.png/keypoints", data=rng.randn(5, 2).astype(np.float16))
    kp.attrs["uncertainty"] = np.float32(0.25)
    f.create_dataset("db/a.png/descriptors", data=rng.randn(8, 5).astype(np.float16))
    f.create_dataset("q-0.png/db-1.png/matches0", data=np.array([3, -1, 0], np.int16))
    f.create_dataset("q-0.png/db-1.png/matching_scores0", data=np.array([0.5, 0, 1], np.float16))


def _dump(f) -> dict:
    """Every object by path: a dataset's dtype, shape, bytes, attributes,
    name and parent name; a group's name and member names."""
    out = {}
    is_dataset = (h5py.Dataset, h5.Dataset)

    def visit(name, obj):
        if isinstance(obj, is_dataset):
            a = np.asarray(obj[()])
            attrs = {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes()) for k, v in obj.attrs.items()}
            out[name] = (a.dtype.str, a.shape, a.tobytes(), attrs, obj.name, obj.parent.name)
        else:
            out[name] = ("group", obj.name, list(obj.keys()))

    f.visititems(visit)
    return out


@pytest.fixture(scope="module", params=[(lib, n) for lib in LIBVERS for n in (1, 8, 9, 5000)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def h5py_file(request, tmp_path_factory):
    lib, n = request.param
    path = str(tmp_path_factory.mktemp("h5") / f"{lib}_{n}.h5")
    with h5py.File(path, "w", libver=lib) as f:
        _fill(f, n, np.random.RandomState(n))
    with h5py.File(path, "r") as f:
        ref = _dump(f)
    return path, ref, n


def test_reads_h5py_files_bit_equal(h5py_file):
    path, ref, n = h5py_file
    with h5.File(path, "r") as f:
        got = _dump(f)
        assert len(f["grp"]) == n and "grp/m00000" in f and "grp/nothing" not in f
        assert f["db"]["a.png"]["keypoints"].shape == (5, 2)
        assert f["/q-0.png/db-1.png/matches0"].dtype == np.int16
        assert list(f.keys()) == ["db", "dtypes", "empty", "empty_2d", "grp", "q-0.png", "scalar", "scalar_int"]
    assert list(got) == list(ref)
    assert got == ref


@pytest.mark.parametrize("n", [1, 8, 9, 5000])
def test_h5py_reads_port_files_bit_equal(tmp_path, n):
    with h5py.File(tmp_path / "ref.h5", "w") as f:
        _fill(f, n, np.random.RandomState(n))
    with h5.File(str(tmp_path / "port.h5"), "w") as f:
        _fill(f, n, np.random.RandomState(n))
        assert f["db/a.png/keypoints"].attrs["uncertainty"] == np.float32(0.25)
    with h5py.File(tmp_path / "ref.h5", "r") as f:
        ref = _dump(f)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        got = _dump(f)
    assert got == ref
    with h5.File(str(tmp_path / "port.h5"), "r") as f:
        assert _dump(f) == ref


@pytest.mark.parametrize("lib", LIBVERS)
def test_append_keeps_the_file_and_adds(h5py_file, tmp_path, lib):
    """Mode "a" on an h5py file of either layout: the pairs already there
    stay bit-equal, the new ones read back in both packages, and h5py can
    go on appending to the rewritten file."""
    src, ref, n = h5py_file
    path = str(tmp_path / "a.h5")
    with h5py.File(src, "r") as fin, h5py.File(path, "w", libver=lib) as fout:
        for k in fin:
            fin.copy(fin[k], fout, k)
    with h5.File(path, "a") as f:
        assert "q-0.png/db-1.png" in f
        g = f.create_group("q-0.png/db-2.png")
        g.create_dataset("matches0", data=np.arange(4, dtype=np.int32))
        f.create_dataset("new/deep/x", data=np.float32([1.5]))
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("q-0.png/db-1.png")
    with h5py.File(path, "r") as f:
        got = _dump(f)
        np.testing.assert_array_equal(f["q-0.png/db-2.png/matches0"][()], np.arange(4, dtype=np.int32))
        assert list(f["q-0.png"].keys()) == ["db-1.png", "db-2.png"]
    for k in ("q-0.png/db-2.png", "q-0.png/db-2.png/matches0", "new", "new/deep", "new/deep/x"):
        del got[k]
    got["q-0.png"] = ref["q-0.png"]
    assert got == ref
    with h5py.File(path, "a") as f:
        f.create_dataset("q-0.png/db-3.png/matches0", data=np.arange(2, dtype=np.int32))
    with h5.File(path, "r") as f:
        assert list(f["q-0.png"].keys()) == ["db-1.png", "db-2.png", "db-3.png"]
        np.testing.assert_array_equal(f["new/deep/x"][()], np.float32([1.5]))


def test_port_roundtrip_and_api(tmp_path):
    path = str(tmp_path / "x.h5")
    rng = np.random.RandomState(3)
    with h5.File(path, "w") as f:
        _fill(f, 20, rng)
        ds = f["db/a.png/descriptors"]
        assert ds.name == "/db/a.png/descriptors" and ds.parent.name == "/db/a.png"
        assert isinstance(f["db"], h5.Group) and isinstance(ds, h5.Dataset)
    with h5.File(path, "a") as f:
        f.create_dataset("extra", data=np.arange(3, dtype=np.uint8))
    with h5.File(path, "r") as f:
        assert f["scalar"][()] == 2.5 and f["scalar"].shape == ()
        assert f["empty_2d"][()].shape == (0, 2)
        np.testing.assert_array_equal(f["extra"][()], np.arange(3, dtype=np.uint8))
        seen = []
        assert f.visititems(lambda name, obj: name if name == "db/a.png" else seen.append(name)) == "db/a.png"
        assert seen == ["db"]
        with pytest.raises(ValueError, match="read-only"):
            f.create_group("z")
        with pytest.raises(KeyError):
            f["db/b.png"]
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["extra"][()], np.arange(3, dtype=np.uint8))
        assert len(f["grp"]) == 20


UNSUPPORTED = {
    "gzip": (lambda f: f.create_dataset("x", data=np.zeros((50, 3)), compression="gzip"), "filter"),
    "chunked": (lambda f: f.create_dataset("x", data=np.zeros((50, 3)), chunks=(10, 3)), "chunked"),
    "vlen_string": (lambda f: f.create_dataset("x", data="hello"), "variable-length"),
    "fixed_string": (lambda f: f.create_dataset("x", data=np.array(b"abc")), "string"),
    "big_endian": (lambda f: f.create_dataset("x", data=np.arange(3, dtype=">f4")), "big-endian"),
    "soft_link": (lambda f: f.__setitem__("x", h5py.SoftLink("/y")), "soft link"),
    "external_link": (lambda f: f.__setitem__("x", h5py.ExternalLink("other.h5", "/y")), "external link"),
}


@pytest.mark.parametrize("lib", LIBVERS)
@pytest.mark.parametrize("kind", list(UNSUPPORTED))
def test_unsupported_layouts_raise_naming_them(tmp_path, kind, lib):
    make, what = UNSUPPORTED[kind]
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w", libver=lib) as f:
        f.create_dataset("y", data=np.arange(2))
        make(f)
    with h5.File(path, "r") as f:
        with pytest.raises(NotImplementedError, match=what) as e:
            f["x"][()]
    assert path in str(e.value)


def test_writer_refuses_types_it_cannot_store(tmp_path):
    with h5.File(str(tmp_path / "x.h5"), "w") as f:
        with pytest.raises(TypeError, match="bool"):
            f.create_dataset("b", data=np.ones(3, bool))


def test_lookup_searches_the_group_btree_without_listing(h5py_file, tmp_path, monkeypatch):
    """A name is found by a search down its group's B-tree (by name in a
    symbol table, by the name's lookup3 hash in dense storage), in h5py's
    files and the port's: every member of ``grp`` and absent names (before
    the first, between two, past the last) resolve with the listing of a
    group's members made to raise."""
    src, _, n = h5py_file
    port = str(tmp_path / "port.h5")
    with h5.File(port, "w") as f:
        _fill(f, n, np.random.RandomState(n))

    def no_listing(*args):
        raise AssertionError("a group was listed for a lookup")

    monkeypatch.setattr(h5._Reader, "links", no_listing)
    for path in (src, port):
        with h5.File(path, "r") as f:
            for i in range(n):
                np.testing.assert_array_equal(f[f"grp/m{i:05d}"][()], [i, -i])
            for name in ("grp/a", "grp/m00000x", f"grp/m{n:05d}", "grp/z", "nothing", "db/a.png/x", "db/b.png"):
                assert name not in f
            assert f["q-0.png/db-1.png/matches0"].dtype == np.int16
            assert f["db/a.png/keypoints"].attrs["uncertainty"] == np.float32(0.25)


def test_lookup3_is_the_dense_name_index_hash(tmp_path):
    """Bob Jenkins' published values, and the hash every record of a dense
    group's name index holds for its name (names of 1 to 40 bytes, so that
    every tail length of the last block occurs)."""
    assert h5.lookup3(b"") == 0xDEADBEEF
    assert h5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert h5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    names = ["".join("abcdefghij"[(i * 7 + j) % 10] for j in range(i)) for i in range(1, 41)] + ["db/ü.png"[3:]]
    path = str(tmp_path / "dense.h5")
    with h5py.File(path, "w", libver="latest") as f:
        for name in names:
            f.create_group(name)
    r = h5._Reader(path)
    try:
        (start,) = [m[2] for m in r.messages(r.root) if m[0] == h5.LINK_INFO]
        heap, btree = r._link_info(start)
        id_len, obj = r._heap_objects(heap)
        seen = []
        for rec in r._btree2_records(btree):
            name, _ = r._link(obj(bytes(rec[4:4 + id_len])))
            assert int.from_bytes(rec[:4], "little") == h5.lookup3(name.encode("utf-8")), name
            seen.append(name)
        assert sorted(seen) == sorted(names)
    finally:
        r.close()


@pytest.mark.parametrize("mode", ["w", "a"])
def test_writer_holds_no_dataset_in_memory(tmp_path, mode):
    """``create_dataset`` writes a dataset's bytes at once and ``close``
    copies no file: writing 32 MiB of datasets (in mode "a", after 32 MiB
    already in the file, which close copies over one dataset at a time)
    peaks at a few MiB of Python memory, and h5py reads every array back."""
    import tracemalloc

    path = str(tmp_path / "big.h5")
    n, size = 32, 1 << 18  # 1 MiB of f32 a dataset

    def arrays(start):
        rng = np.random.RandomState(start)
        for i in range(start, start + n):
            yield f"img{i:03d}.png/descriptors", rng.standard_normal(size).astype(np.float32)

    if mode == "a":
        with h5.File(path, "w") as f:
            for name, a in arrays(0):
                f.create_dataset(name, data=a)
    tracemalloc.start()
    try:
        probe = np.ones(4 << 20, np.uint8)  # numpy's buffers are traced
        assert tracemalloc.get_traced_memory()[0] >= 4 << 20
        del probe
        tracemalloc.reset_peak()
        with h5.File(path, mode) as f:
            for name, a in arrays(n):
                f.create_dataset(name, data=a)
                del a
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 8 << 20, peak
    with h5py.File(path, "r") as f:
        for name, a in (*(arrays(0) if mode == "a" else ()), *arrays(n)):
            np.testing.assert_array_equal(f[name][()], a)
        assert len(f) == (2 * n if mode == "a" else n)
