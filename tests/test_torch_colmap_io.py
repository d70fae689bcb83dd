"""The port's COLMAP readers and writers (pram_tpu_torch/maps/colmap_io.py)
against pram_tpu's, on the CPU: a model written by one package and read by
the other, both ways, in binary, text and PRAM's compressed form; every
field equal (floats exactly: the text form writes Python reprs)."""

import numpy as np
import pytest

from pram_tpu.maps import colmap_io as jio
from pram_tpu_torch.maps import colmap_io as tio


def _model(pkg, rng, compressed=False):
    cameras = {
        1: pkg.ColmapCamera(1, "SIMPLE_PINHOLE", 640, 480, rng.rand(3) * 500),
        2: pkg.ColmapCamera(2, "OPENCV", 1024, 768, rng.randn(8)),
        5: pkg.ColmapCamera(5, "PINHOLE", 320, 240, rng.rand(4) * 300),
    }
    images = {}
    for i, iid in enumerate((1, 2, 7)):
        n = 5 + 3 * i
        q = rng.randn(4)
        images[iid] = pkg.ColmapImage(
            iid, q / np.linalg.norm(q), rng.randn(3), (1, 2, 5)[i], f"seq/frame-{iid:03d}.png",
            np.zeros((0, 2)) if compressed else rng.rand(n, 2) * 600,
            np.where(rng.rand(n) < 0.3, -1, rng.randint(0, 50, n)).astype(np.int64),
        )
    points = {}
    for pid in (3, 11, 40):
        tl = 1 + pid % 4
        points[pid] = pkg.ColmapPoint3D(
            pid, rng.randn(3), rng.randint(0, 256, 3).astype(np.uint8), float(rng.rand()),
            rng.randint(1, 8, tl).astype(np.int32),
            np.zeros((0,), np.int64) if compressed else rng.randint(0, 30, tl).astype(np.int64),
        )
    return cameras, images, points


def _assert_same(a, b):
    for da, db in zip(a, b):
        assert sorted(da) == sorted(db)
        for k in da:
            ra, rb = vars(da[k]), vars(db[k])
            assert sorted(ra) == sorted(rb)
            for f in ra:
                va, vb = ra[f], rb[f]
                if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                    va, vb = np.asarray(va), np.asarray(vb)
                    assert va.shape == vb.shape or va.size == vb.size == 0, (k, f)
                    np.testing.assert_array_equal(va.reshape(vb.shape) if va.size == vb.size else va, vb)
                else:
                    assert va == vb, (k, f)


FORMS = {
    "binary": (lambda pkg, m, d: pkg.write_model(*m, d, ".bin"), lambda pkg, d: pkg.read_model(d, ".bin")),
    "text": (lambda pkg, m, d: pkg.write_model(*m, d, ".txt"), lambda pkg, d: pkg.read_model(d, ".txt")),
    "compressed": (lambda pkg, m, d: pkg.write_compressed_model(*m, d),
                   lambda pkg, d: pkg.read_compressed_model(d, ".bin")),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_models_cross_read(tmp_path, form, direction):
    writer_pkg, reader_pkg = (jio, tio) if direction == "jax_to_port" else (tio, jio)
    write, read = FORMS[form]
    model = _model(writer_pkg, np.random.RandomState(0), compressed=form == "compressed")
    write(writer_pkg, model, str(tmp_path))
    got = read(reader_pkg, str(tmp_path))
    _assert_same(got, read(writer_pkg, str(tmp_path)))
    _assert_same(got, model)


def test_records_are_the_same_dataclasses():
    import dataclasses

    for name in ("ColmapCamera", "ColmapImage", "ColmapPoint3D"):
        assert [f.name for f in dataclasses.fields(getattr(tio, name))] == \
            [f.name for f in dataclasses.fields(getattr(jio, name))]
    assert tio.CAMERA_MODELS == jio.CAMERA_MODELS
