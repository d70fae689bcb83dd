"""COLMAP SQLite database writer/reader (copy of pram_tpu/maps/database.py).

Rebuild of colmap_utils/database.py:139-351 against the public COLMAP
database schema (cameras, images, keypoints, descriptors, matches,
two_view_geometries): used by the triangulation pipeline to hand features and
verified matches to COLMAP-compatible tooling.
"""

from __future__ import annotations

import sqlite3
from typing import Optional

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""

_CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
}


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int):
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def _blob(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


class ColmapDatabase:
    """Thin wrapper over the COLMAP sqlite schema."""

    def __init__(self, conn: sqlite3.Connection):
        self.conn = conn

    @classmethod
    def connect(cls, path: str) -> "ColmapDatabase":
        conn = sqlite3.connect(path)
        conn.executescript(_SCHEMA)
        return cls(conn)

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.conn.commit()
        self.conn.close()

    # -- inserts (colmap_utils/database.py:161-227 semantics)
    def add_camera(
        self,
        model,
        width: int,
        height: int,
        params,
        prior_focal_length: bool = False,
        camera_id: Optional[int] = None,
    ) -> int:
        if isinstance(model, str):
            model = _CAMERA_MODEL_IDS[model]
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                int(model),
                int(width),
                int(height),
                _blob(np.asarray(params, np.float64)),
                int(prior_focal_length),
            ),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        prior_q=(np.nan,) * 4,
        prior_t=(np.nan,) * 3,
        image_id: Optional[int] = None,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.shape[1] in (2, 4, 6)
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, *keypoints.shape, _blob(keypoints)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, *descriptors.shape, _blob(descriptors)),
        )

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        assert matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id, *matches.shape, _blob(matches)),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        F=np.eye(3),
        E=np.eye(3),
        H=np.eye(3),
        qvec=np.array([1.0, 0, 0, 0]),
        tvec=np.zeros(3),
        config: int = 2,
    ):
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pair_id,
                *matches.shape,
                _blob(matches),
                int(config),
                _blob(np.asarray(F, np.float64)),
                _blob(np.asarray(E, np.float64)),
                _blob(np.asarray(H, np.float64)),
                _blob(np.asarray(qvec, np.float64)),
                _blob(np.asarray(tvec, np.float64)),
            ),
        )

    # -- reads
    def get_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,),
        ).fetchone()
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c)

    def get_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pair_id,),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, c, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, c)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def get_two_view_matches(self, image_id1: int, image_id2: int):
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM two_view_geometries WHERE pair_id=?",
            (pair_id,),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, c, data = row
        if r == 0:
            return np.zeros((0, 2), np.uint32)
        m = np.frombuffer(data, np.uint32).reshape(r, c)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m
