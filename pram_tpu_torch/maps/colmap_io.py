"""COLMAP model I/O (numpy copy of pram_tpu/maps/colmap_io.py): binary and
text cameras, images and 3D points, and PRAM's compressed forms.

Interchange-compatible with COLMAP and with the reference's artifacts
(colmap_utils/read_write_model.py): the same binary layouts, including the
compressed variants in which images store only point3D id lists (no 2D
keypoints) and points store only image id tracks (no point2D indices),
read_compressed_* at read_write_model.py:433-553. Records are parsed with
struct.unpack_from over one buffer read from the file.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model table (model_id -> (name, num_params))
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2] (empty for compressed models)
    point3D_ids: np.ndarray  # [N] int64, -1 = no 3D point


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray  # empty for compressed models


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras = {}
    for _ in range(n):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        name, num_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(buf, "<f8", num_params, off).copy()
        off += 8 * num_params
        cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def _read_images_binary_impl(path: str, compressed: bool) -> Dict[int, ColmapImage]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images = {}
    for _ in range(n):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        image_id = vals[0]
        qvec = np.asarray(vals[1:5])
        tvec = np.asarray(vals[5:8])
        camera_id = vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (npts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if compressed:
            p3d = np.frombuffer(buf, "<i8", npts, off).copy()
            off += 8 * npts
            xys = np.zeros((0, 2))
        else:
            rec = np.frombuffer(buf, np.uint8, 24 * npts, off).view(
                [("x", "<f8"), ("y", "<f8"), ("id", "<i8")]
            )
            off += 24 * npts
            xys = np.column_stack([rec["x"], rec["y"]])
            p3d = rec["id"].copy()
        images[image_id] = ColmapImage(
            image_id, qvec, tvec, camera_id, name, xys, p3d
        )
    return images


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    return _read_images_binary_impl(path, compressed=False)


def read_compressed_images_binary(path: str) -> Dict[int, ColmapImage]:
    return _read_images_binary_impl(path, compressed=True)


def _read_points3d_binary_impl(path, compressed) -> Dict[int, ColmapPoint3D]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    points = {}
    for _ in range(n):
        vals = struct.unpack_from("<QdddBBBd", buf, off)
        off += 43
        pid = vals[0]
        xyz = np.asarray(vals[1:4])
        rgb = np.asarray(vals[4:7], np.uint8)
        error = vals[7]
        (tl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if compressed:
            image_ids = np.frombuffer(buf, "<i4", tl, off).copy()
            off += 4 * tl
            p2d = np.zeros((0,), np.int64)
        else:
            rec = np.frombuffer(buf, "<i4", 2 * tl, off)
            off += 8 * tl
            image_ids = rec[0::2].copy()
            p2d = rec[1::2].astype(np.int64)
        points[pid] = ColmapPoint3D(pid, xyz, rgb, error, image_ids, p2d)
    return points


def read_points3d_binary(path: str) -> Dict[int, ColmapPoint3D]:
    return _read_points3d_binary_impl(path, compressed=False)


def read_compressed_points3d_binary(path: str) -> Dict[int, ColmapPoint3D]:
    return _read_points3d_binary_impl(path, compressed=True)


# ---------------------------------------------------------------------------
# binary writers
# ---------------------------------------------------------------------------


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path: str) -> None:
    parts = [struct.pack("<Q", len(cameras))]
    for cam in cameras.values():
        parts.append(
            struct.pack(
                "<iiQQ",
                cam.id,
                CAMERA_MODEL_IDS[cam.model],
                cam.width,
                cam.height,
            )
        )
        parts.append(np.asarray(cam.params, "<f8").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def _write_images_binary_impl(images, path, compressed) -> None:
    parts = [struct.pack("<Q", len(images))]
    for img in images.values():
        parts.append(
            struct.pack(
                "<idddddddi",
                img.id,
                *np.asarray(img.qvec, float),
                *np.asarray(img.tvec, float),
                img.camera_id,
            )
        )
        parts.append(img.name.encode("utf-8") + b"\x00")
        npts = len(img.point3D_ids)
        parts.append(struct.pack("<Q", npts))
        if compressed:
            parts.append(np.asarray(img.point3D_ids, "<i8").tobytes())
        else:
            rec = np.zeros(
                npts, dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")]
            )
            if npts:
                rec["x"] = img.xys[:, 0]
                rec["y"] = img.xys[:, 1]
                rec["id"] = img.point3D_ids
            parts.append(rec.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_images_binary(images, path: str) -> None:
    _write_images_binary_impl(images, path, compressed=False)


def write_compressed_images_binary(images, path: str) -> None:
    _write_images_binary_impl(images, path, compressed=True)


def _write_points3d_binary_impl(points3D, path, compressed) -> None:
    parts = [struct.pack("<Q", len(points3D))]
    for pt in points3D.values():
        parts.append(
            struct.pack(
                "<QdddBBBd",
                pt.id,
                *np.asarray(pt.xyz, float),
                *np.asarray(pt.rgb, int),
                float(pt.error),
            )
        )
        tl = len(pt.image_ids)
        parts.append(struct.pack("<Q", tl))
        if compressed:
            parts.append(np.asarray(pt.image_ids, "<i4").tobytes())
        else:
            rec = np.zeros(2 * tl, "<i4")
            rec[0::2] = pt.image_ids
            rec[1::2] = pt.point2D_idxs
            parts.append(rec.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_points3d_binary(points3D, path: str) -> None:
    _write_points3d_binary_impl(points3D, path, compressed=False)


def write_compressed_points3d_binary(points3D, path: str) -> None:
    _write_points3d_binary_impl(points3D, path, compressed=True)


# ---------------------------------------------------------------------------
# text formats
# ---------------------------------------------------------------------------


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cameras[int(e[0])] = ColmapCamera(
                int(e[0]),
                e[1],
                int(e[2]),
                int(e[3]),
                np.array([float(x) for x in e[4:]]),
            )
    return cameras


def write_cameras_text(cameras, path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params.tolist()))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        image_id = int(e[0])
        qvec = np.array([float(x) for x in e[1:5]])
        tvec = np.array([float(x) for x in e[5:8]])
        camera_id = int(e[8])
        name = e[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array([float(x) for x in pts]).reshape(-1, 3)
        images[image_id] = ColmapImage(
            image_id,
            qvec,
            tvec,
            camera_id,
            name,
            arr[:, :2],
            arr[:, 2].astype(np.int64),
        )
    return images


def write_images_text(images, path: str) -> None:
    with open(path, "w") as f:
        f.write(
            "# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
        )
        for img in images.values():
            head = [img.id, *img.qvec.tolist(), *img.tvec.tolist(),
                    img.camera_id, img.name]
            f.write(" ".join(map(str, head)) + "\n")
            obs = []
            for xy, pid in zip(img.xys, img.point3D_ids):
                obs.extend([str(xy[0]), str(xy[1]), str(int(pid))])
            f.write(" ".join(obs) + "\n")


def read_points3D_text(path: str) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            pid = int(e[0])
            points[pid] = ColmapPoint3D(
                pid,
                np.array([float(x) for x in e[1:4]]),
                np.array([int(x) for x in e[4:7]], np.uint8),
                float(e[7]),
                np.array([int(x) for x in e[8::2]]),
                np.array([int(x) for x in e[9::2]]),
            )
    return points


def write_points3D_text(points3D, path: str) -> None:
    with open(path, "w") as f:
        f.write(
            "# 3D point list: POINT3D_ID, X Y Z, R G B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for pt in points3D.values():
            head = [pt.id, *pt.xyz.tolist(), *pt.rgb.tolist(), pt.error]
            track = []
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                track.extend([str(int(iid)), str(int(p2d))])
            f.write(" ".join(map(str, head)) + " " + " ".join(track) + "\n")


# ---------------------------------------------------------------------------
# model-level API (reference read_write_model.py:409-430,544-553)
# ---------------------------------------------------------------------------

Model = Tuple[
    Dict[int, ColmapCamera], Dict[int, ColmapImage], Dict[int, ColmapPoint3D]
]


def read_model(path: str, ext: str = ".bin") -> Model:
    if ext == ".txt":
        return (
            read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3D_text(os.path.join(path, "points3D.txt")),
        )
    return (
        read_cameras_binary(os.path.join(path, "cameras.bin")),
        read_images_binary(os.path.join(path, "images.bin")),
        read_points3d_binary(os.path.join(path, "points3D.bin")),
    )


def write_model(cameras, images, points3D, path: str, ext: str = ".bin") -> None:
    os.makedirs(path, exist_ok=True)
    if ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3D_text(points3D, os.path.join(path, "points3D.txt"))
    else:
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(points3D, os.path.join(path, "points3D.bin"))


def read_compressed_model(path: str, ext: str = ".bin") -> Model:
    if ext == ".txt":
        return read_model(path, ext)
    return (
        read_cameras_binary(os.path.join(path, "cameras.bin")),
        read_compressed_images_binary(os.path.join(path, "images.bin")),
        read_compressed_points3d_binary(os.path.join(path, "points3D.bin")),
    )


def write_compressed_model(cameras, images, points3D, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
    write_compressed_images_binary(images, os.path.join(path, "images.bin"))
    write_compressed_points3d_binary(points3D, os.path.join(path, "points3D.bin"))
