"""A small mapping scene shared by the port's mapping tests: 3D points with
distinctive descriptors seen by a ring of cameras with known poses, their
keypoints (0.3 px noise), mutual-NN matches over ring pairs, and the inputs
both packages read, written to disk: the reference model, an npy feature
directory, the pair list and, where h5py is installed, hloc h5 features and
matches.

Descriptors carry bf16 values (the precision SFD2 gives them in on the
card), so each descriptor's squared norm differs from 1 by ~1e-3. With
f32-normalized descriptors the two medians of a two-view track differ only
by the rounding of the two self-similarities, and which one is smaller is
decided by each package's summation order: tests/test_torch_mapping.py holds
that case by the medians instead.
"""

import os

import numpy as np
import torch

from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, write_model
from pram_tpu_torch.maps.parsers import names_to_pair
from pram_tpu_torch.maps.synthetic import _look_at, _rotmat2qvec_np

FOCAL, W, H = 500.0, 640, 480


def bf16_values(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 and back to f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def render(xyz, R, t):
    xc = xyz @ R.T + t
    z = xc[:, 2]
    uv = np.stack([xc[:, 0] / z * FOCAL + W / 2, xc[:, 1] / z * FOCAL + H / 2], -1)
    vis = (z > 0.3) & (uv[:, 0] >= 4) & (uv[:, 0] < W - 4) & (uv[:, 1] >= 4) & (uv[:, 1] < H - 4)
    return uv, vis


def make_scene(rng, n_pts: int = 400, desc_dim: int = 32, n_views: int = 8, dropout: float = 0.15) -> dict:
    """Points in front of a ring of ``n_views`` cameras; each view keeps a
    visible point with probability ``1 - dropout`` (tracks of varied length)."""
    xyz = np.stack(
        [(rng.rand(n_pts) - 0.5) * 4, (rng.rand(n_pts) - 0.5) * 2, rng.rand(n_pts) * 2 + 6], -1
    )
    desc = rng.randn(n_pts, desc_dim).astype(np.float32)
    desc = bf16_values(desc / np.linalg.norm(desc, axis=1, keepdims=True))
    center = xyz.mean(0)
    cameras = {1: ColmapCamera(1, "SIMPLE_PINHOLE", W, H, np.array([FOCAL, W / 2, H / 2]))}
    images, views = {}, []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = center + np.array([np.sin(ang) * 1.5, 0.3 * np.sin(2 * ang), -8.0 - np.cos(ang)])
        R, t = _look_at(eye, center)
        uv, vis = render(xyz, R, t)
        sel = np.nonzero(vis & (rng.rand(n_pts) > dropout))[0]
        name = f"db/v{i}.png"
        kpts = (uv[sel] + rng.randn(len(sel), 2) * 0.3).astype(np.float32)
        views.append({"R": R, "t": t, "sel": sel, "name": name, "kpts": kpts})
        images[i + 1] = ColmapImage(
            i + 1, _rotmat2qvec_np(R), t, 1, name, np.zeros((0, 2)), np.zeros(0, np.int64)
        )
    pairs = [(views[i]["name"], views[(i + j) % n_views]["name"]) for i in range(n_views) for j in (1, 2)]
    by_name = {v["name"]: v for v in views}
    matches = {}
    for a, b in pairs:
        s = desc[by_name[a]["sel"]] @ desc[by_name[b]["sel"]].T
        n0, n1 = s.argmax(1), s.argmax(0)
        m0 = np.where(n1[n0] == np.arange(len(n0)), n0, -1)
        idx = np.nonzero(m0 >= 0)[0]
        matches[(a, b)] = (np.stack([idx, m0[idx]], -1), s[idx, m0[idx]].astype(np.float32), m0)
    return {
        "xyz": xyz, "desc": desc, "center": center, "cameras": cameras, "images": images,
        "views": views, "pairs": pairs, "matches": matches,
    }


def keypoints_by_name(scene) -> dict:
    return {v["name"]: v["kpts"] for v in scene["views"]}


def matches_by_pair(scene) -> dict:
    """``(name0, name1) -> (index pairs, scores)``, as ``get_matches`` gives them."""
    return {p: (m, s) for p, (m, s, _) in scene["matches"].items()}


def write_inputs(scene, root: str) -> dict:
    """The scene's inputs on disk under ``root``; returns their paths."""
    paths = {
        "ref": os.path.join(root, "ref_model"), "npy": os.path.join(root, "feats_npy"),
        "pairs": os.path.join(root, "pairs.txt"), "feats_h5": os.path.join(root, "feats.h5"),
        "matches_h5": os.path.join(root, "matches.h5"),
    }
    write_model(scene["cameras"], scene["images"], {}, paths["ref"], ".bin")
    os.makedirs(paths["npy"], exist_ok=True)
    for v in scene["views"]:
        n = len(v["sel"])
        np.save(
            os.path.join(paths["npy"], v["name"].replace("/", "+")),
            {"keypoints": v["kpts"], "scores": np.linspace(1.0, 0.5, n).astype(np.float32),
             "descriptors": scene["desc"][v["sel"]], "image_size": np.array([W, H])},
        )
    with open(paths["pairs"], "w") as f:
        f.write("".join(f"{a} {b}\n" for a, b in scene["pairs"]))
    try:
        import h5py
    except ImportError:
        return paths
    with h5py.File(paths["feats_h5"], "w") as f:
        for v in scene["views"]:
            g = f.create_group(v["name"])
            g.create_dataset("keypoints", data=v["kpts"])
            g.create_dataset("scores", data=np.ones(len(v["sel"]), np.float32))
            g.create_dataset("descriptors", data=scene["desc"][v["sel"]].T)
            g.create_dataset("image_size", data=np.array([W, H]))
    with h5py.File(paths["matches_h5"], "w") as f:
        for (a, b), (_, s, m0) in scene["matches"].items():
            g = f.create_group(names_to_pair(a, b))
            g.create_dataset("matches0", data=m0)
            scores = np.zeros(len(m0), np.float32)
            scores[m0 >= 0] = s
            g.create_dataset("matching_scores0", data=scores)
    return paths
