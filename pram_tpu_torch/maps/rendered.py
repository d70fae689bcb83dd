"""Rendered textured 3D world (numpy copy of pram_tpu/maps/rendered.py).

A procedurally textured three-plane "room corner" is rendered to images; the
map is built by running the SFD2 extractor on reference views (exact 2D->3D
lifting by ray-plane intersection at known poses), and queries are rendered
images with exact ground-truth poses. Localizing them runs the whole path:
extraction -> recognition -> matching -> PnP.

Geometry conventions match maps/synthetic.py: world-to-camera [R|t], y
points down (look_at up=(0,-1,0)), z forward. Nothing here caches to disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pram_tpu_torch.maps.colmap_io import ColmapCamera, ColmapImage, ColmapPoint3D
from pram_tpu_torch.maps.packed import PackedMap, build_scene_map
from pram_tpu_torch.maps.synthetic import _look_at, _rotmat2qvec_np


@dataclass
class Plane:
    """Textured rectangle: p0 + u*su*eu + v*sv*ev, (u, v) in [0, 1]^2."""

    p0: np.ndarray  # [3] corner
    eu: np.ndarray  # [3] unit axis (texture u)
    ev: np.ndarray  # [3] unit axis (texture v)
    su: float  # extent along eu (world units)
    sv: float  # extent along ev
    texture: np.ndarray  # [Th, Tw] float32 in [0, 1] (gray; replicated to RGB)
    dots: Optional[np.ndarray] = None  # [K, 2] dot centers in (u, v) coords

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.eu, self.ev)
        return n / np.linalg.norm(n)

    def dot_world(self) -> np.ndarray:
        """Dot centers as world points [K, 3]."""
        u = self.dots[:, 0] * self.su
        v = self.dots[:, 1] * self.sv
        return self.p0[None] + u[:, None] * self.eu[None] + v[:, None] * self.ev[None]


def _make_texture(rng: np.random.RandomState, size: int = 1024) -> np.ndarray:
    """Multi-scale blob texture that gives conv detectors stable extrema.

    Sums bilinear-upsampled uniform noise octaves (strong low/mid
    frequencies -> blobs and corners at detector-friendly scales) plus a
    sparse set of high-contrast dots.
    """

    def upsample(a: np.ndarray, s: int) -> np.ndarray:
        # bilinear resize [h, w] -> [s, s]
        h, w = a.shape
        y = np.linspace(0, h - 1, s)
        x = np.linspace(0, w - 1, s)
        y0 = np.clip(y.astype(int), 0, h - 2)
        x0 = np.clip(x.astype(int), 0, w - 2)
        fy = (y - y0)[:, None]
        fx = (x - x0)[None, :]
        a00 = a[y0][:, x0]
        a01 = a[y0][:, x0 + 1]
        a10 = a[y0 + 1][:, x0]
        a11 = a[y0 + 1][:, x0 + 1]
        return (
            a00 * (1 - fy) * (1 - fx)
            + a01 * (1 - fy) * fx
            + a10 * fy * (1 - fx)
            + a11 * fy * fx
        )

    tex = np.zeros((size, size), np.float64)
    for res, amp in ((8, 0.35), (24, 0.45), (64, 0.5), (192, 0.3)):
        tex += amp * upsample(rng.rand(res, res), size)
    # high-contrast dots of mixed sizes on a jittered grid: these are the
    # DETECTION ground truth the SFD2-lite detector head is fitted to
    # (scripts/train_rendered.py); the blob octaves above give the
    # descriptor head discriminative local context around each dot
    dots = []
    step = 24
    for gy in range(step, size - step, step):
        for gx in range(step, size - step, step):
            if rng.rand() < 0.35:
                continue
            cy = gy + rng.randint(-7, 8)
            cx = gx + rng.randint(-7, 8)
            r = rng.randint(1, 4)  # 3x3 .. 7x7 texels
            val = 0.0 if rng.rand() < 0.5 else 2.2
            tex[cy - r : cy + r + 1, cx - r : cx + r + 1] = val
            dots.append((cx, cy))
    tex -= tex.min()
    tex /= tex.max()
    dots_uv = np.asarray(dots, np.float64) / (size - 1)
    return (0.06 + 0.88 * tex).astype(np.float32), dots_uv


@dataclass
class TexturedWorld:
    planes: List[Plane]
    # segmentation grid per plane (classes tile the plane extents)
    seg_grid: Tuple[int, int] = (6, 6)

    def n_seg_classes(self) -> int:
        gu, gv = self.seg_grid
        return len(self.planes) * gu * gv

    def seg_class(self, plane_id: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Segment label from plane id + local texture coords (vectorized)."""
        gu, gv = self.seg_grid
        cu = np.clip((u * gu).astype(np.int32), 0, gu - 1)
        cv = np.clip((v * gv).astype(np.int32), 0, gv - 1)
        return plane_id * (gu * gv) + cv * gu + cu

    # -- rendering --------------------------------------------------------
    def render(
        self,
        R: np.ndarray,
        t: np.ndarray,
        cam: Tuple[float, float, float, float],
        width: int,
        height: int,
    ) -> np.ndarray:
        """Render an RGB image [H, W, 3] in [0, 1] from world-to-cam (R, t).

        Per-pixel ray cast against every plane, nearest positive in-extent
        hit wins (z-buffer); bilinear texture sample. Pure numpy.
        """
        fx, fy, cx, cy = cam
        C = -R.T @ t  # camera center in world
        u = (np.arange(width, dtype=np.float64) + 0.0 - cx) / fx
        v = (np.arange(height, dtype=np.float64) + 0.0 - cy) / fy
        # ray directions in world: R^T @ [u, v, 1]
        du, dv = np.meshgrid(u, v)  # [H, W]
        d = (
            du[..., None] * R[0][None, None]
            + dv[..., None] * R[1][None, None]
            + R[2][None, None]
        )  # [H, W, 3]

        best_t = np.full((height, width), np.inf)
        img = np.full((height, width), 0.5, np.float32)
        for pl in self.planes:
            n = pl.normal
            denom = d @ n  # [H, W]
            with np.errstate(divide="ignore", invalid="ignore"):
                th = ((pl.p0 - C) @ n) / denom
            X = C[None, None] + th[..., None] * d
            rel = X - pl.p0[None, None]
            lu = (rel @ pl.eu) / pl.su
            lv = (rel @ pl.ev) / pl.sv
            valid = (
                (th > 0.1)
                & np.isfinite(th)
                & (lu >= 0)
                & (lu < 1)
                & (lv >= 0)
                & (lv < 1)
                & (th < best_t)
            )
            if not valid.any():
                continue
            tex = pl.texture
            ty = lv[valid] * (tex.shape[0] - 1)
            tx = lu[valid] * (tex.shape[1] - 1)
            y0 = np.clip(ty.astype(int), 0, tex.shape[0] - 2)
            x0 = np.clip(tx.astype(int), 0, tex.shape[1] - 2)
            fy_ = ty - y0
            fx_ = tx - x0
            val = (
                tex[y0, x0] * (1 - fy_) * (1 - fx_)
                + tex[y0, x0 + 1] * (1 - fy_) * fx_
                + tex[y0 + 1, x0] * fy_ * (1 - fx_)
                + tex[y0 + 1, x0 + 1] * fy_ * fx_
            )
            img[valid] = val
            best_t[valid] = th[valid]
        return np.repeat(img[..., None], 3, axis=-1)

    # -- detector ground truth --------------------------------------------
    def project_dots(
        self,
        R: np.ndarray,
        t: np.ndarray,
        cam: Tuple[float, float, float, float],
        width: int,
        height: int,
        border: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Visible texture-dot centers in a view.

        Returns (uv [M, 2] pixel coords, xyz [M, 3] world points,
        ids [M] global dot indices — stable across views, for building
        exact cross-view correspondence). A dot is visible when it projects
        in-bounds AND the ray through its pixel hits the dot's own plane
        first (occlusion check via :meth:`lift`).
        """
        fx, fy, cx, cy = cam
        uvs, xyzs, idss = [], [], []
        id_base = 0
        for i, pl in enumerate(self.planes):
            X = pl.dot_world()
            xc = X @ R.T + t
            z = xc[:, 2]
            uv = np.stack(
                [xc[:, 0] / z * fx + cx, xc[:, 1] / z * fy + cy], -1
            )
            ok = (
                (z > 0.2)
                & (uv[:, 0] >= border)
                & (uv[:, 0] < width - border)
                & (uv[:, 1] >= border)
                & (uv[:, 1] < height - border)
            )
            if ok.any():
                lx, lpid, _, _, lok = self.lift(uv[ok], R, t, cam)
                front = lok & (lpid == i) & (
                    np.linalg.norm(lx - X[ok], axis=-1) < 1e-3
                )
                uvs.append(uv[ok][front])
                xyzs.append(X[ok][front])
                idss.append(np.nonzero(ok)[0][front] + id_base)
            id_base += X.shape[0]
        if not uvs:
            return np.zeros((0, 2)), np.zeros((0, 3)), np.zeros((0,), int)
        return np.concatenate(uvs), np.concatenate(xyzs), np.concatenate(idss)

    # -- exact 2D -> 3D lift ----------------------------------------------
    def lift(
        self,
        uv: np.ndarray,  # [N, 2] pixel coords
        R: np.ndarray,
        t: np.ndarray,
        cam: Tuple[float, float, float, float],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Ray-cast keypoints to the world surface.

        Returns (xyz [N, 3], plane_id [N], lu [N], lv [N], valid [N]).
        """
        fx, fy, cx, cy = cam
        C = -R.T @ t
        d = (
            ((uv[:, 0] - cx) / fx)[:, None] * R[0][None]
            + ((uv[:, 1] - cy) / fy)[:, None] * R[1][None]
            + R[2][None]
        )  # [N, 3]
        n_pts = uv.shape[0]
        best_t = np.full((n_pts,), np.inf)
        pid = np.full((n_pts,), -1, np.int32)
        out_u = np.zeros((n_pts,))
        out_v = np.zeros((n_pts,))
        xyz = np.zeros((n_pts, 3))
        for i, pl in enumerate(self.planes):
            n = pl.normal
            denom = d @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                th = ((pl.p0 - C) @ n) / denom
            X = C[None] + th[:, None] * d
            rel = X - pl.p0[None]
            lu = (rel @ pl.eu) / pl.su
            lv = (rel @ pl.ev) / pl.sv
            valid = (
                (th > 0.1)
                & np.isfinite(th)
                & (lu >= 0)
                & (lu < 1)
                & (lv >= 0)
                & (lv < 1)
                & (th < best_t)
            )
            best_t[valid] = th[valid]
            pid[valid] = i
            out_u[valid] = lu[valid]
            out_v[valid] = lv[valid]
            xyz[valid] = X[valid]
        return xyz, pid, out_u, out_v, pid >= 0


def make_world(rng: np.random.RandomState, seg_grid=(6, 6)) -> TexturedWorld:
    """Three-plane room corner: back wall, left wall, floor.

    Extents sized so cameras near the origin looking at +z see texture at
    depths ~3-7 world units across most of the frame.
    """
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])  # y down
    ez = np.array([0, 0, 1.0])
    t0, d0 = _make_texture(rng)
    t1, d1 = _make_texture(rng)
    t2, d2 = _make_texture(rng)
    planes = [
        # back wall at z=6.5, spans x in [-5, 5], y in [-3.5, 3.5]
        Plane(np.array([-5.0, -3.5, 6.5]), ex, ey, 10.0, 7.0, t0, d0),
        # left wall at x=-4, spans z in [1.5, 6.5], y in [-3.5, 3.5]
        Plane(np.array([-4.0, -3.5, 1.5]), ez, ey, 5.0, 7.0, t1, d1),
        # floor at y=+3 (down), spans x in [-5, 5], z in [1.5, 6.5]
        Plane(np.array([-5.0, 3.0, 1.5]), ex, ez, 10.0, 5.0, t2, d2),
    ]
    return TexturedWorld(planes, seg_grid)


def ref_poses(n: int, rng: Optional[np.random.RandomState] = None):
    """Reference ring: cameras near the origin looking into the corner."""
    poses = []
    for i in range(n):
        a = i / max(n - 1, 1)
        eye = np.array(
            [-1.6 + 3.0 * a, -0.7 + 1.2 * ((i * 7) % n) / n, -0.4 + 0.5 * a]
        )
        target = np.array([-0.8 + 1.6 * a, 0.2, 6.0])
        if rng is not None:
            eye = eye + rng.randn(3) * 0.05
            target = target + rng.randn(3) * 0.05
        R, t = _look_at(eye, target)
        poses.append((R, t))
    return poses


def query_pose(rng: np.random.RandomState):
    """Query poses interpolate the reference ring with moderate offsets —
    close enough for random-init SFD2 descriptors to stay view-consistent,
    far enough that matching is a real correspondence problem."""
    a = rng.rand()
    eye = np.array(
        [
            -1.6 + 3.0 * a + rng.randn() * 0.18,
            -0.7 + 1.2 * rng.rand() + rng.randn() * 0.12,
            -0.4 + 0.5 * a + rng.randn() * 0.18,
        ]
    )
    target = np.array(
        [-0.8 + 1.6 * a + rng.randn() * 0.25, 0.2 + rng.randn() * 0.2, 6.0]
    )
    R, t = _look_at(eye, target)
    return R, t


@dataclass
class RenderedScene:
    """World + camera + the map built from on-device SFD2 extraction."""

    world: TexturedWorld
    cam: Tuple[float, float, float, float]
    width: int
    height: int
    map: PackedMap
    ref_views: List[Dict]  # per ref view: R, t, kpts, xyz, seg, valid
    n_bg_class: int = 1  # class 0 = background

    def render_query(self, rng: np.random.RandomState) -> Dict:
        R, t = query_pose(rng)
        img = self.world.render(R, t, self.cam, self.width, self.height)
        return {
            "image": img.astype(np.float32),
            "qvec": _rotmat2qvec_np(R),
            "tvec": t.astype(np.float32),
            "R": R.astype(np.float32),
        }


def build_rendered_scene(
    extract_np,
    rng: np.random.RandomState,
    *,
    width: int = 640,
    height: int = 480,
    focal: float = 500.0,
    n_ref: int = 12,
    kp_per_ref: int = 1024,
    seg_grid=(6, 6),
    max_ref_points: Optional[int] = 2048,
) -> RenderedScene:
    """Build a PackedMap by running the extractor on rendered ref views.

    Args:
      extract_np: callable(images [B, H, W, 3] float32 in [0, 1]) ->
        (kpts [B, K, 2], scores [B, K], descs [B, K, D], mask [B, K]) as
        numpy: the SFD2 ``extract`` wrapped by the caller (so the caller
        controls device placement, dtype and keypoint budget).
      rng: scene randomness (textures + pose jitter). Use a fixed seed for
        a reproducible map.

    Every detected ref keypoint becomes its own 3D point with an exact
    ray-cast position (track length 1 — the engine never needs multi-view
    tracks; queries are other views, so cross-view descriptor consistency
    is still what matching must deliver). Segments are a spatial grid on
    the planes; each segment's VRF is the ref view observing it most.
    """
    world = make_world(rng, seg_grid)
    cam = (focal, focal, width / 2, height / 2)
    poses = ref_poses(n_ref, rng)
    images = np.stack(
        [world.render(R, t, cam, width, height) for R, t in poses]
    ).astype(np.float32)
    kpts, scores, descs, mask = extract_np(images)

    cameras = {
        1: ColmapCamera(
            1, "PINHOLE", width, height,
            np.array([focal, focal, width / 2, height / 2]),
        )
    }
    colmap_images: Dict[int, ColmapImage] = {}
    points3D: Dict[int, ColmapPoint3D] = {}
    p3d_desc: Dict[int, np.ndarray] = {}
    p3d_seg: Dict[int, int] = {}
    ref_views: List[Dict] = []
    n_seg = world.n_seg_classes()
    seg_count = np.zeros((n_ref, n_seg), np.int64)

    pid_next = 1000
    for i, (R, t) in enumerate(poses):
        valid = mask[i].astype(bool)
        uv = kpts[i][valid].astype(np.float64)
        xyz, plane_id, lu, lv, lift_ok = world.lift(uv, R, t, cam)
        seg = world.seg_class(plane_id, lu, lv)
        keep = lift_ok
        uv_k, xyz_k, seg_k = uv[keep], xyz[keep], seg[keep]
        ids = np.arange(pid_next, pid_next + uv_k.shape[0], dtype=np.int64)
        pid_next += uv_k.shape[0]
        colmap_images[i + 1] = ColmapImage(
            i + 1, _rotmat2qvec_np(R), t, 1, f"ref_{i:03d}.png", uv_k, ids
        )
        dsel = descs[i][valid][keep]
        for j, pid in enumerate(ids):
            points3D[int(pid)] = ColmapPoint3D(
                int(pid),
                xyz_k[j],
                np.array([128, 128, 128], np.uint8),
                0.5,
                np.asarray([i + 1], np.int32),
                np.asarray([j], np.int64),
            )
            p3d_desc[int(pid)] = dsel[j]
            p3d_seg[int(pid)] = int(seg_k[j])
        np.add.at(seg_count[i], seg_k, 1)
        ref_views.append(
            {
                "R": R, "t": t, "kpts": uv_k, "xyz": xyz_k, "seg": seg_k,
                "descs": dsel, "point_ids": ids,
            }
        )

    seg_vrf = {
        c: {0: {"image_id": int(np.argmax(seg_count[:, c])) + 1}}
        for c in range(n_seg)
    }
    pmap = build_scene_map(
        cameras,
        colmap_images,
        points3D,
        p3d_desc,
        p3d_seg,
        seg_vrf,
        start_sid=0,
        n_cluster=n_seg,
        covisibility_frame=4,
        scene_name="rendered",
        max_kp_per_frame=kp_per_ref,
        max_ref_points=max_ref_points,
    )
    return RenderedScene(
        world=world,
        cam=cam,
        width=width,
        height=height,
        map=pmap,
        ref_views=ref_views,
    )
