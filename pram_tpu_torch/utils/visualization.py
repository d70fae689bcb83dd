"""Visualization: seg-coloured keypoints, inliers, matches, 3D landmarks
(pram_tpu/utils/visualization.py).

The JAX package draws with cv2; the card's machine has none, so the port
rasterizes cv2's marks itself, in numpy and Python integers, following
OpenCV's drawing code for ``LINE_8``: a filled circle by its integer
midpoint loop, a thick circle as the 12-, 20- or 72-gon of
``ellipse2Poly`` drawn by thick lines, and a thick line as the filled
quadrilateral of ``ThickLine`` (``FillConvexPoly`` with its edges drawn by
the fixed-point ``Line2``) with round caps; a line of thickness 1 is
LineIterator's 8-connected walk. Marks inside the image come out pixel for
pixel as cv2 draws them; a thick line that leaves the image can differ
along its clipped edge. Colours are written as given (cv2's BGR tuples,
channel for channel).

:func:`plot_landmarks_3d` imports matplotlib lazily, as the JAX function
does; where matplotlib is missing (the card's machine) it raises there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def generate_color_dic(n_seg: int = 1000, seed: int = 1) -> Dict[int, tuple]:
    """Deterministic seg-id -> BGR colour table (vis_seg.py:13-35's
    hash-based palette, as a seeded RNG draws it in the JAX package)."""
    rng = np.random.RandomState(seed)
    colors = rng.randint(64, 255, size=(n_seg, 3))
    return {i: tuple(int(c) for c in colors[i]) for i in range(n_seg)}


# ---- OpenCV's LINE_8 rasterizers (imgproc/src/drawing.cpp); each adds the
# pixels it paints to ``out`` as (y, x), clipping to the image size


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(out, size, x: int, y: int) -> None:
    if 0 <= x < size[1] and 0 <= y < size[0]:
        out.append((y, x))


def _hline(out, size, y: int, x1: int, x2: int) -> None:
    if 0 <= y < size[0]:
        for x in range(max(x1, 0), min(x2, size[1] - 1) + 1):
            out.append((y, x))


def _circle(out, size, cx: int, cy: int, radius: int, fill: bool) -> None:
    """drawing.cpp's Circle: the integer midpoint loop."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        for ya, yb, xa, xb in ((y11, y12, x11, x12), (y21, y22, x21, x22)):
            if fill:
                _hline(out, size, ya, xa, xb)
                _hline(out, size, yb, xa, xb)
            else:
                for y in (ya, yb):
                    _put(out, size, xa, y)
                    _put(out, size, xb, y)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """drawing.cpp's clipLine: the ends moved onto the image's border, or
    None where the line misses the image."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line(out, size, x1: int, y1: int, x2: int, y2: int) -> None:
    """drawing.cpp's Line: LineIterator's 8-connected walk between integer
    ends, left to right."""
    clipped = _clip_line(size[1], size[0], x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    major, minor = (1, 0), (0, 1 if dy >= 0 else -1)
    dy = abs(dy)
    if dy > dx:
        dx, dy = dy, dx
        major, minor = minor, major
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        _put(out, size, x, y)
        if err < 0:
            err += minus + plus
            x, y = x + major[0] + minor[0], y + major[1] + minor[1]
        else:
            err += minus
            x, y = x + major[0], y + major[1]


def _line2(out, size, x1: int, y1: int, x2: int, y2: int) -> None:
    """drawing.cpp's Line2: a line between fixed-point (XY_SHIFT) ends."""
    clipped = _clip_line(size[1] << XY_SHIFT, size[0] << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        dy = (dy ^ j) - j
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        dx = (dx ^ i) - i
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(out, size, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(out, size, x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(out, size, x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(out, size, v) -> None:
    """drawing.cpp's FillConvexPoly for fixed-point (XY_SHIFT) vertices."""
    delta = XY_ONE >> 1
    n = len(v)
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(out, size, p0[0], p0[1], p[0], p[1])
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= size[1] or ymin >= size[0]:
        return
    ymax = min(ymax, size[0] - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= n:
                    idx -= n
                while True:  # for (; edges-- > 0; )
                    go = edges > 0
                    edges -= 1
                    if not go:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < size[1]:
                _hline(out, size, y, max(xx1, 0), min(xx2, size[1] - 1))
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(out, size, p0, p1, thickness: int, flags: int, shift: int) -> None:
    """drawing.cpp's ThickLine (LINE_8) between fixed-point ends given with
    ``shift`` fractional bits at the caller (0: integer points); flags 1 / 2
    cap the first / second end with a filled circle."""
    if thickness <= 1:
        if shift == 0:  # integer ends: the 8-connected iterator
            _line(out, size, (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (p1[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p1[1] + (XY_ONE >> 1)) >> XY_SHIFT)
        else:
            _line2(out, size, p0[0], p0[1], p1[0], p1[1])
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex_poly(out, size, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                                      (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)])
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _circle(out, size, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                    (t + (XY_ONE >> 1)) >> XY_SHIFT, True)


def _paint(img: np.ndarray, pixels, color) -> None:
    if pixels:
        ys, xs = np.array(pixels, np.int64).T
        img[ys, xs] = color if img.ndim == 3 else color[0]


def draw_circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` in place (LINE_8)."""
    size = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    out: List = []
    if thickness > 1:
        d = radius
        delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
        pts, prev = [], None
        for a in range(0, 360 + delta, delta):
            a = min(a, 360)
            x = (cx * XY_ONE) + radius * XY_ONE * float(np.float32(math.sin(math.radians(450 - a))))
            y = (cy * XY_ONE) + radius * XY_ONE * float(np.float32(math.sin(math.radians(a))))
            p = (round(x), round(y))
            if p != prev:
                pts.append(p)
                prev = p
        if len(pts) == 1:
            pts = [(cx * XY_ONE, cy * XY_ONE)] * 2
        flags = 3
        for p0, p1 in zip(pts[:-1], pts[1:]):
            _thick_line(out, size, p0, p1, thickness, flags, XY_SHIFT)
            flags = 2
    else:
        _circle(out, size, cx, cy, radius, thickness < 0)
    _paint(img, out, color)
    return img


def draw_line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` in place (LINE_8)."""
    out: List = []
    p0 = (int(pt1[0]) << XY_SHIFT, int(pt1[1]) << XY_SHIFT)
    p1 = (int(pt2[0]) << XY_SHIFT, int(pt2[1]) << XY_SHIFT)
    _thick_line(out, img.shape[:2], p0, p1, thickness, 3, 0)
    _paint(img, out, color)
    return img


def vis_seg_point(
    img: np.ndarray,
    kpts: np.ndarray,
    segs: np.ndarray,
    seg_color: Dict[int, tuple],
    radius: int = 5,
    thickness: int = -1,
) -> np.ndarray:
    """Draw keypoints coloured by landmark id (vis_seg.py:37-60); seg 0 (bg)
    drawn gray."""
    out = img.copy()
    for (x, y), s in zip(np.asarray(kpts[:, :2], int), np.asarray(segs, int)):
        color = (128, 128, 128) if s <= 0 else seg_color[s % len(seg_color)]
        draw_circle(out, (int(x), int(y)), radius, color, thickness)
    return out


def vis_inlier(
    img: np.ndarray,
    kpts: np.ndarray,
    inliers,
    radius: int = 5,
    thickness: int = 2,
) -> np.ndarray:
    """Green = inlier, red = outlier (vis_seg.py vis_inlier)."""
    out = img.copy()
    for (x, y), ok in zip(np.asarray(kpts[:, :2], int), inliers):
        color = (0, 255, 0) if ok else (0, 0, 255)
        draw_circle(out, (int(x), int(y)), radius, color, thickness)
    return out


def plot_matches(
    img1: np.ndarray,
    img2: np.ndarray,
    pts1: np.ndarray,
    pts2: np.ndarray,
    inliers=None,
    radius: int = 5,
    line_thickness: int = 2,
) -> np.ndarray:
    """Side-by-side match plot (vis_seg.py:116-160)."""
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    h = max(h1, h2)
    canvas = np.zeros((h, w1 + w2, 3), np.uint8)
    canvas[:h1, :w1] = img1
    canvas[:h2, w1:] = img2
    if inliers is None:
        inliers = np.ones(len(pts1), bool)
    for (x1, y1), (x2, y2), ok in zip(
        np.asarray(pts1[:, :2], int), np.asarray(pts2[:, :2], int), inliers
    ):
        color = (0, 255, 0) if ok else (0, 0, 255)
        draw_circle(canvas, (int(x1), int(y1)), radius, color, 2)
        draw_circle(canvas, (int(x2) + w1, int(y2)), radius, color, 2)
        draw_line(canvas, (int(x1), int(y1)), (int(x2) + w1, int(y2)), color, line_thickness)
    return canvas


def plot_landmarks_3d(
    xyz: np.ndarray,
    seg_ids: np.ndarray,
    save_fn: Optional[str] = None,
    max_points: int = 20000,
    frame_poses: Optional[List[np.ndarray]] = None,
):
    """Headless 3D landmark scatter (tools/visualize_landmarks.py without
    the open3d window): each landmark gets its palette colour; optional
    camera centres overlaid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(xyz) > max_points:
        sel = np.random.RandomState(0).choice(
            len(xyz), max_points, replace=False
        )
        xyz, seg_ids = xyz[sel], seg_ids[sel]
    palette = generate_color_dic(int(seg_ids.max()) + 2)
    colors = np.array(
        [palette[int(s) % len(palette)] for s in seg_ids], float
    )[:, ::-1] / 255.0

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=colors, s=1)
    if frame_poses:
        centers = np.array(frame_poses)
        ax.scatter(
            centers[:, 0], centers[:, 1], centers[:, 2],
            c="k", marker="^", s=30,
        )
    ax.set_box_aspect((1, 1, 1))
    if save_fn:
        fig.savefig(save_fn, dpi=120)
        plt.close(fig)
        return save_fn
    return fig
