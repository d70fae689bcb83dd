"""Image reading without cv2: a stdlib PNG decoder, the port's JPEG
decoder, ``.npy`` images and cv2's bilinear resize.

The card's machine has no cv2 and no image library, so the port reads its
images itself:

- JPEG through ``io/jpeg.py``, bit-equal to ``cv2.imread`` (libjpeg-turbo's
  integer IDCT, fancy upsampling and colour conversion; EXIF orientation
  applied); a grayscale read is the stream's Y plane, as cv2 reads it;
- PNG through ``zlib`` and ``struct``: 8-bit gray, RGB and RGBA,
  non-interlaced, filter types 0-4 (decoded bytes equal libpng's);
- ``.npy``: ``[H, W]`` or ``[H, W, 1 | 3]``, uint8 or float in [0, 1];
- anything else raises, naming the file and its format.

:func:`resize_linear` is ``cv2.resize``'s ``INTER_LINEAR``: pixel centres
map by ``(x + 0.5) * scale - 0.5``, clamped at the borders.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from pram_tpu_torch.io.jpeg import read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples a pixel
_MAGIC = (
    (b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "RIFF/WebP"),
)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> ``[height, stride]`` uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, line = int(rows[r, 0]), rows[r, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum along each sample of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            if ftype == 3:
                for i in range(stride):
                    a = cur[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
            else:
                for i in range(stride):
                    if i >= bpp:
                        a, c = cur[i - bpp], up[i - bpp]
                    else:
                        a = c = 0
                    b = up[i]
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {r}")
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG -> uint8 ``[H, W]`` (gray) or ``[H, W, 3 | 4]`` (RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(PNG_SIGNATURE), [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, interlace {interlace}; "
            "only 8-bit gray, RGB and RGBA without interlacing are read"
        )
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return img.reshape(height, width) if ch == 1 else img.reshape(height, width, ch)


def _format_of(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return os.path.splitext(path)[1].lstrip(".").upper() or "unknown"


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> gray by ITU-R BT.601 weights in 14-bit fixed point, as
    ``cv2.cvtColor(COLOR_RGB2GRAY)`` computes it (``cv2.imread``'s grayscale
    read converts through libpng instead and lands within one level)."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """An image file -> ``[H, W]`` (grayscale) or ``[H, W, 3]`` RGB, uint8 for
    JPEG, PNG and uint8 ``.npy``, the stored float type for float ``.npy``.

    An RGBA PNG drops its alpha; a gray image read in colour repeats its
    channel three times, as ``cv2.imread`` reads them.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
            raise ValueError(f"{path}: .npy image of shape {img.shape}; expected [H, W] or [H, W, 1 | 3]")
    else:
        if _format_of(path) == "JPEG":  # a stream of its own: gray is its Y plane, not a conversion
            return read_jpeg(path, grayscale)
        if not _is_png(path):
            raise ValueError(
                f"{path}: {_format_of(path)} images are not read by this port (it has "
                "no image library); convert them to PNG or .npy"
            )
        img = read_png(path)
        if img.ndim == 3 and img.shape[-1] == 4:
            img = img[..., :3]
    if grayscale:
        if img.ndim == 3:
            if img.dtype != np.uint8:
                raise ValueError(f"{path}: grayscale reads of float colour images are not supported")
            img = rgb_to_gray(img)
        return img
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` with ``INTER_LINEAR``: ``size = (w, h)``; uint8
    results are rounded to the nearest level, float ones kept in their type."""
    h0, w0 = img.shape[:2]
    w1, h1 = int(size[0]), int(size[1])

    def taps(n_out, n_in):
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(pos).astype(np.int64)
        frac = pos - i0
        low = i0 < 0
        i0[low], frac[low] = 0, 0.0
        high = i0 >= n_in - 1
        i0[high], frac[high] = n_in - 1, 0.0
        return i0, np.minimum(i0 + 1, n_in - 1), frac

    y0, y1, fy = taps(h1, h0)
    x0, x1, fx = taps(w1, w0)
    src = img.astype(np.float64)
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    fy = fy.reshape((-1, 1) + (1,) * (img.ndim - 2))
    rows = src[y0] * (1.0 - fy) + src[y1] * fy
    out = rows[:, x0] * (1.0 - fx) + rows[:, x1] * fx
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)
