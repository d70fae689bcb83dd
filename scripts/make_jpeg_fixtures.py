#!/usr/bin/env python3
"""Write the small JPEG fixtures of tests/jpeg_fixtures/ with cv2 and the
SHA-256 of what ``cv2.imread`` reads from each (digests.json).

    python3 scripts/make_jpeg_fixtures.py [OUT_DIR]

Needs cv2 (libjpeg-turbo), so it runs where the JAX package's tests run,
not on the card's machine. The fixtures cover each chroma sampling
(4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), a progressive stream, restart
intervals, optimized Huffman tables, gray baseline and progressive, and an
EXIF Orientation of 6 (spliced in as an APP1 segment). The digests are of
the uint8 arrays as the port returns them: colour reads with cv2's BGR
channels reversed to RGB, gray reads as they are. ``chip_smoke.py`` phase
32 and tests/test_torch_jpeg.py decode the fixtures and match the digests.
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment holding an IFD0 with the one Orientation entry."""
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def image(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / (5.0 + c) + c) * np.cos(y / (4.0 + c) - c) for c in range(3)], -1)
    img = np.clip(base + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def encode(img, **flags) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, flags.get("quality", 90)]
    for key, flag in (("sampling", cv2.IMWRITE_JPEG_SAMPLING_FACTOR), ("progressive", cv2.IMWRITE_JPEG_PROGRESSIVE),
                      ("restart", cv2.IMWRITE_JPEG_RST_INTERVAL), ("optimize", cv2.IMWRITE_JPEG_OPTIMIZE)):
        if key in flags:
            params += [flag, int(flags[key])]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def fixtures() -> dict:
    s = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
         "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    out = {f"s{k}.jpg": encode(image(37, 45, i), sampling=v) for i, (k, v) in enumerate(s.items())}
    out["progressive.jpg"] = encode(image(41, 53, 10), sampling=s["420"], progressive=True)
    out["restart.jpg"] = encode(image(33, 47, 11), sampling=s["422"], restart=2)
    out["optimized.jpg"] = encode(image(40, 40, 12), sampling=s["420"], optimize=True, quality=75)
    out["gray.jpg"] = encode(image(29, 31, 13, gray=True))
    out["gray_progressive.jpg"] = encode(image(29, 31, 14, gray=True), progressive=True, restart=1)
    plain = encode(image(21, 35, 15), sampling=s["420"])
    out["exif6.jpg"] = plain[:2] + exif_app1(6) + plain[2:]
    return out


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "tests" / "jpeg_fixtures"
    out_dir.mkdir(parents=True, exist_ok=True)
    table = {}
    for name, data in fixtures().items():
        path = out_dir / name
        path.write_bytes(data)
        color = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        table[name] = {"shape": list(color.shape), "color": digest(color), "gray": digest(gray)}
    (out_dir / "digests.json").write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    print(f"{len(table)} fixtures, {sum(len(d) for d in fixtures().values())} bytes, in {out_dir}")


if __name__ == "__main__":
    main()
