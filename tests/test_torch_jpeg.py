"""The port's JPEG decoder (pram_tpu_torch/io/jpeg.py) against cv2.imread.

Every comparison is bit for bit: the colour read against ``cv2.imread``'s
BGR array with its channels reversed, the gray read against
``IMREAD_GRAYSCALE``, on streams that cv2 (libjpeg-turbo) writes here:

- baseline, progressive and optimized-table streams, each in every chroma
  sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), at qualities 50 / 95 /
  100, with and without restart intervals, at 1 x 1, 17 x 13 and 33 x 65
  (sizes off the MCU grid); one 640 x 480 view baseline and progressive;
- gray streams, baseline and progressive;
- EXIF Orientation 1-8 (and an out-of-range 9), spliced in as an APP1
  segment in both byte orders;
- an RGB-coded stream (the JFIF marker replaced by an Adobe one with
  transform 0), whose gray read takes libjpeg's RGB weights;
- the committed fixtures of tests/jpeg_fixtures/ against their digests
  (and the digests against cv2, so the files and table stay in step);
- ``chip_smoke.py``'s baseline encoder, whose streams cv2 and the port
  decode alike, with a mean error within 5% (+ half a level) of cv2's own
  q95 4:2:0 stream of the same view.

Streams the port refuses raise ``NotImplementedError`` naming the file:
arithmetic coding, 12-bit, lossless and hierarchical frames, CMYK, and a
progressive stream cut before its refinement scans.
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

import chip_smoke
from pram_tpu_torch.io.image import read_image
from pram_tpu_torch.io.jpeg import decode_jpeg, read_jpeg

FIXTURES = Path(__file__).resolve().parent / "jpeg_fixtures"
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}


def _image(h, w, seed, gray=False):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / (6.0 + c) + c) * np.cos(y / (5.0 + c) - c) for c in range(3)], -1)
    img = np.clip(base + rng.randn(h, w, 3) * 15, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _encode(img, quality=90, sampling=None, progressive=False, restart=0, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _same_as_cv2(data, name="<test>"):
    buf = np.frombuffer(data, np.uint8)
    color = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    gray = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    got = decode_jpeg(data, name=name)
    assert got.shape == color.shape and np.array_equal(got, color), name
    got = decode_jpeg(data, grayscale=True, name=name)
    assert got.shape == gray.shape and np.array_equal(got, gray), name


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("stream", ["baseline", "progressive", "optimized"])
def test_streams_bit_equal_to_cv2(stream, sampling):
    seed = 0
    for quality in (50, 95, 100):
        for restart in (0, 2):
            for h, w in ((1, 1), (17, 13), (33, 65)):
                seed += 1
                data = _encode(_image(h, w, seed), quality, sampling, stream == "progressive", restart,
                               stream == "optimized")
                _same_as_cv2(data, f"{stream} {sampling} q{quality} rst{restart} {w}x{h}")


@pytest.mark.parametrize("progressive", [False, True])
def test_a_640x480_view_bit_equal_to_cv2(progressive):
    _same_as_cv2(_encode(_image(480, 640, 7), 95, "420", progressive), f"640x480 progressive={progressive}")


@pytest.mark.parametrize("progressive", [False, True])
def test_gray_streams_bit_equal_to_cv2(progressive):
    for quality, (h, w), restart in ((50, (1, 1), 0), (95, (17, 13), 1), (100, (33, 65), 3)):
        data = _encode(_image(h, w, quality, gray=True), quality, None, progressive, restart)
        _same_as_cv2(data, f"gray q{quality} {w}x{h}")


def _exif(orientation, order):
    tiff = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
    tiff += struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(order + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 10))
def test_exif_orientation_as_cv2(orientation):
    data = _encode(_image(17, 29, orientation), 90, "420")
    for order in ("<", ">"):
        _same_as_cv2(data[:2] + _exif(orientation, order) + data[2:], f"orientation {orientation} {order}")


def test_rgb_coded_stream_as_cv2():
    data = _encode(_image(19, 23, 3), 90, "444")
    assert data[2:4] == b"\xff\xe0"  # cv2 writes JFIF first: swap it for Adobe, transform 0 (RGB)
    jfif_end = 4 + struct.unpack(">H", data[4:6])[0]
    adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    _same_as_cv2(data[:2] + b"\xff\xee" + struct.pack(">H", len(adobe) + 2) + adobe + data[jfif_end:], "rgb")


def test_committed_fixtures_match_their_digests():
    table = json.loads((FIXTURES / "digests.json").read_text())
    assert len(table) == 11

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in table.items():
        path = str(FIXTURES / name)
        assert digest(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]) == want["color"], name
        assert digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE)) == want["gray"], name
        color = read_image(path)
        assert list(color.shape) == want["shape"] and digest(color) == want["color"], name
        assert digest(read_image(path, grayscale=True)) == want["gray"], name


@pytest.mark.parametrize("gray", [False, True])
def test_chip_smoke_encoder_decodes_alike(gray):
    for h, w in ((1, 1), (17, 13), (33, 65), (120, 160)):
        img = _image(h, w, h + w, gray)
        data = chip_smoke.jpeg_bytes(img, 95)
        _same_as_cv2(data, f"write_jpeg {w}x{h}")
        # its loss: as cv2's own q95 4:2:0 stream of the same view
        want = img if gray else img[..., ::-1].copy()
        flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        ours = cv2.imdecode(np.frombuffer(data, np.uint8), flag).astype(int)
        theirs = cv2.imdecode(np.frombuffer(_encode(want, 95, "420"), np.uint8), flag).astype(int)
        assert np.abs(ours - want).mean() <= 1.05 * np.abs(theirs - want).mean() + 0.5


def _segments(data):
    """(marker, start, end) of each header segment up to the first SOS."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2 : pos + 4])[0]
        out.append((marker, pos, end))
        if marker == 0xDA:
            return out
        pos = end


def _refused_cases(data):
    sof = next((s, e) for m, s, e in _segments(data) if m == 0xC0)
    cases = {}
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless"), (0xC5, "hierarchical")):
        cases[what] = data[: sof[0] + 1] + bytes([marker]) + data[sof[0] + 2 :]
    cases["12-bit"] = data[: sof[0] + 4] + bytes([12]) + data[sof[0] + 5 :]
    cmyk = struct.pack(">BHHB", 8, 8, 8, 4) + b"".join(bytes((i, 0x11, 0)) for i in range(1, 5))
    cases["CMYK"] = data[: sof[0]] + b"\xff\xc0" + struct.pack(">H", len(cmyk) + 2) + cmyk + data[sof[1] :]
    cases["DAC"] = data[:2] + b"\xff\xcc\x00\x04\x00\x00" + data[2:]
    return cases


@pytest.mark.parametrize("what", ["arithmetic", "lossless", "hierarchical", "12-bit", "CMYK", "DAC"])
def test_unsupported_frames_raise_naming_the_file(tmp_path, what):
    data = _refused_cases(_encode(_image(8, 8, 1), 90, "444"))[what]
    path = tmp_path / f"{what}.jpg"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=str(path)):
        read_jpeg(str(path))
    with pytest.raises(NotImplementedError, match=str(path)):
        read_image(str(path), grayscale=True)


def test_progressive_stream_cut_before_its_refinements_raises(tmp_path):
    """libjpeg smooths the blocks of a progressive stream whose scans leave
    coefficients unrefined; the port refuses such a stream."""
    data = _encode(_image(24, 24, 2), 90, "420", progressive=True)
    first_sos = next(s for m, s, _ in _segments(data) if m == 0xDA)
    # keep the headers and the first (DC) scan, which ends at the next marker
    nxt = first_sos + 2
    while not (data[nxt] == 0xFF and data[nxt + 1] not in (0x00, 0xFF) and not 0xD0 <= data[nxt + 1] <= 0xD7):
        nxt += 1
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:nxt] + b"\xff\xd9")
    with pytest.raises(NotImplementedError, match=f"{path}.*unrefined"):
        read_jpeg(str(path))
