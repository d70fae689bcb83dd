"""JPEG decoding in numpy and the stdlib: ``cv2.imread``'s pixels for JPEG.

The card's machine has no cv2 and no image library, so the port decodes
JPEG itself, bit for bit as ``cv2.imread`` does through libjpeg-turbo with
its default settings:

- streams: baseline and extended sequential Huffman (SOF0/SOF1), and
  progressive Huffman (SOF2: spectral selection, successive approximation,
  EOB runs); default or optimized tables; restart intervals (DRI / RSTn);
  1 or 3 components, 8-bit samples;
- chroma sampling: any integral factors, 4:4:4, 4:2:2, 4:2:0, 4:4:0 and
  4:1:1 among them, at any image size;
- pixels: libjpeg's ``JDCT_ISLOW`` integer IDCT (``jidctint.c``, its
  output saturated as the SIMD version saturates it), its fancy (triangle)
  upsampling for 2x1, 1x2 and 2x2 (``jdsample.c``: 2x1 and 2x2 only where
  the component is wider than 2 samples; box replication otherwise and for
  other factors), and its fixed-point YCbCr -> RGB (``jdcolor.c``);
- a grayscale read is the Y plane, as libjpeg gives ``JCS_GRAYSCALE`` (an
  RGB-coded stream, Adobe transform 0, converts by libjpeg's fixed-point
  weights instead);
- the EXIF Orientation tag (1-8) is applied, as ``cv2.imread`` applies it.

Refused, by ``NotImplementedError`` naming the file and what was found:
arithmetic coding, lossless, hierarchical and 12-bit frames, 2 or 4
components (CMYK / YCCK), and progressive streams whose scans leave
coefficients unrefined (libjpeg would smooth those blocks).

Speed: Huffman symbols are decoded through 16-bit lookup tables that hold
each code's length, run and value; the bits are read from 64-bit words
taken every 4 bytes. Dequantization, the IDCT, upsampling and colour
conversion are numpy over all blocks at once.
"""

from __future__ import annotations

import functools
import struct
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

# zig-zag position -> natural (row-major) index
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
]
# coefficients are stored in zig-zag order and put in natural order once,
# over all blocks, by this gather; a progressive scan's position past 63
# (a corrupt run) lands on 63, as libjpeg's jpeg_natural_order pads it
NATURAL = np.argsort(ZIGZAG)
ZPOS = list(range(64)) + [63] * 16

_SOF_REFUSED = {
    0xC3: "a lossless (SOF3) frame",
    0xC5: "a hierarchical (SOF5) frame", 0xC6: "a hierarchical (SOF6) frame",
    0xC7: "a hierarchical lossless (SOF7) frame",
    0xC9: "an arithmetic-coded (SOF9) frame", 0xCA: "an arithmetic-coded progressive (SOF10) frame",
    0xCB: "an arithmetic-coded lossless (SOF11) frame",
    0xCD: "an arithmetic-coded hierarchical (SOF13) frame",
    0xCE: "an arithmetic-coded hierarchical (SOF14) frame",
    0xCF: "an arithmetic-coded hierarchical (SOF15) frame",
    0xCC: "arithmetic-coding conditioning (DAC)",
    0xDE: "a hierarchical progression (DHP)", 0xDF: "a hierarchical expansion (EXP)",
}

# jidctint.c's constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (int(1.40200 * 65536 + 0.5) * x + one_half) >> 16
    cb_b = (int(1.77200 * 65536 + 0.5) * x + one_half) >> 16
    cr_g = -int(0.71414 * 65536 + 0.5) * x
    cb_g = -int(0.34414 * 65536 + 0.5) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class JpegError(ValueError):
    """A stream that is not valid JPEG."""


# ---------------------------------------------------------------- Huffman


@functools.lru_cache(maxsize=64)
def _huffman_tables(counts: bytes, symbols: bytes, is_dc: bool):
    """``(fast, raw)`` lookup tables of a Huffman table over 16-bit peeks.

    fast[c] = (length, run, value) of the code at the top of ``c`` with its
    magnitude bits decoded where code and bits fit in 16; (-length, run,
    size) where they do not; (0, 0, 0) for no code. For DC tables run is
    0 and value the difference; for AC tables run -1 marks an end of block
    (any size-0 symbol but ZRL ends a block in a sequential scan).
    raw[c] = (length, symbol), length 0 for no code.

    Canonical codes are assigned in increasing order, so each code's range
    of peeks follows the last one's: the tables are built by appending.
    """
    fast, raw = [], []
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            if code >= (1 << bits):
                raise JpegError("bad Huffman table")
            sym = symbols[k]
            run, size = (0, sym) if is_dc else (sym >> 4, sym & 15)
            if not is_dc and size == 0 and run != 15:
                run = -1
            raw += [(bits, sym)] * (1 << (16 - bits))
            if bits + size <= 16:
                rep = 1 << (16 - bits - size)
                half = (1 << (size - 1)) if size else 1
                for t in range(1 << size):
                    v = t if t >= half else t - (1 << size) + 1
                    fast += [(bits + size, run, v if size else 0)] * rep
            else:
                fast += [(-bits, run, size)] * (1 << (16 - bits))
            code += 1
            k += 1
        code <<= 1
    fast += [(0, 0, 0)] * (65536 - len(fast))
    raw += [(0, 0)] * (65536 - len(raw))
    return fast, raw


def _words(segment: bytes) -> List[int]:
    """64-bit big-endian words starting every 4 bytes of the destuffed
    segment, zero-padded past its end (libjpeg reads zeros past the data)."""
    n = len(segment) // 4 + 4
    buf = np.zeros(4 * (n + 1), np.uint8)
    buf[: len(segment)] = np.frombuffer(segment, np.uint8)
    u = buf.view(">u4").astype(np.uint64)
    return ((u[:-1] << np.uint64(32)) | u[1:]).tolist()


def _slow(w: int, o: int, cl: int, s: int) -> Tuple[int, int]:
    """(bits used, value) of a code of length cl whose s magnitude bits
    pass the 16-bit peek."""
    t = (w >> (64 - o - cl - s)) & ((1 << s) - 1)
    return cl + s, (t if t >= (1 << (s - 1)) else t - (1 << s) + 1)


def _corrupt(what: str):
    raise JpegError(f"corrupt Huffman data in {what}")


def _sequential(W, plan, coef, npred):
    """A baseline / extended sequential segment: plan holds (coefficient
    base, component slot, DC table, AC table) for each block in order."""
    pred = [0] * npred
    p = 0
    for base, ci, dcl, acl in plan:
        o = p & 31
        w = W[p >> 5]
        tl, _, v = dcl[(w >> (48 - o)) & 0xFFFF]
        if tl <= 0:
            if tl == 0:
                _corrupt("a DC code")
            tl, v = _slow(w, o, -tl, v)
        p += tl
        v += pred[ci]
        pred[ci] = v
        coef[base] = v
        i, end = base + 1, base + 64  # i: the next coefficient's place
        while i < end:
            o = p & 31
            w = W[p >> 5]
            tl, r, v = acl[(w >> (48 - o)) & 0xFFFF]
            if tl <= 0:
                if tl == 0:
                    _corrupt("an AC code")
                tl, v = _slow(w, o, -tl, v)
            p += tl
            if r < 0:
                break
            i += r
            coef[i] = v  # a corrupt run may land past the block: checked below
            i += 1
        if i > end:
            _corrupt("an AC run past the block's end")


def _dc_first(W, plan, coef, npred, al):
    pred = [0] * npred
    p = 0
    for base, ci, dcl, _ in plan:
        o = p & 31
        w = W[p >> 5]
        tl, _, v = dcl[(w >> (48 - o)) & 0xFFFF]
        if tl <= 0:
            if tl == 0:
                _corrupt("a DC code")
            tl, v = _slow(w, o, -tl, v)
        p += tl
        v += pred[ci]
        pred[ci] = v
        coef[base] = v << al


def _dc_refine(W, plan, coef, al):
    p1 = 1 << al
    p = 0
    for base, _, _, _ in plan:
        if (W[p >> 5] >> (63 - (p & 31))) & 1:
            coef[base] |= p1
        p += 1


def _bits(W, p, n):
    return (W[p >> 5] >> (64 - (p & 31) - n)) & ((1 << n) - 1)


def _ac_first(W, plan, coef, ss, se, al):
    zz = ZPOS
    eobrun = 0
    p = 0
    for base, _, _, acr in plan:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            cl, rs = acr[(W[p >> 5] >> (48 - (p & 31))) & 0xFFFF]
            if cl == 0:
                _corrupt("an AC code")
            p += cl
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                t = _bits(W, p, s)
                p += s
                coef[base + zz[k]] = (t if t >= (1 << (s - 1)) else t - (1 << s) + 1) << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += _bits(W, p, r)
                    p += r
                eobrun -= 1
                break
            k += 1


def _ac_refine(W, plan, coef, ss, se, al):
    """jdphuff.c's decode_mcu_AC_refine."""
    zz = ZPOS
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    p = 0
    for base, _, _, acr in plan:
        k = ss
        if not eobrun:
            while k <= se:
                cl, rs = acr[(W[p >> 5] >> (48 - (p & 31))) & 0xFFFF]
                if cl == 0:
                    _corrupt("an AC refinement code")
                p += cl
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if (W[p >> 5] >> (63 - (p & 31))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _bits(W, p, r)
                        p += r
                    break
                while k <= se:
                    i = base + zz[k]
                    c = coef[i]
                    if c:
                        if (W[p >> 5] >> (63 - (p & 31))) & 1 and not c & p1:
                            coef[i] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + zz[k]
                c = coef[i]
                if c:
                    if (W[p >> 5] >> (63 - (p & 31))) & 1 and not c & p1:
                        coef[i] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


# ---------------------------------------------------------------- pixels


def _idct_1d(z, shift):
    z1 = (z[2] + z[6]) * _F0541
    tmp2 = z1 - z[6] * _F1847
    tmp3 = z1 + z[2] * _F0765
    tmp0 = (z[0] + z[4]) << 13
    tmp1 = (z[0] - z[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = z[7], z[5], z[3], z[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return (
        (tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift, (tmp12 + t1 + r) >> shift,
        (tmp13 + t0 + r) >> shift, (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
        (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift,
    )


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantized coefficients ``[N, 8, 8]`` (natural order, row = vertical
    frequency) -> uint8 samples ``[N, 8, 8]``: jidctint.c's
    ``jpeg_idct_islow`` (columns with PASS1_BITS 2, then rows), the
    result saturated to 0..255 after the +128 level shift."""
    b = blocks.astype(np.int64)
    ws = _idct_1d([b[:, k, :] for k in range(8)], 11)  # spatial rows, [N, 8 columns]
    ws = np.stack(ws, axis=1)
    out = _idct_1d([ws[:, :, k] for k in range(8)], 18)  # spatial columns, [N, 8 rows]
    return np.clip(np.stack(out, axis=2) + 128, 0, 255).astype(np.uint8)


def _edge(a: np.ndarray, axis: int, before: int, after: int) -> np.ndarray:
    pad = [(0, 0)] * a.ndim
    pad[axis] = (before, after)
    return np.pad(a, pad, mode="edge")


def _fancy_h(a: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1 and 2."""
    e = _edge(a, 1, 1, 1)
    c3 = 3 * a
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.int32)
    out[:, 0::2] = (c3 + e[:, :-2] + 1) >> 2
    out[:, 1::2] = (c3 + e[:, 2:] + 2) >> 2
    return out


def _fancy_v(a: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: the row above (bias 1) or below (bias 2)."""
    e = _edge(a, 0, 1, 1)
    c3 = 3 * a
    out = np.empty((2 * a.shape[0], a.shape[1]), np.int32)
    out[0::2] = (c3 + e[:-2] + 1) >> 2
    out[1::2] = (c3 + e[2:] + 2) >> 2
    return out


def _fancy_hv(a: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3 * nearer row + further row, then
    3/4 nearer + 1/4 further column sum, biases 8 and 7 over 16."""
    e = _edge(a, 0, 1, 1)
    out = np.empty((2 * a.shape[0], 2 * a.shape[1]), np.int32)
    for v, other in ((0, e[:-2]), (1, e[2:])):
        cs = 3 * a + other
        ce = _edge(cs, 1, 1, 1)
        out[v::2, 0::2] = (3 * cs + ce[:, :-2] + 8) >> 4
        out[v::2, 1::2] = (3 * cs + ce[:, 2:] + 7) >> 4
    return out


def upsample(plane: np.ndarray, h_exp: int, v_exp: int) -> np.ndarray:
    """A component plane ``[h, w]`` (its real samples) -> ``[v_exp h, h_exp
    w]`` by jdsample.c's choice of method (fancy by default)."""
    a = plane.astype(np.int32)
    w = a.shape[1]
    if (h_exp, v_exp) == (1, 1):
        return a
    if (h_exp, v_exp) == (2, 1) and w > 2:
        return _fancy_h(a)
    if (h_exp, v_exp) == (1, 2):
        return _fancy_v(a)
    if (h_exp, v_exp) == (2, 2) and w > 2:
        return _fancy_hv(a)
    return np.repeat(np.repeat(a, v_exp, axis=0), h_exp, axis=1)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert -> uint8 ``[H, W, 3]`` RGB."""
    y = y.astype(np.int64)
    cb = cb.astype(np.intp)
    cr = cr.astype(np.intp)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_y(rgb: np.ndarray) -> np.ndarray:
    """jdcolor.c's rgb_gray_convert (an RGB-coded stream read as gray)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF Orientation tag, as OpenCV's ApplyExifOrientation applies it."""
    t = np.swapaxes(img, 0, 1) if orientation in (5, 6, 7, 8) else img
    if orientation in (2, 6):
        t = t[:, ::-1]
    elif orientation in (3, 7):
        t = t[::-1, ::-1]
    elif orientation in (4, 8):
        t = t[::-1]
    return np.ascontiguousarray(t)


def exif_orientation(app1: bytes) -> Optional[int]:
    """The Orientation (0x0112) of IFD0 in an ``Exif\\0\\0`` APP1 body."""
    if not app1.startswith(b"Exif\x00\x00") or len(app1) < 14:
        return None
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return None
    try:
        (ifd,) = struct.unpack_from(order + "I", tiff, 4)
        (count,) = struct.unpack_from(order + "H", tiff, ifd)
        for i in range(count):
            tag, typ, n = struct.unpack_from(order + "HHI", tiff, ifd + 2 + 12 * i)
            if tag == 0x0112:
                if typ == 3:
                    return struct.unpack_from(order + "H", tiff, ifd + 10 + 12 * i)[0]
                if typ == 4:
                    return struct.unpack_from(order + "I", tiff, ifd + 10 + 12 * i)[0]
                return None
    except struct.error:
        return None
    return None


# ---------------------------------------------------------------- stream


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable: Optional[np.ndarray] = None  # natural order, latched at its first scan
        self.offset = 0  # first coefficient of the component in the shared array
        self.bh = self.bw = 0  # blocks allocated (whole MCUs)
        self.rows = self.cols = 0  # real samples
        self.coef_bits = [-1] * 64  # progressive: the successive-approximation bit reached


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """Entropy-coded segments of the scan starting at ``pos`` (split at
    RSTn, 0xFF00 destuffed) and the position of the marker that ends it."""
    segments, start, i = [], pos, pos
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segments.append(data[start:])
            return [s.replace(b"\xff\x00", b"\xff") for s in segments], n
        nxt = data[j + 1]
        if nxt == 0x00:
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:j])
            start = i = j + 2
        else:
            segments.append(data[start:j])
            return [s.replace(b"\xff\x00", b"\xff") for s in segments], j


def decode_jpeg(data: bytes, grayscale: bool = False, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 ``[H, W, 3]`` RGB, or ``[H, W]`` with
    ``grayscale``: ``cv2.imread(..., IMREAD_COLOR)`` (channels reversed to
    RGB) or ``IMREAD_GRAYSCALE``, EXIF orientation applied."""

    def refuse(what: str):
        raise NotImplementedError(f"{name}: JPEG with {what} is not decoded by this port")

    if not data.startswith(b"\xff\xd8"):
        raise JpegError(f"{name}: not a JPEG file (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, Tuple[bytes, bytes]] = {}
    ac_tabs: Dict[int, Tuple[bytes, bytes]] = {}
    comps: List[_Component] = []
    restart = 0
    progressive = None
    height = width = 0
    coef = None
    jfif = adobe = False
    adobe_transform = 1
    orientation = None
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:  # garbage before a marker: libjpeg skips it
            nxt = data.find(b"\xff", pos)
            pos = n if nxt < 0 else nxt
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            raise JpegError(f"{name}: truncated at marker 0x{marker:02X}")
        (seg_len,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2 : pos + seg_len]
        pos += seg_len
        if marker in _SOF_REFUSED:
            refuse(_SOF_REFUSED[marker])
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nc = struct.unpack_from(">BHHB", body)
            if precision != 8:
                refuse(f"{precision}-bit samples")
            if nc not in (1, 3):
                refuse(f"{nc} components (CMYK / YCCK or other)" if nc == 4 else f"{nc} components")
            if height == 0:
                refuse("the height given by a DNL marker")
            progressive = marker == 0xC2
            for i in range(nc):
                cid, hv, tq = struct.unpack_from(">BBB", body, 6 + 3 * i)
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise JpegError(f"{name}: bad sampling factors {h}x{v}")
                comps.append(_Component(cid, h, v, tq))
            max_h = max(c.h for c in comps)
            max_v = max(c.v for c in comps)
            mcux = -(-width // (8 * max_h))
            mcuy = -(-height // (8 * max_v))
            total = 0
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.cols = -(-width * c.h // max_h)
                c.rows = -(-height * c.v // max_v)
                c.offset = total
                total += c.bw * c.bh * 64
            coef = array("i", bytes(4 * (total + 16)))  # 16 past the end: a corrupt run's last write
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc_th = body[i]
                counts = bytes(body[i + 1 : i + 17])
                k = sum(counts)
                symbols = bytes(body[i + 17 : i + 17 + k])
                (dc_tabs if tc_th >> 4 == 0 else ac_tabs)[tc_th & 15] = (counts, symbols)
                i += 17 + k
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack_from(">64H", body, i + 1)
                    i += 129
                else:
                    vals = tuple(body[i + 1 : i + 65])
                    i += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[tq] = q
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", body)
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xE1 and orientation is None and body.startswith(b"Exif\x00\x00"):
            orientation = exif_orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
        elif marker == 0xDA:  # SOS
            if coef is None:
                raise JpegError(f"{name}: scan before the frame header")
            pos = _decode_scan(data, pos, body, comps, qt, dc_tabs, ac_tabs, restart, progressive, coef, name)
    if coef is None:
        raise JpegError(f"{name}: no frame")
    if progressive:
        for c in comps:
            if c.coef_bits[0] >= 0 and any(b != 0 for b in c.coef_bits[1:10]):
                refuse("progressive scans that leave coefficients unrefined (libjpeg smooths such blocks)")

    rgb_coded = len(comps) == 3 and not jfif and (
        (adobe and adobe_transform == 0)
        or (not adobe and [c.cid for c in comps] == [82, 71, 66])
    )
    max_h = max(c.h for c in comps)
    max_v = max(c.v for c in comps)
    coefs = np.frombuffer(coef, np.int32)

    def plane(c: _Component) -> np.ndarray:
        if c.qtable is None:  # never in a scan: libjpeg outputs its zero blocks
            q = qt.get(c.tq, np.zeros(64, np.int64))
        else:
            q = c.qtable
        blk = coefs[c.offset : c.offset + c.bw * c.bh * 64].reshape(-1, 64)[:, NATURAL] * q
        px = idct_islow(blk.reshape(-1, 8, 8))
        px = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        up = upsample(px[: c.rows, : c.cols], max_h // c.h, max_v // c.v)
        return up[:height, :width]

    if len(comps) == 1:
        y = plane(comps[0]).astype(np.uint8)
        img = y if grayscale else np.repeat(y[..., None], 3, axis=-1)
    elif rgb_coded:
        rgb = np.stack([plane(c) for c in comps], axis=-1).astype(np.uint8)
        img = rgb_to_y(rgb) if grayscale else rgb
    elif grayscale:
        img = plane(comps[0]).astype(np.uint8)
    else:
        img = ycc_to_rgb(*(plane(c) for c in comps))
    if orientation in (2, 3, 4, 5, 6, 7, 8):
        img = apply_orientation(img, orientation)
    return img


def _decode_scan(data, pos, body, comps, qt, dc_tabs, ac_tabs, restart, progressive, coef, name) -> int:
    """Entropy-decode one scan into ``coef``; returns the position after it."""
    ns = body[0]
    by_id = {c.cid: c for c in comps}
    scomps = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise JpegError(f"{name}: scan names an unknown component {cid}")
        scomps.append((by_id[cid], tables >> 4, tables & 15))
    ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    for c, _, _ in scomps:
        if c.qtable is None:
            if c.tq not in qt:
                raise JpegError(f"{name}: component {c.cid} uses quantization table {c.tq}, never defined")
            c.qtable = qt[c.tq].copy()
        if progressive:
            for k in range(ss, se + 1):
                c.coef_bits[k] = al

    def tables(td, ta):
        dcl = acl = None
        if ss == 0 and ah == 0:
            if td not in dc_tabs:
                raise JpegError(f"{name}: DC Huffman table {td} not defined")
            dcl = _huffman_tables(*dc_tabs[td], True)[0]
        if se > 0 or not progressive:
            if ta not in ac_tabs:
                raise JpegError(f"{name}: AC Huffman table {ta} not defined")
            fast, raw = _huffman_tables(*ac_tabs[ta], False)
            acl = raw if progressive else fast
        return dcl, acl

    # the blocks of the scan, in coding order: (coefficient base, slot, DC, AC)
    if len(scomps) == 1:
        c, td, ta = scomps[0]
        dcl, acl = tables(td, ta)
        rows, cols = -(-c.rows // 8), -(-c.cols // 8)
        r, q = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        bases = (c.offset + (r * c.bw + q) * 64).reshape(-1).tolist()
        plan = [(b, 0, dcl, acl) for b in bases]
        per_mcu = 1
    else:
        width_blocks = comps[0].bw // comps[0].h  # MCUs across
        mcuy = comps[0].bh // comps[0].v
        parts = []
        per_mcu = 0
        slot_tabs = []
        for slot, (c, td, ta) in enumerate(scomps):
            slot_tabs.append(tables(td, ta))
            my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(width_blocks), np.arange(c.v),
                                       np.arange(c.h), indexing="ij")
            base = c.offset + ((my * c.v + v) * c.bw + mx * c.h + h) * 64
            parts.append((base.reshape(mcuy * width_blocks, c.v * c.h), slot))
            per_mcu += c.v * c.h
        bases = np.concatenate([b for b, _ in parts], axis=1).reshape(-1).tolist()
        slots = np.concatenate(
            [np.full((1, b.shape[1]), s) for b, s in parts], axis=1
        ).repeat(mcuy * width_blocks, axis=0).reshape(-1).tolist()
        plan = [(b, s, slot_tabs[s][0], slot_tabs[s][1]) for b, s in zip(bases, slots)]
    segments, end = _scan_segments(data, pos)
    chunk = restart * per_mcu if restart else len(plan)
    want = -(-len(plan) // chunk) if plan else 0
    if len(segments) < want:
        raise JpegError(f"{name}: scan holds {len(segments)} restart intervals, expected {want}")
    for i in range(want):
        W = _words(segments[i])
        part = plan[i * chunk : (i + 1) * chunk]
        if not progressive:
            _sequential(W, part, coef, len(scomps))
        elif ss == 0:
            if ah == 0:
                _dc_first(W, part, coef, len(scomps), al)
            else:
                _dc_refine(W, part, coef, al)
        elif ah == 0:
            _ac_first(W, part, coef, ss, se, al)
        else:
            _ac_refine(W, part, coef, ss, se, al)
    return end


def read_jpeg(path: str, grayscale: bool = False) -> np.ndarray:
    """A JPEG file -> uint8 RGB ``[H, W, 3]`` or gray ``[H, W]`` (:func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, grayscale, name=str(path))
