"""The bit-packed, halo-lean NMS tile (csrc/nms.cu, kernel 9), mirrored in
numpy on the CPU.

A block owns a TH x TW output tile of one image and loads it with a halo of
(1 + 2 num_iters) R pixels on every side into a region of LW = 256 columns
(NWD = 4 word pairs of 64 pixels) by TH + 2 halo rows, TH = 56, with -inf
outside the image. Stage s of the chain (1 + 2 num_iters stages) computes
rows [s R, LH - s R) of the region, all its columns. The masks are words:
{E, O} of word k hold the even and odd pixels of column pairs 32 k .. 32 k
+ 31 (bit l: pair 32 k + l), 0 outside the image. A float pool runs on
pixel pairs: down the column a thread takes a pair and CH = 8 rows (the
last run of a stage ends at its last row, overlapping the one before), the
window's maximum composed from doubling spans in place; along the row a
thread takes a word pair, and for each pair p the maxima a0 / a1 of the R
pairs from p - R/2 and from p - R/2 + 1, and m = max(max(a0, pair p +
R/2), (a0.hi, a1.lo)); s == m sets bit l of E and O. supp_s = where(supp,
0, s) is formed as the column pass loads it. A binary pool (supp) is an OR of
2R + 1 words down the column, then funnel shifts of E and O by -R/2..R/2
pairs across the neighbouring words. The mirror below does exactly these
steps (uint32 words, uint64 funnel shifts, the pairs as even and odd
planes), so its geometry and bit layout are the kernel's.

Tolerances: none. Max and equality are exact, so the mirror is bit-equal to
``simple_nms`` (f32 maps, and bf16 maps whose values f32 holds exactly) for
radii 2 and 4, widths that are not multiples of 32 or 64, and maps with
many exact ties; and bit-equal to the JAX package's Pallas kernel in
interpret mode on non-negative maps, since that kernel pads with zeros
(pram_tpu/ops/nms_pallas.py:11-14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.nms_pallas import simple_nms_pallas
from pram_tpu_torch.ops.nms import max_pool_2d, simple_nms

NWD, LP, LW, TH, CH, PADP = 4, 128, 256, 56, 8, 2
U32 = np.uint32
M32 = np.uint64(0xFFFFFFFF)


def geometry(radius, num_iters):
    halo = (1 + 2 * num_iters) * radius
    return halo, TH + 2 * halo, LW - 2 * halo


def pack(bits):
    """[rows, LW] bool -> E, O [rows, NWD] uint32 (bit l of word k: column
    pair 32 k + l)."""
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    def words(b):
        return (b.reshape(b.shape[0], NWD, 32).astype(np.uint64) * weights).sum(-1).astype(U32)
    return words(bits[:, 0::2]), words(bits[:, 1::2])


def unpack(e, o):
    """E, O [rows, NWD] -> [rows, LW] bool."""
    out = np.zeros((e.shape[0], LW), bool)
    shifts = np.arange(32, dtype=U32)
    out[:, 0::2] = ((e[:, :, None] >> shifts) & 1).reshape(e.shape[0], LP).astype(bool)
    out[:, 1::2] = ((o[:, :, None] >> shifts) & 1).reshape(o.shape[0], LP).astype(bool)
    return out


def shifted(x, s):
    """Words x [rows, NWD] moved so that bit l holds pair l + s, across
    neighbouring words (zeros beyond the row): __funnelshift_r / _l."""
    x64 = x.astype(np.uint64)
    zero = np.zeros((x.shape[0], 1), np.uint64)
    if s > 0:
        xr = np.concatenate([x64[:, 1:], zero], 1)
        return (((xr << np.uint64(32)) | x64) >> np.uint64(s) & M32).astype(U32)
    if s < 0:
        xl = np.concatenate([zero, x64[:, :-1]], 1)
        return ((((x64 << np.uint64(32)) | xl) << np.uint64(-s)) >> np.uint64(32) & M32).astype(U32)
    return x


def dilate_words(e, o, r0, r1, radius):
    """The binary pool of rows [r0, r1): the column OR, then the row's
    funnel shifts; rows outside [r0, r1) of the result are left 0."""
    te, to = np.zeros_like(e), np.zeros_like(o)
    for y in range(r0, r1):
        te[y] = np.bitwise_or.reduce(e[y - radius:y + radius + 1], 0)
        to[y] = np.bitwise_or.reduce(o[y - radius:y + radius + 1], 0)
    de, do = np.zeros_like(e), np.zeros_like(o)
    h = radius // 2
    for s in range(-h, h + 1):
        se, so = shifted(te, s), shifted(to, s)
        de |= se
        do |= so
        if s < h:
            de |= so
        if s > -h:
            do |= se
    de[:r0] = de[r1:] = 0
    do[:r0] = do[r1:] = 0
    return de, do


def column_pool(lo, hi, r0, r1, radius):
    """V of rows [r0, r1) from the pair planes lo, hi [LH, LP]: runs of CH
    rows (the last one ending at r1, overlapping the one before), the
    window's max by doubling spans in place, out[j] = max(w[j], w[j + 1])."""
    vlo, vhi = np.full_like(lo, -np.inf), np.full_like(hi, -np.inf)
    nwin = CH + 2 * radius
    for start in range(r0, r1, CH):
        y0 = min(start, r1 - CH)
        rows = np.arange(y0 - radius, y0 - radius + nwin)
        for src, dst in ((lo, vlo), (hi, vhi)):
            w = src[rows].copy()
            span = 1
            while span < 2 * radius:
                for i in range(nwin - 2 * span + 1):
                    w[i] = np.maximum(w[i], w[i + span])
                span *= 2
            for j in range(CH):
                dst[y0 + j] = np.maximum(w[j], w[j + 1])
    return vlo, vhi


def row_pool(vlo, vhi, radius):
    """The along-the-row max of every pair from V (padded with -inf by PADP
    pairs): a0, a1 over R pairs, the stitch (a0.hi, a1.lo)."""
    pad = np.full((vlo.shape[0], PADP), -np.inf, vlo.dtype)
    plo, phi = np.concatenate([pad, vlo, pad], 1), np.concatenate([pad, vhi, pad], 1)
    def pair(i):  # pair p - R/2 + i for every p
        s = PADP - radius // 2 + i
        return plo[:, s:s + LP], phi[:, s:s + LP]
    c_lo, c_hi = pair(1)
    for i in range(2, radius):
        c_lo, c_hi = np.maximum(c_lo, pair(i)[0]), np.maximum(c_hi, pair(i)[1])
    f_lo, f_hi = pair(0)
    l_lo, l_hi = pair(radius)
    a0_lo, a0_hi = np.maximum(c_lo, f_lo), np.maximum(c_hi, f_hi)
    a1_lo = np.maximum(c_lo, l_lo)
    return (np.maximum(np.maximum(a0_lo, l_lo), a0_hi),
            np.maximum(np.maximum(a0_hi, l_hi), a1_lo))


def tile_nms(scores, radius, num_iters=2):
    """The kernel's formulation over scores [B, H, W] (f32 values)."""
    b_, h_, w_ = scores.shape
    halo, lh, tw = geometry(radius, num_iters)
    out = np.zeros_like(scores)
    for b in range(b_):
        for ty0 in range(0, h_, TH):
            for tx0 in range(0, w_, tw):
                gy0, gx0 = ty0 - halo, tx0 - halo
                ys, xs = gy0 + np.arange(lh), gx0 + np.arange(LW)
                yin, xin = (ys >= 0) & (ys < h_), (xs >= 0) & (xs < w_)
                s = np.full((lh, LW), -np.inf, np.float32)
                s[np.ix_(yin, xin)] = scores[b][np.ix_(ys[yin], xs[xin])]
                cv_e, cv_o = pack(np.broadcast_to(xin, (1, LW)))
                row_ok = yin[:, None]
                s_lo, s_hi = s[:, 0::2], s[:, 1::2]
                mm_e = np.zeros((lh, NWD), U32)
                mm_o = np.zeros((lh, NWD), U32)
                sp_lo = sp_hi = None

                def float_stage(mg, supp):
                    nonlocal mm_e, mm_o
                    r0, r1 = mg, lh - mg
                    a_lo, a_hi = s_lo, s_hi
                    if supp:
                        a_lo = np.where(sp_lo, np.float32(0), s_lo)
                        a_hi = np.where(sp_hi, np.float32(0), s_hi)
                    v_lo, v_hi = column_pool(a_lo, a_hi, r0, r1, radius)
                    m_lo, m_hi = row_pool(v_lo, v_hi, radius)
                    eq = np.zeros((lh, LW), bool)
                    eq[:, 0::2], eq[:, 1::2] = s_lo == m_lo, s_hi == m_hi
                    e, o = pack(eq)
                    e, o = e & cv_e & np.where(row_ok, M32, 0).astype(U32), o & cv_o & np.where(row_ok, M32, 0).astype(U32)
                    rows = slice(r0, r1)
                    if supp:
                        mm_e[rows] |= e[rows] & ~sp_e[rows]
                        mm_o[rows] |= o[rows] & ~sp_o[rows]
                    else:
                        mm_e[rows], mm_o[rows] = e[rows], o[rows]

                mg = radius
                float_stage(mg, False)
                for _ in range(num_iters):
                    mg += radius
                    sp_e, sp_o = dilate_words(mm_e, mm_o, mg, lh - mg, radius)
                    keep = np.where(row_ok, M32, 0).astype(U32)
                    sp_e, sp_o = sp_e & cv_e & keep, sp_o & cv_o & keep
                    sp = unpack(sp_e, sp_o)
                    sp_lo, sp_hi = sp[:, 0::2], sp[:, 1::2]
                    mg += radius
                    float_stage(mg, True)
                mask = unpack(mm_e, mm_o)
                th, twc = min(TH, h_ - ty0), min(tw, w_ - tx0)
                crop = (slice(halo, halo + th), slice(halo, halo + twc))
                out[b, ty0:ty0 + th, tx0:tx0 + twc] = np.where(mask[crop], s[crop], np.float32(0))
    return out


def _maps(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return (rng.rand(*shape) ** 4).astype(np.float32)
    if kind == "ties":  # coarse values: many exact ties between neighbours
        return (rng.randint(0, 6, shape) / 5.0).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)  # signed: -inf padding matters


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("kind", ["random", "ties", "signed"])
@pytest.mark.parametrize("shape", [(2, 61, 333), (1, 120, 70)])
def test_tile_nms_bit_equal_to_simple_nms(dtype, radius, kind, shape):
    """Widths 333 and 70 (neither a multiple of 32), two row tiles at 61
    and 120 rows; bf16 maps go through the mirror as their exact f32
    values."""
    s = torch.from_numpy(_maps(kind, shape, sum(shape) + radius)).to(dtype)
    ref = simple_nms(s, radius).float().numpy()
    got = tile_nms(s.float().numpy(), radius)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("num_iters", [0, 1, 3])
def test_tile_nms_other_iteration_counts(num_iters):
    s = _maps("ties", (1, 50, 90), num_iters)
    ref = simple_nms(torch.from_numpy(s), 2, num_iters).numpy()
    np.testing.assert_array_equal(_bits(tile_nms(s, 2, num_iters)), _bits(ref))


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_tile_nms_bit_equal_to_pallas_interpret(radius, kind):
    """Non-negative maps (the Pallas kernel pads with zeros), H a multiple
    of 8 as it requires, W = 200."""
    s = _maps(kind, (2, 64, 200), 7 + radius)
    pal = np.asarray(simple_nms_pallas(jnp.asarray(s), radius, interpret=True))
    np.testing.assert_array_equal(_bits(tile_nms(s, radius)), _bits(pal))


@pytest.mark.parametrize("radius", [2, 4])
def test_word_dilation_is_the_binary_pool(radius):
    """The column OR and the funnel-shifted row ORs over E / O words equal
    maxpool(mask) > 0 away from the region's border."""
    rng = np.random.RandomState(radius)
    lh = 40
    mask = rng.rand(lh, LW) < 0.03
    e, o = pack(mask)
    de, do = dilate_words(e, o, radius, lh - radius, radius)
    ref = max_pool_2d(torch.from_numpy(mask.astype(np.float32)), radius).numpy() > 0
    got = unpack(de, do)
    inner = (slice(radius, lh - radius), slice(0, LW))
    np.testing.assert_array_equal(got[inner], ref[inner])
    assert np.array_equal(unpack(*pack(mask)), mask)


@pytest.mark.parametrize("radius", [2, 4])
def test_pair_pool_is_max_pool(radius):
    """The column pass by doubling spans and the row pass on pairs with the
    stitch equal the plain separable max pool inside the region."""
    rng = np.random.RandomState(10 + radius)
    lh = 37
    a = rng.randn(lh, LW).astype(np.float32)
    v_lo, v_hi = column_pool(a[:, 0::2], a[:, 1::2], radius, lh - radius, radius)
    m_lo, m_hi = row_pool(v_lo, v_hi, radius)
    got = np.zeros_like(a)
    got[:, 0::2], got[:, 1::2] = m_lo, m_hi
    ref = max_pool_2d(torch.from_numpy(a), radius).numpy()
    inner = (slice(radius, lh - radius), slice(radius, LW - radius))
    np.testing.assert_array_equal(got[inner], ref[inner])
