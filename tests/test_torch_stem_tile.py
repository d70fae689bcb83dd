"""The bf16 stem's formulation (csrc/stem.cu, kernel 8), mirrored on the CPU.

The kernel computes conv1a as an im2col product: each intermediate position
of an 8 x 8-output tile's (2 * 8 + 1)^2 halo takes the 27 taps x channels of
the image (zero outside it: conv1a's padding), zero-padded to K = 32,
against the folded W1 with five zero rows; adds the bias, applies ReLU,
rounds to bf16, and sets every intermediate position outside the image to
zero (conv1b's padding; conv1a evaluated there would give ReLU(bias)). It
keeps the halo as planes of even and odd local columns, and conv1b's tap
(dy, dx) reads even (dx = 0), odd (dx = 1) or even + 1 (dx = 2) entries of
halo row 2 oy + dy: a 64-pixel x 576 product summed tap by tap in f32, plus
the bias, ReLU, bf16. Tiles past the right and bottom edges are computed
and cropped. The products here are f32 sums of the bf16 operands.

Tolerances: against ``fused_stem_plain`` and the JAX ``fused_stem`` in
interpret mode (shapes it takes: H % 16 == 0, W even) within 2e-2 of the
output's scale (chip_smoke.py's STEM_TOL) with >= 99% of the elements
equal: f32 sums in another order move a value across a bf16 rounding
boundary now and then (seen: 0.99975-1.0 equal, 2.7e-3 of scale at most,
against Pallas at 2 x 48 x 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.stem_pallas import fused_stem as jax_fused_stem
from pram_tpu_torch.ops import stem
from test_torch_extractor import _port_stem_args, _stem_params

BF = torch.bfloat16
T = 8  # output rows and columns of a tile


def conv1a_planes(image, w1, c1, zero_outside=True):
    """The intermediate halo of every tile at once, [B, 16 ty + 1, 16 tx +
    1, 64] bf16 values as f32: index (y + 1, x + 1) holds intermediate
    position (y, x), y, x >= -1 (tiles share their edge rows and columns)."""
    b, h, w, _ = image.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    ty, tx = -(-ho // T), -(-wo // T)
    ny, nx = 2 * T * ty + 1, 2 * T * tx + 1
    # image row r at pad row r + 2: position (y, x)'s window starts at pad (y + 1, x + 1)
    pad = torch.zeros(b, ny + 2, nx + 2, 3)
    pad[:, 2:2 + h, 2:2 + w] = image.float()
    cols = [pad[:, dy:dy + ny, dx:dx + nx, c] for dy in range(3) for dx in range(3) for c in range(3)]
    a = torch.stack(cols + [torch.zeros(b, ny, nx)] * 5, -1)  # K = 32, the last 5 zero
    w1k = torch.cat([w1.float().permute(2, 3, 1, 0).reshape(27, 64), torch.zeros(5, 64)])
    mid = torch.relu(a.reshape(-1, 32) @ w1k + c1).reshape(b, ny, nx, 64)
    mid = mid.to(BF).float()
    if zero_outside:
        y = torch.arange(ny) - 1
        x = torch.arange(nx) - 1
        inside = ((y >= 0) & (y < h))[:, None] & ((x >= 0) & (x < w))[None, :]
        mid = mid * inside[None, :, :, None]
    return mid


def conv1b_by_planes(mid, w2, c2, ho, wo):
    """conv1b from the even / odd planes, tap by tap."""
    even, odd = mid[:, :, 0::2], mid[:, :, 1::2]
    b, ny = mid.shape[:2]
    oy_n, ox_n = (ny - 1) // 2, odd.shape[2]
    w2k = w2.float().permute(2, 3, 1, 0)  # [dy, dx, c, n]
    acc = torch.zeros(b, oy_n, ox_n, 64)
    for dy in range(3):
        for dx in range(3):
            plane = odd if dx == 1 else even
            first = 1 if dx == 2 else 0
            a = plane[:, dy:dy + 2 * oy_n:2, first:first + ox_n]
            acc = acc + (a.reshape(-1, 64) @ w2k[dy, dx]).reshape(acc.shape)
    return torch.relu(acc + c2).to(BF)[:, :ho, :wo]


def mirror(image, k1, b1, bn1, k2, b2, bn2, zero_outside=True):
    w1, c1, w2, c2 = stem._folded(k1, b1, bn1, k2, b2, bn2, BF)
    h, w = image.shape[1:3]
    mid = conv1a_planes(image, w1, c1, zero_outside)
    return conv1b_by_planes(mid, w2, c2, (h + 1) // 2, (w + 1) // 2)


def _check(got, ref):
    got, ref = got.float(), ref.float()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    equal = (got == ref).float().mean().item()
    assert err <= 2e-2 and equal >= 0.99, (err, equal)


def _case(seed, b, h, w):
    rng = np.random.RandomState(seed)
    image = rng.randn(b, h, w, 3).astype(np.float32)
    params = _stem_params(rng)
    return image, params


@pytest.mark.parametrize("b,h,w", [(1, 32, 48), (2, 48, 64)])
def test_mirror_matches_plain_and_pallas(b, h, w):
    image, params = _case(h + w, b, h, w)
    x = torch.from_numpy(image).to(BF)
    args = _port_stem_args(*params)
    got = mirror(x, *args)
    _check(got, stem.fused_stem_plain(x, *args))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    pallas = jax_fused_stem(jnp.asarray(image).astype(jnp.bfloat16), *jparams, interpret=True)
    _check(got, torch.from_numpy(np.array(pallas.astype(jnp.float32))))


@pytest.mark.parametrize("b,h,w", [(1, 40, 50), (1, 37, 45)])
def test_mirror_matches_plain_ragged(b, h, w):
    """Tiles past the bottom and right edges, odd sizes."""
    image, params = _case(h * w, b, h, w)
    x = torch.from_numpy(image).to(BF)
    args = _port_stem_args(*params)
    got = mirror(x, *args)
    assert got.shape == (b, (h + 1) // 2, (w + 1) // 2, 64)
    _check(got, stem.fused_stem_plain(x, *args))


def test_out_of_image_intermediate_is_zero_not_relu_bias():
    """Left as conv1a evaluated there, the positions outside the image carry
    ReLU(bias) into conv1b's border outputs; zeroed, they match."""
    image, params = _case(3, 1, 32, 48)
    x = torch.from_numpy(image).to(BF)
    args = _port_stem_args(*params)
    ref = stem.fused_stem_plain(x, *args).float()
    kept = mirror(x, *args, zero_outside=False).float()
    border = torch.zeros_like(ref, dtype=torch.bool)
    border[:, 0], border[:, :, 0] = True, True
    assert (kept - ref)[border].abs().max() > 0.1 * ref.abs().max()
    _check(mirror(x, *args), ref)
