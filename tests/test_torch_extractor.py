"""The port's SFD2 extractor against pram_tpu on the CPU.

The JAX side runs as its own tests run it here: its XLA path, and the
Pallas kernels with ``interpret=True``. The port runs its plain versions
(the kernels' wrappers take them for CPU tensors). Tolerances:
- plain stem: rtol = atol = 1e-4 in f32 against the Pallas stem and the
  unfused conv + BN + ReLU chain (f32 sums in another order, and BN folded
  on one side only);
- NMS: exactly equal (max and equality are exact), f32 and bf16;
- keypoint selection: xy, scores and mask exactly equal on the same map;
- descriptor sampling: 1e-5 in f32;
- ResNet4x with the rendered weights at 480 x 640 in f32: each dense output
  within 1e-3 of its max-abs (measured ~2e-5 relative for score_map and
  mid_features); keypoint-set agreement >= 0.99 and descriptor cosine on the
  common set >= 0.999.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.maps.rendered import make_world, ref_poses
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.models.sfd2 import extract as jax_extract
from pram_tpu.models.sfd2 import preprocess_image as jax_preprocess
from pram_tpu.ops.keypoints import extract_keypoints as jax_extract_keypoints
from pram_tpu.ops.keypoints import normalize_keypoints as jax_normalize_keypoints
from pram_tpu.ops.nms import simple_nms as jax_simple_nms
from pram_tpu.ops.nms_pallas import simple_nms_pallas
from pram_tpu.ops.sampling import sample_descriptors as jax_sample_descriptors
from pram_tpu.ops.stem_pallas import fold_bn as jax_fold_bn
from pram_tpu.ops.stem_pallas import fused_stem as jax_fused_stem
from pram_tpu_torch.engine.rendered_guard import extraction_agreement
from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
from pram_tpu_torch.models.convert import load_sfd2, sfd2_state_dict
from pram_tpu_torch.models.sfd2 import extract, preprocess_image
from pram_tpu_torch.ops import keypoints as tkp
from pram_tpu_torch.ops.nms import max_pool_2d, nms, simple_nms
from pram_tpu_torch.ops.sampling import sample_descriptors
from pram_tpu_torch.ops.stem import fold_bn, fused_stem, fused_stem_plain

SFD2_W = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "sfd2_rendered.msgpack",
)
T = torch.from_numpy


def _stem_params(rng):
    """Random conv1a/conv1b kernels (flax HWIO), biases and BN tuples."""

    def t(*s):
        return (rng.randn(*s) * 0.5).astype(np.float32)

    k1, b1 = t(3, 3, 3, 64), t(64)
    bn1 = (t(64) * 0.2 + 1.0, t(64), t(64) * 0.1, np.abs(t(64)) + 0.5)
    k2, b2 = t(3, 3, 64, 64) * 0.2, t(64)
    bn2 = (t(64) * 0.2 + 1.0, t(64), t(64) * 0.1, np.abs(t(64)) + 0.5)
    return k1, b1, bn1, k2, b2, bn2


def _jax_unfused_stem(image, k1, b1, bn1, k2, b2, bn2):
    """conv + bias -> BN (inference, eps 1e-5) -> ReLU, twice, unfolded."""

    def layer(x, k, b, bn, stride):
        y = jax.lax.conv_general_dilated(
            x, k, (stride, stride), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + b
        scale, bias, mean, var = bn
        return jnp.maximum((y - mean) * (scale / jnp.sqrt(var + 1e-5)) + bias, 0.0)

    return layer(layer(image, k1, b1, bn1, 1), k2, b2, bn2, 2)


def _port_stem_args(k1, b1, bn1, k2, b2, bn2):
    oihw = lambda k: T(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))  # noqa: E731
    return (oihw(k1), T(b1), tuple(T(a) for a in bn1), oihw(k2), T(b2), tuple(T(a) for a in bn2))


@pytest.mark.parametrize("h,w,b", [(32, 16, 1), (48, 20, 2), (64, 32, 1)])
def test_plain_stem_matches_pallas_and_unfused(rng, h, w, b):
    image = rng.randn(b, h, w, 3).astype(np.float32)
    params = _stem_params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    got = fused_stem_plain(T(image), *_port_stem_args(*params)).numpy()
    assert got.shape == (b, h // 2, w // 2, 64)
    pallas = np.asarray(jax_fused_stem(jnp.asarray(image), *jparams, interpret=True))
    unfused = np.asarray(_jax_unfused_stem(jnp.asarray(image), *jparams))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, unfused, rtol=1e-4, atol=1e-4)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_stem(T(image), *_port_stem_args(*params)).numpy(), got)


def test_fold_bn_matches_pram_tpu(rng):
    k1, b1, bn1, k2, b2, bn2 = _stem_params(rng)
    tk1, tb1, tbn1 = _port_stem_args(k1, b1, bn1, k2, b2, bn2)[:3]
    kf, bf = fold_bn(tk1, tb1, *tbn1)
    jk, jb = jax_fold_bn(jnp.asarray(k1), jnp.asarray(b1), *(jnp.asarray(a) for a in bn1))
    np.testing.assert_allclose(kf.numpy(), np.asarray(jk).transpose(3, 2, 0, 1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_plain_stem_odd_sizes_match_unfused(rng):
    """Any H and W: the stride-2 output is ceil(H/2) x ceil(W/2)."""
    image = rng.randn(2, 25, 37, 3).astype(np.float32)
    params = _stem_params(rng)
    got = fused_stem_plain(T(image), *_port_stem_args(*params)).numpy()
    ref = np.asarray(_jax_unfused_stem(jnp.asarray(image), *jax.tree_util.tree_map(jnp.asarray, params)))
    assert got.shape == ref.shape == (2, 13, 19, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _peaks(h, w):
    s = np.zeros((2, h, w), np.float32)
    s[0, 10, 20] = 1.0
    s[0, 12, 22] = 0.5  # within the stronger peak's radius
    s[0, 40, 100] = 0.8
    s[1, 3, 3] = 0.7
    s[1, 5, 9] = 0.7  # a second peak of the same score
    s[1, h - 1, w - 1] = 0.2  # a corner
    return s


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("kind", ["random", "peaks", "quantized"])
def test_plain_nms_equals_pram_tpu(rng, radius, kind):
    h, w = 64, 136
    if kind == "random":
        s = np.abs(rng.randn(2, h, w)).astype(np.float32)
    elif kind == "peaks":
        s = _peaks(h, w)
    else:  # coarse values: many exact ties between neighbours
        s = (rng.randint(0, 6, (2, h, w)) / 5.0).astype(np.float32)
    got = simple_nms(T(s), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_simple_nms(jnp.asarray(s), radius)))
    np.testing.assert_array_equal(got, np.asarray(simple_nms_pallas(jnp.asarray(s), radius, interpret=True)))
    np.testing.assert_array_equal(nms(T(s), radius).numpy(), got)
    if kind == "peaks":
        assert got[0, 10, 20] == 1.0 and got[0, 40, 100] == 0.8
        assert got[0, 12, 22] == 0.0


@pytest.mark.parametrize("radius", [2, 4])
def test_plain_nms_bf16_equals_pram_tpu(rng, radius):
    s = np.abs(rng.randn(2, 48, 72)).astype(np.float32)
    tb = T(s).to(torch.bfloat16)
    got = simple_nms(tb, radius)
    assert got.dtype == torch.bfloat16
    ref = jax_simple_nms(jnp.asarray(s, jnp.bfloat16), radius)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_max_pool_2d_pads_with_minus_inf(rng):
    x = -np.abs(rng.randn(1, 9, 11)).astype(np.float32) - 1.0  # all negative
    got = max_pool_2d(T(x), 3).numpy()
    ref = np.full_like(x, -np.inf)
    for i in range(9):
        for j in range(11):
            ref[0, i, j] = x[0, max(i - 3, 0): i + 4, max(j - 3, 0): j + 4].max()
    np.testing.assert_array_equal(got, ref)


def _check_keypoints(s, **kw):
    got = tkp.extract_keypoints(T(np.array(s)), **kw)
    ref = jax_extract_keypoints(jnp.asarray(s), **kw)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    return got


def test_extract_keypoints_equals_pram_tpu(rng):
    s = np.abs(rng.randn(2, 96, 128)).astype(np.float32) ** 4 * 0.01
    nmsd = np.asarray(jax_simple_nms(jnp.asarray(s), 4))
    got = _check_keypoints(nmsd, max_keypoints=200, conf_th=0.005, min_keypoints=32)
    assert got.mask.sum() > 0


def test_extract_keypoints_ties_in_index_order(rng):
    """Equal scores in many 4x4 blocks: the top-k keeps the lower indices,
    as lax.top_k does, through the block reduction and without it."""
    s = np.zeros((2, 64, 96), np.float32)
    ys, xs = np.meshgrid(np.arange(2, 62, 9), np.arange(2, 94, 9), indexing="ij")
    s[:, ys, xs] = 0.25
    s[0, 20, 20] = 0.5
    s[1, ys[::2], xs[::2]] = 0.125
    s[1, 40, 41] = s[1, 41, 40] = 0.25  # ties inside one 4x4 block
    _check_keypoints(s, max_keypoints=40, conf_th=0.005, min_keypoints=8)
    _check_keypoints(s, max_keypoints=40, conf_th=0.005, min_keypoints=8, nms_radius=2)


def test_extract_keypoints_adaptive_threshold(rng):
    """Too few maxima above conf_th: the threshold is halved (counted before
    the border is removed)."""
    s = np.zeros((2, 64, 64), np.float32)
    s[:, 10, 10] = 0.006
    s[:, 30, 30] = 0.003  # only passes the halved threshold
    s[:, 1, 1] = 0.02  # in the border: counted, then removed
    s[1, 50:60:5, 50:60:5] = 0.01
    got = _check_keypoints(s, max_keypoints=16, conf_th=0.005, min_keypoints=2)
    assert bool(got.mask[0, 1]) and bool(got.mask[1, 4]) and not bool(got.mask[1, 5])


def test_normalize_keypoints_equals_pram_tpu(rng):
    k = (rng.rand(3, 10, 2) * [640, 480]).astype(np.float32)
    np.testing.assert_allclose(
        tkp.normalize_keypoints(T(k), (480, 640)).numpy(),
        np.asarray(jax_normalize_keypoints(jnp.asarray(k), (480, 640))), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("stride", [4, 8])
def test_sample_descriptors_equals_pram_tpu(rng, stride):
    hc, wc, c = 12, 20, 16
    dmap = rng.randn(c, hc, wc).astype(np.float32)
    h, w = hc * stride, wc * stride
    k = np.concatenate([
        rng.rand(40, 2) * [w - 1, h - 1],
        [[0, 0], [w - 1, h - 1], [0.3, h - 1.2], [w - 0.6, 0.4], [-0.5, 3.0], [w + 0.5, 5.0]],
    ]).astype(np.float32)
    ref = np.asarray(jax_sample_descriptors(jnp.asarray(k), jnp.asarray(dmap), stride))
    got = sample_descriptors(T(k), T(dmap), stride).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # batched, with the map in channels_last memory
    bmap = T(np.stack([dmap, -dmap])).contiguous(memory_format=torch.channels_last)
    got2 = sample_descriptors(T(np.stack([k, k])), bmap, stride).numpy()
    np.testing.assert_allclose(got2[0], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got2[1], -ref, rtol=1e-5, atol=1e-5)


def test_sfd2_weights_convert_every_leaf():
    tree = read_flax_msgpack(SFD2_W)
    n_leaves = 0
    stack = [tree]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                n_leaves += 1
    assert n_leaves == 101
    sd = sfd2_state_dict(tree)
    assert sd["res.0.conv2.weight"].shape == (256, 8, 3, 3)
    np.testing.assert_array_equal(
        sd["res.1.conv2.weight"].numpy(), tree["params"]["res_1"]["conv2"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(sd["convPa_bn.running_var"].numpy(), tree["batch_stats"]["convPa_bn"]["var"])
    # bf16: every parameter and statistic rounded from its f32 leaf
    m = load_sfd2(SFD2_W, device="cpu", dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        m.conv1a.bn.running_mean.float().numpy(),
        T(tree["batch_stats"]["conv1a"]["bn"]["mean"]).to(torch.bfloat16).float().numpy(),
    )


@pytest.fixture(scope="module")
def rendered_pair():
    """Two rendered reference views of make_world(RandomState(0)) at 480 x 640
    through both extractors (f32, rendered weights)."""
    rng = np.random.RandomState(0)
    world = make_world(rng)
    poses = ref_poses(12, rng)
    cam = (500.0, 500.0, 320.0, 240.0)
    imgs = np.stack([world.render(R, t, cam, 640, 480) for R, t in (poses[1], poses[7])]).astype(np.float32)
    jm = JaxResNet4x()
    tmpl = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 480, 640, 3), jnp.float32))
    with open(SFD2_W, "rb") as f:
        variables = serialization.from_bytes(tmpl, f.read())
    jout = jax_extract(jm, variables, jax_preprocess(jnp.asarray(imgs)), max_keypoints=512, conf_th=1e-4)
    model = load_sfd2(SFD2_W, device="cpu")
    tout = extract(model, preprocess_image(T(imgs)), max_keypoints=512, conf_th=1e-4)
    return jax.tree_util.tree_map(np.array, jout), tout


@pytest.mark.parametrize("key", ["score_map", "desc_map", "mid_features"])
def test_resnet4x_dense_outputs_match_pram_tpu(rendered_pair, key):
    jout, tout = rendered_pair
    got, ref = tout[key].numpy(), jout[key]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_extract_matches_pram_tpu(rendered_pair):
    jout, tout = rendered_pair
    jkp = jout["keypoints"]
    jfeats = {
        "keypoints": tkp.Keypoints(T(jkp.xy), T(jkp.scores), T(jkp.mask)),
        "descriptors": T(jout["descriptors"]),
    }
    ab = extraction_agreement(tout, jfeats)
    assert ab["kpt_set_agreement"] >= 0.99, ab
    assert ab["desc_cos_min"] >= 0.999, ab
    assert tout["keypoints"].mask.sum(-1).min() >= 400
    assert tout["seg_descriptors"].shape == (2, 512, 256)
    norms = torch.linalg.norm(tout["seg_descriptors"][tout["keypoints"].mask], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    # the unfused stem and the plain NMS give the same extraction on the CPU
    model = load_sfd2(SFD2_W, device="cpu")
    model.use_stem_kernel = False
    rng = np.random.RandomState(0)
    world = make_world(rng)
    R, t = ref_poses(12, rng)[1]
    img = world.render(R, t, (500.0, 500.0, 320.0, 240.0), 640, 480).astype(np.float32)[None]
    plain = extract(model, preprocess_image(T(img)), max_keypoints=512, conf_th=1e-4, use_nms_kernel=False)
    one = {"keypoints": tkp.Keypoints(*(a[:1] for a in tout["keypoints"])), "descriptors": tout["descriptors"][:1]}
    ab = extraction_agreement(one, plain)
    assert ab["kpt_set_agreement"] >= 0.99 and ab["desc_cos_min"] >= 0.999, ab
