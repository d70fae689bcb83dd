"""The Aachen front end of the port against pram_tpu on the CPU, in f32, at a
small size: scripts/bench_aachen.py's ``front`` (SFD2 extraction, then
SegNetViT at n_class 513 over the keypoints) on one 96 x 128 rendered view.

- Extraction with weights/sfd2_rendered.msgpack (fully convolutional, so
  any image size), float and int8. The int8 extractor is calibrated on 2
  other rendered views of the same size, as the bench calibrates on 2
  views at its resolution (bench_aachen.py:169-189): the port's
  calibration equals the JAX package's (int8 weights within one step on
  >= 99.99%, scales and biases within 1e-5 of their scale, as
  tests/test_torch_int8.py holds it at 480 x 640), and the JAX qparams,
  carried across, extract as the JAX int8 extractor does. Keypoint sets
  agree on >= 99% and descriptors by cosine >= 0.999, the bounds
  tests/test_torch_extractor.py and tests/test_torch_int8.py hold. (The
  port's own calibration, one int8 step off on a few weights, moves near-
  tied maxima of this small view: 94% of the keypoint set.)
- SegNetViT nc513 (2 of its 15 layers, d 256) from JAX-initialised params
  carried across, on the JAX extraction's seg descriptors and keypoints
  with their mask: logits within 1e-4 (f32 sums in another order), the
  same argmax on every valid token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.models.segnetvit import SegNetViT as JaxSegNetViT
from pram_tpu.models.segnetvit import SegNetViTConfig as JaxSegNetViTConfig
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.models.sfd2 import extract as jax_extract
from pram_tpu.models.sfd2 import preprocess_image as jax_preprocess
from pram_tpu.models.sfd2_int8 import quantize_extractor as jax_quantize_extractor
from pram_tpu_torch.engine.rendered_guard import SFD2_W, extraction_agreement
from pram_tpu_torch.maps.rendered import make_world, query_pose
from pram_tpu_torch.models.convert import int8_extractor_state, load_sfd2, segnetvit_state_dict
from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
from pram_tpu_torch.models.sfd2 import extract, preprocess_image
from pram_tpu_torch.models.sfd2_int8 import Int8ResNet4x, quantize_extractor
from pram_tpu_torch.ops import keypoints as tkp

H, W = 96, 128
FOCAL = 500.0 * W / 1024  # the bench's 500 px at 1024 wide, scaled
N_KPTS = 512
N_CLASS = 513
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def views():
    """Three rendered views at 96 x 128: two to calibrate, one to extract."""
    world = make_world(np.random.RandomState(0))
    rng = np.random.RandomState(99)
    cam = (FOCAL, FOCAL, W / 2, H / 2)
    return np.stack([world.render(*query_pose(rng), cam, W, H) for _ in range(3)]).astype(np.float32)


def _jax_feats(out):
    k = out["keypoints"]
    return {"keypoints": tkp.Keypoints(T(np.array(k.xy)), T(np.array(k.scores)), T(np.array(k.mask))),
            "descriptors": T(np.array(out["descriptors"]))}


@pytest.fixture(scope="module")
def extractions(views):
    """(JAX float, port float, JAX int8, port int8) extractions of view 2,
    and (the JAX qparams' state, the port's calibrated state)."""
    jm = JaxResNet4x()
    tmpl = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    with open(SFD2_W, "rb") as f:
        variables = serialization.from_bytes(tmpl, f.read())
    x = jax_preprocess(jnp.asarray(views[2:]))
    kw = dict(max_keypoints=N_KPTS, conf_th=1e-4)
    jf = jax_extract(jm, variables, x, **kw)
    jq_model, qparams = jax_quantize_extractor(jm, variables, jax_preprocess(jnp.asarray(views[:2])))
    jq = jax_extract(jq_model, qparams, x, **kw)
    model = load_sfd2(SFD2_W, device="cpu")
    tx = preprocess_image(T(views[2:]))
    tf = extract(model, tx, **kw)
    state = int8_extractor_state(jax.tree_util.tree_map(np.array, qparams))
    tq = extract(Int8ResNet4x(state), tx, **kw)
    calibrated = dict(quantize_extractor(model, preprocess_image(T(views[:2]))).named_buffers())
    return jf, tf, jq, tq, (state, calibrated)


def test_aachen_int8_calibration_matches_pram_tpu(extractions):
    ref, got = extractions[4]
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if r.dtype == torch.int8:
            diff = (g.int() - r.int()).abs()
            assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.9999, name
        else:
            assert ((g - r).abs() <= 1e-5 * r.abs().max().clamp(min=1e-30)).all(), name


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_aachen_extraction_matches_pram_tpu(extractions, kind):
    jf, tf, jq, tq, _ = extractions
    jout, tout = (jf, tf) if kind == "float" else (jq, tq)
    ab = extraction_agreement(tout, _jax_feats(jout))
    assert ab["kpt_set_agreement"] >= 0.99 and ab["desc_cos_min"] >= 0.999, ab
    assert int(tout["keypoints"].mask.sum()) >= 50
    assert tout["seg_descriptors"].shape == (1, N_KPTS, 256)


def test_segnetvit_nc513_matches_pram_tpu(extractions):
    jf = extractions[0]
    k = jf["keypoints"]
    desc = np.array(jf["seg_descriptors"])
    kpts = np.array(k.xy) / np.array([W, H], np.float32) - 0.5
    mask = np.array(k.mask)
    jm = JaxSegNetViT(JaxSegNetViTConfig(n_class=N_CLASS, n_layers=2))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 256)), jnp.zeros((1, 8, 2)))
    ref = np.asarray(jax.jit(jm.apply)(variables, desc, kpts, mask)["prediction"])
    tm = SegNetViT(SegNetViTConfig(n_class=N_CLASS, n_layers=2))
    tm.load_state_dict(segnetvit_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        got = tm(T(desc), T(kpts), T(mask))["prediction"].numpy()
    assert got.shape == (1, N_KPTS, N_CLASS)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[mask].argmax(-1), ref[mask].argmax(-1))
