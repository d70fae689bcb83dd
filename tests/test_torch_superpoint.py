"""The port's SuperPoint, DescriptorCompressor and RetNet against pram_tpu's,
on the CPU in f32.

Each model is built from the JAX package's own init (``Module.init`` at a
fixed PRNGKey), carried over by the flax -> port state dicts of
``models/convert.py`` with ``strict=True``; inputs are numpy draws from
fixed seeds. Tolerances:

- SuperPoint at 120 x 160: the dense maps within 1e-4 (atol and rtol;
  XLA's and oneDNN's convolutions sum in other orders); ``extract`` at
  radius 3 (the ``superpoint-n4096`` config: conf_th 0.005, border 4, at
  most 512 keypoints here), run on the JAX model's own dense maps, gives the
  same keypoints and scores and descriptors within 1e-5; end to end, from
  the port's own maps, at least 99% of the keypoints are the JAX ones (a
  seeded head scores every cell near 1/65, so the last bits of the
  convolutions' sums reorder a few near-equal maxima) and the common ones'
  descriptors within 1e-4. The port's NMS on a CPU tensor is the plain
  version, bit-equal to kernel 9 (tests/test_torch_nms_tile.py); the JAX
  SuperPoint calls its plain ``simple_nms``.
- A reference SuperPoint state dict (tests/torch_mirrors.py:TorchSuperPoint)
  converted by both packages' ``convert_superpoint``: equal trees, and the
  port's model loaded from it (through ``cli.extract_features.build_extractor``'s
  checkpoint path) within 1e-4 of the mirror's outputs.
- DescriptorCompressor (64 and 32) within 1e-5, through ``build_compressor``
  from a reference checkpoint as well; RetNet on a 12 x 16 map of 256
  channels with random BatchNorm statistics within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.models import convert as jconvert
from pram_tpu.models.retnet import RetNet as JRetNet
from pram_tpu.models.sfd2 import DescriptorCompressor as JCompressor
from pram_tpu.models.superpoint import SuperPoint as JSuperPoint
from pram_tpu.models.superpoint import extract as jextract
from pram_tpu_torch.cli import extract_features
from pram_tpu_torch.models import convert as tconvert
from pram_tpu_torch.models.retnet import RetNet
from pram_tpu_torch.models.sfd2 import DescriptorCompressor
from pram_tpu_torch.models.superpoint import SuperPoint, extract, preprocess_image
from tests.torch_mirrors import TorchSuperPoint

T = torch.from_numpy
H, W = 120, 160
SP_CONF = extract_features.CONFS["superpoint-n4096"]["model"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _image(seed, n=2):
    """Smooth grayscale images with edges and blobs (corners for the detector)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W] / 10.0
    out = []
    for _ in range(n):
        a = rng.rand(4)
        img = 0.5 + 0.25 * np.sin(xx * a[0] + yy * a[1]) * np.cos(xx * a[2] - yy * a[3])
        img += 0.2 * ((xx * 10 // 20 + yy * 10 // 20) % 2)
        out.append(np.clip(img + rng.randn(H, W) * 0.02, 0, 1))
    return np.stack(out)[..., None].astype(np.float32)


@pytest.fixture(scope="module")
def superpoint():
    jmodel = JSuperPoint()
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1))))
    model = SuperPoint()
    model.load_state_dict(tconvert.superpoint_state_dict(variables["params"]), strict=True)
    return jmodel, variables, model.eval()


def test_superpoint_forward_matches_pram_tpu(superpoint):
    jmodel, variables, model = superpoint
    img = _image(0)
    ref = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(T(img))
    for k in ("score_map", "desc_map", "mid_features"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4, err_msg=k)


class _Dense(torch.nn.Module):
    """A model whose forward gives fixed dense maps (the JAX model's)."""

    def __init__(self, maps):
        super().__init__()
        self.maps = {k: T(np.asarray(v)) for k, v in maps.items()}

    def forward(self, image):
        return self.maps


def test_superpoint_extract_matches_pram_tpu(superpoint):
    jmodel, variables, model = superpoint
    img = _image(1)
    kw = dict(max_keypoints=512, conf_th=SP_CONF["conf_th"], min_keypoints=SP_CONF["min_keypoints"],
              nms_radius=SP_CONF["nms_radius"], border=4)
    ref = jextract(jmodel, variables, jnp.asarray(img), **kw)
    rk = ref["keypoints"]
    # the extraction itself, on the JAX model's dense maps: exact
    same = extract(_Dense({k: ref[k] for k in ("score_map", "desc_map", "mid_features")}), T(img), **kw)
    sk = same["keypoints"]
    np.testing.assert_array_equal(sk.mask.numpy(), np.asarray(rk.mask))
    np.testing.assert_array_equal(sk.xy.numpy(), np.asarray(rk.xy))
    np.testing.assert_array_equal(sk.scores.numpy(), np.asarray(rk.scores))
    for k in ("descriptors", "seg_descriptors"):
        np.testing.assert_allclose(same[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0, err_msg=k)
    assert same["descriptors"].shape == (2, 512, 256) and same["seg_descriptors"].shape == (2, 512, 256)
    assert int(sk.mask.sum()) > 100
    # end to end, from the port's own dense maps
    got = extract(model, T(img), **kw)
    gk = got["keypoints"]
    for i in range(2):
        jxy = {tuple(p) for p in np.asarray(rk.xy[i])[np.asarray(rk.mask[i])]}
        gxy = gk.xy[i][gk.mask[i]].numpy()
        common = np.array([tuple(p) in jxy for p in gxy])
        assert common.mean() >= 0.99 and len(gxy) == len(jxy)
        jidx = {tuple(p): j for j, p in enumerate(np.asarray(rk.xy[i]))}
        rows = [jidx[tuple(p)] for p in gxy[common]]
        for k in ("descriptors", "seg_descriptors"):
            np.testing.assert_allclose(got[k][i][gk.mask[i]][T(common)].numpy(), np.asarray(ref[k][i])[rows],
                                       atol=1e-4, rtol=0, err_msg=k)


def test_superpoint_preprocess_is_gray():
    rgb = np.random.RandomState(2).rand(1, 8, 8, 3).astype(np.float32)
    gray = preprocess_image(T(rgb))
    ref = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    np.testing.assert_allclose(gray[..., 0].numpy(), ref, atol=1e-6)
    assert torch.equal(preprocess_image(gray), gray)


def test_superpoint_reference_checkpoint(tmp_path):
    torch.manual_seed(3)
    mirror = TorchSuperPoint().eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    ours, theirs = tconvert.convert_superpoint(sd), jconvert.convert_superpoint(sd)
    assert sorted(ours["params"]) == sorted(theirs["params"])
    for name, p in theirs["params"].items():
        for leaf, v in p.items():
            np.testing.assert_array_equal(ours["params"][name][leaf], v)
    path = str(tmp_path / "superpoint.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model, ext, pre = extract_features.build_extractor(extract_features.CONFS["superpoint-n4096"], path, "cpu")
    assert ext is extract and pre is preprocess_image
    img = _image(4, 1)
    with torch.no_grad():
        score, desc, cda = mirror(T(img).permute(0, 3, 1, 2))
        got = model(T(img))
    np.testing.assert_allclose(got["score_map"].numpy(), score.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["desc_map"].numpy(), desc.permute(0, 2, 3, 1).numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["mid_features"].numpy(), cda.permute(0, 2, 3, 1).numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("outdim", [64, 32])
def test_descriptor_compressor_matches_pram_tpu(outdim, tmp_path):
    rng = np.random.RandomState(outdim)
    descs = rng.randn(2, 50, 128).astype(np.float32)
    jmodel = JCompressor(outdim=outdim)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(outdim), jnp.zeros((1, 128))))
    model = DescriptorCompressor(outdim)
    model.load_state_dict(tconvert.compressor_state_dict(variables["params"]), strict=True)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(descs)))
    with torch.no_grad():
        got = model(T(descs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # a reference checkpoint (a 1x1 Conv1d 'conv') through build_compressor
    conv = torch.nn.Conv1d(128, outdim, 1)
    path = str(tmp_path / "comp.pth")
    torch.save({"state_dict": {f"conv.{k}": v for k, v in conv.state_dict().items()}}, path)
    sd = {f"conv.{k}": v.detach().numpy() for k, v in conv.state_dict().items()}
    jtree = jconvert.convert_descriptor_compressor(sd)
    np.testing.assert_array_equal(tconvert.convert_descriptor_compressor(sd)["params"]["conv"]["kernel"],
                                  jtree["params"]["conv"]["kernel"])
    fn = extract_features.build_compressor(outdim, path, "cpu")
    ref = np.asarray(jmodel.apply(jtree, jnp.asarray(descs)))
    np.testing.assert_allclose(fn(descs).numpy(), ref, atol=1e-5, rtol=0)
    assert extract_features.build_compressor(128) is None


def test_retnet_matches_pram_tpu():
    rng = np.random.RandomState(5)
    x = np.maximum(rng.randn(2, 12, 16, 256), 0).astype(np.float32)
    jmodel = JRetNet()
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(5), jnp.zeros((1, 8, 8, 256))))
    # BatchNorm statistics and the GeM exponent off their init, so that they count
    stats = jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32) * 0.5
                                   + (0.75 if a.ndim else 0), variables["batch_stats"])
    params = dict(variables["params"])
    params["gem_p"] = np.array([2.5], np.float32)
    variables = {"params": params, "batch_stats": stats}
    model = RetNet()
    model.load_state_dict(tconvert.retnet_state_dict(variables), strict=True)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(T(x)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
