"""cli.inference with ``network: segnet`` and ``matching_method: gm`` against
pram_tpu's, on the CPU.

The tiny offline scene of tests/test_torch_cli.py (6 queries of 128
keypoints, SFD2-like 128-d caches, 3 clusters), a 2-layer SegNet and GM at
2 layer pairs (``GMConfig`` cut in both packages the way the training CLI
tests cut ``GMLConfig``; the JAX CLI builds ``GMConfig()`` itself). The
port reads the JAX CLIs' own flax inits (PRNGKey 0) from ``.msgpack``
files under tmp_path: the recognizer through ``--rec_weight_path``, GM
through ``--matcher_weight_path`` (the JAX CLI drops a weight path given
for GM; the port takes a flax file and refuses a reference checkpoint,
for which no converter exists).

Two faults of the JAX CLI at these names are patched on its side, as
tests/test_torch_cli.py patches its match function: its recognizer call
``rec.apply(vars, d, k, m)`` hands SegNet the mask as its third argument,
the keypoint scores, so SegNet runs unmasked (the port passes the mask by
name); and its ``build_match_fn`` closure gives ``(matches, scores)``,
which its localizer cannot take. The port's RANSAC is fed the JAX CLI's
Gumbel noise (its evaluator's key split per batch, then per query and
candidate, tests/test_torch_aachen.py:_jax_gumbel_sampler): GM's matches
leave some queries few inliers, where hypotheses drawn apart polish to
poses a centimetre apart. Tolerances as tests/test_torch_cli.py's: the same
success flags, bucket counts and failed cases, poses within 0.1 deg / 5 mm.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import pram_tpu.engine.evaluator as jev
import pram_tpu.models.gm as jgm
import pram_tpu.models.registry as jregistry
from pram_tpu.cli import inference as j_inference
from pram_tpu_torch.cli import inference
from pram_tpu_torch.cli.match_features import build_match_fn
from pram_tpu_torch.engine.localizer import Localizer
from pram_tpu_torch.geometry import pnp as tpnp
from pram_tpu_torch.models import convert as tconvert
from pram_tpu_torch.models.gm import GMConfig
from tests.test_torch_aachen import _jax_gumbel_sampler
from tests.test_torch_cli import LOC, _offline_scene, _same_reports, _write_msgpack, jax_matches_only  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_segnet_masked(monkeypatch):
    """pram_tpu's build_recognizer, its SegNet given the mask as the mask."""
    build = jregistry.build_recognizer

    class Masked:
        def __init__(self, model):
            self.model = model

        def init(self, key, d, k):
            return self.model.init(key, d, k)

        def apply(self, variables, d, k, m):
            return self.model.apply(variables, d, k, None, m)

    def masked(name, config=None):
        model = build(name, config)
        return Masked(model) if name == "segnet" else model

    monkeypatch.setattr(jregistry, "build_recognizer", masked)


@pytest.fixture
def two_gm_layers(monkeypatch):
    monkeypatch.setattr(jgm, "GMConfig", functools.partial(jgm.GMConfig, n_layers=2))
    monkeypatch.setattr(tconvert, "GMConfig", functools.partial(GMConfig, n_layers=2))


def test_inference_main_segnet_gm_matches_pram_tpu(tmp_path, jax_matches_only, jax_segnet_masked, two_gm_layers,
                                                     monkeypatch):
    scene, queries, names = _offline_scene(tmp_path)
    top = {"network": "segnet", "feat_dim": 128, "use_mid_feature": False, "layers": 2,
           "eval_max_keypoints": 128, "localization": {**LOC, "matching_method": "gm"}}
    cfg = str(chip_smoke.synthetic_layout(tmp_path, scene, queries, names, 3, top))
    # the JAX CLI's inits, carried across as msgpack files
    z, k, s = jnp.zeros((1, 8, 128)), jnp.zeros((1, 8, 2)), jnp.zeros((1, 8))
    jrec = jregistry.build_recognizer("segnet", {"descriptor_dim": 128, "output_dim": 1024, "n_class": 4,
                                                 "n_layers": 2})
    rec_w = _write_msgpack(tmp_path / "segnet.msgpack", jrec.init(jax.random.PRNGKey(0), z, k))
    gm_w = _write_msgpack(tmp_path / "gm.msgpack",
                          jgm.GM(jgm.GMConfig()).init(jax.random.PRNGKey(0), z, z, k, k, s, s))
    caught = []
    evaluate = jev.evaluate_queries
    monkeypatch.setattr(jev, "evaluate_queries", lambda *a, **kw: caught.append(evaluate(*a, **kw)) or caught[-1])
    j_inference.main(["--config", cfg, "--batch", "4"])
    key = [jax.random.PRNGKey(0)]  # pram_tpu's evaluate_queries: key, sub = split(key) a batch

    def localize(self, generator, camera, kpts, *a, _f=Localizer.localize_batch, **kw):
        key[0], sub = jax.random.split(key[0])
        monkeypatch.setattr(tpnp, "_sample_triplets", _jax_gumbel_sampler(sub, kpts.shape[0], self.cfg.seg_k))
        return _f(self, generator, camera, kpts, *a, **kw)

    monkeypatch.setattr(Localizer, "localize_batch", localize)
    ours = inference.main(["--config", cfg, "--batch", "4", "--rec_weight_path", rec_w,
                           "--matcher_weight_path", gm_w, "--device", "cpu"])
    _same_reports(ours, caught[0])
    assert ours.n_total == len(names) and ours.n_success >= 3


def test_gm_weight_paths(tmp_path):
    """A reference checkpoint given for GM raises; the seeded GM and a
    flax file load; the recognizer takes a reference SegNet checkpoint by
    its own converter."""
    with pytest.raises(ValueError, match="no converter"):
        build_match_fn("gm", str(tmp_path / "gm.pth"), "cpu")
    assert callable(build_match_fn("gm", None, "cpu"))
    from tests.torch_mirrors import TorchSegNet

    torch.manual_seed(8)
    mirror = TorchSegNet(desc_dim=128, n_class=9, n_layers=2).eval()
    path = str(tmp_path / "segnet.pth")
    torch.save({"model": mirror.state_dict()}, path)
    model = inference.load_recognizer(
        "segnet", {"descriptor_dim": 128, "output_dim": 1024, "n_class": 9, "n_layers": 2}, path, "cpu")
    x, nk = torch.randn(1, 30, 128), torch.rand(1, 30, 2) - 0.5
    with torch.no_grad():
        torch.testing.assert_close(model(x, nk)["prediction"], mirror(x, nk), atol=5e-4, rtol=1e-3)
