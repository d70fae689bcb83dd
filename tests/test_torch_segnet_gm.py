"""The port's SegNet and GM, and GM's match functions, against pram_tpu's, on
the CPU in f32.

Both models at 2 layers (GM: 2 self / cross pairs) from the JAX package's
own init, carried over by ``models/convert.py``'s ``segnet_state_dict`` /
``gm_state_dict`` with ``strict=True``; inputs are numpy draws from fixed
seeds, with padded tokens where masked. Tolerances:

- SegNet logits within 1e-4 (atol and rtol), unmasked and masked, with the
  instance norm ("in", the default) and with BatchNorm on random running
  statistics plus the score input and the scene-coordinate head ("bn",
  ``with_score``, ``with_sc``).
- GM's plan within 1e-5 entry by entry, with and without Sinkhorn, masked
  and unmasked, and its row argmax equal: a seeded GM gives near-uniform
  plans, whose thresholded mutual matches may be empty, so the plan itself
  is held. The port's Sinkhorn on a CPU tensor is the plain iteration, the
  JAX GM's the XLA one (kernel 6 on the card is held to the plain one
  there).
- ``make_gm_match_fn``, ``with_scores`` and ``nn_with_scores``: the same
  matches as pram_tpu's (at a threshold low enough that a seeded GM
  matches), scores within 1e-5.
- Reference state dicts (tests/torch_mirrors.py:TorchSegNet) converted by
  both packages' ``convert_segnet``: equal trees, and the port's SegNet
  loaded from them within 5e-4 of the mirror, as the JAX package's own
  test holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.engine import matching as jmatching
from pram_tpu.models import convert as jconvert
from pram_tpu.models.gm import GM as JGM
from pram_tpu.models.gm import GMConfig as JGMConfig
from pram_tpu.models.segnet import SegNet as JSegNet
from pram_tpu.models.segnet import SegNetConfig as JSegNetConfig
from pram_tpu_torch.engine import matching
from pram_tpu_torch.models import convert as tconvert
from pram_tpu_torch.models.gm import GM, GMConfig, extract_matches
from pram_tpu_torch.models.registry import build_matcher, build_recognizer
from pram_tpu_torch.models.segnet import SegNet, SegNetConfig
from tests.torch_mirrors import TorchSegNet

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, b, n, d, pad=0):
    rng = np.random.RandomState(seed)
    desc = rng.randn(b, n, d).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    nk = (rng.rand(b, n, 2) - 0.5).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    mask = np.ones((b, n), bool)
    if pad:
        mask[-1, n - pad:] = False
    return desc, nk, scores, mask


SEGNET_CASES = {"in": dict(), "bn": dict(norm_fn="bn", with_score=True, with_sc=True)}


@pytest.fixture(scope="module", params=sorted(SEGNET_CASES))
def segnet(request):
    kw = SEGNET_CASES[request.param]
    cfg = dict(n_layers=2, n_class=9, output_dim=64, **kw)
    jmodel = JSegNet(JSegNetConfig(**cfg))
    z, k = jnp.zeros((1, 8, 256)), jnp.zeros((1, 8, 2))
    init_args = (z, k, jnp.zeros((1, 8))) if kw.get("with_score") else (z, k)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(2), *init_args))
    if "batch_stats" in variables:  # running statistics off their init
        rng = np.random.RandomState(9)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32), variables["batch_stats"])
        variables["params"] = jax.tree_util.tree_map(
            lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.1 if a.ndim == 1 else a, variables["params"])
    model = SegNet(SegNetConfig(**cfg))
    model.load_state_dict(tconvert.segnet_state_dict(variables, 2), strict=True)
    return kw, jmodel, variables, model.eval()


@pytest.mark.parametrize("pad", [0, 13])
def test_segnet_matches_pram_tpu(segnet, pad):
    kw, jmodel, variables, model = segnet
    desc, nk, scores, mask = _tokens(pad, 2, 48, 256, pad)
    m = mask if pad else None
    ref = jmodel.apply(variables, jnp.asarray(desc), jnp.asarray(nk), jnp.asarray(scores),
                       None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got = model(T(desc), T(nk), T(scores), None if m is None else T(m))
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=1e-4, err_msg=k)


def test_segnet_reference_checkpoint():
    torch.manual_seed(8)
    mirror = TorchSegNet(n_class=9, n_layers=2).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    ours, theirs = tconvert.convert_segnet(sd, n_layers=2), jconvert.convert_segnet(sd, n_layers=2)
    assert sorted(ours) == sorted(theirs) == ["params"]
    flat = lambda t: {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    fo, ft = flat(ours), flat(theirs)
    assert sorted(fo) == sorted(ft) and all(np.array_equal(fo[k], ft[k]) for k in ft)
    model = build_recognizer("segnet", {"n_layers": 2, "n_class": 9})
    model.load_state_dict(tconvert.segnet_state_dict(ours, 2), strict=True)
    desc, nk, _, _ = _tokens(4, 1, 40, 256)
    with torch.no_grad():
        ref = mirror(T(desc), T(nk))
        got = model.eval()(T(desc), T(nk))["prediction"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-4, rtol=1e-3)


def _gm(with_sinkhorn):
    cfg = dict(n_layers=2, with_sinkhorn=with_sinkhorn)
    jmodel = JGM(JGMConfig(**cfg))
    z, k, s = jnp.zeros((1, 8, 128)), jnp.zeros((1, 8, 2)), jnp.zeros((1, 8))
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(1), z, z, k, k, s, s))
    variables["params"]["bin_score"] = np.asarray(0.4, np.float32)
    model = GM(GMConfig(**cfg))
    model.load_state_dict(tconvert.gm_state_dict(variables["params"], 2), strict=True)
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def gm_models():
    return {w: _gm(w) for w in (True, False)}


def _pair(pad):
    d0, nk0, s0, m0 = _tokens(10 + pad, 2, 40, 128, pad)
    d1, nk1, s1, m1 = _tokens(20 + pad, 2, 56, 128, pad + 3 if pad else 0)
    # side 1 holds noisy copies of side 0's first 30 descriptors
    d1[:, :30] = d0[:, :30] + np.random.RandomState(pad).randn(2, 30, 128).astype(np.float32) * 0.02
    nk1[:, :30] = nk0[:, :30]
    return d0, d1, nk0, nk1, s0, s1, m0, m1


@pytest.mark.parametrize("with_sinkhorn", [True, False])
@pytest.mark.parametrize("pad", [0, 9])
def test_gm_plan_matches_pram_tpu(gm_models, with_sinkhorn, pad):
    jmodel, variables, model = gm_models[with_sinkhorn]
    d0, d1, nk0, nk1, s0, s1, m0, m1 = _pair(pad)
    masks = (m0, m1) if pad else (None, None)
    ref = np.asarray(jmodel.apply(variables, *map(jnp.asarray, (d0, d1, nk0, nk1, s0, s1)),
                                  *(None if m is None else jnp.asarray(m) for m in masks))["plan"])
    with torch.no_grad():
        got = model(*map(T, (d0, d1, nk0, nk1, s0, s1)), *(None if m is None else T(m) for m in masks))["plan"]
    assert got.shape == ref.shape == (2, 41, 57)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, :-1].argmax(-1).numpy(), ref[:, :-1].argmax(-1))


def test_gm_match_functions_match_pram_tpu(gm_models):
    jmodel, variables, model = gm_models[True]
    d0, d1, nk0, nk1, s0, s1, m0, m1 = _pair(9)
    args = (d0, nk0, s0, m0, d1, nk1, s1, m1)
    targs, jargs = [T(a) for a in args], [jnp.asarray(a) for a in args]
    th = 0.05  # a seeded GM's plans are near-uniform; its matches start below the default 0.2
    with torch.no_grad():
        got = matching.make_gm_match_fn(model, th)(*targs)
        gm_s, sc_s = matching.with_scores(model, th, uses_scores=True)(*targs)
        nn_m, nn_s = matching.nn_with_scores(0.9)(*targs)
    ref = np.asarray(jmatching.make_gm_match_fn(jmodel, variables, th)(*jargs))
    rm, rs = jmatching.with_scores(jmodel, variables, th, uses_scores=True)(*jargs)
    rnm, rns = jmatching.nn_with_scores(0.9)(*jargs)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(gm_s.numpy(), np.asarray(rm))
    np.testing.assert_allclose(sc_s.numpy(), np.asarray(rs), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(nn_m.numpy(), np.asarray(rnm))
    np.testing.assert_allclose(nn_s.numpy(), np.asarray(rns), atol=1e-5, rtol=0)
    assert (got >= 0).sum() > 10 and (nn_m >= 0).sum() > 10
    with torch.no_grad():
        plan = model(*(targs[i] for i in (0, 4, 1, 5, 2, 6, 3, 7)))["plan"]
    assert torch.equal(extract_matches(plan, th).matches0, got)


def test_gm_state_dict_keeps_the_applied_projection():
    """A tree with every final_proj_<i> (as a converted reference checkpoint
    would hold) and more layers than asked: the last projection follows
    the kept layers, the others go; the registry builds the default GM."""
    _, variables, _ = _gm(True)
    params = dict(variables["params"])
    params["final_proj_0"] = params["final_proj_1"]
    sd = tconvert.gm_state_dict(params, 1)
    assert sorted(k for k in sd if k.startswith("final_proj")) == ["final_proj.0.bias", "final_proj.0.weight"]
    assert np.array_equal(sd["final_proj.0.weight"].numpy(), params["final_proj_1"]["kernel"].T)
    GM(GMConfig(n_layers=1)).load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="gnn layers"):
        tconvert.gm_state_dict(params, 3)
    model = build_matcher("gm")
    assert len(model.gnn) == 18 and len(model.final_proj) == 9 and model.config.descriptor_dim == 128
