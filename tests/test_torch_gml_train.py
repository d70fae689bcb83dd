"""GML matcher training of the port against pram_tpu on the CPU, in f32.

The JAX side runs its XLA path (the Sinkhorn of ``pram_tpu/ops/sinkhorn.py``
and the flax blocks' einsum attention); the port runs the plain twins of
its kernels, kernel 14's (``cross_attention_bwd_plain``) among them.
Tolerances:
- ``sinkhorn`` (SinkhornPlan): the plan within 1e-6 (relative above 1); d sim and d dustbin within 1e-4 of
  their scale of ``jax.grad`` (f32 summation order over 20 iterations); on
  the CPU its gradient is plain autograd's bit for bit (the same graph);
- the GML loss (2 layers, d 64, 2 x (128 + 256) tokens, flax-initialised
  params carried over by ``models/convert.py``) within 1e-5 relative, every
  parameter's gradient within 1e-3 of its scale (f32 sums in another
  order, amplified through the 20 Sinkhorn iterations);
- Adam on given gradients: optax's ``adam`` within 1e-6 relative; three
  training steps: the losses within 1e-5 relative and every parameter
  within 5e-6 absolute (Adam's first steps move each weight by ~lr = 2e-4
  whatever its gradient's size, so a weight whose gradient is f32 noise
  can move by up to 2 lr either way: 2 such weights would fail);
- the flax-like init at full width (2 layers): biases and LayerNorms exact,
  ``bin_score`` 1, each random tensor's mean and stddev within five
  standard errors of flax's draw, and (``lecun_normal``, truncated at two
  stddevs) its largest magnitude within 1.5x of flax's;
- the two-sided ``CrossAttentionBlock(x0, x1)`` (d 64, 96 x 160 tokens,
  masked): both outputs within 1e-5 and the gradients of the inputs and
  every parameter within 1e-4 of their scale of the flax block's;
- ``make_batch`` and the device pool bit for bit with the JAX script's
  (imported from its path), the normalized keypoints too.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pram_tpu.engine.localizer import normalize_kpts_like_reference as jax_normalize
from pram_tpu.models.common import CrossAttentionBlock as JaxCrossBlock
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu.models.segnetvit import SegNetViT as JaxSegNetViT
from pram_tpu.models.segnetvit import SegNetViTConfig as JaxSegConfig
from pram_tpu.ops.sinkhorn import sinkhorn_matching as jax_sinkhorn
from pram_tpu.train.losses import matching_nll_loss as jax_nll
from pram_tpu_torch.cli import train_synthetic_gml as cli
from pram_tpu_torch.models.common import CrossAttentionBlock
from pram_tpu_torch.models.convert import flax_to_state_dict, gml_state_dict, segnetvit_state_dict
from pram_tpu_torch.models.gml import GML, GMLConfig
from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
from pram_tpu_torch.ops.sinkhorn import sinkhorn, sinkhorn_matching
from pram_tpu_torch.train.losses import matching_nll_loss
from pram_tpu_torch.train.matcher import make_adam, make_matcher_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
SMALL = dict(descriptor_dim=32, hidden_dim=64, num_heads=4, n_layers=2)
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_synthetic_gml", os.path.join(ROOT, "scripts", "train_synthetic_gml.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(seed=0, b=2, n=128, m=256, d=32):
    """Side 0 holds noisy copies of some side-1 descriptors (gt their rows),
    the rest unmatched (dustbin); padded rows and columns on both sides."""
    rng = np.random.RandomState(seed)
    d1 = rng.randn(b, m, d).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    gt = np.full((b, n), m, np.int64)
    d0 = rng.randn(b, n, d).astype(np.float32)
    for i in range(b):
        rows = rng.permutation(m)[: n // 2]
        gt[i, : n // 2] = rows
        d0[i, : n // 2] = d1[i, rows] + 0.1 * rng.randn(n // 2, d)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    k0 = rng.rand(b, n, 2).astype(np.float32) - 0.5
    k1 = rng.rand(b, m, 2).astype(np.float32) - 0.5
    m0 = rng.rand(b, n) > 0.1
    m1 = rng.rand(b, m) > 0.15
    gt = np.where(m1[np.arange(b)[:, None], np.minimum(gt, m - 1)] | (gt == m), gt, m)
    gt = np.where(m0, gt, -1)
    return d0, d1, k0, k1, m0, m1, gt


@pytest.fixture(scope="module")
def jax_ref():
    """Flax params of the small GML, the JAX script's loss_fn and its jitted
    value_and_grad, shared by the tests of this module."""
    model = JaxGML(JaxGMLConfig(**SMALL))
    d0, d1, k0, k1, m0, m1, gt = (jnp.asarray(a) for a in _batch())
    params = jax.jit(model.init)(jax.random.PRNGKey(0), d0, d1, k0, k1, m0, m1)["params"]

    def loss_fn(params, d0, d1, nk0, nk1, m0, m1, gt):
        out = model.apply({"params": params}, d0, d1, nk0, nk1, m0, m1)
        return jax_nll(out["plan"], gt, m1)

    return params, jax.jit(jax.value_and_grad(loss_fn))


def _port_gml(params):
    model = GML(GMLConfig(**SMALL))
    model.load_state_dict(gml_state_dict(jax.tree_util.tree_map(np.asarray, params), SMALL["n_layers"]))
    return model


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-30))


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_plan_against_jax_grad(masked):
    rng = np.random.RandomState(3 + masked)
    b, n, m = 2, 40, 70
    sim = (rng.randn(b, n, m) * 3).astype(np.float32)
    w = rng.randn(b, n + 1, m + 1).astype(np.float32)
    m0 = rng.rand(b, n) > 0.2 if masked else None
    m1 = rng.rand(b, m) > 0.3 if masked else None

    def jfn(s, d):
        plan = jax_sinkhorn(s, d, 20, None if m0 is None else jnp.asarray(m0),
                            None if m1 is None else jnp.asarray(m1))
        return jnp.sum(plan * w), plan

    (_, jplan), (jds, jdd) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(sim), jnp.asarray(1.3, jnp.float32))

    def run(fn):
        s = T(sim).requires_grad_()
        d = torch.tensor(1.3, requires_grad=True)
        plan = fn(s, d, 20, None if m0 is None else T(m0), None if m1 is None else T(m1))
        (plan * T(w)).sum().backward()
        return plan.detach(), s.grad, d.grad

    plan, ds, dd = run(sinkhorn)
    np.testing.assert_allclose(plan.numpy(), np.asarray(jplan), rtol=1e-6, atol=1e-6)
    assert _rel(ds, jds) <= 1e-4 and _rel(dd, jdd) <= 1e-4
    ref = run(sinkhorn_matching)
    assert all(torch.equal(a, r) for a, r in zip((plan, ds, dd), ref))


def test_gml_loss_and_gradients_match_jax(jax_ref):
    params, vg = jax_ref
    batch = _batch()
    jloss, jgrads = vg(params, *(jnp.asarray(a) for a in batch))
    model = _port_gml(params)
    d0, d1, k0, k1, m0, m1, gt = (T(a) for a in batch)
    loss = matching_nll_loss(model(d0, d1, k0, k1, m0, m1)["plan"], gt, m1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = gml_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), SMALL["n_layers"])
    got = dict(model.named_parameters())
    assert sorted(ref) == sorted(got)
    for k, g in ref.items():
        assert _rel(got[k].grad, g) <= 1e-3, k


def test_two_sided_cross_attention_block_matches_flax():
    rng = np.random.RandomState(7)
    b, n0, n1, d = 2, 96, 160, 64
    x0, x1 = rng.randn(b, n0, d).astype(np.float32), rng.randn(b, n1, d).astype(np.float32)
    c0, c1 = rng.randn(b, n0, d).astype(np.float32), rng.randn(b, n1, d).astype(np.float32)
    m0, m1 = rng.rand(b, n0) > 0.2, rng.rand(b, n1) > 0.3
    jblock = JaxCrossBlock(feat_dim=d, hidden_dim=d, num_heads=4)
    params = jax.jit(jblock.init)(jax.random.PRNGKey(1), jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(m0),
                                  jnp.asarray(m1))["params"]

    def jloss(p, a0, a1):
        y0, y1 = jblock.apply({"params": p}, a0, a1, jnp.asarray(m0), jnp.asarray(m1))
        return jnp.sum(y0 * c0) + jnp.sum(y1 * c1), (y0, y1)

    (_, (jy0, jy1)), (jgp, jg0, jg1) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x0), jnp.asarray(x1))
    block = CrossAttentionBlock(d, d, 4)
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    t0, t1 = T(x0).requires_grad_(), T(x1).requires_grad_()
    y0, y1 = block(t0, t1, T(m0), T(m1))
    ((y0 * T(c0)).sum() + (y1 * T(c1)).sum()).backward()
    np.testing.assert_allclose(y0.detach().numpy(), np.asarray(jy0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(jy1), rtol=1e-5, atol=1e-5)
    assert _rel(t0.grad, jg0) <= 1e-4 and _rel(t1.grad, jg1) <= 1e-4
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    for k, p in block.named_parameters():
        assert _rel(p.grad, ref[k]) <= 1e-4, k


def test_adam_matches_optax_on_given_gradients():
    rng = np.random.RandomState(5)
    shapes = [(7, 3), (4,), ()]
    params = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    tp = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt, tx = make_adam(tp, LR), optax.adam(LR)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for step in range(3):
        grads = [np.asarray(rng.randn(*s) * 10.0 ** (-step), np.float32) for s in shapes]
        for p, g in zip(tp, grads):
            p.grad = T(g)
        opt.step()
        upd, state = tx.update([jnp.asarray(g) for g in grads], state)
        jp = optax.apply_updates(jp, upd)
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_three_training_steps_match_optax(jax_ref):
    params, vg = jax_ref
    batch = _batch(seed=1)
    jb = [jnp.asarray(a) for a in batch]
    model = _port_gml(params)
    step = make_matcher_train_step(model, LR)
    d0, d1, k0, k1, m0, m1, gt = (T(a) for a in batch)
    tx = optax.adam(LR)
    state = tx.init(params)
    for _ in range(3):
        jloss, grads = vg(params, *jb)
        upd, state = tx.update(grads, state)
        params = optax.apply_updates(params, upd)
        loss = step(d0, d1, k0, k1, m0, m1, gt)["loss"]
        assert loss.dim() == 0
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = gml_state_dict(jax.tree_util.tree_map(np.asarray, params), SMALL["n_layers"])
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), rtol=0, atol=5e-6, err_msg=k)


def _check_init_stats(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k, a in ours.items():
        a, r = a.double().numpy(), theirs[k].double().numpy()
        if k.endswith("bias") or "ln." in k or "_ln." in k or k == "bin_score":
            np.testing.assert_array_equal(a, r, err_msg=k)
            continue
        # two independent draws: their means differ by sqrt(2) standard
        # errors sd / sqrt(n), their stddevs by sqrt(2) of sd / sqrt(2 n)
        n, sd = a.size, r.std()
        assert abs(a.mean() - r.mean()) <= 5 * (2 / n) ** 0.5 * sd, k
        assert abs(a.std() - sd) <= 5 * sd / n**0.5, k
        if not k.endswith("Wr.weight"):  # lecun_normal: truncated at two stddevs
            assert np.abs(a).max() <= 1.5 * np.abs(r).max() and np.abs(r).max() <= 1.5 * np.abs(a).max(), k


def test_gml_init_statistics_match_flax():
    """Full width, d 256, at 2 layers (every layer draws alike; params do
    not depend on token counts, so flax initialises on a few tokens)."""
    rng = np.random.RandomState(0)
    b, n, m = 1, 8, 16
    args = [jnp.asarray(a) for a in (rng.randn(b, n, 128), rng.randn(b, m, 128), rng.rand(b, n, 2),
                                     rng.rand(b, m, 2))]
    theirs = jax.jit(JaxGML(JaxGMLConfig(n_layers=2)).init)(jax.random.PRNGKey(0), *args)["params"]
    theirs = gml_state_dict(jax.tree_util.tree_map(np.asarray, theirs), 2)
    assert float(theirs["bin_score"]) == 1.0
    _check_init_stats(GML(GMLConfig(n_layers=2)).state_dict(), theirs)


def test_segnetvit_init_statistics_match_flax():
    rng = np.random.RandomState(1)
    cfg = dict(descriptor_dim=256, n_class=113, n_layers=2)
    theirs = jax.jit(JaxSegNetViT(JaxSegConfig(**cfg)).init)(
        jax.random.PRNGKey(0), jnp.asarray(rng.randn(1, 8, 256)), jnp.asarray(rng.rand(1, 8, 2)))["params"]
    theirs = segnetvit_state_dict(jax.tree_util.tree_map(np.asarray, theirs))
    _check_init_stats(SegNetViT(SegNetViTConfig(**cfg)).state_dict(), theirs)


def test_make_batch_and_pool_match_the_jax_script():
    jscript = _jax_script()
    jrng, jscene = jscript.build_scene()
    rng, scene = cli.build_scene()
    for f in ("point_desc", "frame_point_idx", "frame_kp_uv", "frame_kp_mask", "point_xyz", "point_seg"):
        np.testing.assert_array_equal(getattr(scene.map, f), getattr(jscene.map, f), err_msg=f)
    for a, r in zip(cli.make_batch(scene, rng, 2), jscript.make_batch(jscene, jrng, 2)):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r)
    pool = cli.make_pool(scene, rng, 3, 2, "cpu", scene.width, scene.height)
    w, h = jnp.asarray(float(jscene.width)), jnp.asarray(float(jscene.height))
    assert len(pool) == 3
    for got in pool:
        d0, k0, m0, d1, k1, m1, gt = jscript.make_batch(jscene, jrng, 2)
        want = (d0, d1, jax_normalize(jnp.asarray(k0), w, h), jax_normalize(jnp.asarray(k1), w, h), m0, m1, gt)
        for a, r in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    # the validation queries come from the same generator state
    np.testing.assert_array_equal(scene.render_query(rng, noise_px=0.3)["keypoints"],
                                  jscene.render_query(jrng, noise_px=0.3)["keypoints"])


def test_cli_evaluates_a_checkpoint_and_fits_a_recognizer(tmp_path, monkeypatch):
    """The CLI at one layer on the CPU (its configs cut to one layer here):
    --eval_only reads a checkpoint in the layout --out writes and prints the
    validation line (the training run itself goes through
    tests/test_torch_imports.py's fence); --recognizer takes two steps and
    saves bf16 weights."""
    import functools

    from pram_tpu_torch.models import gml as gml_mod
    from pram_tpu_torch.models import segnetvit as seg_mod

    monkeypatch.setattr(gml_mod, "GMLConfig", functools.partial(GMLConfig, n_layers=1))
    monkeypatch.setattr(seg_mod, "SegNetViTConfig", functools.partial(SegNetViTConfig, n_layers=1))
    out = str(tmp_path / "gml.pt")
    model = GML(GMLConfig(n_layers=1))
    torch.save({"model": model.state_dict(), "config": vars(model.config), "steps": 0}, out)
    loaded = cli.load_gml_weights(out, GMLConfig(n_layers=1), "cpu").state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
    res = cli.main(["--device", "cpu", "--eval_only", "--out", out])
    assert res["losses"] == [] and 0.0 <= res["validation"]["recall_5cm5deg_gml"] <= 1.0
    assert set(res["validation"]) >= {"success_rate", "median_t_err", "median_q_err"}
    rec = cli.main(["--recognizer", "--device", "cpu", "--steps", "2", "--batch", "2",
                    "--out", str(tmp_path / "rec.pt")])
    assert len(rec["losses"]) == 2 and 0.0 <= rec["accuracy"] <= 1.0
    sd = torch.load(tmp_path / "rec.pt", weights_only=True)["model"]
    assert sd["input_proj.weight"].dtype == torch.bfloat16 and sd["input_proj.weight"].shape == (256, 128)
