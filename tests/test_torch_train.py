"""The port's recognition training against pram_tpu on the CPU, in f32.

Losses and metrics, the LR schedule, the train step and the augmented
step (frozen SFD2 inside) are held against the JAX package on the same
numpy-seeded inputs and the same JAX-initialised parameters, carried over
by ``models/convert.py``; the Trainer's checkpoints, best copy and NaN-epoch
skip are held by their outcome.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.models.segnetvit import SegNetViT as JaxSegNetViT
from pram_tpu.models.segnetvit import SegNetViTConfig as JaxConfig
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.train import augmented as jaug
from pram_tpu.train import losses as jl
from pram_tpu.train import trainer as jtr
from pram_tpu_torch.models.convert import load_sfd2, segnetvit_state_dict
from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
from pram_tpu_torch.train import augmented as taug
from pram_tpu_torch.train import losses as tl
from pram_tpu_torch.train import trainer as ttr

T = torch.from_numpy
SFD2_W = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights", "sfd2_rendered.msgpack"
)


def _seg_inputs(seed, b=2, n=16, c=7):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, n, c) * 2).astype(np.float32)
    target = rng.randint(0, c, (b, n))
    target[:, :3] = 0  # background tokens
    mask = np.ones((b, n), bool)
    mask[1, n - 5:] = False
    return logits, target, mask


@pytest.mark.parametrize("double_softmax", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_seg_loss_weighted_value_and_gradient(double_softmax, with_mask):
    logits, target, mask = _seg_inputs(0)
    m = mask if with_mask else None

    def jfn(lg):
        return jl.seg_loss_weighted(lg, jnp.asarray(target), None if m is None else jnp.asarray(m),
                                    double_softmax=double_softmax)

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lt = T(logits).requires_grad_()
    tv = tl.seg_loss_weighted(lt, T(target), None if m is None else T(m), double_softmax=double_softmax)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_seg_metrics_match():
    logits, target, mask = _seg_inputs(1)
    for m in (mask, None):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else T(m)
        for got, ref in (
            (tl.seg_accuracy(T(logits), T(target), tm), jl.seg_accuracy(jnp.asarray(logits), jnp.asarray(target), jm)),
            (tl.seg_iou_precision(T(logits), T(target), tm),
             jl.seg_iou_precision(jnp.asarray(logits), jnp.asarray(target), jm)),
        ):
            np.testing.assert_allclose([float(x) for x in got], [float(x) for x in ref], rtol=1e-6)
    ts, js = tl.SeqIoU(), jl.SeqIoU()
    for seed in (2, 3):
        lg, tg, mk = _seg_inputs(seed)
        assert ts.update(T(lg), T(tg), T(mk)) == pytest.approx(js.update(jnp.asarray(lg), jnp.asarray(tg), jnp.asarray(mk)))
    assert ts.mean() == pytest.approx(js.mean())


def test_cls_and_sc_losses_match():
    rng = np.random.RandomState(4)
    pred2, tgt1 = rng.randn(5, 9).astype(np.float32), rng.randint(0, 9, 5)
    pred3, tgt2 = rng.randn(5, 9, 3).astype(np.float32), rng.randint(0, 9, (5, 3))
    soft2, soft3 = rng.randn(5, 9).astype(np.float32), rng.randn(5, 9, 3).astype(np.float32)
    pairs = [
        (tl.cls_loss_ce(T(pred2), T(tgt1)), jl.cls_loss_ce(jnp.asarray(pred2), jnp.asarray(tgt1))),
        (tl.cls_loss_ce(T(pred3), T(tgt2)), jl.cls_loss_ce(jnp.asarray(pred3), jnp.asarray(tgt2))),
        (tl.cls_loss_kl(T(pred2), T(soft2)), jl.cls_loss_kl(jnp.asarray(pred2), jnp.asarray(soft2))),
        (tl.cls_loss_kl(T(pred3), T(soft3)), jl.cls_loss_kl(jnp.asarray(pred3), jnp.asarray(soft3))),
    ]
    sc_p, sc_t = rng.randn(4, 3, 10).astype(np.float32), rng.randn(4, 3, 10).astype(np.float32)
    sc_m = rng.rand(4, 10) > 0.3
    for m in (sc_m, None):
        pairs.append((tl.sc_loss_l1(T(sc_p), T(sc_t), None if m is None else T(m)),
                      jl.sc_loss_l1(jnp.asarray(sc_p), jnp.asarray(sc_t), None if m is None else jnp.asarray(m))))
    P = np.concatenate([np.eye(3)[None].repeat(4, 0), rng.randn(4, 3, 1) * 0.1 + [[[0], [0], [5]]]], -1)
    K = np.array([[[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]] * 4)
    p2 = (rng.rand(4, 10, 2) * [640, 480]).astype(np.float32)
    geo = [a.astype(np.float32) for a in (sc_p, P, K, p2)]
    for m in (sc_m, None):
        pairs.append((
            tl.sc_loss_geo(*(T(a) for a in geo), 0.0, 1.0, mask=None if m is None else T(m)),
            jl.sc_loss_geo(*(jnp.asarray(a) for a in geo), 0.0, 1.0, mask=None if m is None else jnp.asarray(m)),
        ))
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_matching_nll_loss_matches():
    rng = np.random.RandomState(5)
    b, n, m = 2, 12, 10
    plan = rng.rand(b, n + 1, m + 1).astype(np.float32)
    plan[0, 3, 4] = 0.0  # clipped at 1e-9 on both sides
    gt = rng.randint(0, m + 1, (b, n))
    gt[1, -3:] = -1  # padded queries
    ref_mask = rng.rand(b, m) > 0.2
    got = tl.matching_nll_loss(T(plan), T(gt), T(ref_mask))
    ref = jl.matching_nll_loss(jnp.asarray(plan), jnp.asarray(gt), jnp.asarray(ref_mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_lr_schedule_matches():
    cfg = ttr.TrainConfig(decay_iter=1000, decay_rate=0.99, lr=1e-3, min_lr=1e-4)
    jcfg = jtr.TrainConfig(decay_iter=1000, decay_rate=0.99, lr=1e-3, min_lr=1e-4)
    fn, jfn = ttr.lr_schedule(cfg), jtr.lr_schedule(jcfg)
    for it in (0, 999, 1000, 1100, 1229, 100000):
        assert fn(it) == pytest.approx(float(jfn(jnp.asarray(it, jnp.int32))), rel=1e-5)
    assert fn(0) == cfg.lr and fn(100000) == cfg.min_lr
    assert fn(1100) == pytest.approx(cfg.lr * 0.99**100)


# a small SegNetViT: 2 layers, hidden 64, 2 heads, 7 classes
SMALL = dict(descriptor_dim=64, hidden_dim=64, output_dim=128, n_class=7, n_layers=2, num_heads=2)


def _small_batch(seed, b=2, n=64, d=64, c=7):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, n), bool)
    mask[1, n - 20:] = False
    gt = rng.randint(0, c, (b, n))
    gt[:, :8] = 0
    return {
        "seg_descriptors": rng.randn(b, n, d).astype(np.float32),
        "norm_keypoints": (rng.rand(b, n, 2) * 2 - 1).astype(np.float32),
        "gt_seg": gt,
        "mask": mask,
    }


def _jax_model_and_state(jcfg, batch, **cfg):
    model = JaxSegNetViT(JaxConfig(**cfg))
    state = jtr.init_train_state(model, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return model, state


def _port_model(params, **cfg):
    model = SegNetViT(SegNetViTConfig(**cfg))
    model.load_state_dict(segnetvit_state_dict(params))
    return model


def _flat(tree):
    return {k: v.numpy() for k, v in segnetvit_state_dict(jax.tree_util.tree_map(np.asarray, tree)).items()}


def test_train_step_matches_pram_tpu():
    """Three steps from the same JAX-initialised parameters: loss, metrics
    and LR to 1e-5; the first step's gradients to 1e-4 of each tensor's
    scale; the parameters after the steps within 6 lr absolute: Adam's
    m / sqrt(v) turns a sign flip of a near-zero gradient (f32 summation
    order) into a step of up to 2 lr, in either of the three steps."""
    cfg, jcfg = ttr.TrainConfig(lr=1e-3), jtr.TrainConfig(lr=1e-3)
    batch = _small_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel, jstate = _jax_model_and_state(jcfg, batch, **SMALL)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jb["seg_descriptors"], jb["norm_keypoints"], jb["mask"])["prediction"]
        return jl.seg_loss_weighted(logits, jb["gt_seg"], jb["mask"], weight_background=jcfg.weight_background)

    jgrads = _flat(jax.grad(jloss)(jstate.params))
    jstep = jtr.make_train_step(jmodel, jcfg)
    model = _port_model(params0, **SMALL)
    state = ttr.init_train_state(model, cfg)
    step = ttr.make_train_step(model, cfg)
    tb = {k: T(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jmet = jstep(jstate, jb)
        met = step(state, tb)
        for k in ("loss", "acc_corr", "acc_incorr", "lr"):
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-7), (i, k)
        if i == 0:
            for name, p in model.named_parameters():
                ref = jgrads[name]
                err = np.abs(p.grad.numpy() - ref).max()
                assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    assert state.iteration == int(jstate.iteration) == 3
    jp = _flat(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name], rtol=0, atol=6 * cfg.lr, err_msg=name)


def _image_batch(seed, b=2, h=32, w=40, n=24, c=5):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, n), bool)
    mask[0, -4:] = False
    return {
        "image": rng.rand(b, h, w, 3).astype(np.float32),
        "keypoints": (rng.rand(b, n, 2) * [w - 8, h - 8] + 4).astype(np.float32),
        "norm_keypoints": (rng.rand(b, n, 2) * 2 - 1).astype(np.float32),
        "gt_seg": rng.randint(0, c, (b, n)),
        "mask": mask,
    }


def test_augmented_step_matches_pram_tpu():
    """Two augmented steps (jitter amplitudes 0: the identity in both
    packages) with the rendered SFD2 frozen inside, from the same
    JAX-initialised recognizer: loss and metrics within 1e-4 relative (the
    extractor's mid_features agree to ~1e-6 of their scale, summed in
    another order through 8 convolutions), the parameters after the steps
    within 4 lr absolute (the sign-flip bound of the train-step test)."""
    small = dict(SMALL, descriptor_dim=256, n_class=5, n_layers=1)
    cfg, jcfg = ttr.TrainConfig(lr=1e-3), jtr.TrainConfig(lr=1e-3)
    batch = _image_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["seg_descriptors"] = jnp.zeros(batch["mask"].shape + (256,), jnp.float32)  # init only
    jmodel = JaxSegNetViT(JaxConfig(**small))
    jstate = jtr.init_train_state(jmodel, jcfg, jb)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jext = JaxResNet4x()
    with open(SFD2_W, "rb") as f:
        evars = serialization.from_bytes(jext.init(jax.random.PRNGKey(0), jb["image"][:1]), f.read())
    jstep = jaug.make_augmented_train_step(jmodel, jext, evars, jcfg, jitter_brightness=0.0,
                                           jitter_contrast=0.0)
    model = _port_model(params0, **small)
    state = ttr.init_train_state(model, cfg)
    step = taug.make_augmented_train_step(model, load_sfd2(SFD2_W, device="cpu"), cfg,
                                          jitter_brightness=0.0, jitter_contrast=0.0)
    tb = {k: T(v) for k, v in batch.items()}
    marks = []
    for i in range(2):
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(i), jb)
        met = step(state, tb, mark=marks.append)
        for k in ("loss", "acc_corr", "acc_incorr", "lr"):
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-4, abs=1e-7), (i, k)
    assert marks == ["extract", "forward", "backward", "optimizer"] * 2
    jp = _flat(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name], rtol=0, atol=4 * cfg.lr, err_msg=name)


def test_photometric_jitter_matches_with_the_same_factors():
    rng = np.random.RandomState(6)
    imgs = rng.rand(3, 8, 10, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jaug.photometric_jitter(key, jnp.asarray(imgs), 0.4, 0.3))
    kb, kc = jax.random.split(key)
    delta_b = np.array(jax.random.uniform(kb, (3, 1, 1, 1), minval=-0.4, maxval=0.4))
    factor_c = 1.0 + np.array(jax.random.uniform(kc, (3, 1, 1, 1), minval=-0.3, maxval=0.3))
    got = taug.photometric_jitter(T(imgs), 0.4, 0.3, delta_b=T(delta_b), factor_c=T(factor_c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    # the port's own draws: in bounds, reproducible from the generator's seed
    a = taug.photometric_jitter(T(imgs), generator=torch.Generator().manual_seed(1))
    b = taug.photometric_jitter(T(imgs), generator=torch.Generator().manual_seed(1))
    c = taug.photometric_jitter(T(imgs), generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def _trainer(tmp_path, name, epochs, logs=None, init=None):
    torch.manual_seed(0)
    model = SegNetViT(SegNetViTConfig(**SMALL))
    if init is not None:
        model.load_state_dict(init)
    cfg = ttr.TrainConfig(lr=1e-3, epochs=epochs)
    return ttr.Trainer(model, cfg, save_dir=str(tmp_path / name),
                       log_fn=(logs.append if logs is not None else lambda s: None))


def _epoch_batches(epoch, nan_epoch=None):
    out = []
    for i in range(2):
        bt = {k: T(v) for k, v in _small_batch(10 * epoch + i).items()}
        if epoch == nan_epoch:
            bt["seg_descriptors"][0, 0, 0] = float("nan")
        out.append(bt)
    return out


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    full = _trainer(tmp_path, "full", epochs=3)
    init = {k: v.clone() for k, v in full.state.model.state_dict().items()}
    full.train(_epoch_batches)
    assert full.state.epoch == 3 and full.state.iteration == 6
    resumed = _trainer(tmp_path, "resumed", epochs=3, init=init)
    resumed.restore_checkpoint(str(tmp_path / "full" / "epoch_0001.pt"))
    assert (resumed.state.epoch, resumed.state.iteration) == (1, 2)
    resumed.train(_epoch_batches)
    assert resumed.state.iteration == 6
    for (k, a), b in zip(full.state.model.state_dict().items(), resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_trainer_keeps_the_best_epoch(tmp_path):
    tr = _trainer(tmp_path, "best", epochs=3)
    means = []
    orig = tr.process_epoch

    def record(batches):
        m = orig(batches)
        means.append(m["loss"])
        return m

    tr.process_epoch = record
    tr.train(_epoch_batches)
    best = torch.load(str(tmp_path / "best" / "best.pt"), weights_only=True)
    assert best["min_loss"] == pytest.approx(min(means))
    assert best["epoch"] == int(np.argmin(means)) + 1
    assert tr.state.min_loss == pytest.approx(min(means))
    assert sorted(os.listdir(tmp_path / "best")) == ["best.pt", "epoch_0001.pt", "epoch_0002.pt", "epoch_0003.pt"]


def test_trainer_skips_a_nan_epoch(tmp_path):
    logs = []
    tr = _trainer(tmp_path, "nan", epochs=2, logs=logs)
    tr.train(lambda e: _epoch_batches(e, nan_epoch=1))
    assert tr.state.epoch == 2
    assert math.isnan(float(logs[1].split("loss ")[1].split()[0]))
    assert any(s.startswith("skip checkpoint at epoch 1") for s in logs)
    assert sorted(os.listdir(tmp_path / "nan")) == ["best.pt", "epoch_0001.pt"]
