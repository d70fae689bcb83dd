"""Token counts off the CUDA kernels' tiles, padded inside the wrappers
(pram_tpu_torch/ops/padding.py), on the CPU.

Each wrapper's CUDA route pads its token axes (each side separately), runs
its launch on the padded layout and slices the real tokens back out. Here
the plain version stands in for the launch, so what is held is the
pad-and-slice itself: against the unpadded plain version it must change
nothing but the f32 summation order of the softmax denominators, which now
add exact zeros for the padded keys. Tolerances: 1e-6 of the output's scale
in f32 (the plain attention's f32 sums over a longer row; everything else
is row-independent and exact), bit-equal for the MLP, the projections and
the refinement NN (rows independent, padded points skipped); AdaGML's
pruning masks and stop layers exactly equal, its plan within 1e-6 of its
scale.

The backward wrappers of kernels 13, 14 and 15 pad the same way, to 64
tokens a side (attention) and 32 rows (MLP), with the plain backward as
the launch: every output within 1e-6 of its scale of the unpadded plain
backward (the f32 softmax sums and the weight gradients' sums run over
more, exactly zero, terms), dx and dpm bit-equal; rows of zeros alone give
every MLP weight gradient exactly 0. Through the three routes, a 2-layer
GML's loss gradients at 100 + 200 tokens (every side, and the MLP's 600
rows, off the tiles) match ``jax.grad`` of ``pram_tpu``'s GML within 1e-3
of each gradient's scale, the bound tests/test_torch_gml_train.py holds
the unpadded port to (f32 sums in another order, amplified through the
20 Sinkhorn iterations).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pram_tpu_torch.models import adagml as adagml_mod
from pram_tpu_torch.models.adagml import AdaGMLConfig, adagml_batched_adaptive_apply
from pram_tpu_torch.models.convert import load_adagml
from pram_tpu_torch.ops import attention, attention_bwd, attention_qkv, cross_attention, mlp, mlp_bwd, padding, refine

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()


def _attn_case(rng, b, sides):
    n = sum(sides)
    x = _t(rng, b, n, 256)
    ang = _t(rng, b, n, 32)
    cos, sin = torch.cos(ang).repeat_interleave(2, -1), torch.sin(ang).repeat_interleave(2, -1)
    mask = torch.from_numpy(rng.rand(b, n) > 0.2)
    mask[-1, : sides[0]] = False  # a fully masked side: the mean of its own v
    return x, cos, sin, attention.mask_to_bias(mask, b, n, "cpu")


@pytest.mark.parametrize("sides", [(100,), (1000, 600), (37, 128, 300)])
def test_self_attention_pad_and_slice(sides):
    rng = np.random.RandomState(sum(sides))
    x, cos, sin, kb = _attn_case(rng, 2, sides)
    splits = None if len(sides) == 1 else sides
    w, bias = _t(rng, 768, 256, scale=1 / 16), _t(rng, 768, scale=0.1)
    args = (cos, sin, kb, 0.125, 4)
    ref = attention.self_attention_plain(x, w, bias, *args, splits)
    got = attention.on_query_tile(attention.self_attention_plain, x, (w, bias), *args, splits)
    assert got.shape == ref.shape and _rel(got, ref) <= TOL
    qkv = _t(rng, 2, sum(sides), 768)
    ref = attention_qkv.self_attention_qkv_plain(qkv, *args, splits, True)
    got = attention_qkv.qkv_on_query_tile(attention_qkv.self_attention_qkv_plain, qkv, *args, splits, True)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) <= TOL


@pytest.mark.parametrize("n0,n1", [(100, 156), (1000, 600), (128, 300)])
def test_cross_attention_pad_and_slice(n0, n1):
    rng = np.random.RandomState(n0 + 7 * n1)
    x = _t(rng, 2, n0 + n1, 256)
    b0 = attention.mask_to_bias(torch.from_numpy(rng.rand(2, n0) > 0.1), 2, n0, "cpu")
    m1 = torch.from_numpy(rng.rand(2, n1) > 0.3)
    m1[-1] = False
    b1 = attention.mask_to_bias(m1, 2, n1, "cpu")
    weights = (_t(rng, 256, 256, scale=1 / 16), _t(rng, 256, scale=0.1), _t(rng, 256, 256, scale=1 / 16),
               _t(rng, 256, scale=0.1))
    ref = cross_attention.cross_attention_plain(x, *weights, b0, b1, 0.125, 4, n0)
    got = cross_attention.on_side_tile(cross_attention.cross_attention_plain, x, weights, b0, b1, 0.125, 4, n0)
    assert got.shape == ref.shape and _rel(got, ref) <= TOL
    qk, v = _t(rng, 2, n0 + n1, 256), _t(rng, 2, n0 + n1, 256)
    pk = (qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:], b0, b1, 0.125, 4, True)
    ref = cross_attention.cross_attention_packed_plain(*pk)
    got = cross_attention.packed_on_tile(cross_attention.cross_attention_packed_plain, *pk)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) <= TOL


@pytest.mark.parametrize("shape", [(1000,), (3, 333), (1, 4096 + 40)])
def test_mlp_and_projection_pad_and_slice(shape):
    rng = np.random.RandomState(sum(shape))
    x, msg = _t(rng, *shape, 256), _t(rng, *shape, 256, scale=0.1)
    weights = (_t(rng, 256, 256, scale=1 / 16), _t(rng, 256, scale=0.1), _t(rng, 512, 512, scale=1 / 23),
               _t(rng, 512, scale=0.1), 1 + _t(rng, 512, scale=0.1), _t(rng, 512, scale=0.1),
               _t(rng, 256, 512, scale=1 / 23), _t(rng, 256, scale=0.1))
    ref = mlp.residual_mlp_plain(x, msg, *weights)
    assert torch.equal(mlp.mlp_on_token_tile(mlp.residual_mlp_plain, x, msg, weights), ref)
    ang = _t(rng, *shape, 32)
    cos, sin = torch.cos(ang).repeat_interleave(2, -1), torch.sin(ang).repeat_interleave(2, -1)
    w, b = _t(rng, 768, 256, scale=1 / 16), _t(rng, 768, scale=0.1)

    def plain(x2, w2, b2, c2, s2, rot, split):
        y = attention.project_plain(x2, w2, b2, c2, s2, rot)
        return y if split is None else (y[..., :split], y[..., split:])

    ref = attention.project_plain(x, w, b, cos, sin, 512)
    assert torch.equal(attention.on_token_tile(plain, x, (w, b), cos, sin, 512, None), ref)
    got = attention.on_token_tile(plain, x, (w, b), None, None, 0, 256)
    ref = attention.project_plain(x, w, b)
    assert torch.equal(got[0], ref[..., :256]) and torch.equal(got[1], ref[..., 256:])


@pytest.mark.parametrize("n,p", [(100, 300), (1000, 2048), (64, 70)])
def test_refine_nn_pad_and_slice(n, p):
    """Padded points are zero descriptors at uv 0 outside the image: with
    every real similarity below 0 they would beat each gated-out real point;
    the real point count keeps them out, as the kernel's does."""
    rng = np.random.RandomState(n + p)
    b = 2
    descs = torch.nn.functional.normalize(_t(rng, b, n, 128), dim=-1).abs()
    pdesc = -torch.nn.functional.normalize(_t(rng, b, p, 128), dim=-1).abs()
    kpts = torch.from_numpy(rng.rand(b, n, 2).astype(np.float32) * 640)
    uv = torch.from_numpy(rng.rand(b, p, 2).astype(np.float32) * 640)
    uv[:, : min(n, p)] = kpts[:, : min(n, p)] + 2.0
    in_img = torch.from_numpy(rng.rand(b, p) > 0.1)
    in_img[-1] = False  # every point of the last problem gated out
    qmask = torch.from_numpy(rng.rand(b, n) > 0.1)
    args = (descs, pdesc, kpts, uv, in_img, qmask, 16.0, 0.995)
    ref = refine.refine_nn_plain(*args)
    got = refine.refine_on_tile(refine.refine_nn_plain, *args)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert (ref[1][-1] >= 100).all()
    # without the real count the padded points would win there
    pp = padding.round_up(p, 64)
    if pp != p:
        loose = refine.refine_nn_plain(descs, padding.pad_end(pdesc, pp), kpts, padding.pad_end(uv, pp),
                                       padding.pad_end(in_img, pp, False), qmask, 16.0, 0.995)
        assert int(loose[0][-1].max()) >= p


def test_adagml_padded_statistics_and_masks_exact(monkeypatch):
    """AdaGML in f32 (weights/adagml_aachen.msgpack) at off-tile token
    counts, 300 query tokens (half of them near copies of frame tokens) and
    200 frame tokens, through the padded routes with the plain versions as
    their launches, against the unpadded plain path: the same pruning masks
    (side 0 pruned to ~110 of ~270 tokens) and stop layers exactly, the plan
    within 1e-6 of its scale."""
    ada = load_adagml(str(Path(__file__).resolve().parents[1] / "weights" / "adagml_aachen.msgpack"),
                      AdaGMLConfig(), device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(3)
    b, n, m = 2, 300, 200
    d1 = torch.nn.functional.normalize(_t(rng, b, m, 128), dim=-1)
    d0 = torch.nn.functional.normalize(torch.cat([d1[:, :150] + 0.05 * _t(rng, b, 150, 128),
                                                  _t(rng, b, 150, 128)], 1), dim=-1)
    nk1 = torch.from_numpy(rng.rand(b, m, 2).astype(np.float32) - 0.5)
    nk0 = torch.cat([nk1[:, :150] + 0.01, torch.from_numpy(rng.rand(b, 150, 2).astype(np.float32) - 0.5)], 1)
    m0, m1 = torch.from_numpy(rng.rand(b, n) > 0.1), torch.from_numpy(rng.rand(b, m) > 0.2)
    args = (d0, d1, nk0, nk1, m0, m1)
    ada.use_kernels = False
    ref = adagml_batched_adaptive_apply(ada, *args)
    assert 0 < int(ref["mask0"].sum()) < int(m0.sum())
    ada.use_kernels = True
    monkeypatch.setattr(adagml_mod, "self_attention_qkv",
                        lambda *a, **k: attention_qkv.qkv_on_query_tile(attention_qkv.self_attention_qkv_plain, *a, **k))
    monkeypatch.setattr(adagml_mod, "cross_attention_packed",
                        lambda *a, **k: cross_attention.packed_on_tile(cross_attention.cross_attention_packed_plain,
                                                                       *a, **k))
    monkeypatch.setattr(adagml_mod, "residual_mlp",
                        lambda x, msg, *w, eps=1e-6: mlp.mlp_on_token_tile(mlp.residual_mlp_plain, x, msg, w, eps))
    got = adagml_batched_adaptive_apply(ada, *args)
    assert torch.equal(got["stop_layer"], ref["stop_layer"])
    assert torch.equal(got["mask0"], ref["mask0"]) and torch.equal(got["mask1"], ref["mask1"])
    assert _rel(got["plan"], ref["plan"]) <= TOL


@pytest.mark.parametrize("sides", [(100,), (1000, 600), (37, 128, 300)])
def test_self_attention_bwd_pad_and_slice(sides):
    rng = np.random.RandomState(sum(sides) + 1)
    x, cos, sin, kb = _attn_case(rng, 2, sides)
    splits = None if len(sides) == 1 else sides
    qkv, g = _t(rng, 2, sum(sides), 768, scale=0.5), _t(rng, 2, sum(sides), 256)
    args = (qkv, cos, sin, kb, g, 0.125, 4, splits)
    ref = attention_bwd.self_attention_bwd_plain(*args)
    got = attention_bwd.self_bwd_on_tile(attention_bwd.self_attention_bwd_plain, *args)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) <= TOL


@pytest.mark.parametrize("n0,n1", [(100, 156), (1000, 600), (128, 300)])
def test_cross_attention_bwd_pad_and_slice(n0, n1):
    rng = np.random.RandomState(n0 + 7 * n1 + 1)
    qk, v, g = (_t(rng, 2, n0 + n1, 256) for _ in range(3))
    b0 = attention.mask_to_bias(torch.from_numpy(rng.rand(2, n0) > 0.1), 2, n0, "cpu")
    m1 = torch.from_numpy(rng.rand(2, n1) > 0.3)
    m1[-1] = False  # an all-masked key side
    b1 = attention.mask_to_bias(m1, 2, n1, "cpu")
    args = (qk, v, b0, b1, g, 0.125, 4, n0)
    ref = attention_bwd.cross_attention_bwd_plain(*args)
    got = attention_bwd.cross_bwd_on_tile(attention_bwd.cross_attention_bwd_plain, *args)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) <= TOL


def _mlp_bwd_weights(rng):
    return (_t(rng, 512, 512, scale=1 / 23), _t(rng, 512, scale=0.1), 1 + _t(rng, 512, scale=0.1),
            _t(rng, 512, scale=0.1), _t(rng, 256, 512, scale=1 / 23))


@pytest.mark.parametrize("shape", [(1000,), (3, 333), (1, 4096 + 40)])
def test_mlp_bwd_pad_and_slice(shape):
    rng = np.random.RandomState(sum(shape) + 1)
    x, pm, ct = _t(rng, *shape, 256), _t(rng, *shape, 256, scale=0.1), _t(rng, *shape, 256)
    w = _mlp_bwd_weights(rng)
    ref = mlp_bwd.residual_mlp_bwd_plain(x, pm, ct, *w)
    got = mlp_bwd.mlp_bwd_on_token_tile(mlp_bwd.residual_mlp_bwd_plain, x, pm, ct, *w)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for a, r in zip(got[2:], ref[2:]):
        assert a.shape == r.shape and _rel(a, r) <= TOL


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
def test_mlp_bwd_zero_rows_add_exactly_nothing(vec_dtype):
    """What the padding adds to each weight gradient: rows of zeros alone,
    whose LayerNorm input is b0 (a constant b0 too: variance 0), give
    finite zeros, in f32 and with bf16 vectors as the training step holds
    them."""
    rng = np.random.RandomState(11)
    w = list(_mlp_bwd_weights(rng))
    z = torch.zeros(32, 256)
    for b0 in (w[1], torch.full((512,), 0.25)):
        w[1] = b0
        vecs = [t.to(vec_dtype) for t in w[1:4]]
        out = mlp_bwd.residual_mlp_bwd_plain(z, z, z, w[0], *vecs, w[4])
        for t in out:
            assert torch.isfinite(t).all() and not t.any()


@pytest.fixture(scope="module")
def gml_grads():
    """pram_tpu's 2-layer GML at 100 + 200 tokens: its flax params, the
    batch, and jax.value_and_grad of the matching loss (jitted once)."""
    import jax
    import jax.numpy as jnp

    from pram_tpu.models.gml import GML as JaxGML
    from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
    from pram_tpu.train.losses import matching_nll_loss as jax_nll

    small = dict(descriptor_dim=32, hidden_dim=64, num_heads=4, n_layers=2)
    rng = np.random.RandomState(5)
    b, n, m, d = 2, 100, 200, 32
    d1 = rng.randn(b, m, d).astype(np.float32)
    gt = np.full((b, n), -1, np.int64)
    gt[:, :60] = rng.randint(0, m, (b, 60))
    d0 = rng.randn(b, n, d).astype(np.float32)
    for i in range(b):
        d0[i, :60] = d1[i, gt[i, :60]] + 0.1 * rng.randn(60, d)
    nk0 = (rng.rand(b, n, 2) - 0.5).astype(np.float32)
    nk1 = (rng.rand(b, m, 2) - 0.5).astype(np.float32)
    m0, m1 = rng.rand(b, n) > 0.1, rng.rand(b, m) > 0.1
    m1[np.arange(b)[:, None], gt.clip(0)] |= gt >= 0
    batch = (d0, d1, nk0, nk1, m0, m1, gt.astype(np.int32))
    model = JaxGML(JaxGMLConfig(**small))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in batch[:6]))["params"]

    def loss_fn(params, d0, d1, nk0, nk1, m0, m1, gt):
        return jax_nll(model.apply({"params": params}, d0, d1, nk0, nk1, m0, m1)["plan"], gt, m1)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *(jnp.asarray(a) for a in batch))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return small, to_np(params), batch, float(loss), to_np(grads)


def test_gml_gradients_through_padded_backward_routes_match_jax(gml_grads, monkeypatch):
    from pram_tpu_torch.models.convert import gml_state_dict
    from pram_tpu_torch.models.gml import GML, GMLConfig
    from pram_tpu_torch.train.losses import matching_nll_loss

    small, params, batch, jloss, jgrads = gml_grads
    padded = {"self": 0, "cross": 0, "mlp": 0}

    def route(key, fn, plain, off_tile):
        def call(*a, **k):
            padded[key] += off_tile(*a, **k)
            return fn(plain, *a, **k)
        return call

    monkeypatch.setattr(attention_bwd, "self_attention_bwd", route(
        "self", attention_bwd.self_bwd_on_tile, attention_bwd.self_attention_bwd_plain,
        lambda qkv, *a, **k: any(s % 64 for s in a[-1])))
    monkeypatch.setattr(attention_bwd, "cross_attention_bwd", route(
        "cross", attention_bwd.cross_bwd_on_tile, attention_bwd.cross_attention_bwd_plain,
        lambda qk, *a: a[-1] % 64 != 0 or (qk.shape[1] - a[-1]) % 64 != 0))
    monkeypatch.setattr(mlp_bwd, "residual_mlp_bwd", route(
        "mlp", mlp_bwd.mlp_bwd_on_token_tile, mlp_bwd.residual_mlp_bwd_plain,
        lambda x, *a: (x.numel() // x.shape[-1]) % 32 != 0))
    model = GML(GMLConfig(**small))
    model.load_state_dict(gml_state_dict(params, small["n_layers"]))
    d0, d1, k0, k1, m0, m1, gt = (torch.from_numpy(a) for a in batch)
    loss = matching_nll_loss(model(d0, d1, k0, k1, m0, m1)["plan"], gt.long(), m1)
    loss.backward()
    assert padded == {"self": 2, "cross": 2, "mlp": 4}  # each layer's self, cross and two MLP calls
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    ref = gml_state_dict(jgrads, small["n_layers"])
    got = dict(model.named_parameters())
    assert sorted(ref) == sorted(got)
    for k, g in ref.items():
        assert _rel(got[k].grad, torch.from_numpy(np.asarray(g))) <= 1e-3, k
