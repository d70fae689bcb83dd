"""AdaGML of the port against pram_tpu on the CPU, in f32.

The JAX side runs as its own tests run it here: the XLA path of its flax
modules, and the Pallas kernels in interpret mode (both regimes: the
single-tile kernels, and the query-tiled ones reached by lowering
``_SINGLE_TILE_MAX``). Inputs come from numpy seeds; the port's weights are
the JAX-initialized ones carried across by ``adagml_state_dict``.

Tolerances:
- the plain versions of kernels 10-12 against the Pallas kernels, f32: 1e-5
  of the messages' and statistics' scale (summation order only); bf16: the
  messages within 2^-7 of their scale (one bf16 step where an f32 value
  straddles a rounding boundary), the statistics within 1e-5 (both sides
  sum the same f32 weights);
- blocks (pooling head, self and cross attention with statistics): 1e-5;
- the whole matcher, a few random layers: masks and stop layers exact,
  confidences 1e-5, plan rtol 5e-4 / atol 5e-5 (as tests/test_adagml_fused.py
  holds the fused JAX path to its XLA path);
- early exit against the unrolled module: masks and stop layers exact in
  either package; the port's plans bit-equal (the frames run the same
  operations up to the point where all stopped), pram_tpu's within
  rtol 1e-5 / atol 1e-6 (XLA compiles its one-hot out_proj contraction and
  its gather apart).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pram_tpu.ops.attention_pallas as ap
from pram_tpu.models import adagml as jada
from pram_tpu.models.common import LearnableFourierPE as JaxFourierPE
from pram_tpu_torch.engine.matching import make_adagml_match_fn
from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
from pram_tpu_torch.models.adagml import (
    AdaGML,
    AdaGMLConfig,
    adagml_batched_adaptive_apply,
    adagml_online_apply,
    confidence_threshold,
    extract_matches,
)
from pram_tpu_torch.models.convert import adagml_state_dict, load_adagml
from pram_tpu_torch.ops.attention_qkv import permute_qkv_kernel, self_attention_qkv_plain
from pram_tpu_torch.ops.cross_attention import cross_attention_packed_plain

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "adagml_aachen.msgpack",
)
T = torch.from_numpy
SMALL = dict(descriptor_dim=16, hidden_dim=32, num_heads=2, n_layers=3,
             n_min_tokens=8, sinkhorn_iterations=10)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{what}: {err}"


def _bias(mask):
    return np.where(mask, 0.0, -1e9).astype(np.float32)


def _qkv_inputs(seed, b=2, n=48, heads=2, hd=16):
    rng = np.random.RandomState(seed)
    d = heads * hd
    qkv = rng.randn(b, n, 3 * d).astype(np.float32)
    ang = rng.randn(b, n, hd // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    mask = rng.rand(b, n) > 0.2
    mask[0, 5] = False  # a pruned token
    mask[1] = False  # a fully masked frame
    return qkv, cos, sin, _bias(mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_self_attention_qkv_plain_matches_pallas(monkeypatch, dtype, tiled, stats):
    qkv, cos, sin, bias = _qkv_inputs(1)
    if tiled:
        monkeypatch.setattr(ap, "_SINGLE_TILE_MAX", 8)
    jq = jnp.asarray(qkv).astype(dtype)
    j = ap.fused_self_attention_qkv(jq, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(bias),
                                    16**-0.5, 2, interpret=True, return_stats=stats)
    tq = T(np.array(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    t = self_attention_qkv_plain(tq, T(cos), T(sin), T(bias), 16**-0.5, 2, return_stats=stats)
    j_msg, t_msg = (j[0], t[0]) if stats else (j, t)
    assert t_msg.dtype == tq.dtype
    _close(t_msg.float().numpy(), jnp.asarray(j_msg, jnp.float32), 1e-5 if dtype == "float32" else 2**-7, "messages")
    if stats:
        _close(t[1].numpy(), j[1], 1e-5, "statistics")
        assert float(t[1][1].abs().max()) == 0.0  # no valid queries, no mass


def test_self_attention_qkv_blocked_plain_matches_pallas():
    qkv, cos, sin, bias = _qkv_inputs(2)
    bias[0, 16:] = -1e9  # side 2 of frame 0 fully masked
    j = ap.fused_self_attention_qkv_blocked(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                                            jnp.asarray(bias), 16**-0.5, 2, (16, 32), interpret=True)
    t = self_attention_qkv_plain(T(qkv), T(cos), T(sin), T(bias), 16**-0.5, 2, splits=(16, 32))
    _close(t.numpy(), j, 1e-5, "blocked messages")
    whole = self_attention_qkv_plain(T(qkv), T(cos), T(sin), T(bias), 16**-0.5, 2)
    assert np.abs(whole.numpy() - t.numpy()).max() > 0.1  # the sides really are separate


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_cross_attention_packed_plain_matches_pallas(monkeypatch, tiled, stats):
    rng = np.random.RandomState(3)
    b, n, m, d = 2, 48, 24, 32
    qk0, v0, qk1, v1 = (rng.randn(b, k, d).astype(np.float32) for k in (n, n, m, m))
    mask0, mask1 = rng.rand(b, n) > 0.1, rng.rand(b, m) > 0.3
    mask0[0, 7] = False
    mask1[1] = False  # side 0 of frame 1 attends to an all-masked side
    args = (qk0, qk1, v0, v1, _bias(mask0), _bias(mask1))
    if tiled:
        monkeypatch.setattr(ap, "_SINGLE_TILE_MAX", 8)
    j = ap.fused_cross_attention_packed(*map(jnp.asarray, args), 16**-0.5, 2, interpret=True,
                                        return_stats=stats)
    t = cross_attention_packed_plain(*map(T, args), 16**-0.5, 2, return_stats=stats)
    assert len(t) == len(j) == (4 if stats else 2)
    for got, want, what in zip(t, j, ("m0", "m1", "stat0", "stat1")):
        _close(got.numpy(), want, 1e-5, what)


def test_permute_qkv_kernel_matches():
    rng = np.random.RandomState(4)
    k, bias = rng.randn(32, 96).astype(np.float32), rng.randn(96).astype(np.float32)
    jw, jb = ap.permute_qkv_kernel(jnp.asarray(k), jnp.asarray(bias), 2, 16)
    tw, tb = permute_qkv_kernel(T(k), T(bias), 2, 16)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def _matcher_inputs(seed, b=2, n0=24, n1=16, dd=16):
    rng = np.random.RandomState(seed)
    d0 = rng.randn(b, n0, dd).astype(np.float32)
    d1 = rng.randn(b, n1, dd).astype(np.float32)
    k0 = rng.rand(b, n0, 2).astype(np.float32)
    k1 = rng.rand(b, n1, 2).astype(np.float32)
    m0 = rng.rand(b, n0) > 0.2
    m1 = rng.rand(b, n1) > 0.2
    return d0, d1, k0, k1, m0, m1


def _both(cfg_kw, seed=0, conf_logit=None, **inputs_kw):
    """A JAX AdaGML with random weights, the port's copy of it, and inputs.
    ``conf_logit`` sets the pooling heads' output bias, which moves the
    confidences (random heads sit near 0.5, below every threshold)."""
    jcfg, cfg = jada.AdaGMLConfig(**cfg_kw), AdaGMLConfig(**cfg_kw)
    inputs = _matcher_inputs(seed, **inputs_kw)
    jmodel = jada.AdaGML(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    if conf_logit is not None:
        params = jax.tree_util.tree_map(lambda a: a, variables["params"])
        for i in range(cfg.n_layers):
            head = params[f"pooling_{i}"]["predict_3"]
            head["bias"] = jnp.full_like(head["bias"], conf_logit)
        variables = {"params": params}
    model = AdaGML(cfg)
    model.load_state_dict(adagml_state_dict(variables["params"], cfg.n_layers), strict=True)
    return jmodel, variables, model.eval(), inputs


def test_confidence_threshold_matches():
    for i in range(9):
        assert confidence_threshold(i, 9) == jada.confidence_threshold(i, 9)


def test_blocks_match_pram_tpu():
    jmodel, variables, model, (d0, d1, k0, k1, m0, m1) = _both(SMALL, seed=5)
    p = variables["params"]
    rng = np.random.RandomState(6)
    x0 = rng.randn(2, 24, 32).astype(np.float32)
    x1 = rng.randn(2, 16, 32).astype(np.float32)
    m0[1] = False  # one frame's side 0 fully masked
    with torch.no_grad():
        # Fourier encoding
        jenc = JaxFourierPE(f_dim=16).apply({"params": p["poseenc"]}, jnp.asarray(k0))
        enc = model.poseenc(T(k0))
        _close(enc[0].numpy(), jenc[0][:, 0], 1e-6, "cos")
        _close(enc[1].numpy(), jenc[1][:, 0], 1e-6, "sin")

        # self-attention with statistics
        jx, js = jada._SelfAttnStats(32, 32, 2).apply({"params": p["self_attn_1"]}, jnp.asarray(x0), jenc,
                                                    jnp.asarray(m0))
        x, s = model.self_attn[1](T(x0), enc, T(m0))
        _close(x.numpy(), jx, 1e-5, "self block")
        _close(s.numpy(), js, 1e-5, "self statistic")

        # cross-attention with statistics
        jout = jada._CrossAttnStats(32, 32, 2).apply({"params": p["cross_attn_2"]}, jnp.asarray(x0),
                                                    jnp.asarray(x1), jnp.asarray(m0), jnp.asarray(m1))
        out = model.cross_attn[2](T(x0), T(x1), T(m0), T(m1))
        for got, want, what in zip(out, jout, ("x0", "x1", "stat0", "stat1")):
            _close(got.numpy(), want, 1e-5, f"cross block {what}")

        # pooling head
        score = rng.rand(2, 24, 2).astype(np.float32) * 0.1
        jc = jada.PoolingLayer(32).apply({"params": p["pooling_0"]}, jnp.asarray(x0), jnp.asarray(score))
        _close(model.pooling[0](T(x0), T(score)).numpy(), jc, 1e-5, "pooling")


def _assert_same_outcome(out, jout, plan_rtol=5e-4, plan_atol=5e-5):
    for k in ("mask0", "mask1", "stop_layer"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_allclose(out["plan"].numpy(), np.asarray(jout["plan"]), rtol=plan_rtol, atol=plan_atol)


def test_adagml_forms_match_pram_tpu():
    """The unrolled module (with its per-layer confidences), the batched
    early exit and the online form, each against its JAX counterpart."""
    jmodel, variables, model, inputs = _both(SMALL, seed=7)
    jin = tuple(map(jnp.asarray, inputs))
    tin = tuple(map(T, inputs))
    with torch.no_grad():
        out = model(*tin)
    jout = jmodel.apply(variables, *jin)
    _assert_same_outcome(out, jout)
    for k in ("confidences0", "confidences1"):
        _close(out[k].numpy(), jout[k], 1e-5, k)
    assert (out["mask0"].numpy() != inputs[4]).any()  # pruning took place

    stacked = jada.stack_adagml_layers(variables, SMALL["n_layers"])
    jcfg = jada.AdaGMLConfig(**SMALL)
    _assert_same_outcome(adagml_batched_adaptive_apply(model, *tin),
                         jada.adagml_batched_adaptive_apply(stacked, *jin, cfg=jcfg))
    one = tuple(a[:1] for a in inputs)
    _assert_same_outcome(adagml_online_apply(model, *map(T, one)),
                         jada.adagml_online_apply(stacked, *map(jnp.asarray, one), cfg=jcfg))

    m = extract_matches(out["plan"], 0.2).matches0
    assert not (m.numpy() >= 0)[~out["mask0"].numpy()].any()  # pruned tokens do not match


# (config, pooling output bias): early stop with pruning (frames stopping
# at different layers), pruning and no stop, and pruning blocked by the
# token floor
EXIT_CASES = {
    "early_stop": (dict(SMALL, n_layers=5, stop_ratio=0.97), 0.5),
    "no_stop": (dict(SMALL, n_layers=5, stop_ratio=1.0), 0.5),
    "no_pruning": (dict(SMALL, n_layers=5, stop_ratio=0.97, n_min_tokens=10**6), 1.5),
}


@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_early_exit_equals_unrolled(case):
    """adagml_batched_adaptive_apply against the unrolled module, in the
    port and in pram_tpu, on the same inputs: equal plan, masks and stop
    layers."""
    cfg_kw, conf_logit = EXIT_CASES[case]
    jmodel, variables, model, inputs = _both(cfg_kw, seed=8, conf_logit=conf_logit, b=4)
    tin = tuple(map(T, inputs))
    with torch.no_grad():
        full = model(*tin)
    early = adagml_batched_adaptive_apply(model, *tin)
    for k in ("plan", "mask0", "mask1", "stop_layer"):
        np.testing.assert_array_equal(early[k].numpy(), full[k].numpy(), err_msg=k)

    jin = tuple(map(jnp.asarray, inputs))
    jfull = jmodel.apply(variables, *jin)
    jearly = jada.adagml_batched_adaptive_apply(
        jada.stack_adagml_layers(variables, cfg_kw["n_layers"]), *jin, cfg=jada.AdaGMLConfig(**cfg_kw))
    for k in ("mask0", "mask1", "stop_layer"):
        np.testing.assert_array_equal(np.asarray(jearly[k]), np.asarray(jfull[k]), err_msg=k)
    # XLA compiles the one-hot out_proj contraction and the gather apart
    np.testing.assert_allclose(np.asarray(jearly["plan"]), np.asarray(jfull["plan"]), rtol=1e-5, atol=1e-6)

    stop = full["stop_layer"].numpy()
    pruned = (full["mask0"].numpy() != inputs[4]).any() or (full["mask1"].numpy() != inputs[5]).any()
    if case == "early_stop":
        assert stop.min() < cfg_kw["n_layers"] - 1 and len(set(stop.tolist())) > 1
    elif case == "no_stop":
        assert (stop == cfg_kw["n_layers"] - 1).all() and pruned
    else:
        assert not pruned and stop.min() < cfg_kw["n_layers"] - 1
    _assert_same_outcome(full, jfull)


def test_load_adagml_round_trip():
    """Every flax leaf of the trained Aachen AdaGML lands in the strict state
    dict: kernels transposed, the qkv columns in (head, head_dim, 3) order."""
    tree = read_flax_msgpack(WEIGHTS)
    assert len(tree) == 3 + 4 * 9
    model = load_adagml(WEIGHTS, AdaGMLConfig(), device="cpu")
    np.testing.assert_array_equal(model.self_attn[4].qkv.weight.detach().numpy(),
                                  np.asarray(tree["self_attn_4"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(model.pooling[8].score_enc_0.weight.detach().numpy(),
                                  np.asarray(tree["pooling_8"]["score_enc_0"]["kernel"]).T)
    assert model.bin_score.shape == () and model.pooling[0].predict_ln.eps == 1e-6
    short = load_adagml(WEIGHTS, AdaGMLConfig(n_layers=2), device="cpu")
    assert len(short.out_proj) == 2


def test_adagml_match_fn_reads_early_exit_switch(monkeypatch):
    _, _, model, (d0, d1, k0, k1, m0, m1) = _both(SMALL, seed=9)
    args = (T(d0), T(k0), None, T(m0), T(d1), T(k1), None, T(m1))
    with torch.no_grad():
        want = extract_matches(model(T(d0), T(d1), T(k0), T(k1), T(m0), T(m1))["plan"]).matches0
    monkeypatch.setenv("PRAM_ADA_EXIT", "0")
    np.testing.assert_array_equal(make_adagml_match_fn(model)(*args).numpy(), want.numpy())
    monkeypatch.setenv("PRAM_ADA_EXIT", "1")
    np.testing.assert_array_equal(make_adagml_match_fn(model)(*args).numpy(), want.numpy())
