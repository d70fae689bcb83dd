"""GML matcher of the port against pram_tpu on the CPU, in f32.

The JAX side runs as its own tests run it here: the XLA path of its flax
modules, and the Pallas kernels in interpret mode. Tolerances:
- blocks and the plain twins of the attention kernels: 1e-5 (f32 summation
  order; the XLA cross path also scales qk by scale**0.5 on each side);
- Sinkhorn: the real block within 1e-5 of the XLA path and 1e-4 of the
  Pallas kernel; the dustbin row and column within 0.3% of the kernel
  (ops/sinkhorn_pallas.py documents ~0.2% between kernel and XLA);
- mutual matches: exact on the same plan;
- GML plan: 2e-5 after 2 random layers; 1e-4 after 9 trained layers at full
  width; matches exact in both.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pram_tpu.models.common import CrossAttentionBlock as JaxCrossBlock
from pram_tpu.models.common import SelfAttentionBlock as JaxSelfBlock
from pram_tpu.models.gml import GML as JaxGML
from pram_tpu.models.gml import GMLConfig as JaxGMLConfig
from pram_tpu.ops.attention_pallas import (
    fused_cross_attention_proj,
    fused_self_attention_proj,
    permute_qkv_kernel,
)
from pram_tpu.ops.matching import mutual_matches as jax_mutual_matches
from pram_tpu.ops.sinkhorn import dual_softmax_matching as jax_dual_softmax
from pram_tpu.ops.sinkhorn import sinkhorn_matching as jax_sinkhorn
from pram_tpu.ops.sinkhorn_pallas import sinkhorn_matching_pallas
from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
from pram_tpu_torch.models.common import CrossAttentionBlock, SelfAttentionBlock
from pram_tpu_torch.models.convert import flax_to_state_dict, gml_state_dict, load_gml
from pram_tpu_torch.models.gml import GML, GMLConfig, extract_matches
from pram_tpu_torch.ops.attention import mask_to_bias, self_attention
from pram_tpu_torch.ops.cross_attention import cross_attention
from pram_tpu_torch.ops.matching import mutual_matches
from pram_tpu_torch.ops.sinkhorn import dual_softmax_matching, sinkhorn, sinkhorn_matching

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "gml_synthetic.msgpack",
)
T = torch.from_numpy


def _masks(rng, b, n0, n1):
    m0 = rng.rand(b, n0) > 0.15
    m1 = rng.rand(b, n1) > 0.3
    return m0, m1


def test_load_gml_round_trip():
    """Every flax leaf lands in the strict state dict, kernels transposed."""
    tree = read_flax_msgpack(WEIGHTS)
    model = load_gml(WEIGHTS, GMLConfig(), device="cpu")
    sd = model.state_dict()
    assert sorted(k for k in tree if k.startswith("out_proj_")) == ["out_proj_8"]
    np.testing.assert_array_equal(sd["bin_score"].numpy(), np.float32(tree["bin_score"]))
    np.testing.assert_array_equal(sd["out_proj.weight"].numpy(), tree["out_proj_8"]["kernel"].T)
    np.testing.assert_array_equal(sd["poseenc.Wr.weight"].numpy(), tree["poseenc"]["Wr"]["kernel"].T)
    for i in (0, 8):
        for blk in ("self_attn", "cross_attn"):
            for name, leaf in tree[f"{blk}_{i}"].items():
                for kind, arr in leaf.items():
                    key = f"{blk}.{i}.{name}." + {"kernel": "weight", "scale": "weight"}.get(kind, kind)
                    want = arr.T if kind == "kernel" else arr
                    np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(sd) == n_leaves
    # the torch qkv keeps the flax column order (head, head_dim, q/k/v)
    assert sd["self_attn.0.qkv.weight"].shape == (768, 256)
    with pytest.raises(ValueError, match="layers"):
        gml_state_dict(tree, 10)
    bf = load_gml(WEIGHTS, GMLConfig(n_layers=2), device="cpu", dtype=torch.bfloat16)
    assert bf.bin_score.dtype == torch.bfloat16 and len(bf.self_attn) == 2


def test_self_attention_splits_matches_pallas_interpret():
    """Block-diagonal plain twin of csrc/attention.cu against the TPU kernel."""
    b, splits, d, heads = 2, (128, 256), 64, 2
    n, hd = sum(splits), d // heads
    rng = np.random.RandomState(10)
    x = rng.randn(b, n, d).astype(np.float32)
    kernel = (rng.randn(d, 3 * d) / np.sqrt(d)).astype(np.float32)
    bias = (rng.randn(3 * d) * 0.1).astype(np.float32)
    ang = rng.randn(b, n, hd // 2).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)
    mask = rng.rand(b, n) > 0.2
    mask[1, :128] = False  # frame 1's first side is all padding
    key_bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    wp, bp = permute_qkv_kernel(jnp.asarray(kernel), jnp.asarray(bias), heads, hd)
    ref = np.asarray(fused_self_attention_proj(
        jnp.asarray(x), wp, bp, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(key_bias), hd**-0.5, heads, splits, interpret=True,
    ))
    got = self_attention(
        T(x), T(kernel.T.copy()), T(bias), T(cos), T(sin),
        mask_to_bias(T(mask), b, n, "cpu"), hd**-0.5, heads, splits,
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_self_attention_block_splits_matches():
    d, heads, splits = 64, 4, (48, 80)
    rng = np.random.RandomState(11)
    b, n = 2, sum(splits)
    x = rng.randn(b, n, d).astype(np.float32)
    ang = rng.randn(b, 1, n, d // heads // 2).astype(np.float32)
    enc = (np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1))
    mask = rng.rand(b, n) > 0.2
    jb = JaxSelfBlock(feat_dim=d, hidden_dim=d, num_heads=heads)
    jenc = tuple(jnp.asarray(e) for e in enc)
    params = jb.init(jax.random.PRNGKey(3), jnp.asarray(x), jenc, jnp.asarray(mask), splits=splits)
    ref = np.asarray(jb.apply(params, jnp.asarray(x), jenc, jnp.asarray(mask), splits=splits))
    tb = SelfAttentionBlock(d, d, heads)
    tb.load_state_dict(flax_to_state_dict(params["params"]))
    with torch.no_grad():
        got = tb(T(x), tuple(T(e[:, 0].copy()) for e in enc), T(mask), splits=splits).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("all_masked", [False, True])
def test_cross_attention_block_matches(all_masked):
    """Cat-form cross block against the JAX block's XLA path, with padding;
    ``all_masked``: frame 1's side 1 is all padding (side 0 gets mean(v1))."""
    d, heads, n0, n1, b = 64, 4, 40, 72, 2
    rng = np.random.RandomState(12)
    x = rng.randn(b, n0 + n1, d).astype(np.float32)
    m0, m1 = _masks(rng, b, n0, n1)
    if all_masked:
        m1[1] = False
    jb = JaxCrossBlock(feat_dim=d, hidden_dim=d, num_heads=heads)
    args = (jnp.asarray(x), None, jnp.asarray(m0), jnp.asarray(m1))
    params = jb.init(jax.random.PRNGKey(4), *args, splits=(n0, n1))
    ref = np.asarray(jb.apply(params, *args, splits=(n0, n1))[0])
    tb = CrossAttentionBlock(d, d, heads)
    tb.load_state_dict(flax_to_state_dict(params["params"]))
    with torch.no_grad():
        got = tb(T(x), (n0, n1), T(m0), T(m1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cross_attention_plain_matches_pallas_interpret():
    """The plain twin of csrc/cross_attention.cu against the TPU kernel, with
    padded masks and one all-masked side."""
    b, n0, n1, d, heads = 2, 64, 96, 64, 2
    rng = np.random.RandomState(13)
    x = rng.randn(b, n0 + n1, d).astype(np.float32)
    w_qk, w_v = ((rng.randn(d, d) / np.sqrt(d)).astype(np.float32) for _ in range(2))
    b_qk, b_v = ((rng.randn(d) * 0.1).astype(np.float32) for _ in range(2))
    m0, m1 = _masks(rng, b, n0, n1)
    m0[1] = False
    bias0 = np.where(m0, 0.0, -1e9).astype(np.float32)
    bias1 = np.where(m1, 0.0, -1e9).astype(np.float32)
    scale = (d // heads) ** -0.5
    ref = np.asarray(fused_cross_attention_proj(
        *(jnp.asarray(a) for a in (x, w_qk, b_qk, w_v, b_v, bias0, bias1)),
        scale, heads, n0, interpret=True,
    ))
    got = cross_attention(
        T(x), T(w_qk.T.copy()), T(b_qk), T(w_v.T.copy()), T(b_v), T(bias0), T(bias1),
        scale, heads, n0,
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_matches_xla_and_pallas_interpret(masked):
    b, n, m = 2, 40, 60
    rng = np.random.RandomState(14)
    sim = (rng.randn(b, n, m) * 3).astype(np.float32)
    m0, m1 = _masks(rng, b, n, m) if masked else (None, None)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (T(m0), T(m1))
    xla = np.asarray(jax_sinkhorn(jnp.asarray(sim), jnp.asarray(0.8), 20, *jm))
    pal = np.asarray(sinkhorn_matching_pallas(
        jnp.asarray(sim), jnp.asarray(0.8), 20, *jm, interpret=True))
    got = sinkhorn(T(sim), torch.tensor(0.8), 20, *tm).numpy()
    np.testing.assert_array_equal(got, sinkhorn_matching(T(sim), 0.8, 20, *tm).numpy())
    np.testing.assert_allclose(got[:, :n, :m], xla[:, :n, :m], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, :n, :m], pal[:, :n, :m], rtol=0, atol=1e-4)
    for ours, kern in ((got[:, n], pal[:, n]), (got[:, :, m], pal[:, :, m])):
        np.testing.assert_allclose(ours, kern, rtol=3e-3, atol=1e-7)
    if masked:
        assert (got[:, :n][~m0] == 0).all()
        assert (got[:, :, :m].transpose(0, 2, 1)[~m1] == 0).all()


def test_dual_softmax_matches():
    b, n, m = 2, 20, 30
    rng = np.random.RandomState(15)
    sim = rng.randn(b, n, m).astype(np.float32)
    m0, m1 = _masks(rng, b, n, m)
    ref = np.asarray(jax_dual_softmax(jnp.asarray(sim), jnp.asarray(1.0), jnp.asarray(m0), jnp.asarray(m1)))
    got = dual_softmax_matching(T(sim), torch.tensor(1.0), T(m0), T(m1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_mutual_matches_exact():
    rng = np.random.RandomState(16)
    b, n, m = 3, 50, 70
    plan = rng.rand(b, n + 1, m + 1).astype(np.float32) ** 4
    # planted mutual pairs above the threshold, one exact tie, one below it
    for i in range(0, 40, 3):
        plan[:, i, (2 * i) % m] = 0.5 + 0.01 * i
    plan[0, 5, 7] = plan[0, 5, 8] = 0.9
    plan[1, 9, 18] = 0.15
    ref = jax_mutual_matches(jnp.asarray(plan), 0.2)
    got = mutual_matches(T(plan), 0.2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got.matches0.numpy() >= 0).sum() >= 3 * 10
    np.testing.assert_array_equal(extract_matches(T(plan)).matches0.numpy(), got.matches0.numpy())


def _gml_inputs(rng, b, n0, n1, d=128):
    desc0 = rng.randn(b, n0, d).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = rng.randn(b, n1, d).astype(np.float32)
    desc1[:, : n0 // 2] = desc0[:, : n0 // 2] + rng.randn(b, n0 // 2, d) * 0.1
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    k0 = (rng.rand(b, n0, 2) - 0.5).astype(np.float32)
    k1 = (rng.rand(b, n1, 2) - 0.5).astype(np.float32)
    k1[:, : n0 // 2] = k0[:, : n0 // 2]
    m0, m1 = _masks(rng, b, n0, n1)
    return desc0, desc1, k0, k1, m0, m1


@pytest.mark.parametrize("with_sinkhorn", [True, False])
def test_gml_two_random_layers_match(with_sinkhorn):
    """``with_sinkhorn=False`` reads the plan out by dual softmax instead."""
    rng = np.random.RandomState(17)
    inputs = _gml_inputs(rng, 2, 48, 80)
    jm = JaxGML(JaxGMLConfig(n_layers=2, with_sinkhorn=with_sinkhorn))
    variables = jm.init(jax.random.PRNGKey(5), *(jnp.asarray(a) for a in inputs))
    ref = jm.apply(variables, *(jnp.asarray(a) for a in inputs))
    tm = GML(GMLConfig(n_layers=2, with_sinkhorn=with_sinkhorn))
    tm.load_state_dict(gml_state_dict(variables["params"], 2), strict=True)
    with torch.no_grad():
        got = tm(*(T(a) for a in inputs))
    plan, jplan = got["plan"].numpy(), np.asarray(ref["plan"])
    np.testing.assert_allclose(plan, jplan, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["mdesc0"].numpy(), np.asarray(ref["mdesc0"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        mutual_matches(got["plan"], 0.01).matches0.numpy(),
        np.asarray(jax_mutual_matches(ref["plan"], 0.01).matches0),
    )


def test_gml_full_width_trained_matches():
    """9 layers, d=256, trained weights, 512 x 1024 tokens, 2 frames in f32."""
    rng = np.random.RandomState(18)
    inputs = _gml_inputs(rng, 2, 512, 1024)
    with open(WEIGHTS, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    ref = jax.jit(lambda *a: JaxGML(JaxGMLConfig()).apply({"params": params}, *a)["plan"])(
        *(jnp.asarray(a) for a in inputs))
    tm = load_gml(WEIGHTS, GMLConfig(), device="cpu")
    with torch.no_grad():
        plan = tm(*(T(a) for a in inputs))["plan"]
    np.testing.assert_allclose(plan.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    got = mutual_matches(plan, 0.2).matches0.numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mutual_matches(ref, 0.2).matches0))
    # the planted pairs are found: half of side 0 matches its twin
    twins = got[:, :256] == np.arange(256)[None]
    assert twins.sum() >= 0.8 * (inputs[4][:, :256] & inputs[5][:, :256]).sum()
