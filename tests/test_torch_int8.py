"""The port's int8 path against pram_tpu on the CPU.

The JAX side runs as its own tests run it here: the Pallas kernels with
``interpret=True`` (or ``_INTERPRET`` patched), its XLA s8 route otherwise.
The port runs its plain versions (the kernels' wrappers take them for CPU
tensors). Inputs are made from a seed with numpy. Tolerances:

- the quantizers: bit-equal integers and scales, .5 ties included; the
  int8 conv kernel's quantizer arithmetic (``csrc/conv_tile.cuh``,
  mirrored in numpy with exact fmas) bit-equal to ``quant_static`` on
  every bf16 value at fixed and calibrated scales;
- kernel 18 (int8 conv, both strides) against the Pallas kernel: within
  rtol = atol = 1e-5 (``tests/test_conv_int8.py:57``'s bound; the integer
  sums are exact on both sides, the f32 tails may differ by FMA
  contraction); the XLA route's tail in f32 the same, and in bf16 every
  element within one bf16 step (2^-8 of its magnitude) of the JAX route,
  since XLA may keep the tail's intermediate in f32 where the port rounds
  each operation;
- kernel 16 (int8 MLP) and kernel 17 (int8 projections of the self- and
  cross-attention) against the Pallas kernels in f32: the quantized
  activations may flip by one step where an f32 value differs by an ulp
  (the GELU, a sum order), so outputs within 2e-3 of their scale; kernel
  17's projection alone, on the same quantized inputs, bit-equal;
- kernel 19 (conv pair) against the Pallas kernel: rtol = atol = 1e-4
  (``tests/test_convpair_pallas.py``'s bound);
- ``quantize_extractor`` from ``weights/sfd2_rendered.msgpack`` on the 4
  calibration views: s8 weights equal on >= 99.99% of the entries and never
  more than 1 apart, scales within 1e-5 relative (the calibration maxima
  come from f32 forwards summed in another order);
- ``Int8ResNet4x`` on the JAX package's own qparams, carried across, on
  rendered 96 x 128 views in f32, on both conv routes: keypoint sets agree
  >= 0.99, descriptor cosine >= 0.999, dense outputs within 1e-2 of their
  scale (an activation one quantization step off moves later layers);
- the self- and cross-attention blocks with ``int8_proj`` and ``int8_mlp``
  against the JAX blocks with ``PRAM_INT8_PROJ=1 PRAM_INT8_MLP=1`` and the
  interpret patches of ``tests/test_mlp_int8.py``: within 2e-3 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pram_tpu.models.common as jcommon
import pram_tpu.ops.attention_pallas as jap
import pram_tpu.ops.mlp_pallas as jmp
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.models.sfd2 import extract as jax_extract
from pram_tpu.models.sfd2 import preprocess_image as jax_preprocess
from pram_tpu.models.sfd2_int8 import Int8ResNet4x as JaxInt8ResNet4x
from pram_tpu.models.sfd2_int8 import _quant_w, quantize_extractor as jax_quantize_extractor
from pram_tpu.ops.conv_int8_pallas import conv3x3_int8 as jax_conv3x3_int8
from pram_tpu.ops.conv_int8_pallas import conv3x3s2_int8 as jax_conv3x3s2_int8
from pram_tpu.ops.convpair_pallas import fused_conv_pair as jax_fused_conv_pair
from pram_tpu_torch.engine.rendered_guard import SFD2_W, calibration_views, extraction_agreement
from pram_tpu_torch.models.common import CrossAttentionBlock, SelfAttentionBlock
from pram_tpu_torch.models.convert import flax_to_state_dict, int8_extractor_state, load_sfd2
from pram_tpu_torch.models.sfd2 import extract, preprocess_image
from pram_tpu_torch.models.sfd2_int8 import Int8ResNet4x, quantize_extractor
from pram_tpu_torch.ops import conv_int8, convpair, mlp
from pram_tpu_torch.ops.attention import project_int8_plain, self_attention_int8_plain
from pram_tpu_torch.ops.cross_attention import cross_attention_int8_plain
from pram_tpu_torch.ops.quant import quant_cols, quant_linear, quant_rows, quant_static, quant_w

T = torch.from_numpy


def _scaled_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# ---- the quantizers -------------------------------------------------------


def test_quantizers_equal_pram_tpu(rng):
    a = rng.randn(6, 40).astype(np.float32) * 3
    # row 0 and column 0: max 127 -> scale exactly 1, so the .5 values tie
    ties = np.array([127.0, 2.5, 3.5, -0.5, 0.5, 1.5, -2.5, 126.5], np.float32)
    a[0, :8] = ties
    a[0, 8:] = 0.25
    a[:, 0] = 0.0
    a[:6, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    q, rs = quant_rows(T(a))
    jq, jrs = jmp._quant_rows(jnp.asarray(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
    assert q[0, :8].tolist() == [127, 2, 4, -0, 0, 2, -2, 126]

    q, ws = quant_cols(T(a))
    jq, jws = jmp._quant_cols(jnp.asarray(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    assert q[:6, 0].tolist() == [127, 2, -4, 0, -0, 2]
    lq, lws = quant_linear(T(a.T.copy()))
    np.testing.assert_array_equal(lq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(lws.numpy(), np.asarray(jws)[0])

    k = rng.randn(3, 3, 16, 8).astype(np.float32)
    k[..., 0] = 0.0
    k[0, 0, :4, 0] = [127.0, 2.5, -3.5, 0.5]
    q, s = quant_w(T(k))
    jq, js = _quant_w(jnp.asarray(k))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, :4, 0].tolist() == [127, 2, -4, 0]


# ---- kernel 18: the int8 conv ------------------------------------------------


def _conv_case(rng, b, h, w, cin, cout):
    x = np.abs(rng.randn(b, h, w, cin)).astype(np.float32)
    wf = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05
    ws = np.maximum(np.abs(wf).reshape(-1, cout).max(0), 1e-12) / 127.0
    wq = np.clip(np.round(wf / ws), -127, 127).astype(np.int8)
    bias = rng.randn(cout).astype(np.float32) * 0.1
    sa = np.float32(np.abs(x).max() / 127.0)
    return x, wq, sa, ws.astype(np.float32), bias


@pytest.mark.parametrize(
    "stride,cin,cout,relu", [(1, 128, 256, True), (1, 256, 128, False), (2, 128, 128, True), (2, 256, 256, False)]
)
def test_conv3x3_int8_matches_pallas(rng, stride, cin, cout, relu):
    b, h, w = 2, 16, 24
    x, wq, sa, ws, bias = _conv_case(rng, b, h, w, cin, cout)
    jfn = jax_conv3x3_int8 if stride == 1 else jax_conv3x3s2_int8
    gate = conv_int8.conv3x3_int8_supported if stride == 1 else conv_int8.conv3x3s2_int8_supported
    assert gate(h, w, cin, cout)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(wq), sa, jnp.asarray(ws), jnp.asarray(bias),
                         relu=relu, interpret=True))
    got = conv_int8.conv3x3_int8(T(x), T(wq), float(sa), T(ws), T(bias), stride=stride, relu=relu)
    assert got.shape == ref.shape == (b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the XLA route's tail agrees in f32
    tail = conv_int8.conv3x3_int8(T(x), T(wq), float(sa), T(ws), T(bias), stride=stride, relu=relu,
                                  bf16_tail=True)
    np.testing.assert_allclose(tail.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_conv_gates_equal_pram_tpu():
    from pram_tpu.ops import conv_int8_pallas as cip

    for h, w in ((480, 640), (240, 320), (120, 160), (60, 80), (16, 24), (12, 16)):
        for cin, cout in ((64, 128), (128, 128), (128, 256), (256, 256)):
            assert conv_int8.conv3x3_int8_supported(h, w, cin, cout) == cip.conv3x3_int8_supported(h, w, cin, cout)
            assert conv_int8.conv3x3s2_int8_supported(h, w, cin, cout) == cip.conv3x3s2_int8_supported(h, w, cin, cout)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,cin", [(1, 64), (1, 256), (2, 128)])
def test_conv_xla_route_matches_pram_tpu(rng, dtype, stride, cin):
    """The layers the TPU gate refuses (conv2a: 64 channels; convPa_3: 60
    rows) take the XLA s8 route in both packages: the same s8 sums and the
    tail in the working type."""
    x, wq, sa, ws, bias = _conv_case(rng, 2, 12, 20, cin, 128)
    qp = {"l_in_scale": jnp.asarray(sa), "l_wq": jnp.asarray(wq), "l_wscale": jnp.asarray(ws),
          "l_bias": jnp.asarray(bias)}
    ref = np.asarray(
        JaxInt8ResNet4x()._qlayer(qp, "l", jnp.asarray(x).astype(dtype), (stride, stride)), np.float32
    )
    tdt = getattr(torch, dtype)
    got = conv_int8.conv3x3_int8(T(x).to(tdt), T(wq), float(sa), T(ws), T(bias), stride=stride,
                                 bf16_tail=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        step = np.maximum(np.abs(ref), np.abs(got)) * 2.0**-8
        assert (np.abs(got - ref) <= step + 1e-30).all(), np.abs(got - ref).max()
        assert (got == ref).mean() >= 0.9


# ---- kernel 19: the conv pair ------------------------------------------------


def _pair_params(rng, cin, cmid, cout):
    def t(*s):
        return rng.randn(*s).astype(np.float32) * 0.1

    k1, b1 = t(3, 3, cin, cmid), t(cmid)
    bn1 = (t(cmid) * 0.2 + 1.0, t(cmid), t(cmid) * 0.1, np.abs(t(cmid)) + 0.5)
    k2, b2 = t(3, 3, cmid, cout) * 0.5, t(cout)
    bn2 = (t(cout) * 0.2 + 1.0, t(cout), t(cout) * 0.1, np.abs(t(cout)) + 0.5)
    return k1, b1, bn1, k2, b2, bn2


@pytest.mark.parametrize("h,w,b,cin,cmid,cout", [(24, 12, 1, 8, 16, 24), (48, 20, 2, 8, 16, 24), (16, 24, 1, 128, 256, 256)])
def test_conv_pair_matches_pallas(rng, h, w, b, cin, cmid, cout):
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k1, b1, bn1, k2, b2, bn2 = _pair_params(rng, cin, cmid, cout)
    ref = np.asarray(jax_fused_conv_pair(
        jnp.asarray(x), jnp.asarray(k1), jnp.asarray(b1), tuple(map(jnp.asarray, bn1)),
        jnp.asarray(k2), jnp.asarray(b2), tuple(map(jnp.asarray, bn2)), interpret=True,
    ))

    def oihw(k):
        return T(k.transpose(3, 2, 0, 1).copy())

    got = convpair.fused_conv_pair(
        T(x), oihw(k1), T(b1), tuple(map(T, bn1)), oihw(k2), T(b2), tuple(map(T, bn2))
    )
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


# ---- kernel 16: the int8 residual MLP -----------------------------------------


def _mlp_case(rng, b, n, d=256, dh=512):
    def t(*s, scale=1.0):
        return rng.randn(*s).astype(np.float32) * scale

    return dict(
        x=t(b, n, d), msg=t(b, n, d), wp=t(d, d, scale=d ** -0.5), bp=t(d, scale=0.1),
        w0=t(2 * d, dh, scale=(2 * d) ** -0.5), b0=t(dh, scale=0.1),
        g=1.0 + t(dh, scale=0.1), be=t(dh, scale=0.1), w3=t(dh, d, scale=dh ** -0.5), b3=t(d, scale=0.1),
    )


def _port_mlp_int8(c):
    wpq, wps = quant_linear(T(c["wp"].T.copy()))
    w0q, w0s = quant_linear(T(c["w0"].T.copy()))
    w3q, w3s = quant_linear(T(c["w3"].T.copy()))
    return mlp.residual_mlp_int8(
        T(c["x"]), T(c["msg"]), wpq, wps, T(c["bp"]), w0q, w0s, T(c["b0"]), T(c["g"]), T(c["be"]),
        w3q, w3s, T(c["b3"]),
    )


def test_residual_mlp_int8_matches_pallas(rng):
    c = _mlp_case(rng, 2, 128)
    ref = np.asarray(jmp.fused_residual_mlp_int8(
        *(jnp.asarray(c[k]) for k in ("x", "msg", "wp", "bp", "w0", "b0", "g", "be", "w3", "b3")),
        interpret=True,
    ))
    got = _port_mlp_int8(c).numpy()
    assert _scaled_err(got, ref) <= 2e-3
    # all but a few elements agree to f32 rounding
    assert (np.abs(got - ref) <= 1e-5 * np.abs(ref).max()).mean() >= 0.99


def test_mlp_int8_gate_equals_pram_tpu():
    for n in (128, 512, 1536, 1544, 4096, 6144):
        for itemsize in (2, 4):
            assert mlp.fused_mlp_int8_supported(n, 256, 512, itemsize) == jmp.fused_mlp_int8_supported(
                n, 256, 512, itemsize)


# ---- kernel 17: the int8 projections of the attention kernels -----------------


def _attn_case(rng, b, n, d=256, heads=4):
    hd = d // heads
    x = rng.randn(b, n, d).astype(np.float32)
    kernel = (rng.randn(d, 3 * d) * d ** -0.5).astype(np.float32)  # flax [in, (h, hd, 3)]
    bias = (rng.randn(3 * d) * 0.1).astype(np.float32)
    ang = rng.rand(b, n, hd // 2).astype(np.float32) * 6
    cos = np.repeat(np.cos(ang), 2, -1).astype(np.float32)
    sin = np.repeat(np.sin(ang), 2, -1).astype(np.float32)
    key_bias = np.where(rng.rand(b, n) > 0.2, 0.0, -1e9).astype(np.float32)
    return x, kernel, bias, cos, sin, key_bias


def test_self_attention_int8_matches_pallas(rng):
    b, d, heads, splits = 2, 256, 4, (128, 256)
    n = sum(splits)
    x, kernel, bias, cos, sin, key_bias = _attn_case(rng, b, n, d, heads)
    wp, bp = jap.permute_qkv_kernel(jnp.asarray(kernel), jnp.asarray(bias), heads, d // heads)
    scale = (d // heads) ** -0.5
    ref = np.asarray(jap.fused_self_attention_proj(
        jnp.asarray(x), wp, bp, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(key_bias), scale, heads,
        splits, int8=True, interpret=True,
    ))
    wq, ws = quant_linear(T(kernel.T.copy()))
    got = self_attention_int8_plain(T(x), wq, ws, T(bias), T(cos), T(sin), T(key_bias), scale, heads, splits)
    assert got.shape == ref.shape == (b, n, d)
    assert _scaled_err(got.numpy(), ref) <= 2e-3

    # the projection alone, against the JAX kernel's scratch arithmetic
    jq, jrs = jmp._quant_rows(jnp.asarray(x))
    jwq, jws = jmp._quant_cols(jnp.asarray(kernel))
    jproj = np.asarray(jax.lax.dot_general(
        jq, jwq, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * jrs * jws + jnp.asarray(bias))
    np.testing.assert_array_equal(project_int8_plain(T(x), wq, ws, T(bias)).numpy(), jproj)


def test_cross_attention_int8_matches_pallas(rng):
    b, d, heads, n0, n1 = 2, 256, 4, 128, 256
    x = rng.randn(b, n0 + n1, d).astype(np.float32)
    w_qk, w_v = ((rng.randn(d, d) * d ** -0.5).astype(np.float32) for _ in range(2))
    b_qk, b_v = ((rng.randn(d) * 0.1).astype(np.float32) for _ in range(2))
    bias0 = np.where(rng.rand(b, n0) > 0.2, 0.0, -1e9).astype(np.float32)
    bias1 = np.where(rng.rand(b, n1) > 0.2, 0.0, -1e9).astype(np.float32)
    scale = (d // heads) ** -0.5
    ref = np.asarray(jap.fused_cross_attention_proj(
        *(jnp.asarray(a) for a in (x, w_qk, b_qk, w_v, b_v, bias0, bias1)), scale, heads, n0,
        int8=True, interpret=True,
    ))
    (wq_qk, ws_qk), (wq_v, ws_v) = quant_linear(T(w_qk.T.copy())), quant_linear(T(w_v.T.copy()))
    got = cross_attention_int8_plain(T(x), wq_qk, ws_qk, T(b_qk), wq_v, ws_v, T(b_v), T(bias0), T(bias1),
                                     scale, heads, n0)
    assert got.shape == ref.shape
    assert _scaled_err(got.numpy(), ref) <= 2e-3


# ---- the blocks ---------------------------------------------------------------


@pytest.fixture
def jax_int8_blocks(monkeypatch):
    """The JAX blocks on their int8 kernels, interpreted (tests/test_mlp_int8.py)."""
    monkeypatch.setattr(jcommon, "use_fused_attention", lambda *a: True)
    for mod, name in ((jap, "fused_self_attention_proj"), (jap, "fused_cross_attention_proj"),
                      (jmp, "fused_residual_mlp_int8")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **kw: _f(*a, interpret=True, **kw))
    monkeypatch.setenv("PRAM_INT8_PROJ", "1")
    monkeypatch.setenv("PRAM_INT8_MLP", "1")


def test_int8_blocks_match_pram_tpu(rng, jax_int8_blocks):
    from pram_tpu.models.common import CrossAttentionBlock as JaxCross
    from pram_tpu.models.common import LearnableFourierPE as JaxPE
    from pram_tpu.models.common import SelfAttentionBlock as JaxSelf

    b, n0, n1, d, heads = 2, 128, 256, 256, 4
    x = jnp.asarray(rng.randn(b, n0 + n1, d).astype(np.float32))
    mask = jnp.asarray(rng.rand(b, n0 + n1) > 0.2)
    kxy = jnp.asarray(rng.rand(b, n0 + n1, 2).astype(np.float32))
    pe = JaxPE(f_dim=d // heads)
    enc = pe.apply(pe.init(jax.random.PRNGKey(2), kxy), kxy)

    sa = JaxSelf(feat_dim=d, hidden_dim=d, num_heads=heads)
    svars = sa.init(jax.random.PRNGKey(0), x, enc, mask, (n0, n1))
    ref = np.asarray(sa.apply(svars, x, enc, mask, (n0, n1)))
    blk = SelfAttentionBlock(d, d, heads)
    blk.load_state_dict(flax_to_state_dict(jax.device_get(svars["params"])))
    cos, sin = (T(np.array(a[:, 0])) for a in enc)
    with torch.no_grad():
        got = blk(T(np.array(x)), (cos, sin), T(np.array(mask)), splits=(n0, n1), int8_proj=True,
                  int8_mlp=True).numpy()
        float_out = blk(T(np.array(x)), (cos, sin), T(np.array(mask)), splits=(n0, n1)).numpy()
    assert _scaled_err(got, ref) <= 2e-3
    assert _scaled_err(float_out, got) > 2 * _scaled_err(got, ref)  # the int8 route was taken

    ca = JaxCross(feat_dim=d, hidden_dim=d, num_heads=heads)
    m0, m1 = mask[:, :n0], mask[:, n0:]
    cvars = ca.init(jax.random.PRNGKey(1), x, None, m0, m1, (n0, n1))
    ref, _ = ca.apply(cvars, x, None, m0, m1, (n0, n1))
    cblk = CrossAttentionBlock(d, d, heads)
    cblk.load_state_dict(flax_to_state_dict(jax.device_get(cvars["params"])))
    with torch.no_grad():
        got = cblk(T(np.array(x)), (n0, n1), T(np.array(m0)), T(np.array(m1)), int8_proj=True,
                   int8_mlp=True).numpy()
    assert _scaled_err(got, np.asarray(ref)) <= 2e-3

    with pytest.raises(RuntimeError, match="inference only"):
        blk(T(np.array(x)), (cos, sin), T(np.array(mask)), splits=(n0, n1), int8_proj=True)


# ---- the int8 extractor -------------------------------------------------------


@pytest.fixture(scope="module")
def quantized_pair():
    """(JAX int8 model, its qparams, the port's quantize_extractor) from the
    rendered weights on the 4 calibration views, in f32."""
    calib = calibration_views()
    jm = JaxResNet4x()
    tmpl = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 480, 640, 3), jnp.float32))
    with open(SFD2_W, "rb") as f:
        variables = serialization.from_bytes(tmpl, f.read())
    jq_model, qparams = jax_quantize_extractor(jm, variables, jax_preprocess(jnp.asarray(calib)))
    model = load_sfd2(SFD2_W, device="cpu")
    port = quantize_extractor(model, preprocess_image(T(calib)))
    return jq_model, jax.tree_util.tree_map(np.array, qparams), port


def test_quantize_extractor_matches_pram_tpu(quantized_pair):
    _, qparams, port = quantized_pair
    ref = int8_extractor_state(qparams)
    got = dict(port.named_buffers())
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if r.dtype == torch.int8:
            diff = (g.int() - r.int()).abs()
            assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.9999, name
        else:
            tol = 1e-5 * r.abs().max().clamp(min=1e-30)
            assert ((g - r).abs() <= tol).all(), (name, (g - r).abs().max())


def _fma32(a, b, c):
    """fmaf(a, b, c) of f32 arrays, rounded once to nearest even: the exact
    product in f64 (24 + 24 bits), its sum with c and that sum's error by
    TwoSum, rounded to f32; a sum that lands on an f32 midpoint goes to the
    side its error points to."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)  # s + e == p + c exactly
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    up, dn = np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))
    r = np.where(((s - r64) * 2 == up.astype(np.float64) - r64) & (e > 0), up, r)
    return np.where(((r64 - s) * 2 == r64 - dn.astype(np.float64)) & (e < 0), dn, r)


def _conv_tile_quant(x, s):
    """``csrc/conv_tile.cuh:quant_bits`` in numpy: v clamped to +-128 s,
    Markstein's two corrections of RN(v * RN(1 / s)) by fmas, the clip to
    +-127, then + 1.5 * 2^23, which rounds half to even into the low
    mantissa bits; the low byte is the s8 value."""
    s = np.float32(s)
    y, lim = np.float32(1) / s, np.float32(128) * s
    xc = np.minimum(np.maximum(x, -lim), lim)
    t = xc * y
    t1 = _fma32(y, _fma32(-s, t, xc), t)
    d = _fma32(y, _fma32(-s, t1, xc), t1)
    d = np.minimum(np.maximum(d, np.float32(-127)), np.float32(127)).astype(np.float32)
    return ((d + np.float32(12582912.0)).view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)


def test_conv_tile_quantizer_equals_quant_static(quantized_pair):
    """The int8 conv kernel's quantizer arithmetic equals quant_static on
    every bf16 value but NaN, at fixed scales and at every input scale that
    quantize_extractor calibrates."""
    _, _, port = quantized_pair
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    x = x[~torch.isnan(x)]
    assert x.numel() == 65536 - 254 and torch.isinf(x).sum() == 2
    scales = [2.0**-6, 1 / 127, 0.0123, 3.7e-3, 1e-4, 1.0, 45.0, *port.in_scales.values()]
    assert len(scales) > 20
    for s in scales:
        np.testing.assert_array_equal(_conv_tile_quant(x.numpy(), s), quant_static(x, s).to(torch.int8).numpy(),
                                      err_msg=f"scale {s}")


@pytest.fixture(scope="module")
def crops():
    """Two rendered views cut to 96 x 128 (divisible by 16), preprocessed."""
    imgs = calibration_views()[:2, 200:296, 256:384]
    return preprocess_image(T(np.ascontiguousarray(imgs)))


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_int8_resnet4x_matches_pram_tpu(quantized_pair, crops, monkeypatch, conv_kernel):
    from pram_tpu.ops import conv_int8_pallas as cip

    jq_model, qparams, _ = quantized_pair
    if conv_kernel:
        monkeypatch.setenv("PRAM_INT8_CONV", "1")
        monkeypatch.setattr(cip, "_INTERPRET", True)
    qp = jax.tree_util.tree_map(jnp.asarray, qparams)
    x = crops.numpy()
    jout = jax_extract(jq_model, qp, jnp.asarray(x), max_keypoints=256, conf_th=1e-4)
    port = Int8ResNet4x(int8_extractor_state(qparams), conv_kernel=conv_kernel)
    with torch.no_grad():
        tout = extract(port, crops, max_keypoints=256, conf_th=1e-4)
    for key in ("score_map", "desc_map", "mid_features"):
        assert _scaled_err(tout[key].numpy(), np.asarray(jout[key])) <= 1e-2, key
    jk = jout["keypoints"]
    ab = extraction_agreement(
        tout, {"keypoints": type(tout["keypoints"])(T(np.array(jk.xy)), None, T(np.array(jk.mask))),
               "descriptors": T(np.array(jout["descriptors"]))},
    )
    assert ab["kpt_set_agreement"] >= 0.99 and ab["desc_cos_min"] >= 0.999, ab
