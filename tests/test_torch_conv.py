"""Kernel 18's oracle, ``conv3x3_int8_plain``, against pram_tpu on the CPU,
on the inputs the other int8 tests never make: signed values, exact
half-steps of the scale, values beyond +-127 times it (the clip), and
ragged and odd sizes.

The JAX side runs as its own tests run it here: the Pallas
``conv3x3_int8`` / ``conv3x3s2_int8`` with ``interpret=True`` where its
gate takes the shape, its XLA s8 route (``Int8ResNet4x._qlayer``, which
always applies ReLU) where the gate refuses it (21 x 37 at stride 1, 25 x
35 at stride 2, 64 input channels). Two scales: 2^-6, on which every
(k + 1/2) * s is an exact half-step of x / s (bf16 holds it too), and
0.0123, on which those values land an ulp beside the half-step, so only a
true f32 division rounds them as the JAX package does. Tolerances:

- the quantized integers bit-equal (``quant_static`` against
  ``jnp.clip(jnp.round(x / s), -127, 127)``);
- in f32 both of the port's tails within rtol = atol = 1e-5 of the JAX
  output (``tests/test_torch_int8.py``'s bound: the integer sums are exact
  on both sides, the f32 tails may differ by FMA contraction; in f32 the
  two tails compute the same function);
- in bf16 the port's bf16 tail against the XLA route within one bf16 step
  (2^-8 of the magnitude) and equal on >= 90% of the elements, as
  ``tests/test_torch_int8.py`` holds the same route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.models.sfd2_int8 import Int8ResNet4x as JaxInt8ResNet4x
from pram_tpu.ops.conv_int8_pallas import conv3x3_int8 as jax_conv3x3_int8
from pram_tpu.ops.conv_int8_pallas import conv3x3s2_int8 as jax_conv3x3s2_int8
from pram_tpu_torch.ops import conv_int8
from pram_tpu_torch.ops.quant import quant_static

T = torch.from_numpy
TIE_SCALE = 2.0**-6
SCALES = [TIE_SCALE, 0.0123]


def _signed_case(rng, b, h, w, cin, cout, sa):
    """Signed x: 60% on (k + 1/2) * sa for k in [-128, 127], 20% normal of
    300 sa (mostly clipped), 20% normal of 40 sa; HWIO s8 weights with
    per-channel scales; a bias."""
    shape = (b, h, w, cin)
    x = (rng.randint(-128, 128, size=shape) + 0.5) * sa
    pick = rng.rand(*shape)
    x = np.where(pick < 0.2, rng.randn(*shape) * 300 * sa, x)
    x = np.where(pick > 0.8, rng.randn(*shape) * 40 * sa, x).astype(np.float32)
    wf = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05
    ws = np.maximum(np.abs(wf).reshape(-1, cout).max(0), 1e-12) / 127.0
    wq = np.clip(np.round(wf / ws), -127, 127).astype(np.int8)
    bias = rng.randn(cout).astype(np.float32) * 0.1
    return x, wq, np.float32(sa), ws.astype(np.float32), bias


@pytest.mark.parametrize("sa", SCALES)
def test_quant_static_equals_pram_tpu_on_ties_and_clip(rng, sa):
    x = _signed_case(rng, 2, 8, 12, 64, 8, sa)[0]
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(np.float32(sa))), -127, 127))
    got = quant_static(T(x), sa).numpy()
    np.testing.assert_array_equal(got, ref)
    frac = np.abs(x / np.float32(sa) - np.round(x / np.float32(sa)))
    if sa == TIE_SCALE:
        assert (frac == 0.5).mean() > 0.3  # exact ties, rounded half to even
    assert (np.abs(got) == 127).mean() > 0.1 and got.min() < 0  # clipped, signed


@pytest.mark.parametrize("sa", SCALES)
@pytest.mark.parametrize("stride,cin,cout,relu", [(1, 256, 128, False), (2, 128, 256, True)])
def test_conv_plain_matches_pallas_on_signed_inputs(rng, sa, stride, cin, cout, relu):
    b, h, w = 2, 16, 24
    x, wq, sa32, ws, bias = _signed_case(rng, b, h, w, cin, cout, sa)
    jfn = jax_conv3x3_int8 if stride == 1 else jax_conv3x3s2_int8
    gate = conv_int8.conv3x3_int8_supported if stride == 1 else conv_int8.conv3x3s2_int8_supported
    assert gate(h, w, cin, cout)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(wq), sa32, jnp.asarray(ws), jnp.asarray(bias),
                         relu=relu, interpret=True))
    for bf16_tail in (False, True):
        got = conv_int8.conv3x3_int8_plain(T(x), T(wq), float(sa32), T(ws), T(bias), stride=stride,
                                           relu=relu, bf16_tail=bf16_tail)
        assert got.shape == ref.shape == (b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin", [64, 256])
@pytest.mark.parametrize("stride,h,w", [(1, 21, 37), (2, 25, 35)])
def test_conv_plain_matches_xla_route_ragged(rng, stride, h, w, cin):
    x, wq, sa32, ws, bias = _signed_case(rng, 2, h, w, cin, 128, TIE_SCALE)
    gate = conv_int8.conv3x3_int8_supported if stride == 1 else conv_int8.conv3x3s2_int8_supported
    assert not gate(h, w, cin, 128)
    qp = {"l_in_scale": jnp.asarray(sa32), "l_wq": jnp.asarray(wq), "l_wscale": jnp.asarray(ws),
          "l_bias": jnp.asarray(bias)}
    args = (T(wq), float(sa32), T(ws), T(bias))
    ref = np.asarray(JaxInt8ResNet4x()._qlayer(qp, "l", jnp.asarray(x), (stride, stride)))
    assert ref.shape == (2, (h - 1) // stride + 1, (w - 1) // stride + 1, 128)
    for bf16_tail in (False, True):
        got = conv_int8.conv3x3_int8_plain(T(x), *args, stride=stride, bf16_tail=bf16_tail)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the bf16 tail in bf16, against the XLA route in bf16
    ref16 = np.asarray(JaxInt8ResNet4x()._qlayer(qp, "l", jnp.asarray(x).astype(jnp.bfloat16),
                                                 (stride, stride)), np.float32)
    got16 = conv_int8.conv3x3_int8_plain(T(x).to(torch.bfloat16), *args, stride=stride,
                                         bf16_tail=True).float().numpy()
    step = np.maximum(np.abs(ref16), np.abs(got16)) * 2.0**-8
    assert (np.abs(got16 - ref16) <= step + 1e-30).all(), np.abs(got16 - ref16).max()
    assert (got16 == ref16).mean() >= 0.9


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_18convtile14conv3x3_kernelIaLi1ELi256ELi0EEEvNS0_4MapsEPKfS4_fNS0_4DimsEi",
     "conv3x3_kernel<a,1,256,0>"),
    ("_ZN12_GLOBAL__N_18convtile14conv3x3_kernelI13__nv_bfloat16Li1ELi128ELi2EEEvNS0_4MapsEPKfS5_fNS0_4DimsEi",
     "conv3x3_kernel<__nv_bfloat16,1,128,2>"),
    ("_ZN12_GLOBAL__N_114proj_s8_kernelENS_4MapsEPKfS3_iiii", "proj_s8_kernel"),
    ("_Z8plain_fnPf", "_Z8plain_fnPf"),
])
def test_ptxas_report_names_each_conv_instance(mangled, name):
    """ptxas's report names the conv tile's ten instances apart (the kernel
    and its template arguments), as chip_smoke.py's spill check logs them."""
    from pram_tpu_torch._build import _short_name

    assert _short_name(mangled) == name
