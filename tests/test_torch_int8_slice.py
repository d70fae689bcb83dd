"""The port's int8 image slice against pram_tpu on the CPU.

The port's ``RenderedGuard(batch=4, device="cpu", dtype=float32, int8=True,
int8_mlp=True, int8_proj=True, int8_conv=False)`` against the JAX
``RenderedGuard(batch=4, int8=True)`` with ``PRAM_INT8_MLP=1
PRAM_INT8_PROJ=1`` (f32 on the CPU), on the first 4 noisy queries of seed
11: rendered images -> the int8 SFD2 (calibrated by each package on the same
4 views) -> SegNetViT (15 layers, nc113) -> GML (9 layers), both with int8
projections and MLPs -> RANSAC PnP -> projection refinement.

The JAX blocks take their int8 Pallas kernels in interpret mode (the
patches of ``tests/test_mlp_int8.py``). The extractor is held on the XLA s8
route (``PRAM_INT8_CONV`` unset against the port's ``int8_conv=False``):
the f32 tails of the two routes agree in f32 (``tests/test_torch_int8.py``
holds the kernel route at module level), and XLA's s8 convolution on the
CPU takes seconds a layer at 480 x 640, so the JAX route's
``_conv_i8`` is replaced by the same integer convolution computed exactly:
f32 convolutions over 64-channel chunks (every partial sum an integer below
2^24) summed in int32.

Held by outcome, as ``tests/test_torch_rendered.py`` holds the float
slice: map point counts within 1%; keypoint sets agree >= 0.98 per query;
descriptor cosine on the common set >= 0.9999 on average and >= 0.995 at
its least. Each package calibrates its own static scales: the int8 weights
come out equal and the scales 0 to 7 f32 steps apart (the calibration
maxima are f32 sums in another order), so activations at a rounding
boundary quantize one step apart and keypoints at a tie move (measured:
0.9883 and 0.9985 at the least; ``tests/test_torch_int8.py`` holds the
extractor on carried-across scales at 0.99 and 0.999). The recognizer's top
class agrees on >= 98% of the keypoints both packages keep (its attention
mixes every token of the query, so the few keypoints that differ move the
others; measured 0.9899); success flags equal on >= 3 of 4;
both packages' poses within 5 cm / 5 deg of the ground truth on the queries
both localize; the port's match precision >= 0.95 (``recall``'s own
bookkeeping is held on the float slice). RANSAC draws from jax.random on
one side and a torch.Generator on the other. The JAX guard's ``recall`` writes a query
cache into ``weights/``, so the test never calls it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pram_tpu.models.common as jcommon
import pram_tpu.models.sfd2_int8 as jsfd2_int8
import pram_tpu.ops.attention_pallas as jap
import pram_tpu.ops.mlp_pallas as jmp
from pram_tpu.engine.rendered_guard import RenderedGuard as JaxRenderedGuard
from pram_tpu.geometry.rotations import compute_pose_error as jax_pose_error
from pram_tpu_torch.engine.rendered_guard import (
    RenderedGuard,
    apply_noise,
    extraction_agreement,
    match_precision,
)
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.ops.keypoints import Keypoints

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights", "bench_cache")
T = torch.from_numpy


def _exact_conv_i8(xq, wq, strides=(1, 1)):
    """``pram_tpu/models/sfd2_int8.py:_conv_i8``'s int32 result (SAME 3x3,
    NHWC, HWIO), computed exactly: f32 convolutions over 64-channel chunks
    (each partial sum an integer of magnitude below 9 * 64 * 127^2 < 2^24),
    summed in int32."""
    acc = None
    for c0 in range(0, xq.shape[-1], 64):
        part = jax.lax.conv_general_dilated(
            xq[..., c0:c0 + 64].astype(jnp.float32), wq[:, :, c0:c0 + 64].astype(jnp.float32),
            strides, [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ).astype(jnp.int32)
        acc = part if acc is None else acc + part
    return acc


@pytest.fixture
def jax_int8_guard(monkeypatch):
    assert not os.environ.get("PRAM_INT8_CONV")
    monkeypatch.setattr(jsfd2_int8, "_conv_i8", _exact_conv_i8)
    monkeypatch.setattr(jcommon, "use_fused_attention", lambda *a: True)
    for mod, name in ((jap, "fused_self_attention_proj"), (jap, "fused_cross_attention_proj"),
                      (jmp, "fused_residual_mlp_int8")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **kw: _f(*a, interpret=True, **kw))
    monkeypatch.setenv("PRAM_INT8_PROJ", "1")
    monkeypatch.setenv("PRAM_INT8_MLP", "1")
    return JaxRenderedGuard(batch=4, int8=True)


def test_int8_slice_matches_pram_tpu(jax_int8_guard):
    with np.load(os.path.join(CACHE, "queries_s11_n128.npz")) as d:
        images, qvecs, tvecs = d["images"][:4].copy(), d["qvecs"][:4].copy(), d["tvecs"][:4].copy()
    noisy = apply_noise(images, np.random.RandomState(12))

    # ---- pram_tpu (f32 on the CPU, int8 blocks interpreted)
    jg = jax_int8_guard
    jfront = jax.jit(jg.front)(jnp.asarray(noisy))
    # jg.pipeline is loc._step on the front's outputs; one compile of each
    jres = jax.jit(jg.loc._step)(jax.random.PRNGKey(7), jg.camera, *jfront)
    jxy, _, jdescs, jmask, jlogits = (np.array(a) for a in jfront)
    jq_err, jt_err = (np.asarray(a) for a in jax_pose_error(jres.qvec, jres.tvec, qvecs, tvecs))
    jsucc = np.asarray(jres.success)

    # ---- the port (plain versions on the CPU, f32)
    g = RenderedGuard(batch=4, device="cpu", dtype=torch.float32, int8=True, int8_mlp=True,
                      int8_proj=True, int8_conv=False)
    assert abs(g.scene.map.num_points - jg.scene.map.num_points) <= 0.01 * jg.scene.map.num_points
    (kxy, _, descs, kmask, logits), res = g.pipeline(torch.Generator().manual_seed(7), noisy)
    assert descs.shape == (4, 512, 128) and logits.shape == (4, 512, g.n_class)

    for i in range(4):
        sl = slice(i, i + 1)
        ab = extraction_agreement(
            {"keypoints": Keypoints(kxy[sl], None, kmask[sl]), "descriptors": descs[sl]},
            {"keypoints": Keypoints(T(jxy[sl]), None, T(jmask[sl])), "descriptors": T(jdescs[sl])},
        )
        assert ab["kpt_set_agreement"] >= 0.98 and ab["desc_cos_min"] >= 0.995, (i, ab)
        assert ab["desc_cos_mean"] >= 0.9999, (i, ab)
    same = (kxy.numpy() == jxy).all(-1) & kmask.numpy() & jmask
    top = logits.numpy().argmax(-1) == jlogits.argmax(-1)
    assert top[same].mean() >= 0.98, top[same].mean()

    q_err, t_err = compute_pose_error(res.qvec, res.tvec, T(qvecs).float(), T(tvecs))
    succ = res.success.numpy()
    assert (succ == jsucc).sum() >= 3
    both = succ & jsucc
    assert both.any()
    assert (q_err.numpy()[both] < 5.0).all() and (t_err.numpy()[both] < 0.05).all()
    assert (jq_err[both] < 5.0).all() and (jt_err[both] < 0.05).all()
    num, den = match_precision(res, kxy, kmask, qvecs, tvecs)
    assert num >= 0.95 * den > 0
