"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On the
card's machine (no jax there, so without this directory's conftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: bf16 outputs within 2% of the output's
scale; inlier counts within 2 at the gate edge; polished poses within 2e-3;
the projection pass of kernels 1 and 5 (csrc/proj_bf16.cu) equal to its
plain version on >= 99% of its elements and everywhere within one bf16 step
of its f32 accumulation order: |got - ref| <= 2^-7 |ref| (one bf16 ulp is
at most 2^-7 of the value), and on the rotated q and k columns <= 2^-7
(|ref| + |y0| + |y1|), y the pair before the rotary (a one-step difference
in y0 or y1 carries through the rotation, and the result rounds once
more), plus 2^-13 of the output's scale near zero, where the sums' own f32
rounding decides; kernel 17's s8 projection pass (csrc/proj_int8.cu) the
same against project_int8_plain; kernels 1 and 5 and the int8 projections give the
same bits on two launches; Sinkhorn's real block within 1e-4 and its dustbin row and column within
0.3%; refinement NN indices and keep flags agreeing on 99% of queries (f32
sums in another order flip near-ties of the 0.995 ratio test) and d1 within
1e-4 (chip_smoke.py allows 1e-3 because its rendered queries carry exact
map descriptors, where d1 ~ 1e-3 and its slope in the similarity is 1/d1;
the noisy copies here keep d1 above 0.1); the stem within 2% of the
output's scale in bf16 and within rtol = atol = 1e-4 in f32 (cuDNN's TF32
off); NMS bit for bit in both types, at radii 2, 3 (SuperPoint's) and 4;
kernel 7's 256-d instance (SuperPoint's descriptors) as its 128-d one. Kernels 10-12 (packed self- and
cross-attention with AdaGML's statistics): messages within 2% of their
scale in bf16 and 1e-4 in f32 (products on the CUDA cores; summation order
only), statistics within 1e-3 of their scale in bf16 and 1e-4 in f32
(both sides sum the same normalized f32 weights; the logits are summed in
another order); their bf16 passes (wgmma, TMA) also give the same bits on
two launches, the same messages with and without the statistics, zero
statistics for masked keys and frames without valid queries, and the mean
of v for queries with no valid key (within 0.02: bf16 inputs of scale 1).
The f32 residual MLP within 1e-4 of its scale. Backward
kernels 13-15: bf16 outputs within 2% of their scale, f32 reductions
within 1%, also at token counts off their tiles (padded in the wrappers),
where kernel 15 on rows of zeros alone gives exactly zero weight gradients; a training step's f32 master gradients, kernel path against
plain path, within 3% of each tensor's scale. Kernels 16-19 (int8 MLP,
int8 projections, int8 conv, conv pair): bf16 outputs within 2% of their
scale, the int8 conv equal on >= 99.9% of its elements (also on inputs on
exact half-steps of its scale and beyond the clip) and the same bits on two
launches; the int8 extractor's kernel path against its plain path by the
extraction A/B bounds.
"""

import pytest
import torch

from pram_tpu_torch.geometry.camera import Camera, project
from pram_tpu_torch.geometry.rotations import so3_exp
from pram_tpu_torch.ops import (
    attention,
    attention_bwd,
    attention_qkv,
    cross_attention,
    mlp,
    mlp_bwd,
    nms,
    pnp,
    refine,
    sinkhorn,
    stem,
)

pytestmark = pytest.mark.cuda

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("b,n", [(2, 128), (3, 512)])
def test_self_attention_kernel(dev, b, n):
    g = torch.Generator().manual_seed(n)
    x = _rand(g, b, n, 256).to(dev, torch.bfloat16)
    w = _rand(g, 768, 256, scale=256**-0.5).to(dev, torch.bfloat16)
    bias = _rand(g, 768, scale=0.1).to(dev)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    mask = torch.rand(b, n, generator=g) > 0.2
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (x, w, bias, cos, sin, kb, 64**-0.5, 4)
    before = attention.LAUNCHES["self_attention"]
    got = attention.self_attention(*args)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["self_attention"] == before + 1
    ref = attention.self_attention_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 0.02 * ref.float().abs().max().item()
    assert torch.equal(attention.self_attention(*args), got)


@pytest.mark.parametrize("b,splits", [(2, (128, 256)), (2, (512, 1024))])
def test_self_attention_kernel_splits(dev, b, splits):
    """Block-diagonal attention over a concatenation of sides (GML)."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + 1)
    x = _rand(g, b, n, 256).to(dev, torch.bfloat16)
    w = _rand(g, 768, 256, scale=256**-0.5).to(dev, torch.bfloat16)
    bias = _rand(g, 768, scale=0.1).to(dev)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    mask = torch.rand(b, n, generator=g) > 0.2
    mask[1, splits[0]:] = False  # an all-padded side
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (x, w, bias, cos, sin, kb, 64**-0.5, 4)
    got = attention.self_attention(*args, splits=splits)
    ref = attention.self_attention_plain(*args, splits=splits)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 0.02 * ref.float().abs().max().item()
    assert torch.equal(attention.self_attention(*args, splits=splits), got)
    # the blocks really are separate: one attention over all tokens differs
    full = attention.self_attention_plain(*args)
    assert (full.float() - ref.float()).abs().max().item() > 0.1 * ref.float().abs().max().item()


@pytest.mark.parametrize("b,n0,n1", [(2, 128, 256), (2, 512, 1024)])
def test_cross_attention_kernel(dev, b, n0, n1):
    g = torch.Generator().manual_seed(n0 + n1)
    n = n0 + n1
    x = _rand(g, b, n, 256).to(dev, torch.bfloat16)

    def w():
        return _rand(g, 256, 256, scale=256**-0.5).to(dev, torch.bfloat16)

    m0 = torch.rand(b, n0, generator=g) > 0.1
    m1 = torch.rand(b, n1, generator=g) > 0.3
    m1[1] = False  # an all-masked key side: side 0 of frame 1 gets mean(v1)
    b0 = attention.mask_to_bias(m0, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(m1, b, n1, "cpu").to(dev)
    args = (x, w(), _rand(g, 256, scale=0.1).to(dev), w(), _rand(g, 256, scale=0.1).to(dev),
            b0, b1, 64**-0.5, 4, n0)
    before = cross_attention.LAUNCHES["cross_attention"]
    got = cross_attention.cross_attention(*args)
    torch.cuda.synchronize()
    assert cross_attention.LAUNCHES["cross_attention"] == before + 1
    ref = cross_attention.cross_attention_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 0.02 * ref.float().abs().max().item()
    assert torch.equal(cross_attention.cross_attention(*args), got)


def _check_projection(got, ref, pre=None, rot_cols=0):
    """The projection pass against its plain version: equal on >= 99% of the
    elements, and everywhere within one bf16 step of the f32 accumulation
    order, 2^-7 |ref|; on the first rot_cols (rotated) columns within 2^-7
    (|ref| + |y0| + |y1|), with pre the unrotated projection; plus 2^-13
    max|ref| near zero."""
    got, ref = got.float(), ref.float()
    assert (got == ref).float().mean().item() >= 0.99
    bound = ref.abs() * 2**-7 + ref.abs().max() * 2**-13
    if rot_cols:
        y = pre[..., :rot_cols].float().abs().unflatten(-1, (-1, 2)).sum(-1)
        bound[..., :rot_cols] += y.repeat_interleave(2, -1) * 2**-7
    assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("b,splits", [(2, (128, 256)), (32, (512, 1024))])
@pytest.mark.parametrize("epilogue", ["rotary", "split"])
def test_projection_kernel(dev, b, splits, epilogue):
    """csrc/proj_bf16.cu in kernel 1's epilogue (768 columns, q and k
    rotated) and kernel 5's (512 columns into qk and v), at the small and at
    GML's shape; two launches bit-equal."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + b)
    x, cos, sin = _attn_inputs(g, b, n, dev)
    n_out = 768 if epilogue == "rotary" else 512
    w = _rand(g, n_out, 256, scale=256**-0.5).to(dev, torch.bfloat16)
    bias = _rand(g, n_out, scale=0.1).to(dev)
    before = attention.LAUNCHES["projection"]
    if epilogue == "rotary":
        got = attention.project(x, w, bias, cos, sin, rotary_cols=512)
        ref = attention.project_plain(x, w, bias, cos, sin, rotary_cols=512)
        _check_projection(got, ref, attention.project_plain(x, w, bias), 512)
        again = attention.project(x, w, bias, cos, sin, rotary_cols=512)
        assert torch.equal(again, got)
    else:
        qk, v = attention.project(x, w, bias, split=256)
        assert qk.shape == v.shape == (b, n, 256)
        _check_projection(torch.cat([qk, v], -1), attention.project_plain(x, w, bias))
        again = attention.project(x, w, bias, split=256)
        assert torch.equal(again[0], qk) and torch.equal(again[1], v)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["projection"] == before + 2


@pytest.mark.parametrize("b,n,m", [(3, 100, 200), (2, 512, 1024)])
def test_sinkhorn_kernel(dev, b, n, m):
    g = torch.Generator().manual_seed(n)
    sim = _rand(g, b, n, m, scale=3.0).to(dev)
    m0 = torch.rand(b, n, generator=g) > 0.1
    m1 = torch.rand(b, m, generator=g) > 0.4
    args = (sim, torch.tensor(1.2, device=dev), 20, m0.to(dev), m1.to(dev))
    got = sinkhorn.sinkhorn(*args)
    ref = sinkhorn.sinkhorn_matching(*args)
    assert (got[:, :n, :m] - ref[:, :n, :m]).abs().max().item() <= 1e-4
    for a, r in ((got[:, n, :], ref[:, n, :]), (got[:, :, m], ref[:, :, m])):
        assert ((a - r).abs() / r.abs().clamp(min=1e-6)).max().item() <= 3e-3
    assert (got[:, :n][~m0.to(dev)] == 0).all()
    assert (got[:, :, :m].transpose(1, 2)[~m1.to(dev)] == 0).all()


@pytest.mark.parametrize("b,n,m,clustered", [(2, 512, 1024, True), (2, 70, 301, True), (1, 600, 1500, False)])
def test_sinkhorn_kernel_instances(dev, b, n, m, clustered):
    """GML's shape takes the cluster instance (16 blocks a problem), and so
    does 70 x 301 (m % 4 != 0: the similarity read without 16-byte
    copies); 600 x 1500 (m + 1 > 1152) takes the wide one. Either
    gives the same bits on two launches."""
    size, active = sinkhorn.instance(n, m, dev)
    assert (size, active > 0) == ((16, True) if clustered else (sinkhorn.WIDE, False))
    g = torch.Generator().manual_seed(m)
    sim = _rand(g, b, n, m, scale=3.0).to(dev)
    m0 = (torch.rand(b, n, generator=g) > 0.1).to(dev)
    m1 = (torch.rand(b, m, generator=g) > 0.4).to(dev)
    args = (sim, torch.tensor(0.9, device=dev), 20, m0, m1)
    key = "sinkhorn" if clustered else "sinkhorn_wide"
    before = sinkhorn.LAUNCHES[key]
    got = sinkhorn.sinkhorn(*args)
    torch.cuda.synchronize()
    assert sinkhorn.LAUNCHES[key] == before + 1
    ref = sinkhorn.sinkhorn_matching(*args)
    assert (got[:, :n, :m] - ref[:, :n, :m]).abs().max().item() <= 1e-4
    for a, r in ((got[:, n, :], ref[:, n, :]), (got[:, :, m], ref[:, :, m])):
        assert ((a - r).abs() / r.abs().clamp(min=1e-6)).max().item() <= 3e-3
    assert torch.equal(sinkhorn.sinkhorn(*args).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("b,n,p", [(2, 128, 256), (4, 512, 2048)])
def test_refine_nn_kernel(dev, b, n, p):
    g = torch.Generator().manual_seed(p)
    descs = torch.nn.functional.normalize(_rand(g, b, n, 128), dim=-1)
    pdesc = torch.nn.functional.normalize(_rand(g, b, p, 128), dim=-1)
    pdesc[:, : n // 2] = torch.nn.functional.normalize(
        descs[:, : n // 2] + _rand(g, b, n // 2, 128, scale=0.05), dim=-1)
    kpts = torch.rand(b, n, 2, generator=g) * torch.tensor([640.0, 480.0])
    uv = torch.rand(b, p, 2, generator=g) * torch.tensor([640.0, 480.0])
    uv[:, : n // 2] = kpts[:, : n // 2] + _rand(g, b, n // 2, 2, scale=3.0)
    in_img = torch.rand(b, p, generator=g) > 0.1
    qmask = torch.rand(b, n, generator=g) > 0.1
    args = [descs.to(dev, torch.bfloat16), pdesc.to(dev, torch.bfloat16)]
    args += [a.to(dev).contiguous() for a in (kpts, uv, in_img, qmask)] + [16.0, 0.995]
    idx, d1, keep = refine.refine_nn(*args)
    ridx, rd1, rkeep = refine.refine_nn_plain(*args)
    assert (idx == ridx).float().mean().item() >= 0.99
    assert (keep == rkeep).float().mean().item() >= 0.99
    assert (d1 - rd1).abs().max().item() <= 1e-4
    assert keep.any()


def _refine_tie_case(g, b, n, p, dev, d=128):
    """Near-duplicate map points for half the queries, exact duplicates of
    the first 16 (and of the next 8 in the last tile) with their
    projections, every point of the last problem outside the image."""
    descs = torch.nn.functional.normalize(_rand(g, b, n, d), dim=-1)
    pdesc = torch.nn.functional.normalize(_rand(g, b, p, d), dim=-1)
    h = n // 2
    pdesc[:, :h] = torch.nn.functional.normalize(descs[:, :h] + _rand(g, b, h, d, scale=0.05), dim=-1)
    pdesc[:, h : h + 16] = pdesc[:, :16]
    pdesc[:, p - 8 :] = pdesc[:, 16:24]
    kpts = torch.rand(b, n, 2, generator=g) * torch.tensor([640.0, 480.0])
    uv = torch.rand(b, p, 2, generator=g) * torch.tensor([640.0, 480.0])
    uv[:, :h] = kpts[:, :h] + _rand(g, b, h, 2, scale=3.0)
    uv[:, h : h + 16] = uv[:, :16]
    uv[:, p - 8 :] = uv[:, 16:24]
    in_img = torch.rand(b, p, generator=g) > 0.1
    in_img[:, :24] = True
    in_img[:, h : h + 16] = True
    in_img[:, p - 8 :] = True
    in_img[-1] = False
    qmask = torch.rand(b, n, generator=g) > 0.1
    args = [descs.to(dev, torch.bfloat16), pdesc.to(dev, torch.bfloat16)]
    return args + [a.to(dev).contiguous() for a in (kpts, uv, in_img, qmask)] + [16.0, 0.995]


@pytest.mark.parametrize("b,n,p", [(4, 512, 2048), (2, 4096, 4096), (2, 192, 320)])
def test_refine_nn_kernel_ties_and_launches(dev, b, n, p):
    """Kernel 7's wgmma/TMA design at GML's and AdaGML's shapes (and one
    whose last CTA has a warpgroup without queries, with an odd number of
    point tiles): agreement as above, exact duplicates tie to the first
    index on both sides and are never kept, a problem with every point
    gated out keeps nothing, one counted launch a call, the same bits on
    two launches."""
    args = _refine_tie_case(torch.Generator().manual_seed(n + p), b, n, p, dev)
    before = refine.LAUNCHES["refine_nn"]
    idx, d1, keep = refine.refine_nn(*args)
    torch.cuda.synchronize()
    assert refine.LAUNCHES["refine_nn"] == before + 1
    ridx, rd1, rkeep = refine.refine_nn_plain(*args)
    assert (idx == ridx).float().mean().item() >= 0.99
    assert (keep == rkeep).float().mean().item() >= 0.99
    assert (d1 - rd1).abs().max().item() <= 1e-4
    ties = torch.arange(16, device=dev).expand(b - 1, 16)
    assert torch.equal(idx[:-1, :16], ties) and torch.equal(ridx[:-1, :16], ties)
    assert not keep[:, :16].any() and not keep[-1].any()
    assert (d1[-1] >= 100).all()
    assert keep.any()
    again = refine.refine_nn(*args)
    for a, r in zip(again, (idx, d1, keep)):
        assert torch.equal(a, r)


def test_residual_mlp_kernel(dev):
    g = torch.Generator().manual_seed(1)
    t, d = 256, 256
    x = _rand(g, 2, t // 2, d).to(dev, torch.bfloat16)
    msg = _rand(g, 2, t // 2, d, scale=0.1).to(dev, torch.bfloat16)

    def w(o, i):
        return _rand(g, o, i, scale=i**-0.5).to(dev, torch.bfloat16)

    args = (
        x, msg, w(d, d), _rand(g, d, scale=0.1).to(dev), w(2 * d, 2 * d),
        _rand(g, 2 * d, scale=0.1).to(dev), (1 + _rand(g, 2 * d, scale=0.1)).to(dev),
        _rand(g, 2 * d, scale=0.1).to(dev), w(d, 2 * d), _rand(g, d, scale=0.1).to(dev),
    )
    got = mlp.residual_mlp(*args)
    ref = mlp.residual_mlp_plain(*args)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 0.02 * ref.float().abs().max().item()


def _mlp_bf16_args(g, tokens, dev):
    d = 256
    x = _rand(g, tokens, d).to(dev, torch.bfloat16)
    msg = _rand(g, tokens, d, scale=0.1).to(dev, torch.bfloat16)

    def w(o, i):
        return _rand(g, o, i, scale=i**-0.5).to(dev, torch.bfloat16)

    return (
        x, msg, w(d, d), _rand(g, d, scale=0.1).to(dev), w(2 * d, 2 * d),
        _rand(g, 2 * d, scale=0.1).to(dev), (1 + _rand(g, 2 * d, scale=0.1)).to(dev),
        _rand(g, 2 * d, scale=0.1).to(dev), w(d, 2 * d), _rand(g, d, scale=0.1).to(dev),
    )


@pytest.mark.parametrize("tokens", [32, 96, 16384 + 32])
def test_residual_mlp_kernel_ragged_tokens(dev, tokens):
    """Kernel 2's TMA/wgmma tile on token counts that leave its last
    64-token tile part empty: within 2% of the plain version's scale, the
    same bits on two launches, one counted launch a call."""
    args = _mlp_bf16_args(torch.Generator().manual_seed(tokens), tokens, dev)
    before = mlp.LAUNCHES["residual_mlp"]
    got = mlp.residual_mlp(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES["residual_mlp"] == before + 1
    assert _rel_err(got, mlp.residual_mlp_plain(*args)) <= 0.02
    assert torch.equal(mlp.residual_mlp(*args), got)


def _pnp_problems(g, p, n):
    cam = torch.tensor([500.0, 500.0, 320.0, 240.0, 0.01, -0.005, 0.0, 0.0]).repeat(p, 1)
    R = so3_exp(_rand(g, p, 3, scale=0.2))
    t = _rand(g, p, 3, scale=0.3) + torch.tensor([0.0, 0.0, 5.0])
    xyz = _rand(g, p, n, 3, scale=2.0)
    uv, _ = project(Camera(cam, None), R, t, xyz)
    uv = uv + _rand(g, p, n, 2, scale=0.3)
    out = torch.rand(p, n, generator=g) < 0.3
    uv[out] = torch.rand(int(out.sum()), 2, generator=g) * 500
    mask = torch.rand(p, n, generator=g) > 0.1
    return cam, R, t, xyz, uv, mask


def test_ransac_score_kernel(dev):
    g = torch.Generator().manual_seed(2)
    p, n, k = 4, 300, 200  # ragged: neither is a multiple of the block size
    cam, R, t, xyz, uv, mask = _pnp_problems(g, p, n)
    Rh = so3_exp(_rand(g, p, k, 3, scale=0.05)) @ R[:, None]
    th = t[:, None] + _rand(g, p, k, 3, scale=0.05)
    valid = torch.rand(p, k, generator=g) > 0.2
    args = [a.to(dev).contiguous() for a in (cam, Rh, th, valid, xyz, uv, mask)] + [8.0]
    got = pnp.ransac_score(*args)
    ref = pnp.ransac_score_plain(*args)
    assert (got[~args[3]] == -1).all()
    assert (got - ref).abs().max().item() <= 2


# kernel 3 past the first design's shared-memory ceiling (7264 points), at
# matching refinement's 32 x 1024 x 10240, at a tail (K not a multiple of
# 128 nor N of the 256-point chunk) with and without distortion, and at
# GML's shape, where the point axis splits into several slices
@pytest.mark.parametrize("p,k,n,distorted", [(32, 1024, 10240, False), (32, 1000, 10000, False),
                                             (4, 1000, 10000, True), (32, 512, 512, False)])
def test_ransac_score_kernel_point_tiles(dev, p, k, n, distorted):
    """Counts within 2 of the plain version (summed over slices by
    atomics), -1 for every invalid pose, one counted launch a call, and the
    same counts on two launches."""
    g = torch.Generator().manual_seed(n + k)
    dist = [0.01, -0.005, 0.001, -0.0005] if distorted else [0.0] * 4
    cam = torch.tensor([500.0, 500.0, 320.0, 240.0] + dist).repeat(p, 1)
    R = so3_exp(_rand(g, p, 3, scale=0.2))
    t = _rand(g, p, 3, scale=0.3) + torch.tensor([0.0, 0.0, 5.0])
    # points inside the 640 x 480 image, 2-8 m deep, as observed points are
    # (tests/test_torch_score_tile.py says why)
    z = 2.0 + 6.0 * torch.rand(p, n, 1, generator=g)
    xy = (torch.rand(p, n, 2, generator=g) - 0.5) * torch.tensor([1.28, 0.96])
    xyz = torch.einsum("pji,pnj->pni", R, torch.cat([xy * z, z], -1) - t[:, None])
    uv, _ = project(Camera(cam, None), R, t, xyz)
    uv = uv + _rand(g, p, n, 2, scale=0.3)
    out = torch.rand(p, n, generator=g) < 0.3
    uv[out] = torch.rand(int(out.sum()), 2, generator=g) * torch.tensor([640.0, 480.0])
    mask = torch.rand(p, n, generator=g) > 0.1
    Rh = so3_exp(_rand(g, p, k, 3, scale=0.05)) @ R[:, None]
    th = t[:, None] + _rand(g, p, k, 3, scale=0.05)
    valid = torch.rand(p, k, generator=g) > 0.2
    Rh[:, 0], th[:, 0], valid[:, 0] = R, t, True  # the true pose gates ~60% of the points in
    args = [a.to(dev).contiguous() for a in (cam, Rh, th, valid, xyz, uv, mask)] + [8.0]
    before = pnp.LAUNCHES["ransac_score"]
    got = pnp.ransac_score(*args)
    torch.cuda.synchronize()
    assert pnp.LAUNCHES["ransac_score"] == before + 1
    # the plain version 128 poses at a time: its [P, K, N] intermediates
    ref = torch.cat([pnp.ransac_score_plain(args[0], args[1][:, i:i + 128], args[2][:, i:i + 128],
                                            args[3][:, i:i + 128], *args[4:])
                     for i in range(0, k, 128)], dim=1)
    assert (got[~args[3]] == -1).all()
    assert (got - ref).abs().max().item() <= 2
    assert (got[:, 0] > 0.5 * n).all()
    assert torch.equal(pnp.ransac_score(*args), got)


def test_gn_polish_kernel(dev):
    g = torch.Generator().manual_seed(3)
    p, n = 5, 300
    cam, R, t, xyz, uv, mask = _pnp_problems(g, p, n)
    R0 = so3_exp(_rand(g, p, 3, scale=0.02)) @ R
    t0 = t + _rand(g, p, 3, scale=0.05)
    args = [a.to(dev).contiguous() for a in (cam, R0, t0, xyz, uv, mask)] + [8.0, 32]
    got = pnp.gn_polish(*args, gn_iters=5, lo_rounds=1)
    ref = pnp.gn_polish_plain(*args, gn_iters=5, lo_rounds=1)
    assert (got[0] - ref[0]).abs().max().item() <= 2e-3
    assert (got[1] - ref[1]).abs().max().item() <= 2e-3
    assert (got[2] - ref[2]).abs().max().item() <= 2
    assert (got[3] != ref[3]).sum(-1).max().item() <= 2
    assert (got[1].cpu() - t).abs().max().item() < 2e-2


@pytest.fixture(scope="module")
def polish_problems():
    """One seeded set of 32 problems of 4096 points; each case below takes
    its first p problems and their first n points. Problem 14's start lies
    12.5 cm from the truth and gates in one point at 512 points, so the
    polish, the plain version's as the kernel's, cannot accept it there."""
    g = torch.Generator().manual_seed(4097)
    cam, R, t, xyz, uv, mask = _pnp_problems(g, 32, 4096)
    R0 = so3_exp(_rand(g, 32, 3, scale=0.02)) @ R
    t0 = t + _rand(g, 32, 3, scale=0.05)
    return cam, R0, t0, xyz, uv, mask, t


# (problems, points, the cluster size the wrapper picks): GML's shape, then
# AdaGML's 8 problems cut to reach every size the picker gives
@pytest.mark.parametrize("p,n,cluster", [(32, 512, 1), (8, 300, 1), (8, 1000, 2), (8, 2000, 4), (8, 4096, 8)])
def test_gn_polish_kernel_clusters(dev, polish_problems, p, n, cluster):
    """Kernel 4 on each cluster size the wrapper picks, at GML's and
    AdaGML's shapes: within the tolerances above of the plain version, the
    same bits on two launches."""
    assert pnp.polish_cluster(n) == cluster
    cam, R0, t0, xyz, uv, mask, t = polish_problems
    args = [a[:p].to(dev).contiguous() for a in (cam, R0, t0)]
    args += [a[:p, :n].to(dev).contiguous() for a in (xyz, uv, mask)] + [8.0, 32]
    kw = dict(gn_iters=5, lo_rounds=1)
    got = pnp.gn_polish(*args, **kw)
    ref = pnp.gn_polish_plain(*args, **kw)
    assert (got[0] - ref[0]).abs().max().item() <= 2e-3
    assert (got[1] - ref[1]).abs().max().item() <= 2e-3
    assert (got[2] - ref[2]).abs().max().item() <= 2
    assert (got[3] != ref[3]).sum(-1).max().item() <= 2
    assert torch.equal(got[2], got[3].sum(-1).to(torch.int32))
    # every problem with min_inliers at the end lands on the truth
    accepted = (got[2] >= 32).cpu()
    assert accepted.sum().item() >= p - 1
    assert (got[1].cpu() - t[:p])[accepted].abs().max().item() < 2e-2
    again = pnp.gn_polish(*args, **kw)
    for a, r in zip(again, got):
        assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 128, 256, device=dev)  # f32: the kernel takes bf16
    w = torch.zeros(768, 256, device=dev, dtype=torch.bfloat16)
    cs = torch.zeros(1, 128, 64, device=dev)
    kb = torch.zeros(1, 128, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        attention.self_attention(x, w, torch.zeros(768, device=dev), cs, cs, kb, 0.125, 4)
    # a key bias off the 16-byte grid (TMA): a contiguous view one float in
    xb = x.to(torch.bfloat16)
    kb_off = torch.zeros(1, 129, device=dev)[:, 1:]
    with pytest.raises(ValueError, match="aligned"):
        attention.self_attention(xb, w, torch.zeros(768, device=dev), cs, cs, kb_off, 0.125, 4)
    b0 = torch.zeros(1, 128, device=dev)
    wc = torch.zeros(256, 256, device=dev, dtype=torch.bfloat16)
    bc = torch.zeros(256, device=dev)
    xc = torch.zeros(1, 256, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cross_attention.cross_attention(xc, wc, bc, wc, bc, b0, kb_off, 0.125, 4, 128)
    with pytest.raises(ValueError, match="non-empty"):
        cross_attention.cross_attention(xc, wc, bc, wc, bc, b0[:, :0], kb, 0.125, 4, 0)
    # the projection: n_out not a multiple of 128, cos of the wrong shape, x
    # off the 16-byte grid (token counts off 64 are padded)
    with pytest.raises(ValueError, match="multiples of 128"):
        attention.project(xb, w[:704].contiguous(), torch.zeros(704, device=dev))
    with pytest.raises(ValueError, match="shape"):
        attention.project(xb, w, torch.zeros(768, device=dev), cs[:, :64], cs[:, :64], rotary_cols=512)
    with pytest.raises(ValueError, match="aligned"):
        attention.project(torch.zeros(1, 64 * 256 + 1, device=dev, dtype=torch.bfloat16)[:, 1:].view(1, 64, 256),
                          w, torch.zeros(768, device=dev))


def _stem_args(g, dev):
    """Random conv1a/conv1b weights ([O, I, 3, 3]), biases and BN tuples."""

    def bn():
        return (1.0 + _rand(g, 64, scale=0.2), _rand(g, 64, scale=0.3),
                _rand(g, 64, scale=0.05), _rand(g, 64).abs() * 0.5 + 0.5)

    args = (_rand(g, 64, 3, 3, 3, scale=0.3), _rand(g, 64, scale=0.3), bn(),
            _rand(g, 64, 64, 3, 3, scale=0.05), _rand(g, 64, scale=0.3), bn())
    return tuple(tuple(t.to(dev) for t in a) if isinstance(a, tuple) else a.to(dev) for a in args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", [(2, 50, 70), (2, 96, 160)])
def test_stem_kernel(dev, dtype, b, h, w):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(h * w)
    image = _rand(g, b, h, w, 3).to(dev, dtype)
    args = _stem_args(g, dev)
    before = stem.LAUNCHES["fused_stem"]
    got = stem.fused_stem(image, *args)
    torch.cuda.synchronize()
    assert stem.LAUNCHES["fused_stem"] == before + 1
    ref = stem.fused_stem_plain(image, *args)
    assert got.shape == ref.shape == (b, (h + 1) // 2, (w + 1) // 2, 64)
    assert got.is_contiguous() and got.dtype == dtype
    if dtype == torch.bfloat16:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 0.02 * ref.float().abs().max().item()
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(stem.fused_stem(image, *args), got)  # two launches bit-equal


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,r", [(2, 50, 70, 4), (2, 96, 256, 4), (1, 61, 333, 2), (2, 61, 333, 3),
                                     (1, 120, 449, 3)])
def test_nms_kernel(dev, dtype, b, h, w, r):
    g = torch.Generator().manual_seed(h + w + r)
    for s in (torch.rand(b, h, w, generator=g) ** 4,
              torch.randint(0, 6, (b, h, w), generator=g) / 5.0):  # many exact ties
        s = s.to(dev, dtype)
        before = nms.LAUNCHES["nms"]
        got = nms.nms(s, r)
        torch.cuda.synchronize()
        assert nms.LAUNCHES["nms"] == before + 1
        assert torch.equal(got, nms.simple_nms(s, r))


@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, torch.int16), (torch.float32, torch.int32)])
@pytest.mark.parametrize("b,h,w,r", [(3, 129, 437, 4), (2, 77, 250, 2)])
def test_nms_kernel_ragged_two_launches(dev, dtype, bits, b, h, w, r):
    """Ragged tiles on both edges (437 = 2 x 216 + 5 columns at R = 4),
    signed maps (the -inf padding), bit for bit on two launches."""
    g = torch.Generator().manual_seed(h * w + r)
    s = torch.randn(b, h, w, generator=g).to(dev, dtype)
    got = nms.nms(s, r)
    assert torch.equal(got.view(bits), nms.simple_nms(s, r).view(bits))
    assert torch.equal(nms.nms(s, r).view(bits), got.view(bits))


@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, torch.int16), (torch.float32, torch.int32)])
def test_nms_kernel_radius_3_superpoint_maps(dev, dtype, bits):
    """Kernel 9's R = 3 instance (halo 15 rounded up to 16: 56 x 224 tiles)
    on SuperPoint-shaped score maps, 2 x 480 x 640: 65-way softmax cells
    without their dustbin, pixel-shuffled (values near 1/65, exact ties in
    a quantized band), bit for bit against simple_nms on two launches, one
    counted launch a call."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 65, 60, 80, generator=g) * 2.0
    s = torch.nn.functional.pixel_shuffle(torch.softmax(logits, 1)[:, :-1], 8)[:, 0]
    s[:, 200:260] = torch.round(s[:, 200:260] * 256) / 256
    s = s.to(dev, dtype).contiguous()
    before = nms.LAUNCHES["nms"]
    got = nms.nms(s, 3)
    torch.cuda.synchronize()
    assert nms.LAUNCHES["nms"] == before + 1
    assert torch.equal(got.view(bits), nms.simple_nms(s, 3).view(bits))
    assert torch.equal(nms.nms(s, 3).view(bits), got.view(bits))
    assert int((got > 0).sum()) > 1000


@pytest.mark.parametrize("b,n,p", [(4, 512, 2048), (2, 4096, 4096), (2, 192, 320)])
def test_refine_nn_kernel_256d(dev, b, n, p):
    """Kernel 7's 256-d instance (one CTA an SM, the query tiles and stages
    of four boxes), on the tie case at SuperPoint's width: agreement,
    ties and gating as the 128-d instance's, one counted launch, the same
    bits on two launches; a padded shape through the wrapper."""
    args = _refine_tie_case(torch.Generator().manual_seed(n + p + 256), b, n, p, dev, d=256)
    before = refine.LAUNCHES["refine_nn"]
    idx, d1, keep = refine.refine_nn(*args)
    torch.cuda.synchronize()
    assert refine.LAUNCHES["refine_nn"] == before + 1
    ridx, rd1, rkeep = refine.refine_nn_plain(*args)
    assert (idx == ridx).float().mean().item() >= 0.99
    assert (keep == rkeep).float().mean().item() >= 0.99
    assert (d1 - rd1).abs().max().item() <= 1e-4
    ties = torch.arange(16, device=dev).expand(b - 1, 16)
    assert torch.equal(idx[:-1, :16], ties) and not keep[:, :16].any() and not keep[-1].any()
    assert keep.any()
    again = refine.refine_nn(*args)
    for a, r in zip(again, (idx, d1, keep)):
        assert torch.equal(a, r)
    cut = [args[0][:, : n - 7], args[1][:, : p - 13], args[2][:, : n - 7], args[3][:, : p - 13],
           args[4][:, : p - 13], args[5][:, : n - 7]]
    cut = [t.contiguous() for t in cut] + args[6:]
    idx, _, keep = refine.refine_nn(*cut)
    ridx, _, rkeep = refine.refine_nn_plain(*cut)
    assert (idx == ridx).float().mean().item() >= 0.99 and (keep == rkeep).float().mean().item() >= 0.99
    with pytest.raises(ValueError, match="descriptors"):
        refine.refine_nn(*[a[..., :64].contiguous() if i < 2 else a for i, a in enumerate(args)])


def test_extractor_wrappers_refuse_what_the_kernels_do_not_take(dev):
    s = torch.rand(1, 32, 32, device=dev)
    for r in (1, 9):
        with pytest.raises(ValueError, match="radius"):
            nms.nms(s, r)
    with pytest.raises(ValueError, match="f32 or bf16"):
        nms.nms(s.half(), 4)
    args = _stem_args(torch.Generator().manual_seed(0), dev)
    image = torch.rand(1, 3, 16, 16, device=dev).permute(0, 2, 3, 1)  # NHWC view, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        stem.fused_stem(image, *args)


def _masks(g, b, n, p_valid):
    """Validity with a pruned token and, in the last frame, an all-masked side."""
    mask = torch.rand(b, n, generator=g) < p_valid
    mask[0, 3] = False
    mask[-1] = False
    return mask


def _rel_err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


@pytest.mark.parametrize("b,n,dtype", [(2, 256, torch.bfloat16), (2, 4096, torch.bfloat16),
                                       (2, 384, torch.float32)])
def test_self_attention_qkv_kernel(dev, b, n, dtype):
    """Kernel 10 with statistics, at a small and at the Aachen query side's shape."""
    g = torch.Generator().manual_seed(n)
    qkv = _rand(g, b, n, 768).to(dev, dtype)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    kb = attention.mask_to_bias(_masks(g, b, n, 0.7), b, n, "cpu").to(dev)
    args = (qkv, cos, sin, kb, 64**-0.5, 4)
    before = attention_qkv.LAUNCHES["self_attention_qkv"]
    msg, stat = attention_qkv.self_attention_qkv(*args, return_stats=True)
    torch.cuda.synchronize()
    assert attention_qkv.LAUNCHES["self_attention_qkv"] == before + 1
    ref_msg, ref_stat = attention_qkv.self_attention_qkv_plain(*args, return_stats=True)
    tol = (0.02, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert _rel_err(msg, ref_msg) <= tol[0]
    assert _rel_err(stat, ref_stat) <= tol[1]
    assert (stat[-1] == 0).all()  # no valid queries, no mass
    assert torch.equal(attention_qkv.self_attention_qkv(*args), msg)  # the statistics change nothing


@pytest.mark.parametrize("b,splits", [(2, (128, 256)), (4, (512, 1024))])
def test_self_attention_qkv_blocked_kernel(dev, b, splits):
    """Kernel 12: independent sides, GML's splits among them."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + 3)
    qkv = _rand(g, b, n, 768).to(dev, torch.bfloat16)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    mask = torch.rand(b, n, generator=g) > 0.2
    mask[1, splits[0]:] = False  # an all-padded side
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (qkv, cos, sin, kb, 64**-0.5, 4)
    before = attention_qkv.LAUNCHES["self_attention_qkv_blocked"]
    got = attention_qkv.self_attention_qkv(*args, splits=splits)
    torch.cuda.synchronize()
    assert attention_qkv.LAUNCHES["self_attention_qkv_blocked"] == before + 1
    ref = attention_qkv.self_attention_qkv_plain(*args, splits=splits)
    assert _rel_err(got, ref) <= 0.02
    assert _rel_err(attention_qkv.self_attention_qkv_plain(*args), ref) > 0.1


@pytest.mark.parametrize("b,n0,n1,dtype", [(2, 128, 256, torch.bfloat16), (2, 4096, 2048, torch.bfloat16),
                                           (2, 256, 128, torch.float32)])
def test_cross_attention_packed_kernel(dev, b, n0, n1, dtype):
    """Kernel 11 with statistics, on views into one projection of both sides."""
    g = torch.Generator().manual_seed(n0 + n1 + 1)
    qk = _rand(g, b, n0 + n1, 256).to(dev, dtype)
    v = _rand(g, b, n0 + n1, 256).to(dev, dtype)
    b0 = attention.mask_to_bias(torch.rand(b, n0, generator=g) > 0.1, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(_masks(g, b, n1, 0.7), b, n1, "cpu").to(dev)
    args = (qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:], b0, b1, 64**-0.5, 4)
    before = cross_attention.LAUNCHES["cross_attention_packed"]
    got = cross_attention.cross_attention_packed(*args, return_stats=True)
    torch.cuda.synchronize()
    assert cross_attention.LAUNCHES["cross_attention_packed"] == before + 1
    ref = cross_attention.cross_attention_packed_plain(*args, return_stats=True)
    tol = (0.02, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert _rel_err(a, r) <= tol[i // 2], i
    # side 0 of the last frame attends to an all-masked side 1: mean of v1,
    # and side 1's keys receive 1/n1 from every valid side-0 query and head
    assert torch.allclose(got[0][-1].float(), v[-1, n0:].float().mean(0).expand(n0, -1), atol=0.02)
    valid0 = (b0[-1] > -0.5).sum().item()
    assert torch.allclose(got[3][-1], torch.full_like(got[3][-1], 4 * valid0 / n1), rtol=1e-3)


def _mean_v(v, edges):
    """The messages of queries with no valid key: each side's mean of v."""
    return torch.cat([v[lo:hi].float().mean(0).expand(hi - lo, -1) for lo, hi in edges])


@pytest.mark.parametrize("b,splits", [(8, (4096,)), (8, (2048,)), (2, (128,)), (4, (512, 1024))])
def test_self_attention_qkv_wgmma(dev, b, splits):
    """Kernels 10 and 12's bf16 passes (wgmma on TMA-fed tiles): the Aachen
    sides, the least side and GML's splits, with pruned query rows and a
    fully masked frame; two launches bit-equal, and the messages bit-equal
    with and without the statistics."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + b)
    qkv = _rand(g, b, n, 768).to(dev, torch.bfloat16)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    mask = _masks(g, b, n, 0.7)
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (qkv, cos, sin, kb, 64**-0.5, 4)
    sp = splits if len(splits) > 1 else None
    msg, stat = attention_qkv.self_attention_qkv(*args, splits=sp, return_stats=True)
    ref_msg, ref_stat = attention_qkv.self_attention_qkv_plain(*args, splits=sp, return_stats=True)
    assert _rel_err(msg, ref_msg) <= 0.02
    assert _rel_err(stat, ref_stat) <= 1e-3
    assert (stat[-1] == 0).all()  # no valid queries, no mass
    assert (stat[~mask.to(dev)] == 0).all()  # masked keys receive none
    edges = attention.split_edges(sp, n)
    v = qkv[-1, :, 512:].view(n, 4, 64).transpose(0, 1)
    want = torch.stack([_mean_v(vh, edges) for vh in v], 1).reshape(n, 256)
    assert torch.allclose(msg[-1].float(), want, atol=0.02)
    again = attention_qkv.self_attention_qkv(*args, splits=sp, return_stats=True)
    assert torch.equal(again[0], msg) and torch.equal(again[1], stat)
    assert torch.equal(attention_qkv.self_attention_qkv(*args, splits=sp), msg)


@pytest.mark.parametrize("b,n0,n1", [(8, 4096, 2048), (8, 2048, 4096), (2, 128, 128)])
def test_cross_attention_packed_wgmma(dev, b, n0, n1):
    """Kernel 11's bf16 passes on strided views of one [B, N + M, 256]
    projection, both side orders of the Aachen shape and the least sides,
    with pruned query rows and a fully masked last frame; two launches
    bit-equal, the messages bit-equal with and without the statistics."""
    g = torch.Generator().manual_seed(n0 + 2 * n1 + b)
    qk = _rand(g, b, n0 + n1, 256).to(dev, torch.bfloat16)
    v = _rand(g, b, n0 + n1, 256).to(dev, torch.bfloat16)
    mask0, mask1 = _masks(g, b, n0, 0.9), _masks(g, b, n1, 0.7)
    b0 = attention.mask_to_bias(mask0, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(mask1, b, n1, "cpu").to(dev)
    args = (qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:], b0, b1, 64**-0.5, 4)
    got = cross_attention.cross_attention_packed(*args, return_stats=True)
    ref = cross_attention.cross_attention_packed_plain(*args, return_stats=True)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert _rel_err(a, r) <= (0.02, 1e-3)[i // 2], i
    for stat, mask in ((got[2], mask0), (got[3], mask1)):
        assert (stat[-1] == 0).all() and (stat[~mask.to(dev)] == 0).all()
    for msg, vk in ((got[0], v[-1, n0:]), (got[1], v[-1, :n0])):
        assert torch.allclose(msg[-1].float(), vk.float().mean(0).expand(msg.shape[1], -1), atol=0.02)
    again = cross_attention.cross_attention_packed(*args, return_stats=True)
    assert all(torch.equal(a, r) for a, r in zip(again, got))
    plain_msgs = cross_attention.cross_attention_packed(*args)
    assert torch.equal(plain_msgs[0], got[0]) and torch.equal(plain_msgs[1], got[1])


def test_packed_attention_f32_instance(dev):
    """The f32 instances of kernels 10 and 11 (CUDA-core tiles) within 1e-4 of
    their plain versions, at two sides each, and the same bits twice."""
    g = torch.Generator().manual_seed(17)
    n, splits = 384, (128, 256)
    qkv = _rand(g, 2, n, 768).to(dev)
    ang = _rand(g, 2, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    kb = attention.mask_to_bias(_masks(g, 2, n, 0.7), 2, n, "cpu").to(dev)
    args = (qkv, cos, sin, kb, 64**-0.5, 4)
    got = attention_qkv.self_attention_qkv(*args, splits=splits, return_stats=True)
    ref = attention_qkv.self_attention_qkv_plain(*args, splits=splits, return_stats=True)
    assert _rel_err(got[0], ref[0]) <= 1e-4 and _rel_err(got[1], ref[1]) <= 1e-4
    again = attention_qkv.self_attention_qkv(*args, splits=splits, return_stats=True)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    qk = qkv[:, :, :256].contiguous()
    vv = qkv[:, :, 256:512].contiguous()
    b0, b1 = kb[:, :128].contiguous(), kb[:, 128:].contiguous()
    cargs = (qk[:, :128], qk[:, 128:], vv[:, :128], vv[:, 128:], b0, b1, 64**-0.5, 4)
    got = cross_attention.cross_attention_packed(*cargs, return_stats=True)
    ref = cross_attention.cross_attention_packed_plain(*cargs, return_stats=True)
    for a, r in zip(got, ref):
        assert _rel_err(a, r) <= 1e-4


def test_residual_mlp_kernel_f32(dev):
    g = torch.Generator().manual_seed(5)
    d = 256
    x = _rand(g, 2, 64, d).to(dev)
    msg = _rand(g, 2, 64, d, scale=0.1).to(dev)

    def w(o, i):
        return _rand(g, o, i, scale=i**-0.5).to(dev)

    args = (
        x, msg, w(d, d), _rand(g, d, scale=0.1).to(dev), w(2 * d, 2 * d),
        _rand(g, 2 * d, scale=0.1).to(dev), (1 + _rand(g, 2 * d, scale=0.1)).to(dev),
        _rand(g, 2 * d, scale=0.1).to(dev), w(d, 2 * d), _rand(g, d, scale=0.1).to(dev),
    )
    got = mlp.residual_mlp(*args)
    assert got.dtype == torch.float32
    assert _rel_err(got, mlp.residual_mlp_plain(*args)) <= 1e-4


def test_packed_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    cs = torch.zeros(1, 200, 64, device=dev)
    kb = torch.zeros(1, 200, device=dev)
    qkv = torch.zeros(1, 200, 768, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention_qkv.self_attention_qkv(qkv[:, :128].half(), cs[:, :128], cs[:, :128], kb[:, :128], 0.125, 4)
    with pytest.raises(ValueError, match="at most 8 sides"):
        attention_qkv.self_attention_qkv(qkv, cs, cs, kb, 0.125, 4, splits=(25,) * 8 + (0,))
    qk = torch.zeros(1, 256, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="non-empty"):
        cross_attention.cross_attention_packed(qk[:, :0], qk, qk[:, :0], qk, kb[:, :0], kb[:, :156], 0.125, 4)
    kb256 = torch.zeros(1, 256, device=dev)
    with pytest.raises(ValueError, match="rows"):  # a transposed view
        cross_attention.cross_attention_packed(qk.transpose(1, 2), qk[:, :128], qk, qk[:, :128],
                                               kb256, kb[:, :128], 0.125, 4)


def _check_bwd(got, ref, n_bf16):
    """Backward outputs: the first n_bf16 (bf16) within 2% of their scale,
    the f32 reductions within 1% (chip_smoke.py's BWD_TOL, BWD_F32_TOL)."""
    for i, (a, r) in enumerate(zip(got, ref)):
        assert _rel_err(a, r) <= (0.02 if i < n_bf16 else 0.01), i


def _bit_equal(got, again):
    return all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("b,splits", [(32, (512,)), (2, (512, 1024)), (3, (64, 192)), (2, (192,))])
def test_self_attention_bwd_kernel(dev, b, splits):
    """Kernel 13 at training's shape, GML's splits, sides of 64 and 192 (a
    CTA's two 64-row warpgroups on two sides) and 192 tokens (a CTA with one
    warpgroup), with a fully masked side; two launches give the same bits."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + 7)
    qkv = _rand(g, b, n, 768).to(dev, torch.bfloat16)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    mask = torch.rand(b, n, generator=g) > 0.2
    mask[1, splits[0]:] = False  # padded tokens to the end of the frame
    mask[0, :splits[0]] = False  # a fully masked side: uniform weights
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (qkv, cos, sin, kb, _rand(g, b, n, 256).to(dev, torch.bfloat16), 64**-0.5, 4)
    before = attention_bwd.LAUNCHES["self_attention_bwd"]
    got = attention_bwd.self_attention_bwd(*args, splits=splits)
    torch.cuda.synchronize()
    assert attention_bwd.LAUNCHES["self_attention_bwd"] == before + 1
    _check_bwd(got, attention_bwd.self_attention_bwd_plain(*args, splits=splits), 1)
    assert _bit_equal(attention_bwd.self_attention_bwd(*args, splits=splits), got)


@pytest.mark.parametrize("b,n0,n1", [(2, 128, 192), (4, 512, 1024), (3, 64, 192), (2, 192, 64), (2, 64, 128)])
def test_cross_attention_bwd_kernel(dev, b, n0, n1):
    """Kernel 14 at GML's sides and sides of 64 and 192 both ways (a CTA's
    two warpgroups on the two sides) and 64 + 128 (a CTA with one
    warpgroup), with a fully masked side of each; two launches give the
    same bits."""
    g = torch.Generator().manual_seed(n0 + n1 + 7)
    n = n0 + n1
    qk, v, gg = (_rand(g, b, n, 256).to(dev, torch.bfloat16) for _ in range(3))
    m0 = torch.rand(b, n0, generator=g) > 0.1
    m1 = torch.rand(b, n1, generator=g) > 0.3
    m1[1] = False  # an all-masked key side
    m0[0] = False
    b0 = attention.mask_to_bias(m0, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(m1, b, n1, "cpu").to(dev)
    args = (qk, v, b0, b1, gg, 64**-0.5, 4, n0)
    before = attention_bwd.LAUNCHES["cross_attention_bwd"]
    got = attention_bwd.cross_attention_bwd(*args)
    torch.cuda.synchronize()
    assert attention_bwd.LAUNCHES["cross_attention_bwd"] == before + 1
    _check_bwd(got, attention_bwd.cross_attention_bwd_plain(*args), 2)
    assert _bit_equal(attention_bwd.cross_attention_bwd(*args), got)


@pytest.mark.parametrize("tokens,vec_dtype", [(96, torch.float32), (16384, torch.float32),
                                              (16384, torch.bfloat16), (16416, torch.bfloat16)])
def test_residual_mlp_bwd_kernel(dev, tokens, vec_dtype):
    """16416 tokens: the last 64-token tile holds 32; bf16 vectors as the
    training step holds them (read as they are, widened in the kernel)."""
    g = torch.Generator().manual_seed(tokens)
    d = 256
    x, pm, ct = (_rand(g, 2, tokens // 2, d).to(dev, torch.bfloat16) for _ in range(3))
    args = (
        x, pm, ct, _rand(g, 2 * d, 2 * d, scale=(2 * d) ** -0.5).to(dev, torch.bfloat16),
        _rand(g, 2 * d, scale=0.1).to(dev, vec_dtype), (1 + _rand(g, 2 * d, scale=0.1)).to(dev, vec_dtype),
        _rand(g, 2 * d, scale=0.1).to(dev, vec_dtype),
        _rand(g, d, 2 * d, scale=(2 * d) ** -0.5).to(dev, torch.bfloat16),
    )
    before = mlp_bwd.LAUNCHES["residual_mlp_bwd"]
    got = mlp_bwd.residual_mlp_bwd(*args)
    torch.cuda.synchronize()
    assert mlp_bwd.LAUNCHES["residual_mlp_bwd"] == before + 1
    _check_bwd(got, mlp_bwd.residual_mlp_bwd_plain(*args), 2)
    assert _bit_equal(mlp_bwd.residual_mlp_bwd(*args), got)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Token counts off the tiles are padded now
    (test_backward_kernels_off_their_tiles); what stays refused: no rotary
    tables, another head width, more than 8 sides, an empty side, inputs
    off the 16-byte grid."""
    bf = torch.bfloat16
    qkv = torch.zeros(1, 64, 768, device=dev, dtype=bf)
    cs = torch.zeros(1, 64, 64, device=dev)
    kb = torch.zeros(1, 64, device=dev)
    gg = torch.zeros(1, 64, 256, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="cos/sin"):
        attention_bwd.self_attention_bwd(qkv, None, None, kb, gg, 0.125, 4)
    with pytest.raises(ValueError, match="head_dim"):
        attention_bwd.self_attention_bwd(qkv, cs, cs, kb, gg, 0.125, 8)
    with pytest.raises(ValueError, match="at most 8"):
        attention_bwd.self_attention_bwd(qkv, cs, cs, kb, gg, 0.125, 4, splits=(8,) * 7 + (4, 4))
    off = torch.zeros(1, 64 * 768 + 1, device=dev, dtype=bf)[:, 1:].view(1, 64, 768)
    with pytest.raises(ValueError, match="aligned"):
        attention_bwd.self_attention_bwd(off, cs, cs, kb, gg, 0.125, 4)
    with pytest.raises(ValueError, match="non-empty"):
        attention_bwd.cross_attention_bwd(gg, gg, kb[:, :0], kb, gg, 0.125, 4, 0)
    with pytest.raises(ValueError, match="head_dim"):
        attention_bwd.cross_attention_bwd(qkv, qkv, kb[:, :32], kb[:, 32:], qkv[..., :768], 0.125, 4, 32)
    x = torch.zeros(1, 64, 256, device=dev, dtype=bf)
    w0 = torch.zeros(512, 512, device=dev, dtype=bf)
    v = torch.zeros(512, device=dev)
    with pytest.raises(ValueError, match="hidden"):
        mlp_bwd.residual_mlp_bwd(x, x, x, w0[:256], v[:256], v[:256], v[:256],
                                 torch.zeros(256, 256, device=dev, dtype=bf))
    xo = torch.zeros(64 * 256 + 1, device=dev, dtype=bf)[1:].view(1, 64, 256)
    with pytest.raises(ValueError, match="aligned"):
        mlp_bwd.residual_mlp_bwd(xo, x, x, w0, v, v, v, torch.zeros(256, 512, device=dev, dtype=bf))


@pytest.mark.parametrize("kernel,shape", [("self", (2, (100,))), ("self", (2, (1000, 600))),
                                          ("self", (3, (37, 128, 300))), ("cross", (2, 100, 156)),
                                          ("cross", (2, 1000, 600)), ("mlp", (1000,)), ("mlp", (3, 333))])
def test_backward_kernels_off_their_tiles(dev, kernel, shape):
    """Kernels 13, 14 and 15 at token counts off their tiles, padded in the
    wrappers: one counted launch, within the on-tile tests' tolerances of
    the unpadded plain versions; rows of zeros alone (what the padding
    adds) give kernel 15 exactly zero weight gradients."""
    g = torch.Generator().manual_seed(sum(shape[1]) if kernel == "self" else sum(shape))
    bf = torch.bfloat16
    if kernel == "self":
        b, splits = shape
        n = sum(splits)
        ang = _rand(g, b, n, 32)
        mask = torch.rand(b, n, generator=g) > 0.2
        args = (_rand(g, b, n, 768).to(dev, bf), torch.cos(ang).repeat_interleave(2, -1).to(dev),
                torch.sin(ang).repeat_interleave(2, -1).to(dev), attention.mask_to_bias(mask, b, n, "cpu").to(dev),
                _rand(g, b, n, 256).to(dev, bf), 64**-0.5, 4, None if len(splits) == 1 else splits)
        fn, plain, key, n_bf16 = (attention_bwd.self_attention_bwd, attention_bwd.self_attention_bwd_plain,
                                  "self_attention_bwd", 1)
    elif kernel == "cross":
        b, n0, n1 = shape
        n = n0 + n1
        m1 = torch.rand(b, n1, generator=g) > 0.3
        m1[1] = False
        args = (*(_rand(g, b, n, 256).to(dev, bf) for _ in range(2)),
                attention.mask_to_bias(torch.rand(b, n0, generator=g) > 0.1, b, n0, "cpu").to(dev),
                attention.mask_to_bias(m1, b, n1, "cpu").to(dev), _rand(g, b, n, 256).to(dev, bf), 64**-0.5, 4, n0)
        fn, plain, key, n_bf16 = (attention_bwd.cross_attention_bwd, attention_bwd.cross_attention_bwd_plain,
                                  "cross_attention_bwd", 2)
    else:
        d = 256
        args = (*(_rand(g, *shape, d).to(dev, bf) for _ in range(3)),
                _rand(g, 2 * d, 2 * d, scale=(2 * d) ** -0.5).to(dev, bf), _rand(g, 2 * d, scale=0.1).to(dev, bf),
                (1 + _rand(g, 2 * d, scale=0.1)).to(dev, bf), _rand(g, 2 * d, scale=0.1).to(dev, bf),
                _rand(g, d, 2 * d, scale=(2 * d) ** -0.5).to(dev, bf))
        fn, plain, key, n_bf16 = mlp_bwd.residual_mlp_bwd, mlp_bwd.residual_mlp_bwd_plain, "residual_mlp_bwd", 2
    launches = attention_bwd.LAUNCHES if kernel != "mlp" else mlp_bwd.LAUNCHES
    before = launches[key]
    got = fn(*args)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    ref = plain(*args)
    assert all(a.shape == r.shape for a, r in zip(got, ref))
    _check_bwd(got, ref, n_bf16)
    if kernel == "mlp":
        z = torch.zeros(32, 256, device=dev, dtype=bf)
        zero = mlp_bwd.residual_mlp_bwd(z, z, z, *args[3:])
        assert all(torch.isfinite(t).all() and not t.any() for t in zero[2:])


def test_training_gradients_kernels_vs_plain(dev):
    """One bf16 step's f32 master gradients of a 2-layer SegNetViT, kernel
    path against plain path, each within 3% of its scale."""
    from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
    from pram_tpu_torch.train.trainer import TrainConfig, cast_forward, seg_metrics

    torch.manual_seed(0)
    model = SegNetViT(SegNetViTConfig(n_class=17, n_layers=2)).to(dev)
    g = torch.Generator().manual_seed(5)
    b, n = 4, 256
    mask = torch.rand(b, n, generator=g) > 0.1
    batch = {"gt_seg": torch.randint(0, 17, (b, n), generator=g).to(dev), "mask": mask.to(dev)}
    descs = _rand(g, b, n, 256).to(dev, torch.bfloat16)
    nk = (torch.rand(b, n, 2, generator=g) * 2 - 1).to(dev, torch.bfloat16)

    def grads(kernels):
        model.use_kernels = kernels
        model.zero_grad(set_to_none=True)
        out = cast_forward(model, torch.bfloat16, descs, nk, batch["mask"])
        seg_metrics(out["prediction"].float(), batch, TrainConfig())[0].backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    before = dict(attention_bwd.LAUNCHES, **mlp_bwd.LAUNCHES)
    gk = grads(True)
    after = dict(attention_bwd.LAUNCHES, **mlp_bwd.LAUNCHES)
    assert after["self_attention_bwd"] - before["self_attention_bwd"] == 2
    assert after["residual_mlp_bwd"] - before["residual_mlp_bwd"] == 2
    gp = grads(False)
    for k in gp:
        assert gk[k].dtype == torch.float32
        assert _rel_err(gk[k], gp[k]) <= 0.03, k


# ---- the int8 kernels (16-18) and the conv pair (19) --------------------------
# The integer sums are exact on both sides and every division is a true f32
# division, so kernel and plain version quantize alike; they differ where the
# f32 statistics (LayerNorm, the row maxima of an f32 GELU output, softmax)
# are summed in another order: bf16 outputs within 2% of their scale, and the
# conv kernels' outputs equal on >= 99.9% of the elements (their tails round
# each operation as the plain version does).


def _i8_linear(g, out_f, in_f, dev):
    from pram_tpu_torch.ops.quant import quant_linear

    return quant_linear(_rand(g, out_f, in_f, scale=in_f**-0.5).to(dev, torch.bfloat16))


@pytest.mark.parametrize("tokens", [96, 16384])
def test_residual_mlp_int8_kernel(dev, tokens):
    g = torch.Generator().manual_seed(tokens + 7)
    x = _rand(g, tokens, 256).to(dev, torch.bfloat16)
    msg = _rand(g, tokens, 256).to(dev, torch.bfloat16)
    (wpq, wps), (w0q, w0s), (w3q, w3s) = (_i8_linear(g, o, i, dev) for o, i in ((256, 256), (512, 512), (256, 512)))
    vec = [_rand(g, n, scale=0.1).to(dev) for n in (256, 512, 512, 512, 256)]
    bp, b0, ln_b, b3 = vec[0], vec[1], vec[3], vec[4]
    ln_w = 1.0 + vec[2]
    args = (x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3)
    before = mlp.LAUNCHES["residual_mlp_int8"]
    got = mlp.residual_mlp_int8(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES["residual_mlp_int8"] == before + 1
    ref = mlp.residual_mlp_int8_plain(*args)
    assert _rel_err(got, ref) <= 0.02
    assert (got == ref).float().mean().item() >= 0.9


@pytest.mark.parametrize("tokens", [32, 96, 16384 + 32])
def test_residual_mlp_int8_kernel_edges(dev, tokens):
    """Kernel 16's s8 tile on ragged token counts, with a zero row (scale
    floored at 1e-6 / 127, every value quantized to 0) and an outlier row
    (one value 300x the rest) in x and msg: within 2% of the plain version's
    scale, the same bits on two launches, one counted launch a call."""
    g = torch.Generator().manual_seed(tokens + 13)
    x = _rand(g, tokens, 256)
    msg = _rand(g, tokens, 256)
    x[0], msg[0] = 0.0, 0.0
    x[tokens - 1, 7], msg[tokens - 1, 200] = 300.0, -300.0
    x, msg = x.to(dev, torch.bfloat16), msg.to(dev, torch.bfloat16)
    (wpq, wps), (w0q, w0s), (w3q, w3s) = (_i8_linear(g, o, i, dev) for o, i in ((256, 256), (512, 512), (256, 512)))
    vec = [_rand(g, n, scale=0.1).to(dev) for n in (256, 512, 512, 512, 256)]
    args = (x, msg, wpq, wps, vec[0], w0q, w0s, vec[1], 1.0 + vec[2], vec[3], w3q, w3s, vec[4])
    before = mlp.LAUNCHES["residual_mlp_int8"]
    got = mlp.residual_mlp_int8(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES["residual_mlp_int8"] == before + 1
    ref = mlp.residual_mlp_int8_plain(*args)
    assert _rel_err(got, ref) <= 0.02
    assert _rel_err(got[0], ref[0]) <= 0.02
    assert torch.equal(mlp.residual_mlp_int8(*args), got)


def _attn_inputs(g, b, n, dev):
    x = _rand(g, b, n, 256).to(dev, torch.bfloat16)
    ang = _rand(g, b, n, 32)
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dev)
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dev)
    return x, cos, sin


@pytest.mark.parametrize("b,splits", [(2, (512,)), (2, (512, 1024)), (3, (128, 256))])
def test_self_attention_int8_kernel(dev, b, splits):
    """Kernel 17 self-attention: one call is one launch of the s8 pass and
    the rotated message pass (no kernel 12 entry, so no rotate launch)."""
    n = sum(splits)
    g = torch.Generator().manual_seed(n + 11)
    x, cos, sin = _attn_inputs(g, b, n, dev)
    wq, ws = _i8_linear(g, 768, 256, dev)
    bias = _rand(g, 768, scale=0.1).to(dev)
    mask = _masks(g, b, n, 0.8)
    kb = attention.mask_to_bias(mask, b, n, "cpu").to(dev)
    args = (x, wq, ws, bias, cos, sin, kb, 64**-0.5, 4, splits)
    before = dict(attention.LAUNCHES, **attention_qkv.LAUNCHES)
    got = attention.self_attention_int8(*args)
    torch.cuda.synchronize()
    after = dict(attention.LAUNCHES, **attention_qkv.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == dict(
        {k: 0 for k in after}, self_attention_int8=1, projection_int8=1)
    assert _rel_err(got, attention.self_attention_int8_plain(*args)) <= 0.02
    assert torch.equal(attention.self_attention_int8(*args), got)


@pytest.mark.parametrize("b,n0,n1", [(2, 128, 256), (2, 512, 1024)])
def test_cross_attention_int8_kernel(dev, b, n0, n1):
    g = torch.Generator().manual_seed(n0 + n1 + 13)
    x = _rand(g, b, n0 + n1, 256).to(dev, torch.bfloat16)
    (wq_qk, ws_qk), (wq_v, ws_v) = _i8_linear(g, 256, 256, dev), _i8_linear(g, 256, 256, dev)
    m0, m1 = torch.rand(b, n0, generator=g) > 0.1, torch.rand(b, n1, generator=g) > 0.3
    m1[1] = False  # an all-masked key side
    b0 = attention.mask_to_bias(m0, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(m1, b, n1, "cpu").to(dev)
    args = (x, wq_qk, ws_qk, _rand(g, 256, scale=0.1).to(dev), wq_v, ws_v,
            _rand(g, 256, scale=0.1).to(dev), b0, b1, 64**-0.5, 4, n0)
    before = cross_attention.LAUNCHES["cross_attention_int8"]
    before_pass = attention.LAUNCHES["projection_int8"]
    got = cross_attention.cross_attention_int8(*args)
    torch.cuda.synchronize()
    assert cross_attention.LAUNCHES["cross_attention_int8"] == before + 1
    assert attention.LAUNCHES["projection_int8"] == before_pass + 1
    assert _rel_err(got, cross_attention.cross_attention_int8_plain(*args)) <= 0.02
    assert torch.equal(cross_attention.cross_attention_int8(*args), got)


# 5 and 400 tiles of 64 tokens: fewer than one a CTA, and several a CTA
# with a remainder (the self-attention's 768 columns run 3 x 44 CTAs)
@pytest.mark.parametrize("b,n", [(1, 320), (25, 1024)])
@pytest.mark.parametrize("epilogue", ["rotary", "plain", "split"])
def test_projection_int8_kernel(dev, b, n, epilogue):
    """csrc/proj_int8.cu (kernel 17's s8 pass) against project_int8_plain:
    768 columns with q and k rotated (rotary_cols 512) and without, and 512
    columns into qk and v; a zero row and rows with one large outlier; two
    launches bit-equal."""
    g = torch.Generator().manual_seed(n + b + 17)
    x, cos, sin = _attn_inputs(g, b, n, dev)
    x[0, 5] = 0
    x[0, 9, 17] = 300.0
    x[-1, 0, 255] = -1e4
    n_out = 512 if epilogue == "split" else 768
    wq, ws = _i8_linear(g, n_out, 256, dev)
    bias = _rand(g, n_out, scale=0.1).to(dev)
    rot = 512 if epilogue == "rotary" else 0
    before = attention.LAUNCHES["projection_int8"]
    ref = attention.project_int8_plain(x, wq, ws, bias, cos, sin, rotary_cols=rot)
    if epilogue == "split":
        qk, v = attention.project_int8(x, wq, ws, bias, split=256)
        assert qk.shape == v.shape == (b, n, 256)
        got = torch.cat([qk, v], -1)
        again = torch.cat(attention.project_int8(x, wq, ws, bias, split=256), -1)
    else:
        got = attention.project_int8(x, wq, ws, bias, cos, sin, rotary_cols=rot)
        again = attention.project_int8(x, wq, ws, bias, cos, sin, rotary_cols=rot)
    _check_projection(got, ref, attention.project_int8_plain(x, wq, ws, bias), rot)
    assert torch.equal(again, got)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["projection_int8"] == before + 2


def test_projection_int8_wrapper_refuses_what_the_pass_does_not_take(dev):
    """Column counts off the 256-column slice, float weights, cos of the
    wrong shape: raised before any launch (token counts off 64 are padded)."""
    g = torch.Generator().manual_seed(3)
    x, cos, sin = _attn_inputs(g, 1, 128, dev)
    wq, ws = _i8_linear(g, 768, 256, dev)
    bias = torch.zeros(768, device=dev)
    with pytest.raises(ValueError, match="multiples of 256"):
        attention.project_int8(x, wq[:640].contiguous(), ws[:640].contiguous(), bias[:640])
    with pytest.raises(ValueError, match="multiples of 256"):
        attention.project_int8(x, wq, ws, bias, cos, sin, rotary_cols=128)
    with pytest.raises(ValueError, match="split of 64"):
        attention.project_int8(x, wq, ws, bias, split=100)
    with pytest.raises(ValueError, match="dtype"):
        attention.project_int8(x, wq.to(torch.bfloat16), ws, bias)
    with pytest.raises(ValueError, match="shape"):
        attention.project_int8(x, wq, ws, bias, cos[:, :64], sin[:, :64], rotary_cols=512)


def _conv_i8_case(g, b, h, w, cin, cout, dev):
    from pram_tpu_torch.ops.quant import quant_w

    x = _rand(g, b, h, w, cin).abs().to(dev, torch.bfloat16)
    wq, ws = quant_w(_rand(g, 3, 3, cin, cout, scale=0.05))
    bias = _rand(g, cout, scale=0.1)
    sa = float(x.float().abs().max().item() / 127.0)
    return x, wq.to(dev), sa, ws.to(dev), bias.to(dev)


@pytest.mark.parametrize("stride,b,h,w,cin,cout,bf16_tail,relu", [
    (1, 2, 24, 40, 128, 256, False, True),
    (1, 2, 21, 37, 256, 128, False, False),
    (1, 2, 30, 50, 64, 128, True, True),
    (1, 1, 60, 80, 256, 256, True, False),
    (1, 2, 60, 80, 256, 256, False, True),
    (1, 1, 9, 13, 32, 128, True, True),
    (2, 2, 48, 64, 128, 128, False, True),
    (2, 2, 25, 35, 256, 256, True, True),
    (2, 2, 31, 45, 128, 128, False, True),
    (2, 1, 17, 3, 64, 384, True, False),
])
def test_conv3x3_int8_kernel(dev, stride, b, h, w, cin, cout, bf16_tail, relu):
    from pram_tpu_torch.ops import conv_int8

    g = torch.Generator().manual_seed(h * w + cin)
    x, wq, sa, ws, bias = _conv_i8_case(g, b, h, w, cin, cout, dev)
    kw = dict(stride=stride, relu=relu, bf16_tail=bf16_tail)
    before = conv_int8.LAUNCHES["conv3x3_int8"]
    got = conv_int8.conv3x3_int8(x, wq, sa, ws, bias, **kw)
    torch.cuda.synchronize()
    assert conv_int8.LAUNCHES["conv3x3_int8"] == before + 1
    ref = conv_int8.conv3x3_int8_plain(x, wq, sa, ws, bias, **kw)
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= 0.02
    assert (got == ref).float().mean().item() >= 0.999


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_int8_kernel_two_launches_equal(dev, stride):
    """Each output element is one s32 sum and one tail: two launches give
    the same bits."""
    from pram_tpu_torch.ops import conv_int8

    g = torch.Generator().manual_seed(11 + stride)
    x, wq, sa, ws, bias = _conv_i8_case(g, 2, 40, 56, 256, 256, dev)
    got = conv_int8.conv3x3_int8(x, wq, sa, ws, bias, stride=stride)
    assert torch.equal(conv_int8.conv3x3_int8(x, wq, sa, ws, bias, stride=stride), got)


@pytest.mark.parametrize("bf16_tail", [False, True])
def test_conv3x3_int8_kernel_ties_and_clip(dev, bf16_tail):
    """Signed inputs on exact half-steps of a power-of-two scale (x / s =
    k + 1/2 exactly, rounded half to even) and beyond +-127 s (clipped),
    with random values between: the kernel quantizes as quant_static."""
    from pram_tpu_torch.ops import conv_int8
    from pram_tpu_torch.ops.quant import quant_w

    g = torch.Generator().manual_seed(5)
    sa = 2.0**-6
    b, h, w, cin, cout = 2, 24, 40, 128, 256
    k = torch.randint(-128, 128, (b, h, w, cin), generator=g).float()
    x = (k + 0.5) * sa                                      # ties, up to +-127.5 s
    pick = torch.rand(b, h, w, cin, generator=g)
    x = torch.where(pick < 0.2, torch.randn(b, h, w, cin, generator=g) * 300 * sa, x)  # beyond the clip
    x = torch.where(pick > 0.8, torch.randn(b, h, w, cin, generator=g) * 40 * sa, x)
    x = x.to(dev, torch.bfloat16)
    wq, ws = quant_w(_rand(g, 3, 3, cin, cout, scale=0.05))
    bias = _rand(g, cout, scale=0.1).to(dev)
    for stride in (1, 2):
        kw = dict(stride=stride, relu=True, bf16_tail=bf16_tail)
        got = conv_int8.conv3x3_int8(x, wq.to(dev), sa, ws.to(dev), bias, **kw)
        ref = conv_int8.conv3x3_int8_plain(x, wq.to(dev), sa, ws.to(dev), bias, **kw)
        assert _rel_err(got, ref) <= 0.02
        assert (got == ref).float().mean().item() >= 0.999


def test_conv3x3_int8_kernel_channel_slices(dev):
    """A residual block's two dense splits: each reads its input slice and
    writes its output slice of one tensor."""
    from pram_tpu_torch.ops import conv_int8

    g = torch.Generator().manual_seed(3)
    x, wq0, sa, ws0, b0 = _conv_i8_case(g, 2, 16, 24, 256, 128, dev)
    _, wq1, _, ws1, b1 = _conv_i8_case(g, 2, 16, 24, 128, 128, dev)
    wq0 = wq0[:, :, :128].contiguous()
    out = torch.empty(2, 16, 24, 256, dtype=torch.bfloat16, device=dev)
    for si, (wq, ws, bb) in enumerate(((wq0, ws0, b0), (wq1, ws1, b1))):
        conv_int8.conv3x3_int8(x, wq, sa, ws, bb, x_coff=128 * si, out=out, out_coff=128 * si)
    ref = torch.cat([conv_int8.conv3x3_int8_plain(x[..., 128 * si:128 * (si + 1)], wq, sa, ws, bb)
                     for si, (wq, ws, bb) in enumerate(((wq0, ws0, b0), (wq1, ws1, b1)))], -1)
    assert (out == ref).float().mean().item() >= 0.999


@pytest.mark.parametrize("b,h,w,cin,cmid,cout", [(1, 24, 12, 8, 16, 24), (2, 48, 20, 8, 16, 24),
                                                 (2, 30, 40, 128, 256, 256)])
def test_conv_pair_kernel(dev, b, h, w, cin, cmid, cout):
    """bf16 outputs within 2% of their scale: both sides round the
    intermediate to bf16 after f32 sums taken in another order."""
    from pram_tpu_torch.ops import convpair

    g = torch.Generator().manual_seed(cin + cmid + h)
    x = _rand(g, b, h, w, cin).to(dev, torch.bfloat16)

    def conv(o, i):
        return (_rand(g, o, i, 3, 3, scale=(9 * i) ** -0.5).to(dev), _rand(g, o, scale=0.1).to(dev),
                (1.0 + _rand(g, o, scale=0.1).to(dev), _rand(g, o, scale=0.1).to(dev),
                 _rand(g, o, scale=0.1).to(dev), 0.5 + _rand(g, o).abs().to(dev)))

    args = (x, *conv(cmid, cin), *conv(cout, cmid))
    before = convpair.LAUNCHES["fused_conv_pair"]
    got = convpair.fused_conv_pair(*args)
    torch.cuda.synchronize()
    assert convpair.LAUNCHES["fused_conv_pair"] == before + 1
    ref = convpair.fused_conv_pair_plain(*args)
    assert got.shape == ref.shape == (b, h, w, cout)
    assert _rel_err(got, ref) <= 0.02


def test_int8_extractor_kernels_vs_plain(dev):
    """The int8 extractor on the card, kernel path against plain path, on a
    small rendered view: keypoint sets >= 0.95, descriptor cosine >= 0.99
    (bf16, the extraction A/B bounds)."""
    from pram_tpu_torch.engine.rendered_guard import extraction_ab_check

    ab = extraction_ab_check(n_images=2, seed=13, device=dev, dtype=torch.bfloat16, int8=True)
    assert ab["kpt_set_agreement"] >= 0.95 and ab["desc_cos_min"] >= 0.99, ab


def _plan_inputs(dev, b=2, n=512, m=1024, seed=21):
    g = torch.Generator().manual_seed(seed)
    sim = _rand(g, b, n, m, scale=3.0).to(dev)
    m0 = (torch.rand(b, n, generator=g) > 0.1).to(dev)
    m1 = (torch.rand(b, m, generator=g) > 0.4).to(dev)
    gt = torch.randint(0, m + 1, (b, n), generator=g).to(dev)
    gt[~m0] = -1
    return sim, m0, m1, gt


def test_sinkhorn_kernel_gradient(dev):
    """``sinkhorn`` with a gradient (SinkhornPlan): kernel 6 forward (one
    launch), the plain iterations differentiated backward. The plan as the
    kernel's; d sim and d dustbin of the matching loss within 1% of their
    scale of plain autograd's (the loss's cotangent, -1 / plan, carries the
    kernel plan's ~0.2% dustbin difference); under ``torch.no_grad()`` the
    same plan from the same single launch."""
    from pram_tpu_torch.train.losses import matching_nll_loss

    sim, m0, m1, gt = _plan_inputs(dev)
    n, m = sim.shape[1:]

    def run(fn):
        s = sim.clone().requires_grad_()
        d = torch.tensor(1.1, device=dev, requires_grad=True)
        plan = fn(s, d, 20, m0, m1)
        matching_nll_loss(plan, gt, m1).backward()
        return plan.detach(), s.grad, d.grad

    before = sinkhorn.LAUNCHES["sinkhorn"]
    plan, ds, dd = run(sinkhorn.sinkhorn)
    torch.cuda.synchronize()
    assert sinkhorn.LAUNCHES["sinkhorn"] == before + 1
    ref, rs, rd = run(sinkhorn.sinkhorn_matching)
    assert (plan[:, :n, :m] - ref[:, :n, :m]).abs().max().item() <= 1e-4
    assert _rel_err(ds, rs) <= 0.01 and _rel_err(dd, rd) <= 0.01
    with torch.no_grad():
        assert torch.equal(sinkhorn.sinkhorn(sim, 1.1, 20, m0, m1), plan)
    assert sinkhorn.LAUNCHES["sinkhorn"] == before + 2


def test_gml_train_step_launches(dev):
    """One GML training step (2 layers, d 256, 2 x (128 + 256) tokens, bf16
    over f32 masters): kernels 1, 5 and 13, 14 once a layer, 2 and 15
    twice a layer, 6 once; the loss finite and every master gradient
    within 3% of its scale of the plain path's in bf16."""
    from pram_tpu_torch.models.gml import GML, GMLConfig
    from pram_tpu_torch.train.losses import matching_nll_loss
    from pram_tpu_torch.train.matcher import make_matcher_train_step
    from pram_tpu_torch.train.trainer import cast_forward

    layers, b, n, m = 2, 2, 128, 256
    model = GML(GMLConfig(n_layers=layers)).to(dev)
    g = torch.Generator().manual_seed(3)
    d0 = torch.nn.functional.normalize(_rand(g, b, n, 128), dim=-1).to(dev)
    d1 = torch.nn.functional.normalize(_rand(g, b, m, 128), dim=-1).to(dev)
    nk0, nk1 = (torch.rand(b, n, 2, generator=g) - 0.5).to(dev), (torch.rand(b, m, 2, generator=g) - 0.5).to(dev)
    m0 = (torch.rand(b, n, generator=g) > 0.1).to(dev)
    m1 = (torch.rand(b, m, generator=g) > 0.2).to(dev)
    gt = torch.randint(0, m + 1, (b, n), generator=g).to(dev)
    gt[~m0] = -1
    args = (d0, d1, nk0, nk1, m0, m1)

    def grads(kernels):
        model.use_kernels = kernels
        model.zero_grad(set_to_none=True)
        out = cast_forward(model, torch.bfloat16, d0.bfloat16(), d1.bfloat16(), *args[2:])
        matching_nll_loss(out["plan"], gt, m1).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    gp = grads(False)
    gk = grads(True)
    model.use_kernels = True
    for k in gp:
        assert _rel_err(gk[k], gp[k]) <= 0.03, k
    counters = (attention.LAUNCHES, cross_attention.LAUNCHES, mlp.LAUNCHES, sinkhorn.LAUNCHES,
                attention_bwd.LAUNCHES, mlp_bwd.LAUNCHES)
    before = {k: v for c in counters for k, v in c.items()}
    loss = make_matcher_train_step(model, 2e-4, torch.bfloat16)(*args, gt)["loss"]
    torch.cuda.synchronize()
    got = {k: v - before[k] for c in counters for k, v in c.items()}
    want = {"self_attention": layers, "cross_attention": layers, "residual_mlp": 2 * layers, "sinkhorn": 1,
            "self_attention_bwd": layers, "cross_attention_bwd": layers, "residual_mlp_bwd": 2 * layers}
    assert {k: got.get(k, 0) for k in want} == want, got
    assert torch.isfinite(loss)


@pytest.mark.parametrize("b,n,m,iters", [(2, 200, 1600, 20), (1, 4096, 2048, 20), (2, 64, 1700, 0),
                                         (1, 45000, 1000, 20)])
def test_sinkhorn_kernel_wide(dev, b, n, m, iters):
    """Kernel 6's wide instance (the plan in device memory, a launch a
    pass): past 1536 columns, at the Aachen GML shape, without iterations,
    and at 45000 x 1000 (rows past any cluster's shared memory). Within the
    tolerances of the other instances, the padded rows and columns with
    zero mass, one counted call, the same bits on two calls."""
    assert sinkhorn.instance(n, m, dev) == (sinkhorn.WIDE, 0)
    g = torch.Generator().manual_seed(n + m)
    sim = _rand(g, b, n, m, scale=3.0).to(dev)
    m0 = (torch.rand(b, n, generator=g) > 0.1).to(dev)
    m1 = (torch.rand(b, m, generator=g) > 0.4).to(dev)
    args = (sim, torch.tensor(1.1, device=dev), iters, m0, m1)
    before = dict(sinkhorn.LAUNCHES)
    got = sinkhorn.sinkhorn(*args)
    torch.cuda.synchronize()
    assert sinkhorn.LAUNCHES == {**before, "sinkhorn_wide": before["sinkhorn_wide"] + 1}
    ref = sinkhorn.sinkhorn_matching(*args)
    assert (got[:, :n, :m] - ref[:, :n, :m]).abs().max().item() <= 1e-4
    for a, r in ((got[:, n, :], ref[:, n, :]), (got[:, :, m], ref[:, :, m])):
        assert ((a - r).abs() / r.abs().clamp(min=1e-6)).max().item() <= 3e-3
    if iters:
        assert (got[:, :n][~m0] == 0).all()
        assert (got[:, :, :m].transpose(1, 2)[~m1] == 0).all()
    assert torch.equal(sinkhorn.sinkhorn(*args).view(torch.int32), got.view(torch.int32))


def test_sinkhorn_wide_refuses_what_does_not_fit(dev):
    sim = torch.zeros(1, 1, 1, device=dev).expand(4000, 8192, 8192)  # a 1 TB plan
    with pytest.raises(ValueError, match="GiB"):
        sinkhorn._launch(sim, torch.tensor(1.0, device=dev), 20, None, None)


def _padded_attention_case(g, b, sides, dev):
    n = sum(sides)
    x, cos, sin = _attn_inputs(g, b, n, dev)
    mask = torch.rand(b, n, generator=g) > 0.2
    mask[-1, : sides[0]] = False  # a fully masked side
    return x, cos, sin, attention.mask_to_bias(mask, b, n, "cpu").to(dev)


@pytest.mark.parametrize("b,sides", [(2, (100,)), (2, (1000, 600)), (3, (37, 128, 300))])
def test_padded_self_attention(dev, b, sides):
    """Kernels 1 and 17 (self), 10 and 12 on sides off the 128-token tile,
    padded inside the wrappers: within their tolerances of the unpadded
    plain versions, one counted launch a call, a fully masked side giving
    the mean of its own v as the plain version does."""
    g = torch.Generator().manual_seed(sum(sides) + b)
    x, cos, sin, kb = _padded_attention_case(g, b, sides, dev)
    splits = None if len(sides) == 1 else sides
    w = _rand(g, 768, 256, scale=256**-0.5).to(dev, torch.bfloat16)
    bias = _rand(g, 768, scale=0.1).to(dev)
    args = (cos, sin, kb, 64**-0.5, 4)
    before = dict(attention.LAUNCHES)
    got = attention.self_attention(x, w, bias, *args, splits=splits)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["self_attention"] == before["self_attention"] + 1
    assert got.shape == x.shape
    assert _rel_err(got, attention.self_attention_plain(x, w, bias, *args, splits=splits)) <= 0.02
    wq, ws = _i8_linear(g, 768, 256, dev)
    got = attention.self_attention_int8(x, wq, ws, bias, *args, splits=splits)
    assert _rel_err(got, attention.self_attention_int8_plain(x, wq, ws, bias, *args, splits=splits)) <= 0.02
    qkv = _rand(g, b, sum(sides), 768).to(dev, torch.bfloat16)
    msg, stat = attention_qkv.self_attention_qkv(qkv, *args, splits=splits, return_stats=True)
    ref_msg, ref_stat = attention_qkv.self_attention_qkv_plain(qkv, *args, splits=splits, return_stats=True)
    assert _rel_err(msg, ref_msg) <= 0.02 and _rel_err(stat, ref_stat) <= 1e-3
    # the same for the f32 instance: statistics within 1e-4
    msg32, stat32 = attention_qkv.self_attention_qkv(qkv.float(), *args, splits=splits, return_stats=True)
    ref32 = attention_qkv.self_attention_qkv_plain(qkv.float(), *args, splits=splits, return_stats=True)
    assert _rel_err(msg32, ref32[0]) <= 1e-4 and _rel_err(stat32, ref32[1]) <= 1e-4


@pytest.mark.parametrize("b,n0,n1", [(2, 100, 156), (2, 1000, 2048), (2, 4096, 1000)])
def test_padded_cross_attention(dev, b, n0, n1):
    """Kernels 5, 17 (cross) and 11 on sides off the tile, padded inside the
    wrappers, against the unpadded plain versions."""
    g = torch.Generator().manual_seed(n0 * 3 + n1)
    x, _, _ = _attn_inputs(g, b, n0 + n1, dev)
    b0 = attention.mask_to_bias(torch.rand(b, n0, generator=g) > 0.1, b, n0, "cpu").to(dev)
    b1 = attention.mask_to_bias(_masks(g, b, n1, 0.7), b, n1, "cpu").to(dev)
    w = [_rand(g, 256, 256, scale=1 / 16).to(dev, torch.bfloat16) for _ in range(2)]
    bb = [_rand(g, 256, scale=0.1).to(dev) for _ in range(2)]
    args = (w[0], bb[0], w[1], bb[1], b0, b1, 64**-0.5, 4, n0)
    got = cross_attention.cross_attention(x, *args)
    assert _rel_err(got, cross_attention.cross_attention_plain(x, *args)) <= 0.02
    (q1, s1), (q2, s2) = _i8_linear(g, 256, 256, dev), _i8_linear(g, 256, 256, dev)
    i8 = (q1, s1, bb[0], q2, s2, bb[1], b0, b1, 64**-0.5, 4, n0)
    got = cross_attention.cross_attention_int8(x, *i8)
    assert _rel_err(got, cross_attention.cross_attention_int8_plain(x, *i8)) <= 0.02
    qk = _rand(g, b, n0 + n1, 256).to(dev, torch.bfloat16)
    v = _rand(g, b, n0 + n1, 256).to(dev, torch.bfloat16)
    pk = (qk[:, :n0], qk[:, n0:], v[:, :n0], v[:, n0:], b0, b1, 64**-0.5, 4)
    got = cross_attention.cross_attention_packed(*pk, return_stats=True)
    ref = cross_attention.cross_attention_packed_plain(*pk, return_stats=True)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == r.shape and _rel_err(a, r) <= (0.02, 1e-3)[i // 2], i


@pytest.mark.parametrize("tokens", [1000, 4096 * 8 + 40])
def test_padded_mlp_and_projections(dev, tokens):
    """Kernels 2 and 16 on token counts off their 32-token tile, and the bf16
    and s8 projection passes off their 64, padded inside the wrappers."""
    g = torch.Generator().manual_seed(tokens)
    args = _mlp_bf16_args(g, tokens, dev)
    before = mlp.LAUNCHES["residual_mlp"]
    got = mlp.residual_mlp(*args)
    torch.cuda.synchronize()
    assert mlp.LAUNCHES["residual_mlp"] == before + 1
    assert _rel_err(got, mlp.residual_mlp_plain(*args)) <= 0.02
    (wpq, wps), (w0q, w0s), (w3q, w3s) = (_i8_linear(g, o, i, dev) for o, i in ((256, 256), (512, 512), (256, 512)))
    i8 = (args[0], args[1], wpq, wps, args[3], w0q, w0s, args[5], args[6], args[7], w3q, w3s, args[9])
    assert _rel_err(mlp.residual_mlp_int8(*i8), mlp.residual_mlp_int8_plain(*i8)) <= 0.02
    x, cos, sin = _attn_inputs(g, 1, tokens, dev)
    w = _rand(g, 768, 256, scale=256**-0.5).to(dev, torch.bfloat16)
    bias = _rand(g, 768, scale=0.1).to(dev)
    pre = attention.project_plain(x, w, bias)
    _check_projection(attention.project(x, w, bias, cos, sin, rotary_cols=512),
                      attention.project_plain(x, w, bias, cos, sin, rotary_cols=512), pre, 512)
    wq, ws = _i8_linear(g, 768, 256, dev)
    qk, vv = attention.project_int8(x, wq, ws, bias, split=256)
    _check_projection(torch.cat([qk, vv], -1), attention.project_int8_plain(x, wq, ws, bias))


@pytest.mark.parametrize("b,n,p", [(2, 100, 300), (2, 1000, 2048), (1, 4096, 4000)])
def test_padded_refine_nn(dev, b, n, p):
    """Kernel 7 on query and point counts off its 64, padded inside the
    wrapper; the padded points are zero descriptors at uv 0, which win every
    row whose real points are all far or gated out unless the kernel skips
    them: no index reaches them, and the agreement holds."""
    g = torch.Generator().manual_seed(n + p + 5)
    args = _refine_tie_case(g, b, n, p, dev)
    args[1][:, :] = -args[1].abs()  # every similarity of a positive query below 0
    args[0] = args[0].abs()
    idx, d1, keep = refine.refine_nn(*args)
    ridx, rd1, rkeep = refine.refine_nn_plain(*args)
    assert idx.shape == (b, n) and int(idx.max()) < p
    assert (idx == ridx).float().mean().item() >= 0.99
    assert (keep == rkeep).float().mean().item() >= 0.99
    assert (d1 - rd1).abs().max().item() <= 1e-4
