"""SFD2 (ResNet4x) detector and descriptor (pram_tpu/models/sfd2.py).

A ResNet-style backbone at stride 4, a 65-channel softmax + 8x8 pixel
shuffle score decoder at full resolution, an L2-normalized 128-d descriptor
map at stride 4 and a 256-d stride-4 ``mid_features`` map that is sampled as
the recognition tokens. BatchNorm runs in inference mode (the extractor is
frozen). Inside, tensors are NCHW in channels_last memory, the layout the
stem kernel writes and cuDNN's NHWC convolutions read; the outputs are in
the JAX package's NHWC layout.

The stem (conv1a + conv1b) goes through ``ops/stem.py`` (kernel 8) unless
``use_stem_kernel`` is off; the other convolutions are ``F.conv2d``, as the
JAX package leaves them to XLA. :func:`extract` runs NMS through
``ops/nms.py`` (kernel 9) unless ``use_nms_kernel`` is off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.ops.keypoints import extract_keypoints
from pram_tpu_torch.ops.nms import nms, simple_nms
from pram_tpu_torch.ops.sampling import sample_descriptors
from pram_tpu_torch.ops.stem import fused_stem

# ImageNet RGB normalization
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class ConvBNReLU(nn.Module):
    """3x3 conv (bias kept) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.bn = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def stem_args(self):
        """``(kernel, bias, (scale, bias, mean, var))`` for ``fused_stem``."""
        bn = self.bn
        return self.conv.weight, self.conv.bias, (bn.weight, bn.bias, bn.running_mean, bn.running_var)


class ResBlock(nn.Module):
    """1x1 -> grouped 3x3 (32 groups) -> 1x1 bottleneck with identity."""

    def __init__(self, c: int = 256, groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1, bias=False)
        self.bn1 = _bn(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, groups=groups, bias=False)
        self.bn2 = _bn(c)
        self.conv3 = nn.Conv2d(c, c, 1, bias=False)
        self.bn3 = _bn(c)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + x)


def pixel_shuffle_score(semi: torch.Tensor) -> torch.Tensor:
    """``semi [B, 64, Hc, Wc]`` (dustbin dropped; channel i*8+j is sub-pixel
    row i, column j of each 8x8 cell) -> ``[B, Hc*8, Wc*8]``."""
    return F.pixel_shuffle(semi, 8)[:, 0].contiguous()


class ResNet4x(nn.Module):
    """SFD2 backbone + detector/descriptor heads (dense outputs)."""

    def __init__(self, inputdim: int = 3, outdim: int = 128, use_stem_kernel: bool = True):
        super().__init__()
        d1, d2, d3 = 64, 128, 256
        self.use_stem_kernel = use_stem_kernel
        self.conv1a = ConvBNReLU(inputdim, d1)
        self.conv1b = ConvBNReLU(d1, d1, stride=2)
        self.conv2a = ConvBNReLU(d1, d2)
        self.conv2b = ConvBNReLU(d2, d2, stride=2)
        self.conv3a = ConvBNReLU(d2, d3)
        self.conv3b = ConvBNReLU(d3, d3)
        self.res = nn.ModuleList(ResBlock(d3) for _ in range(3))
        self.convPa_0 = nn.Conv2d(d3, 256, 3, stride=2, padding=1)
        self.convPa_bn = _bn(256)
        self.convPa_3 = nn.Conv2d(256, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa_0 = nn.Conv2d(d3, 256, 3, padding=1)
        self.convDa_bn = _bn(256)
        self.convDa_3 = nn.Conv2d(256, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, outdim, 1)

    def forward(self, image: torch.Tensor) -> dict:
        """``image [B, H, W, 3]`` ImageNet-normalized, H and W divisible by 8.

        Returns NHWC ``score_map [B, H, W]``, ``desc_map [B, H/4, W/4,
        outdim]`` (L2-normalized), ``mid_features [B, H/4, W/4, 256]`` and
        ``logits [B, H/8, W/8, 65]``.
        """
        if self.use_stem_kernel:
            x = fused_stem(image.contiguous(), *self.conv1a.stem_args(), *self.conv1b.stem_args())
            x = x.permute(0, 3, 1, 2)
        else:
            x = image.permute(0, 3, 1, 2)
            x = self.conv1b(self.conv1a(x))
        x = self.conv2b(self.conv2a(x))
        x = self.conv3b(self.conv3a(x))
        for block in self.res:
            x = block(x)
        mid = x

        cpa = F.relu(self.convPa_bn(self.convPa_0(mid)))
        logits = self.convPb(self.convPa_3(cpa))
        semi = torch.softmax(logits, dim=1)[:, :-1]
        score_map = pixel_shuffle_score(semi)

        cda = F.relu(self.convDa_bn(self.convDa_0(mid)))
        desc = self.convDb(self.convDa_3(cda))
        norm = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True))
        desc = desc / torch.clamp(norm, min=1e-12)
        return {
            "score_map": score_map,
            "desc_map": desc.permute(0, 2, 3, 1),
            "mid_features": mid.permute(0, 2, 3, 1),
            "logits": logits.permute(0, 2, 3, 1),
        }


def preprocess_image(image_rgb01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an RGB image ``[..., 3]`` in [0, 1]."""
    mean = torch.tensor(RGB_MEAN, dtype=image_rgb01.dtype, device=image_rgb01.device)
    std = torch.tensor(RGB_STD, dtype=image_rgb01.dtype, device=image_rgb01.device)
    return (image_rgb01 - mean) / std


@torch.no_grad()
def extract(
    model: ResNet4x,
    image: torch.Tensor,
    *,
    max_keypoints: int = 4096,
    conf_th: float = 0.005,
    border: int = 4,
    min_keypoints: int = 128,
    nms_radius: int = 4,
    use_nms_kernel: bool = True,
) -> dict:
    """Dense forward + NMS + top-K + descriptor sampling.

    ``image [B, H, W, 3]`` ImageNet-normalized, in the model's type. Returns
    ``keypoints`` (``ops.keypoints.Keypoints``, padded to ``max_keypoints`` with a
    mask), ``descriptors [B, K, outdim]`` sampled from ``desc_map``,
    ``seg_descriptors [B, K, 256]`` sampled from ``mid_features`` (both
    L2-normalized), and the dense ``score_map``, ``desc_map`` and
    ``mid_features`` (NHWC).
    """
    out = model(image)
    score_map = out["score_map"]
    nms_fn = nms if use_nms_kernel else simple_nms
    kps = extract_keypoints(
        nms_fn(score_map, nms_radius),
        max_keypoints=max_keypoints,
        conf_th=conf_th,
        border=border,
        min_keypoints=min_keypoints,
        nms_radius=nms_radius,
    )
    descs = sample_descriptors(kps.xy, out["desc_map"].permute(0, 3, 1, 2), 4)
    seg_descs = sample_descriptors(kps.xy, out["mid_features"].permute(0, 3, 1, 2), 4)
    return {
        "keypoints": kps,
        "descriptors": descs,
        "seg_descriptors": seg_descs,
        "score_map": score_map,
        "desc_map": out["desc_map"],
        "mid_features": out["mid_features"],
    }
