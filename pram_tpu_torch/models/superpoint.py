"""SuperPoint detector and descriptor (pram_tpu/models/superpoint.py).

A VGG-style encoder on grayscale images with three 2x2 max-pools (stride
8), a 65-channel softmax + 8x8 pixel-shuffle score decoder at full
resolution, and an L2-normalized 256-d descriptor map at stride 8; its
``mid_features`` are the descriptor head's first activation (cDa, 256-d),
which the recognizer takes as tokens. The interface is SFD2's
(``models/sfd2.py``): a dense forward and :func:`extract`.

The convolutions and pools are ``F.conv2d`` / ``F.max_pool2d``, as the JAX
package leaves them to XLA; :func:`extract` runs NMS through
``ops/nms.py`` (kernel 9, at radius 3 on this model's path) unless
``use_nms_kernel`` is off. The JAX SuperPoint calls the plain NMS; the
kernel is bit-equal to it, so the two extractions are one function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pram_tpu_torch.models.sfd2 import pixel_shuffle_score
from pram_tpu_torch.ops.keypoints import extract_keypoints
from pram_tpu_torch.ops.nms import nms, simple_nms
from pram_tpu_torch.ops.sampling import sample_descriptors

# ITU-R BT.601 luma, the weights of cv2's RGB -> gray
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


class SuperPoint(nn.Module):
    """SuperPoint (DeTone et al., CVPRW'18), the reference's layer names
    (``conv1a`` .. ``convDb``). Parameters keep torch's default init; the
    callers seed it."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        for name, cin, cout in (("conv1a", 1, c1), ("conv1b", c1, c1), ("conv2a", c1, c2),
                                ("conv2b", c2, c2), ("conv3a", c2, c3), ("conv3b", c3, c3),
                                ("conv4a", c3, c4), ("conv4b", c4, c4), ("convPa", c4, c5),
                                ("convDa", c4, c5)):
            self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)

    def forward(self, image: torch.Tensor) -> dict:
        """``image [B, H, W, 1]`` grayscale in [0, 1], H and W divisible by 8.

        Returns NHWC ``score_map [B, H, W]``, ``desc_map [B, H/8, W/8, D]``
        (L2-normalized) and ``mid_features [B, H/8, W/8, 256]``.
        """
        x = image.permute(0, 3, 1, 2)
        for stage in ("1", "2", "3"):
            x = F.relu(getattr(self, f"conv{stage}a")(x))
            x = F.relu(getattr(self, f"conv{stage}b")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x3 = F.relu(self.conv4b(x))

        cpa = F.relu(self.convPa(x3))
        semi = torch.softmax(self.convPb(cpa), dim=1)[:, :-1]
        score_map = pixel_shuffle_score(semi)

        cda = F.relu(self.convDa(x3))
        desc = self.convDb(cda)
        norm = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True))
        desc = desc / torch.clamp(norm, min=1e-12)
        return {
            "score_map": score_map,
            "desc_map": desc.permute(0, 2, 3, 1),
            "mid_features": cda.permute(0, 2, 3, 1),
        }


def preprocess_image(image01: torch.Tensor) -> torch.Tensor:
    """The model's input from an image in [0, 1]: ``[..., 1]`` grayscale
    as it is, ``[..., 3]`` RGB to gray by :data:`GRAY_WEIGHTS`."""
    if image01.shape[-1] == 1:
        return image01
    w = torch.tensor(GRAY_WEIGHTS, dtype=image01.dtype, device=image01.device)
    return (image01 * w).sum(-1, keepdim=True)


@torch.no_grad()
def extract(
    model: SuperPoint,
    image: torch.Tensor,
    *,
    max_keypoints: int = 4096,
    conf_th: float = 0.001,
    border: int = 4,
    min_keypoints: int = 32,
    nms_radius: int = 3,
    use_nms_kernel: bool = True,
) -> dict:
    """Dense forward + NMS + top-K + descriptor sampling at stride 8.

    ``image [B, H, W, 1]`` in the model's type. The keypoint selection is
    the JAX SuperPoint's: its 4-pixel block reduction before the top-K
    (``extract_keypoints``' default radius), which keeps every survivor of
    an NMS at radius 3 or more but one of two exactly tied in a block.
    Returns ``keypoints`` (``ops.keypoints.Keypoints``), ``descriptors [B,
    K, D]`` from ``desc_map``, ``seg_descriptors [B, K, 256]`` from
    ``mid_features`` (both L2-normalized) and the dense maps (NHWC).
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
    )
    descs = sample_descriptors(kps.xy, out["desc_map"].permute(0, 3, 1, 2), 8)
    seg_descs = sample_descriptors(kps.xy, out["mid_features"].permute(0, 3, 1, 2), 8)
    return {
        "keypoints": kps,
        "descriptors": descs,
        "seg_descriptors": seg_descs,
        "score_map": score_map,
        "desc_map": out["desc_map"],
        "mid_features": out["mid_features"],
    }
