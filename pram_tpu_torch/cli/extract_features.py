"""Feature extraction CLI: images -> hloc-compatible h5
(pram_tpu/cli/extract_features.py).

Image listing and loading, padding to the stride, the per-config
extractor (SFD2 or SuperPoint, kernels 8 and 9 on the card) and the
descriptor compressor; ``extract_to_h5`` writes hloc's h5 layout through
the port's own HDF5 writer (``io/h5.py``). Images are read without cv2
(``io/image.py``): JPEG (bit-equal to ``cv2.imread``, ``io/jpeg.py``), PNG
and ``.npy``; any other format raises naming the file and its format.

Usage:
  python -m pram_tpu_torch.cli.extract_features --image_dir D --export_fn out.h5 \
      --conf sfd2 [--weight_path W] [--image_list list.txt] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from pram_tpu_torch.io.image import read_image, resize_linear

CONFS = {
    "sfd2": {
        "output": "feats-sfd2",
        "model": {"name": "resnet4x", "outdim": 128, "max_keypoints": 4096,
                  "conf_th": 0.005, "nms_radius": 4, "min_keypoints": 128},
        "preprocessing": {"grayscale": False, "resize_max": None},
    },
    "resnet4x": {
        "output": "feats-resnet4x",
        "model": {"name": "resnet4x", "outdim": 128, "max_keypoints": 4096,
                  "conf_th": 0.005, "nms_radius": 4, "min_keypoints": 128},
        "preprocessing": {"grayscale": False, "resize_max": None},
    },
    "superpoint-n4096": {
        "output": "feats-superpoint-n4096",
        "model": {"name": "superpoint", "outdim": 256, "max_keypoints": 4096,
                  "conf_th": 0.005, "nms_radius": 3, "min_keypoints": 32},
        "preprocessing": {"grayscale": True, "resize_max": None},
    },
}

IMAGE_GLOBS = ["*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG"]


def list_images(root: str, image_list: Optional[str] = None) -> List[str]:
    if image_list is not None:
        with open(image_list) as f:
            return [l.strip() for l in f if l.strip()]
    paths = []
    for g in IMAGE_GLOBS:
        paths += glob.glob(osp.join(root, "**", g), recursive=True)
    rel = sorted(osp.relpath(p, root) for p in paths)
    if not rel:
        raise ValueError(f"no images under {root}")
    return rel


def load_image(path: str, grayscale: bool, resize_max: Optional[int]):
    """Read an image -> float [H, W, C] in [0,1] + scale back factor.

    JPEG, PNG and ``.npy`` (uint8, or float in [0, 1]) through ``io/image.py``;
    ``resize_max`` resizes as ``cv2.resize``'s ``INTER_LINEAR`` does."""
    img = read_image(path, grayscale)
    size = np.array(img.shape[:2][::-1])  # (w, h)
    scale = 1.0
    if resize_max and max(img.shape[:2]) > resize_max:
        scale = resize_max / max(img.shape[:2])
        img = resize_linear(
            img, (int(round(img.shape[1] * scale)), int(round(img.shape[0] * scale)))
        )
    img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img.astype(np.float32)
    if grayscale:
        img = img[..., None]
    return img, size, scale


def _pad_to_multiple(img: np.ndarray, mult: int = 8):
    h, w = img.shape[:2]
    ph = (mult - h % mult) % mult
    pw = (mult - w % mult) % mult
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    return img


def build_extractor(conf: Dict, weight_path: Optional[str] = None, device="cuda"):
    """(model, extract_fn, preprocess) for a config on ``device``, in
    ``cli/match_features.py:model_dtype`` (bf16 on the card, f32 on the CPU).

    ``weight_path``: a reference torch checkpoint (converted by
    ``models/convert.py:convert_sfd2``) or the repo's flax ``.msgpack``;
    without one the model keeps torch's seeded random init."""
    name = conf["model"]["name"]
    if name in ("resnet4x", "sfd2"):
        from pram_tpu_torch.cli.match_features import model_dtype
        from pram_tpu_torch.models.convert import (
            convert_sfd2,
            load_sfd2,
            load_torch_state_dict,
            sfd2_state_dict,
        )
        from pram_tpu_torch.models.sfd2 import ResNet4x, extract, preprocess_image

        dtype = model_dtype(device)
        if weight_path and weight_path.endswith(".msgpack"):
            model = load_sfd2(weight_path, device=device, dtype=dtype)
        else:
            torch.manual_seed(0)
            model = ResNet4x(outdim=conf["model"]["outdim"])
            if weight_path:
                model.load_state_dict(
                    sfd2_state_dict(convert_sfd2(load_torch_state_dict(weight_path))), strict=True
                )
            model = model.to(device, dtype).to(memory_format=torch.channels_last).eval()
        return model, extract, preprocess_image
    if name == "superpoint":
        from pram_tpu_torch.cli.match_features import model_dtype
        from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
        from pram_tpu_torch.models.convert import (
            convert_superpoint,
            load_torch_state_dict,
            superpoint_state_dict,
        )
        from pram_tpu_torch.models.superpoint import SuperPoint, extract, preprocess_image

        torch.manual_seed(0)
        model = SuperPoint(descriptor_dim=conf["model"]["outdim"])
        if weight_path:
            if weight_path.endswith(".msgpack"):
                tree = read_flax_msgpack(weight_path)
                params = tree.get("params", tree)
            else:
                params = convert_superpoint(load_torch_state_dict(weight_path))["params"]
            model.load_state_dict(superpoint_state_dict(params), strict=True)
        model = model.to(device, model_dtype(device)).to(memory_format=torch.channels_last).eval()
        return model, extract, preprocess_image
    raise ValueError(f"unknown extractor {name}")


def build_compressor(feat_dim: int, weight_path: Optional[str] = None, device="cuda"):
    """Optional 128 -> 64 / 32-d descriptor compression (reference
    main.py:50-63): a callable ``descs [..., N, 128] -> [..., N, feat_dim]``
    (L2-normalized) on ``device`` in ``cli/match_features.py:model_dtype``,
    or None when ``feat_dim`` is 128. ``weight_path``: a reference torch
    checkpoint (``models/convert.py:convert_descriptor_compressor``) or a
    flax ``.msgpack``; without one torch's seeded init."""
    if feat_dim == 128:
        return None
    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
    from pram_tpu_torch.models.convert import (
        compressor_state_dict,
        convert_descriptor_compressor,
        load_torch_state_dict,
    )
    from pram_tpu_torch.models.sfd2 import DescriptorCompressor

    torch.manual_seed(0)
    comp = DescriptorCompressor(outdim=feat_dim)
    if weight_path:
        if weight_path.endswith(".msgpack"):
            tree = read_flax_msgpack(weight_path)
            params = tree.get("params", tree)
        else:
            params = convert_descriptor_compressor(load_torch_state_dict(weight_path))["params"]
        comp.load_state_dict(compressor_state_dict(params), strict=True)
    comp = comp.to(device, model_dtype(device)).eval()

    @torch.no_grad()
    def fn(descs):
        return comp(torch.as_tensor(descs).to(device, model_dtype(device)))

    return fn


def extract_to_h5(
    image_dir: str,
    export_fn: str,
    conf_name: str = "sfd2",
    weight_path: Optional[str] = None,
    image_list: Optional[str] = None,
    resize_max: Optional[int] = None,
    feat_dim: int = 128,
    compressor_weight_path: Optional[str] = None,
    device="cuda",
):
    """Features of every image into an hloc h5 file (``io/h5.py``): a group
    per image name with ``keypoints [N, 2]`` (scaled back to the original
    size), ``scores [N]``, ``descriptors [D, N]`` (all f32) and
    ``image_size`` (the original ``(w, h)``). Images go one at a time through
    the config's extractor on ``device``."""
    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.io import h5

    conf = CONFS[conf_name]
    model, extract_fn, preprocess = build_extractor(conf, weight_path, device)
    compressor = build_compressor(feat_dim, compressor_weight_path, device)
    dtype = model_dtype(device)
    names = list_images(image_dir, image_list)
    os.makedirs(osp.dirname(osp.abspath(export_fn)), exist_ok=True)

    mconf = conf["model"]
    with h5.File(export_fn, "w") as out:
        for name in names:
            img, orig_size, scale = load_image(
                osp.join(image_dir, name),
                conf["preprocessing"]["grayscale"],
                resize_max or conf["preprocessing"]["resize_max"],
            )
            img = _pad_to_multiple(img)
            x = preprocess(torch.from_numpy(img).to(device)[None]).to(dtype)
            feats = extract_fn(
                model,
                x,
                max_keypoints=mconf["max_keypoints"],
                conf_th=mconf["conf_th"],
                nms_radius=mconf["nms_radius"],
                min_keypoints=mconf["min_keypoints"],
            )
            kps = feats["keypoints"]
            mask = kps.mask[0].cpu().numpy()
            kpts = kps.xy[0].float().cpu().numpy()[mask] / scale  # scale back
            scores = kps.scores[0].float().cpu().numpy()[mask]
            descs = feats["descriptors"][0][torch.from_numpy(mask).to(device)]
            if compressor is not None:
                descs = compressor(descs)
            descs = descs.float().cpu().numpy()
            g = out.create_group(name)
            g.create_dataset("keypoints", data=kpts.astype(np.float32))
            g.create_dataset("scores", data=scores.astype(np.float32))
            # hloc layout: descriptors [D, N]
            g.create_dataset("descriptors", data=descs.T.astype(np.float32))
            g.create_dataset("image_size", data=orig_size)
    return export_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--export_fn", required=True)
    ap.add_argument("--conf", default="sfd2", choices=list(CONFS))
    ap.add_argument("--weight_path", default=None)
    ap.add_argument("--image_list", default=None)
    ap.add_argument("--resize_max", type=int, default=None)
    ap.add_argument(
        "--feat_dim", type=int, default=128,
        help="64/32 compress descriptors through DescriptorCompressor",
    )
    ap.add_argument("--compressor_weight_path", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    return extract_to_h5(
        args.image_dir,
        args.export_fn,
        args.conf,
        args.weight_path,
        args.image_list,
        args.resize_max,
        args.feat_dim,
        args.compressor_weight_path,
        args.device,
    )


if __name__ == "__main__":
    main()
