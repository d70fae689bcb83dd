"""Common host utilities (pram_tpu/utils/common.py, reference
tools/common.py).

Image resize and pad helpers and the config snapshot, without cv2 or yaml
(the card's machine has neither):

- :func:`resize_img` is ``cv2.resize``: ``INTER_NEAREST`` (the default,
  source index ``floor(x / (dst / src))``, as OpenCV's resizeNN computes
  it) or ``INTER_LINEAR`` (``io/image.py:resize_linear``);
- :func:`save_args_yaml` writes block YAML that ``yaml.safe_load`` reads
  as it reads the JAX package's ``yaml.safe_dump`` output, and that
  ``core/config.py``'s reader reads back;
- :func:`puttext_with_background` needs cv2's Hershey fonts and raises.
"""

from __future__ import annotations

import math
import os
import re
from typing import Tuple

import numpy as np

from pram_tpu_torch.io.image import resize_linear

# cv2's interpolation flags
INTER_NEAREST = 0
INTER_LINEAR = 1


def _nearest_index(n_out: int, n_in: int) -> np.ndarray:
    scale = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)


def _resize(img: np.ndarray, size: Tuple[int, int], mode: int) -> np.ndarray:
    w, h = size
    if mode == INTER_LINEAR:
        return resize_linear(img, (w, h))
    if mode != INTER_NEAREST:
        raise NotImplementedError(
            f"resize_img takes INTER_NEAREST ({INTER_NEAREST}) or INTER_LINEAR ({INTER_LINEAR}); got {mode}"
        )
    rows = _nearest_index(h, img.shape[0])
    cols = _nearest_index(w, img.shape[1])
    return img[rows][:, cols]


def resize_img(img: np.ndarray, nh: int = -1, nw: int = -1, mode=None):
    """Resize keeping the aspect ratio when only one target side is given
    (tools/common.py resize_img semantics); ``mode`` is a cv2 flag."""
    if mode is None:
        mode = INTER_NEAREST
    h, w = img.shape[:2]
    if nh > 0 and nw > 0:
        return _resize(img, (nw, nh), mode)
    if nh > 0:
        return _resize(img, (int(w * nh / h), nh), mode)
    if nw > 0:
        return _resize(img, (nw, int(h * nw / w)), mode)
    return img


def pad_to_multiple(
    img: np.ndarray, multiple: int = 8
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad H/W up to a multiple (the extractors' stride of 8)."""
    h, w = img.shape[:2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph or pw:
        widths = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, widths)
    return img, (h, w)


def puttext_with_background(
    img, text, org, bg_color=(0, 0, 0), text_color=(0, 255, 0),
    fscale=1.0, thickness=2,
):
    """Text overlay with a filled background box (tools/common.py): it
    draws with cv2's Hershey fonts, which the port does not carry."""
    raise NotImplementedError(
        "puttext_with_background draws text with cv2's Hershey fonts (FONT_HERSHEY_SIMPLEX), "
        "which the port does not carry (no cv2 on the card's machine)"
    )


# ---- a block-YAML writer for the config snapshot

_PLAIN = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*$")


def _yaml_scalar(v) -> str:
    from pram_tpu_torch.core.config import YAMLSubsetError, _scalar

    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)  # YAML 1.1 floats carry a dot, and a signed exponent
        if "e" in r:
            mant, exp = r.split("e")
            r = (mant if "." in mant else mant + ".0") + "e" + (exp if exp[0] in "+-" else "+" + exp)
        return r
    if isinstance(v, str):
        if any(ord(ch) < 32 or ord(ch) == 127 for ch in v):
            raise ValueError(f"save_args_yaml writes one-line strings; got {v!r}")
        try:
            plain = _PLAIN.match(v) is not None and _scalar(v, 0, v) == v
        except YAMLSubsetError:
            plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"save_args_yaml writes str, int, float, bool and None scalars; got {type(v).__name__}")


def yaml_lines(obj: dict, indent: int = 0) -> list:
    """Block YAML of nested dicts, lists of scalars and scalars."""
    pad = " " * indent
    out = []
    for key, value in obj.items():
        k = _yaml_scalar(key)
        if isinstance(value, dict):
            out += [f"{pad}{k}: {{}}"] if not value else [f"{pad}{k}:"] + yaml_lines(value, indent + 2)
        elif isinstance(value, (list, tuple)):
            if any(isinstance(x, (dict, list, tuple)) for x in value):
                raise TypeError(f"save_args_yaml writes lists of scalars; {key!r} holds a nested one")
            out += [f"{pad}{k}: []"] if not value else [f"{pad}{k}:"] + [f"{pad}- {_yaml_scalar(x)}" for x in value]
        else:
            out.append(f"{pad}{k}: {_yaml_scalar(value)}")
    return out


def save_args_yaml(args, save_dir: str, name: str = "args.yaml"):
    """Config snapshot (trainer.py:86): argparse args or a dict, in block
    YAML with the keys in their order (``sort_keys=False``)."""
    os.makedirs(save_dir, exist_ok=True)
    if not isinstance(args, dict):
        args = vars(args) if hasattr(args, "__dict__") else dict(args)
    with open(os.path.join(save_dir, name), "w") as f:
        f.write("\n".join(yaml_lines(args)) + "\n" if args else "{}\n")
