"""Typed experiment configuration with the reference's YAML surface
(pram_tpu/core/config.py).

The same YAML files parse into the same dataclasses: unknown keys are kept
in ``extras``, and the nested ``localization:`` block maps onto the engine's
LocConfig exactly as the JAX package maps it. As there,
``refinement_method`` and ``matching_method`` go to the host config, not to
LocConfig, and keys such as ``covisibility_frame`` go to ``extras``.

The card's machine has no ``yaml``, so :func:`safe_load` reads the subset
of YAML that ``configs/*.yaml`` and ``configs/datasets/*.yaml`` use: block
maps, block lists of scalars, plain or quoted one-line scalars resolved
as ``yaml.safe_load`` resolves them (int, float, bool, null, string),
single-quoted keys, and the empty ``[]`` and ``{}``. It raises, naming the
line, on anything else.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from pram_tpu_torch.engine.localizer import LocConfig
from pram_tpu_torch.train.trainer import TrainConfig

# YAML 1.1's implicit scalar types as PyYAML's resolver has them
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)([eE][-+][0-9]+)?$")
# the other forms YAML 1.1 resolves to numbers, which the subset leaves out
_OTHER_NUMBER = re.compile(
    r"[-+]?(0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$"
)
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


class YAMLSubsetError(ValueError):
    """A construct outside the subset :func:`safe_load` reads."""


def _fail(lineno: int, what: str, line: str):
    raise YAMLSubsetError(f"line {lineno}: {what} is not supported: {line.strip()!r}")


def _scalar(text: str, lineno: int, line: str):
    """A one-line scalar: quoted strings as written, plain ones resolved."""
    if text[:1] == "'":
        if len(text) < 2 or not text.endswith("'") or "'" in text[1:-1].replace("''", ""):
            _fail(lineno, "a multi-line or malformed quoted string", line)
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or not text.endswith('"') or '"' in text[1:-1] or "\\" in text:
            _fail(lineno, "a multi-line or escaped double-quoted string", line)
        return text[1:-1]
    if text in ("[]", "{}"):  # the empty flow collections, as yaml.safe_dump writes them
        return [] if text == "[]" else {}
    if text[:1] in ("[", "{"):
        _fail(lineno, "flow style", line)
    if text[:1] in ("&", "*", "!"):
        _fail(lineno, "an anchor, alias or tag", line)
    if text[:1] in ("|", ">"):
        _fail(lineno, "a block scalar", line)
    if text[:1] in ("@", "`", "%"):
        _fail(lineno, "a reserved indicator", line)
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OTHER_NUMBER.match(text):
        _fail(lineno, "a binary, octal, hexadecimal or sexagesimal number", line)
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(text: str) -> str:
    """Drop a trailing `` #`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or text[i - 1] in " :-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _lines(text: str):
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            _fail(lineno, "tab indentation", raw)
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            _fail(lineno, "a document marker", raw)
        indent = len(body) - len(body.lstrip(" "))
        out.append((lineno, indent, body.strip(), raw))
    return out


_QUOTED_KEY = re.compile(r"('(?:[^']|'')*'):(?: (.*))?$")


def _split_key(content: str, lineno: int, line: str):
    """``key: value`` / ``key:`` -> (key, value text or None); None if no
    key. A key may be single-quoted (``'off': 1``, as yaml.safe_dump quotes
    a key that would resolve to another type)."""
    if content.startswith("'"):
        m = _QUOTED_KEY.match(content)
        if m is None:
            _fail(lineno, "a malformed quoted key", line)
        value = (m.group(2) or "").strip()
        return m.group(1), value or None
    if content.startswith(('"', "?")):
        _fail(lineno, "a double-quoted or complex key", line)
    if content.endswith(":") and ": " not in content:
        return content[:-1], None
    if ": " in content:
        key, value = content.split(": ", 1)
        return key, value.strip()
    return None


def _parse_block(lines, i: int, indent: int):
    """Parse the block starting at ``lines[i]`` (all at ``indent``); returns
    (value, next index)."""
    lineno, ind, content, raw = lines[i]
    if content == "-" or content.startswith("- "):
        items = []
        while i < len(lines) and lines[i][1] == indent and (
            lines[i][2] == "-" or lines[i][2].startswith("- ")
        ):
            lineno, _, content, raw = lines[i]
            item = content[1:].strip()
            nested = item[:1] not in ("'", '"') and (": " in item or item.endswith(":"))
            if not item or nested or item == "-" or item.startswith("- "):
                _fail(lineno, "a list item that is not a one-line scalar", raw)
            items.append(_scalar(item, lineno, raw))
            i += 1
        if i < len(lines) and lines[i][1] > indent:
            _fail(lines[i][0], "a continuation line", lines[i][3])
        return items, i

    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, content, raw = lines[i]
        kv = _split_key(content, lineno, raw)
        if kv is None:
            _fail(lineno, "a line that is not 'key: value'", raw)
        key, value = kv
        key = _scalar(key, lineno, raw)
        i += 1
        if value is not None:
            out[key] = _scalar(value, lineno, raw)
            if i < len(lines) and lines[i][1] > indent:
                _fail(lines[i][0], "a multi-line scalar", lines[i][3])
            continue
        if i < len(lines) and lines[i][1] > indent:
            out[key], i = _parse_block(lines, i, lines[i][1])
        elif i < len(lines) and lines[i][1] == indent and (
            lines[i][2] == "-" or lines[i][2].startswith("- ")
        ):
            out[key], i = _parse_block(lines, i, indent)  # a list beside its key
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        _fail(lines[i][0], "an indentation that closes no block", lines[i][3])
    return out, i


def safe_load(text: str):
    """Read the YAML subset of the repo's configs (block maps, block lists of
    scalars, one-line scalars) as ``yaml.safe_load`` reads it."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][1])
    if i < len(lines):
        _fail(lines[i][0], "an indentation that closes no block", lines[i][3])
    return value


def load_yaml(path: str):
    with open(path) as f:
        return safe_load(f.read())


@dataclass
class JitterParams:
    brightness: float = 0.5
    contrast: float = 0.5
    saturation: float = 0.25
    hue: float = 0.15
    blur: float = 0.0


@dataclass
class ExperimentConfig:
    """Flat experiment config (configs/config_train_*_sfd2.yaml layout)."""

    dataset: List[str] = field(default_factory=lambda: ["7Scenes"])
    network: str = "segnetvit"
    feature: str = "sfd2"

    save_path: str = "exp"
    landmark_path: str = "landmarks"
    dataset_path: str = "datasets"
    config_path: str = "configs/datasets"

    image_dim: int = 3
    feat_dim: int = 128

    min_inliers: int = 32
    max_inliers: int = 256
    random_inliers: bool = True
    max_keypoints: int = 512
    eval_max_keypoints: int = 1024
    output_dim: int = 1024
    layers: int = 15
    n_class: int = 113

    jitter_params: JitterParams = field(default_factory=JitterParams)
    scale_params: Sequence[float] = (0.5, 1.0)
    with_aug: bool = True
    use_mid_feature: bool = True
    norm_desc: bool = False
    with_cls: bool = False
    with_score: bool = False

    batch_size: int = 32
    its_per_epoch: int = 1000
    epochs: int = 200
    lr: float = 1e-4
    min_lr: float = 1e-5
    decay_rate: float = 0.999992
    decay_iter: int = 80000
    workers: int = 8
    log_intervals: int = 50
    eval_n_epoch: int = 10
    do_eval: bool = False
    cluster_method: str = "birch"

    weight_path: Optional[str] = None
    resume_path: Optional[str] = None

    localization: LocConfig = field(default_factory=LocConfig)
    # keys of the localization block that belong to the host pipeline, not
    # the engine
    loc_scene_name: List[str] = field(default_factory=list)
    matching_method: str = "gml"
    with_compress: bool = True
    refinement_method: str = "projection"
    save_loc_path: Optional[str] = None

    extras: Dict[str, Any] = field(default_factory=dict)

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            lr=self.lr,
            min_lr=self.min_lr,
            decay_rate=self.decay_rate,
            decay_iter=self.decay_iter,
            epochs=self.epochs,
            its_per_epoch=self.its_per_epoch,
            batch_size=self.batch_size,
        )


_LOC_KEY_MAP = {
    # reference 'localization:' key -> LocConfig field
    "seg_k": "seg_k",
    "threshold": "threshold",
    "min_kpts": "min_kpts",
    "min_matches": "min_matches",
    "min_inliers": "min_inliers",
    "semantic_matching": "semantic_matching",
    "do_refinement": "do_refinement",
    "pre_filtering_th": "pre_filtering_th",
    "refinement_nn_ratio": "projection_ratio",
}


def load_config(path: str) -> ExperimentConfig:
    """Parse a reference-format YAML into an ExperimentConfig."""
    return config_from_dict(load_yaml(path))


def config_from_dict(raw: Dict[str, Any]) -> ExperimentConfig:
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kwargs: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}

    loc_raw = raw.pop("localization", {}) or {}
    loc_kwargs = {}
    loc_host = {}
    for k, v in loc_raw.items():
        if k in _LOC_KEY_MAP:
            loc_kwargs[_LOC_KEY_MAP[k]] = v
        elif k in ("loc_scene_name", "matching_method", "with_compress",
                   "refinement_method"):
            loc_host[k] = v
        elif k == "save_path":
            loc_host["save_loc_path"] = v
        else:
            extras[f"localization.{k}"] = v
    kwargs["localization"] = LocConfig(**{
        k: (float(v) if k in ("threshold", "pre_filtering_th",
                              "projection_ratio") else v)
        for k, v in loc_kwargs.items()
    })
    kwargs.update(loc_host)

    for k, v in raw.items():
        if k == "jitter_params" and isinstance(v, dict):
            kwargs[k] = JitterParams(**v)
        elif k in known:
            kwargs[k] = v
        else:
            extras[k] = v
    kwargs["extras"] = extras
    return ExperimentConfig(**kwargs)


@dataclass
class SceneConfig:
    """Per-scene entry of configs/datasets/<Dataset>.yaml."""

    n_cluster: int
    cluster_mode: str = "xz"
    cluster_method: str = "birch"
    training_sample_ratio: int = 1
    eval_sample_ratio: int = 1
    gt_pose_path: Optional[str] = None
    query_path: Optional[str] = None
    image_path_prefix: str = ""
    extras: Dict[str, Any] = field(default_factory=dict)


def load_dataset_config(path: str):
    """Parse a dataset YAML -> (dataset name, {scene: SceneConfig})."""
    raw = load_yaml(path)
    name = raw.pop("dataset")
    scenes = raw.pop("scenes")
    known = {f.name for f in dataclasses.fields(SceneConfig)}
    out = {}
    for scene in scenes:
        sc = raw.get(scene, {}) or {}
        kwargs = {k: v for k, v in sc.items() if k in known}
        kwargs["extras"] = {k: v for k, v in sc.items() if k not in known}
        out[scene] = SceneConfig(**kwargs)
    return name, out
