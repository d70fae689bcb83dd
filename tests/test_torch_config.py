"""The port's config reader (pram_tpu_torch/core/config.py) against yaml and
pram_tpu's config module, on the CPU.

- ``safe_load`` equals ``yaml.safe_load`` on every file under configs/ and on
  scalars of each type YAML 1.1 resolves (int, float with a dot, bool, null,
  quoted and plain strings), and raises naming the line on constructs
  outside its subset (flow style, anchors, block scalars, multi-line
  scalars, tabs, non-decimal numbers);
- ``load_config`` field by field against ``pram_tpu.core.config.load_config``
  on every top config (the ``localization:`` block's quirks included:
  ``refinement_method`` and ``matching_method`` on the host config,
  ``covisibility_frame`` in ``extras``), and ``load_dataset_config`` on every
  dataset config.
"""

import dataclasses
import glob
import os

import pytest
import yaml

from pram_tpu.core import config as jcfg
from pram_tpu_torch.core import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
DATASETS = sorted(glob.glob(os.path.join(ROOT, "configs", "datasets", "*.yaml")))


@pytest.mark.parametrize("path", TOP + DATASETS, ids=os.path.basename)
def test_reader_equals_yaml_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert tcfg.safe_load(text) == yaml.safe_load(text)


SCALARS = [
    "a: 1", "a: -3", "a: +4", "a: 0", "a: 1_000", "a: 0.0001", "a: 1.0e-05", "a: 1e-5",
    "a: .5", "a: 2.", "a: -.inf", "a: true", "a: False", "a: yes", "a: off", "a: null",
    "a: ~", "a:", "a: ''", "a: 'it''s'", 'a: "x y"', "a: 12Scenes", "a: apt1/kitchen",
    "a: images/images_upright", "a: x # a comment", "a: [1] ", "a: b:c",
]


@pytest.mark.parametrize("text", [s for s in SCALARS if "[" not in s])
def test_scalars_resolve_as_yaml(text):
    assert tcfg.safe_load(text) == yaml.safe_load(text)


def test_nested_blocks_and_lists_beside_their_key():
    text = "a:\n  b:\n  - 1\n  - x\n  c:\n    d: 2.5\ne:\n- ''\n- null\nf: 3\n"
    assert tcfg.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: [1, 2]\n", 2),
    ("a: {b: 1}\n", 1),
    ("a: &x 1\nb: *x\n", 1),
    ("a: |\n  text\n", 1),
    ("a: >\n  text\n", 1),
    ("a: b\n  c\n", 2),
    ("a:\n\t- 1\n", 2),
    ("a: 0x10\n", 1),
    ("a: 1:20\n", 1),
    ("- a: 1\n", 1),
    ("---\na: 1\n", 1),
    ('a: "x\\n"\n', 1),
])
def test_constructs_outside_the_subset_raise_naming_the_line(text, line):
    with pytest.raises(tcfg.YAMLSubsetError, match=f"line {line}:"):
        tcfg.safe_load(text)


def _as_dict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


@pytest.mark.parametrize("path", TOP, ids=os.path.basename)
def test_load_config_field_by_field(path):
    ours, theirs = tcfg.load_config(path), jcfg.load_config(path)
    names = [f.name for f in dataclasses.fields(jcfg.ExperimentConfig)]
    assert [f.name for f in dataclasses.fields(tcfg.ExperimentConfig)] == names
    for name in names:
        assert _as_dict(getattr(ours, name)) == _as_dict(getattr(theirs, name)), name
    # the localization block's quirks, copied
    assert ours.extras["localization.covisibility_frame"] == 20
    assert ours.localization.refinement_method == "projection" and ours.refinement_method == "projection"
    assert ours.train_config() == tcfg.TrainConfig(**dataclasses.asdict(theirs.train_config()))


def test_config_from_dict_routes_keys_as_pram_tpu():
    raw = {
        "dataset": ["7Scenes"], "layers": 15, "lr": 0.0001, "unknown_key": 42,
        "jitter_params": {"brightness": 0.1, "contrast": 0.2, "saturation": 0.3, "hue": 0.4, "blur": 0},
        "localization": {
            "seg_k": 7, "threshold": 6, "min_inliers": 24, "matching_method": "adagml",
            "refinement_method": "matching", "save_path": "out", "refinement_nn_ratio": 0.9,
            "covisibility_frame": 10, "weird_loc_key": "x",
        },
    }
    ours, theirs = tcfg.config_from_dict(dict(raw)), jcfg.config_from_dict(dict(raw))
    for f in dataclasses.fields(jcfg.ExperimentConfig):
        assert _as_dict(getattr(ours, f.name)) == _as_dict(getattr(theirs, f.name)), f.name
    assert ours.localization.threshold == 6.0 and isinstance(ours.localization.threshold, float)
    assert ours.localization.projection_ratio == 0.9
    assert ours.save_loc_path == "out" and ours.matching_method == "adagml"


@pytest.mark.parametrize("path", DATASETS, ids=os.path.basename)
def test_load_dataset_config(path):
    name, scenes = tcfg.load_dataset_config(path)
    jname, jscenes = jcfg.load_dataset_config(path)
    assert name == jname and list(scenes) == list(jscenes)
    for scene in scenes:
        assert dataclasses.asdict(scenes[scene]) == dataclasses.asdict(jscenes[scene])
