"""Model registry: construction by config name (pram_tpu/models/registry.py).

The reference's plugin loader (localization/base_model.py:9-44,
nets/load_segnet.py) selects models by string name from a config: the
recognizers SegNetViT and SegNet, the matchers GML, AdaGML and GM, and the
extractors SFD2 (``sfd2`` / ``resnet4x``) and SuperPoint.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def build_recognizer(name: str, config: Optional[Dict[str, Any]] = None):
    """Build a recognition head module by name ('segnetvit' | 'segnet')."""
    config = config or {}
    name = name.lower()
    if name == "segnetvit":
        from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig

        return SegNetViT(SegNetViTConfig(**config))
    if name == "segnet":
        from pram_tpu_torch.models.segnet import SegNet, SegNetConfig

        return SegNet(SegNetConfig(**config))
    raise ValueError(f"unknown recognizer: {name}")


def build_matcher(name: str, config: Optional[Dict[str, Any]] = None):
    """Build a matcher module by name ('gml' | 'adagml' | 'gm')."""
    config = config or {}
    name = name.lower()
    if name == "gml":
        from pram_tpu_torch.models.gml import GML, GMLConfig

        return GML(GMLConfig(**config))
    if name == "adagml":
        from pram_tpu_torch.models.adagml import AdaGML, AdaGMLConfig

        return AdaGML(AdaGMLConfig(**config))
    if name == "gm":
        from pram_tpu_torch.models.gm import GM, GMConfig

        return GM(GMConfig(**config))
    raise ValueError(f"unknown matcher: {name}")


def build_extractor(name: str, config: Optional[Dict[str, Any]] = None):
    """Build a feature extractor module by name ('sfd2' | 'superpoint')."""
    config = config or {}
    name = name.lower()
    if name in ("sfd2", "resnet4x"):
        from pram_tpu_torch.models.sfd2 import ResNet4x

        return ResNet4x(**config)
    if name == "superpoint":
        from pram_tpu_torch.models.superpoint import SuperPoint

        return SuperPoint(**config)
    raise ValueError(f"unknown extractor: {name}")
