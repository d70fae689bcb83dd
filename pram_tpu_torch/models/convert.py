"""Flax parameter trees -> the port's state dicts.

A flax ``Dense`` kernel ``[in, out]`` becomes a torch ``Linear.weight``
``[out, in]``; a ``Conv`` kernel ``[kh, kw, in / groups, out]`` a
``Conv2d.weight`` ``[out, in / groups, kh, kw]``; a norm's ``scale`` becomes
``weight``, a BatchNorm's ``mean`` and ``var`` (from ``batch_stats``)
``running_mean`` and ``running_var``; biases keep their name. The flax
layout is the contract: the qkv columns stay in their ``(head, head_dim, 3)``
order.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
from pram_tpu_torch.models.adagml import AdaGML, AdaGMLConfig
from pram_tpu_torch.models.gml import GML, GMLConfig
from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
from pram_tpu_torch.models.sfd2 import ResNet4x
from pram_tpu_torch.models.sfd2_int8 import Int8ResNet4x, cast_stem, quantize_extractor


def flax_to_state_dict(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into ``torch`` state-dict entries (f32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out.update(flax_to_state_dict(leaf, key + "."))
            continue
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            if arr.ndim == 2:
                out[f"{prefix}weight"] = torch.from_numpy(arr.T.copy())
            elif arr.ndim == 4:
                out[f"{prefix}weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
            else:
                raise ValueError(f"{key}: only Dense and 2-D Conv kernels are converted, got {arr.shape}")
        elif name == "scale":
            out[f"{prefix}weight"] = torch.from_numpy(arr.copy())
        elif name in ("mean", "var"):
            out[f"{prefix}running_{name}"] = torch.from_numpy(arr.copy())
        elif name == "bias":
            out[key] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"unexpected flax leaf {key}")
    return out


def segnetvit_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """SegNetViT flax params (``gnn_<i>`` blocks) -> SegNetViT state dict."""
    sd = flax_to_state_dict(params)
    return {re.sub(r"^gnn_(\d+)\.", r"gnn.\1.", k): v for k, v in sd.items()}


def load_segnetvit(
    path: str, config: SegNetViTConfig, device="cuda", dtype=torch.float32
) -> SegNetViT:
    """SegNetViT with weights from a flax msgpack file (random-free)."""
    tree = read_flax_msgpack(path)
    params = tree.get("params", tree)
    sd = segnetvit_state_dict(params)
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("gnn.")})
    if n_layers < config.n_layers:
        raise ValueError(f"{path} has {n_layers} layers, config wants {config.n_layers}")
    sd = {
        k: v for k, v in sd.items()
        if not k.startswith("gnn.") or int(k.split(".")[1]) < config.n_layers
    }
    model = SegNetViT(config)
    model.load_state_dict(sd, strict=True)
    return model.to(device=device, dtype=dtype).eval()


def gml_state_dict(params: dict, n_layers: int) -> Dict[str, torch.Tensor]:
    """GML flax params -> GML state dict for its first ``n_layers`` layers.

    ``self_attn_<i>`` / ``cross_attn_<i>`` become ``self_attn.<i>`` /
    ``cross_attn.<i>``; the checkpoint's one output projection
    (``out_proj_<k>``: flax creates no parameters for the unused ones)
    becomes ``out_proj``; the scalar ``bin_score`` is kept as is.
    """
    params = dict(params)
    if "bin_score" not in params:
        raise ValueError("GML params have no bin_score")
    bin_score = np.asarray(params.pop("bin_score"), np.float32).reshape(())
    out_projs = sorted(k for k in params if k.startswith("out_proj_"))
    if len(out_projs) != 1:
        raise ValueError(f"expected one out_proj_<k> in the GML params, got {out_projs}")
    params["out_proj"] = params.pop(out_projs[0])
    sd = {
        re.sub(r"^(self_attn|cross_attn)_(\d+)\.", r"\1.\2.", k): v
        for k, v in flax_to_state_dict(params).items()
    }
    have = len({k.split(".")[1] for k in sd if k.startswith("self_attn.")})
    if have < n_layers:
        raise ValueError(f"GML params have {have} layers, config wants {n_layers}")
    sd = {
        k: v for k, v in sd.items()
        if not k.startswith(("self_attn.", "cross_attn.")) or int(k.split(".")[1]) < n_layers
    }
    sd["bin_score"] = torch.from_numpy(bin_score.copy())
    return sd


def load_gml(
    path: str, config: GMLConfig = GMLConfig(), device="cuda", dtype=torch.float32
) -> GML:
    """GML with weights from a flax msgpack file (random-free).

    With ``config.n_layers`` below the checkpoint's, the first layers are
    kept and the checkpoint's output projection follows them. In bf16 every
    parameter is rounded to bf16, ``bin_score`` and the Fourier encoding's
    ``Wr`` included, as ``bench.py:cast_tree`` casts every f32 leaf; the
    encoding then runs in f32 on the rounded ``Wr`` (flax promotes the bf16
    kernel to the f32 keypoints) and Sinkhorn in f32 on the rounded score.
    """
    tree = read_flax_msgpack(path)
    sd = gml_state_dict(tree.get("params", tree), config.n_layers)
    model = GML(config)
    model.load_state_dict(sd, strict=True)
    return model.to(device=device, dtype=dtype).eval()


def adagml_state_dict(params: dict, n_layers: int) -> Dict[str, torch.Tensor]:
    """AdaGML flax params -> AdaGML state dict for its first ``n_layers`` layers.

    ``self_attn_<i>``, ``cross_attn_<i>``, ``pooling_<i>`` and ``out_proj_<i>``
    become ``self_attn.<i>`` and so on; the scalar ``bin_score`` is kept as
    is. The qkv columns keep their ``(head, head_dim, 3)`` order, which
    ``ops/attention_qkv.py:permute_qkv_kernel`` reorders at the call.
    """
    params = dict(params)
    if "bin_score" not in params:
        raise ValueError("AdaGML params have no bin_score")
    bin_score = np.asarray(params.pop("bin_score"), np.float32).reshape(())
    layered = ("self_attn", "cross_attn", "pooling", "out_proj")
    pattern = r"^(%s)_(\d+)\." % "|".join(layered)
    sd = {re.sub(pattern, r"\1.\2.", k): v for k, v in flax_to_state_dict(params).items()}
    have = len({k.split(".")[1] for k in sd if k.startswith("self_attn.")})
    if have < n_layers:
        raise ValueError(f"AdaGML params have {have} layers, config wants {n_layers}")
    sd = {
        k: v for k, v in sd.items()
        if k.split(".")[0] not in layered or int(k.split(".")[1]) < n_layers
    }
    sd["bin_score"] = torch.from_numpy(bin_score.copy())
    return sd


def load_adagml(
    path: str, config: AdaGMLConfig = AdaGMLConfig(), device="cuda", dtype=torch.float32
) -> AdaGML:
    """AdaGML with weights from a flax msgpack file (random-free).

    With ``config.n_layers`` below the checkpoint's, the first layers are
    kept. In bf16 every parameter is rounded to bf16, ``bin_score`` and the
    Fourier encoding's ``Wr`` included, as ``bench.py:cast_tree`` casts every
    f32 leaf; the encoding, the pooling heads' f32 parts and Sinkhorn then
    compute in f32 from the rounded values, as flax promotes them.
    """
    tree = read_flax_msgpack(path)
    sd = adagml_state_dict(tree.get("params", tree), config.n_layers)
    model = AdaGML(config)
    model.load_state_dict(sd, strict=True)
    return model.to(device=device, dtype=dtype).eval()


def sfd2_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """SFD2 flax variables (``params`` and ``batch_stats``) -> ResNet4x state
    dict: ``res_<i>`` becomes ``res.<i>``, and every BatchNorm gets a zero
    ``num_batches_tracked`` (unused in inference)."""
    if "params" not in tree or "batch_stats" not in tree:
        raise ValueError("SFD2 variables need both params and batch_stats")
    sd = flax_to_state_dict(tree["params"])
    sd.update(flax_to_state_dict(tree["batch_stats"]))
    sd = {re.sub(r"^res_(\d+)\.", r"res.\1.", k): v for k, v in sd.items()}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def load_sfd2(path: str, device="cuda", dtype=torch.float32) -> ResNet4x:
    """ResNet4x with weights and BN statistics from a flax msgpack file, in
    channels_last memory. In bf16 every parameter and statistic is rounded
    to bf16 first, as ``bench.py:cast_tree`` rounds every f32 leaf; BN and
    the stem's BN folding then compute from the rounded values."""
    model = ResNet4x()
    model.load_state_dict(sfd2_state_dict(read_flax_msgpack(path)), strict=True)
    model = model.to(device=device, dtype=dtype).to(memory_format=torch.channels_last)
    return model.eval()


def int8_extractor_state(qparams: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 SFD2 qparams (``{"int8": {...}}`` of
    ``pram_tpu/models/sfd2_int8.py:quantize_extractor``, as numpy arrays) ->
    the state of :class:`Int8ResNet4x`, the same scales and integers, not
    recalibrated: the stem's HWIO kernels become ``[O, I, 3, 3]`` and its BN
    tuples four tensors; a residual block's list of dense conv2 splits is
    stacked."""
    qp = qparams.get("int8", qparams)
    state: Dict[str, torch.Tensor] = {}
    for name, value in qp.items():
        if name.endswith("_bn"):
            for p, v in zip(("scale", "bias", "mean", "var"), value):
                state[f"{name}_{p}"] = torch.from_numpy(np.array(v, np.float32))
        elif isinstance(value, (list, tuple)):
            state[name] = torch.from_numpy(np.stack([np.asarray(v) for v in value]))
        elif name in ("conv1a_kernel", "conv1b_kernel"):
            state[name] = torch.from_numpy(np.array(value, np.float32).transpose(3, 2, 0, 1).copy())
        else:
            arr = np.asarray(value)
            arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
            state[name] = torch.from_numpy(arr.copy())
    return state


def load_sfd2_int8(
    path: str, calib_images: torch.Tensor, device="cuda", dtype=torch.float32,
    conv_kernel: bool = False,
) -> Int8ResNet4x:
    """The int8 extractor of the SFD2 weights in ``path``: the float model
    in ``dtype`` (every parameter and statistic rounded to it), quantized
    and calibrated from those values in f32 on ``calib_images [B, H, W, 3]``
    (preprocessed), then its stem cast to ``dtype``
    (``pram_tpu/engine/rendered_guard.py``'s int8 extractor)."""
    model = load_sfd2(path, device=device, dtype=dtype)
    return cast_stem(quantize_extractor(model, calib_images, conv_kernel), dtype).eval()
