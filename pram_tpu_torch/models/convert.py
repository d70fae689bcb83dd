"""Flax parameter trees -> the port's state dicts, and reference torch
checkpoints -> flax parameter trees (pram_tpu/models/convert.py).

A flax ``Dense`` kernel ``[in, out]`` becomes a torch ``Linear.weight``
``[out, in]``; a ``Conv`` kernel ``[kh, kw, in / groups, out]`` a
``Conv2d.weight`` ``[out, in / groups, kh, kw]``; a norm's ``scale`` becomes
``weight``, a BatchNorm's ``mean`` and ``var`` (from ``batch_stats``)
``running_mean`` and ``running_var``; biases keep their name. The flax
layout is the contract: the qkv columns stay in their ``(head, head_dim, 3)``
order.

The reference's own checkpoints (``state_dict`` layouts of the PRAM torch
code) map onto the same flax trees through :func:`convert_sfd2`,
:func:`convert_superpoint`, :func:`convert_segnetvit`, :func:`convert_segnet`,
:func:`convert_gml`, :func:`convert_adagml` and
:func:`convert_descriptor_compressor`, numpy copies of the JAX package's
converters; their output goes through the ``*_state_dict`` functions below
like a tree read from msgpack. GM and RetNet have no reference converter in
either package (the reference's GM cannot be built, and RetNet is unused):
their flax trees come from the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pram_tpu_torch.io.flax_msgpack import read_flax_msgpack
from pram_tpu_torch.models.adagml import AdaGML, AdaGMLConfig
from pram_tpu_torch.models.gm import GM, GMConfig
from pram_tpu_torch.models.gml import GML, GMLConfig
from pram_tpu_torch.models.segnet import SegNet, SegNetConfig
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
    ``cross_attn.<i>``; the checkpoint's last output projection becomes
    ``out_proj``: a flax checkpoint holds only that one (flax creates no
    parameters for the unused ones), a converted reference checkpoint
    (:func:`convert_gml`) holds one a layer, of which the reference applies
    the last at inference (nets/gml.py:279-280). The scalar ``bin_score`` is
    kept as is.
    """
    params = dict(params)
    if "bin_score" not in params:
        raise ValueError("GML params have no bin_score")
    bin_score = np.asarray(params.pop("bin_score"), np.float32).reshape(())
    out_projs = sorted((k for k in params if k.startswith("out_proj_")), key=lambda k: int(k[9:]))
    if not out_projs:
        raise ValueError("GML params have no out_proj_<k>")
    params["out_proj"] = params.pop(out_projs[-1])
    for k in out_projs[:-1]:
        del params[k]
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


def _with_batch_stats(tree: dict) -> Dict[str, torch.Tensor]:
    """``params`` and, where the tree has them, ``batch_stats`` flattened
    into one state dict, a zero ``num_batches_tracked`` beside every
    BatchNorm's running statistics (unused in inference)."""
    sd = flax_to_state_dict(tree["params"])
    sd.update(flax_to_state_dict(tree.get("batch_stats", {})))
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def _layers_below(sd: Dict[str, torch.Tensor], prefix: str, n: int, what: str) -> Dict[str, torch.Tensor]:
    """``sd`` without the ``<prefix>.<i>.`` entries of i >= n; raises when it
    holds fewer than n such layers."""
    have = len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})
    if have < n:
        raise ValueError(f"{what} params have {have} {prefix} layers, config wants {n}")
    return {k: v for k, v in sd.items() if not k.startswith(prefix + ".") or int(k.split(".")[1]) < n}


def superpoint_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """SuperPoint flax params (``conv1a`` .. ``convDb``) -> SuperPoint state
    dict."""
    return flax_to_state_dict(params)


def segnet_state_dict(tree: dict, n_layers: int) -> Dict[str, torch.Tensor]:
    """SegNet flax variables (``params``, and ``batch_stats`` with
    ``norm_fn="bn"``) -> SegNet state dict for the first ``n_layers``
    layers: ``gnn_<i>`` becomes ``gnn.<i>``."""
    tree = tree if "params" in tree else {"params": tree}
    sd = {re.sub(r"^gnn_(\d+)\.", r"gnn.\1.", k): v for k, v in _with_batch_stats(tree).items()}
    return _layers_below(sd, "gnn", n_layers, "SegNet")


def gm_state_dict(params: dict, n_layers: int) -> Dict[str, torch.Tensor]:
    """GM flax params -> GM state dict for its first ``n_layers`` layer
    pairs (``gnn_<i>`` for i < 2 n_layers become ``gnn.<i>``). The last
    ``final_proj_<k>`` of the tree, the one applied, becomes
    ``final_proj.<n_layers - 1>``; a flax tree holds only that one, and the
    others of a tree that holds them are dropped, as the module gives them
    no parameters. The scalar ``bin_score`` is kept as is."""
    params = dict(params)
    if "bin_score" not in params:
        raise ValueError("GM params have no bin_score")
    bin_score = np.asarray(params.pop("bin_score"), np.float32).reshape(())
    projs = sorted((k for k in params if k.startswith("final_proj_")), key=lambda k: int(k[11:]))
    if not projs:
        raise ValueError("GM params have no final_proj_<k>")
    last = params.pop(projs[-1])
    for k in projs[:-1]:
        del params[k]
    params[f"final_proj_{n_layers - 1}"] = last
    sd = {re.sub(r"^(gnn|final_proj)_(\d+)\.", r"\1.\2.", k): v for k, v in flax_to_state_dict(params).items()}
    sd = _layers_below(sd, "gnn", 2 * n_layers, "GM")
    sd["bin_score"] = torch.from_numpy(bin_score.copy())
    return sd


def retnet_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """RetNet flax variables (``params`` and ``batch_stats``) -> RetNet state
    dict; ``gem_p`` is kept as is."""
    params = dict(tree["params"])
    gem_p = np.asarray(params.pop("gem_p"), np.float32).reshape(1)
    sd = _with_batch_stats({"params": params, "batch_stats": tree["batch_stats"]})
    sd["gem_p"] = torch.from_numpy(gem_p.copy())
    return sd


def compressor_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """DescriptorCompressor flax params (``conv``) -> its state dict."""
    return flax_to_state_dict(params)


def load_segnet(path: str, config: SegNetConfig, device="cuda", dtype=torch.float32) -> SegNet:
    """SegNet with weights from a flax msgpack file (random-free)."""
    model = SegNet(config)
    model.load_state_dict(segnet_state_dict(read_flax_msgpack(path), config.n_layers), strict=True)
    return model.to(device=device, dtype=dtype).eval()


def load_gm(path: str, config: Optional[GMConfig] = None, device="cuda", dtype=torch.float32) -> GM:
    """GM with weights from a flax msgpack file (random-free), at ``config``
    (default ``GMConfig()``, the CLI's); in bf16 every parameter is
    rounded, ``bin_score`` included, as for GML."""
    config = config or GMConfig()
    tree = read_flax_msgpack(path)
    model = GM(config)
    model.load_state_dict(gm_state_dict(tree.get("params", tree), config.n_layers), strict=True)
    return model.to(device=device, dtype=dtype).eval()


def sfd2_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """SFD2 flax variables (``params`` and ``batch_stats``) -> ResNet4x state
    dict: ``res_<i>`` becomes ``res.<i>``, and every BatchNorm gets a zero
    ``num_batches_tracked`` (unused in inference)."""
    if "params" not in tree or "batch_stats" not in tree:
        raise ValueError("SFD2 variables need both params and batch_stats")
    return {re.sub(r"^res_(\d+)\.", r"res.\1.", k): v for k, v in _with_batch_stats(tree).items()}


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


# ---- reference torch checkpoints -> flax trees (pram_tpu/models/convert.py:27-270)


def load_torch_state_dict(path: str, key: str = None) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint to numpy on host (CPU torch only).

    The reference stores extractor weights under ``state_dict``
    (nets/sfd2.py:594) and matcher/recognition weights under ``model``
    (localization/matchers/gml.py) or at top level.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and key in ckpt:
        ckpt = ckpt[key]
    elif isinstance(ckpt, dict):
        for k in ("state_dict", "model"):
            if k in ckpt and isinstance(ckpt[k], dict):
                ckpt = ckpt[k]
                break
    out = {}
    for name, tensor in ckpt.items():
        name = name.removeprefix("module.")  # DDP wrapper
        out[name] = tensor.detach().cpu().numpy()
    return out


def _conv(sd, name):
    w = np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0))
    p = {"kernel": w}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _linear(sd, name):
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _bn(sd, name) -> Tuple[dict, dict]:
    params = {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}
    stats = {
        "mean": sd[f"{name}.running_mean"],
        "var": sd[f"{name}.running_var"],
    }
    return params, stats


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def convert_sfd2(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Map the reference ResNet4x state_dict (nets/sfd2.py:127-170) to flax."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    for blk in ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b"):
        p_bn, s_bn = _bn(sd, f"{blk}.1")
        params[blk] = {"conv": _conv(sd, f"{blk}.0"), "bn": p_bn}
        stats[blk] = {"bn": s_bn}

    for i in range(3):
        t = f"conv4.{i}"
        rp, rs = {}, {}
        for j in (1, 2, 3):
            rp[f"conv{j}"] = _conv(sd, f"{t}.conv{j}")
            p_bn, s_bn = _bn(sd, f"{t}.bn{j}")
            rp[f"bn{j}"] = p_bn
            rs[f"bn{j}"] = s_bn
        params[f"res_{i}"] = rp
        stats[f"res_{i}"] = rs

    for head in ("convPa", "convDa"):
        params[f"{head}_0"] = _conv(sd, f"{head}.0")
        p_bn, s_bn = _bn(sd, f"{head}.1")
        params[f"{head}_bn"] = p_bn
        stats[f"{head}_bn"] = s_bn
        params[f"{head}_3"] = _conv(sd, f"{head}.3")
    params["convPb"] = _conv(sd, "convPb")
    params["convDb"] = _conv(sd, "convDb")
    return {"params": params, "batch_stats": stats}


def _self_attn_block(sd, prefix):
    return {
        "qkv": _linear(sd, f"{prefix}.qkv"),
        "proj": _linear(sd, f"{prefix}.proj"),
        "mlp_0": _linear(sd, f"{prefix}.mlp.0"),
        "mlp_ln": _ln(sd, f"{prefix}.mlp.1"),
        "mlp_3": _linear(sd, f"{prefix}.mlp.3"),
    }


def _cross_attn_block(sd, prefix):
    return {
        "to_qk": _linear(sd, f"{prefix}.to_qk"),
        "to_v": _linear(sd, f"{prefix}.to_v"),
        "proj": _linear(sd, f"{prefix}.proj"),
        "mlp_0": _linear(sd, f"{prefix}.mlp.0"),
        "mlp_ln": _ln(sd, f"{prefix}.mlp.1"),
        "mlp_3": _linear(sd, f"{prefix}.mlp.3"),
    }


def convert_segnetvit(sd: Dict[str, np.ndarray], n_layers: int = 15) -> Dict:
    """Map the reference SegNetViT state_dict (nets/segnetvit.py:124-172)."""
    params: Dict[str, Any] = {
        "input_proj": _linear(sd, "input_proj"),
        "kenc": {"Wr": {"kernel": np.ascontiguousarray(sd["kenc.Wr.weight"].T)}},
        "seg_0": _linear(sd, "seg.0"),
        "seg_ln": _ln(sd, "seg.1"),
        "seg_3": _linear(sd, "seg.3"),
    }
    for i in range(n_layers):
        params[f"gnn_{i}"] = _self_attn_block(sd, f"gnn.layers.{i}")
    if "sc.0.weight" in sd:
        params["sc_0"] = _linear(sd, "sc.0")
        params["sc_ln"] = _ln(sd, "sc.1")
        params["sc_3"] = _linear(sd, "sc.3")
    return {"params": params}


def convert_gml(sd: Dict[str, np.ndarray], n_layers: int = 9) -> Dict:
    """Map the reference GML state_dict (nets/gml.py:211-240)."""
    params: Dict[str, Any] = {
        "input_proj": _linear(sd, "input_proj"),
        "poseenc": {
            "Wr": {"kernel": np.ascontiguousarray(sd["poseenc.Wr.weight"].T)}
        },
        "bin_score": sd["bin_score"],
    }
    for i in range(n_layers):
        params[f"self_attn_{i}"] = _self_attn_block(sd, f"self_attn.{i}")
        params[f"cross_attn_{i}"] = _cross_attn_block(sd, f"cross_attn.{i}")
        params[f"out_proj_{i}"] = _linear(sd, f"out_proj.{i}")
    return {"params": params}


def convert_adagml(sd: Dict[str, np.ndarray], n_layers: int = 9) -> Dict:
    """Map the reference AdaGML state_dict (nets/adagml.py:251-288)."""
    out = convert_gml(sd, n_layers)
    for i in range(n_layers):
        p = f"pooling.{i}"
        out["params"][f"pooling_{i}"] = {
            "score_enc_0": _linear(sd, f"{p}.score_enc.0"),
            "score_enc_ln": _ln(sd, f"{p}.score_enc.1"),
            "score_enc_3": _linear(sd, f"{p}.score_enc.3"),
            "proj": _linear(sd, f"{p}.proj"),
            "predict_0": _linear(sd, f"{p}.predict.0"),
            "predict_ln": _ln(sd, f"{p}.predict.1"),
            "predict_3": _linear(sd, f"{p}.predict.3"),
        }
    return out


def convert_superpoint(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Map the reference SuperPoint state_dict (nets/superpoint.py:123-138)."""
    names = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
             "convPa", "convPb", "convDa", "convDb")
    return {"params": {name: _conv(sd, name) for name in names}}


def _conv1d(sd, name):
    """torch Conv1d [O, I, 1] -> Dense kernel [I, O]."""
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"][:, :, 0].T)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _point_mlp(sd, prefix, n_convs):
    """Reference MLP helper (Conv1d + norm + act; nets/layers.py:15-35):
    convs sit at Sequential indices 0, 3, 6, ...; InstanceNorm1d has no
    parameters, BatchNorm1d (norm_fn='bn') contributes affine params and
    running stats at indices 1, 4, ...

    Returns (params, batch_stats); batch_stats is {} for the 'in' case.
    """
    params = {f"lin_{i}": _conv1d(sd, f"{prefix}.{3 * i}") for i in range(n_convs)}
    stats = {}
    for i in range(n_convs - 1):
        bn = f"{prefix}.{3 * i + 1}"
        if f"{bn}.running_mean" in sd:
            params[f"norm_{i}"] = {"scale": sd[f"{bn}.weight"], "bias": sd[f"{bn}.bias"]}
            stats[f"norm_{i}"] = {"mean": sd[f"{bn}.running_mean"], "var": sd[f"{bn}.running_var"]}
    return params, stats


def convert_segnet(sd: Dict[str, np.ndarray], n_layers: int = 9) -> Dict:
    """Map the reference SegNet state_dict (nets/segnet.py:32-84) to flax."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(name, pair):
        p, s = pair
        params[name] = p
        if s:
            stats[name] = s

    # kenc: channels [in]+[32,64,128,256]+[256] -> 5 convs
    put("kenc", _point_mlp(sd, "kenc.encoder", 5))
    put("seg", _point_mlp(sd, "seg", 2))
    for i in range(n_layers):
        p = f"gnn.layers.{i}"
        mlp_p, mlp_s = _point_mlp(sd, f"{p}.mlp", 2)
        params[f"gnn_{i}"] = {
            "proj_q": _conv1d(sd, f"{p}.attn.proj.0"),
            "proj_k": _conv1d(sd, f"{p}.attn.proj.1"),
            "proj_v": _conv1d(sd, f"{p}.attn.proj.2"),
            "merge": _conv1d(sd, f"{p}.attn.merge"),
            "mlp": mlp_p,
        }
        if mlp_s:
            stats[f"gnn_{i}"] = {"mlp": mlp_s}
    if "sc.0.weight" in sd:
        put("sc", _point_mlp(sd, "sc", 2))
    out: Dict[str, Any] = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def convert_descriptor_compressor(sd: Dict[str, np.ndarray]) -> Dict:
    """Map the reference DescriptorCompressor state_dict (nets/sfd2.py:357-365):
    a single 1x1 Conv1d 'conv' with bias."""
    return {"params": {"conv": _conv1d(sd, "conv")}}
