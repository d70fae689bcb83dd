"""Pair-list feature matching CLI: features h5 + pairs -> matches h5
(pram_tpu/cli/match_features.py), and the matcher configs the other CLIs
share.

``build_match_fn`` returns the engine's match function, a closure that gives
``matches0``, the form the localizer and the tracker take. (The JAX
package's closure gives ``(matches0, matching_scores0)``, which its
localizer cannot take: ROADMAP §3.) ``match_from_paths`` matches a pair list
in padded batches through the score-returning closures
(``engine/matching.py:with_scores`` / ``nn_with_scores``, as the JAX loop
unpacks them) and stores ``matches0`` / ``matching_scores0`` under hloc's
nested pair names, through the port's own HDF5 reader and writer
(``io/h5.py``).

Usage:
  python -m pram_tpu_torch.cli.match_features --pairs pairs.txt \
      --features feats.h5 --export_fn matches.h5 --conf gml [--weight_path W] \
      [--batch_size 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pram_tpu_torch.maps.parsers import names_to_pair

CONFS = {
    "gml": {"output": "gml", "model": {"name": "gml", "sinkhorn_iterations": 20}},
    "adagml": {
        "output": "adagml",
        "model": {"name": "adagml", "sinkhorn_iterations": 20},
    },
    "gm": {"output": "gm", "model": {"name": "gm", "sinkhorn_iterations": 20}},
    "NNM": {
        "output": "NNM",
        "model": {"name": "nearest_neighbor", "do_mutual_check": True},
    },
}


def model_dtype(device) -> torch.dtype:
    """The CLIs' model type: bf16 on the card, the type its attention and
    refinement kernels take (as bench.py casts the JAX models for the TPU
    kernels), f32 on the CPU, the JAX CLIs' type."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def load_matcher(name: str, weight_path: Optional[str], device="cuda"):
    """GML / AdaGML / GM on ``device`` in :func:`model_dtype`: from a
    reference torch checkpoint (converted by ``models/convert.py``; GM has
    none, and raises), the repo's flax ``.msgpack``, or, without a path,
    the seeded init."""
    from pram_tpu_torch.models import convert
    from pram_tpu_torch.models.registry import build_matcher

    dtype = model_dtype(device)
    if weight_path and weight_path.endswith(".msgpack"):
        load = {"gml": convert.load_gml, "adagml": convert.load_adagml, "gm": convert.load_gm}[name]
        return load(weight_path, device=device, dtype=dtype)
    if weight_path and name == "gm":
        # the JAX CLI drops the path for GM (ROADMAP 3)
        raise ValueError(
            f"GM weights {weight_path!r}: a reference GM checkpoint has no converter in either "
            "package (the reference cannot build GM); give a flax .msgpack"
        )
    torch.manual_seed(0)
    model = build_matcher(name)
    if weight_path:
        sd = convert.load_torch_state_dict(weight_path)
        if name == "gml":
            state = convert.gml_state_dict(convert.convert_gml(sd)["params"], model.config.n_layers)
        else:
            state = convert.adagml_state_dict(convert.convert_adagml(sd)["params"], model.config.n_layers)
        model.load_state_dict(state, strict=True)
    return model.to(device, dtype).eval()


def build_scored_match_fn(conf_name: str, weight_path: Optional[str] = None, device="cuda"):
    """The matcher of a config, as the JAX CLI builds it: fn(...) ->
    ``(matches0, matching_scores0)``.

    ``weight_path``: a reference torch checkpoint, or the repo's flax
    ``.msgpack`` (the format the repo ships its weights in); GM
    (``GMConfig()``, with the keypoint scores) takes only the latter. A
    model matcher takes the descriptors in its own type
    (:func:`model_dtype`), whatever type the caller gives them in."""
    from pram_tpu_torch.engine.matching import nn_with_scores, with_scores

    name = CONFS[conf_name]["model"]["name"]
    if name == "nearest_neighbor":
        return torch.no_grad()(nn_with_scores())
    if name not in ("gml", "adagml", "gm"):
        raise ValueError(f"unknown matcher {conf_name}")
    fn = with_scores(load_matcher(name, weight_path, device), uses_scores=name == "gm")
    dtype = model_dtype(device)

    @torch.no_grad()
    def match(d0, nk0, s0, m0, d1, nk1, s1, m1):
        return fn(d0.to(dtype), nk0, s0, m0, d1.to(dtype), nk1, s1, m1)

    return match


def build_match_fn(conf_name: str, weight_path: Optional[str] = None, device="cuda"):
    """The engine's match_fn for a matcher config: :func:`build_scored_match_fn`'s
    matcher giving ``matches0`` alone."""
    fn = build_scored_match_fn(conf_name, weight_path, device)
    return lambda *args: fn(*args)[0]


def read_pairs(path: str) -> List[Tuple[str, str]]:
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                a, b = line.split(" ")
                pairs.append((a, b))
    return pairs


def match_from_paths(
    pairs: List[Tuple[str, str]],
    features_path: str,
    export_fn: str,
    conf_name: str = "gml",
    weight_path: Optional[str] = None,
    batch_size: int = 8,
    pad_to: int = 4096,
    device="cuda",
):
    """Match every pair not yet in ``export_fn`` on ``device``, in batches of
    ``batch_size`` padded to ``pad_to`` keypoints a side, and append them
    as hloc's ``names_to_pair(a, b)`` groups holding ``matches0`` (i32) and
    ``matching_scores0`` (f32), cut to the first image's keypoint count."""
    from pram_tpu_torch.engine.localizer import normalize_kpts_like_reference
    from pram_tpu_torch.io import h5

    match_fn = build_scored_match_fn(conf_name, weight_path, device)
    feats = h5.File(features_path, "r")
    cache: Dict[str, Dict[str, np.ndarray]] = {}

    def get(name):
        if name not in cache:
            g = feats[name]
            cache[name] = {
                "keypoints": g["keypoints"][()].astype(np.float32),
                "scores": g["scores"][()].astype(np.float32).reshape(-1),
                "descriptors": g["descriptors"][()].T.astype(np.float32),
                "image_size": g["image_size"][()]
                if "image_size" in g
                else np.array([640, 480]),
            }
        return cache[name]

    def normalized(kpts, size):
        w, h = (torch.tensor(float(v)) for v in size[:2])
        return normalize_kpts_like_reference(torch.from_numpy(np.ascontiguousarray(kpts)), w, h).numpy()

    # skip already-done pairs (match_features_batch.py behavior)
    done = set()
    if osp.exists(export_fn):
        with h5.File(export_fn, "r") as f:
            done = {p for p in (names_to_pair(*pr) for pr in pairs) if p in f}
    todo = [p for p in pairs if names_to_pair(*p) not in done]

    with h5.File(export_fn, "a") as out:
        for start in range(0, len(todo), batch_size):
            chunk = todo[start : start + batch_size]
            b = len(chunk)
            dim = get(chunk[0][0])["descriptors"].shape[1]
            d0 = np.zeros((b, pad_to, dim), np.float32)
            d1 = np.zeros((b, pad_to, dim), np.float32)
            k0 = np.zeros((b, pad_to, 2), np.float32)
            k1 = np.zeros((b, pad_to, 2), np.float32)
            s0 = np.zeros((b, pad_to), np.float32)
            s1 = np.zeros((b, pad_to), np.float32)
            m0 = np.zeros((b, pad_to), bool)
            m1 = np.zeros((b, pad_to), bool)
            n0s = []
            for i, (a, c) in enumerate(chunk):
                fa, fc = get(a), get(c)
                na = min(len(fa["keypoints"]), pad_to)
                nc = min(len(fc["keypoints"]), pad_to)
                n0s.append(na)
                d0[i, :na] = fa["descriptors"][:na]
                d1[i, :nc] = fc["descriptors"][:nc]
                k0[i, :na] = normalized(fa["keypoints"][:na, :2], fa["image_size"])
                k1[i, :nc] = normalized(fc["keypoints"][:nc, :2], fc["image_size"])
                s0[i, :na] = fa["scores"][:na]
                s1[i, :nc] = fc["scores"][:nc]
                m0[i, :na] = True
                m1[i, :nc] = True

            dev = lambda x: torch.from_numpy(x).to(device)
            matches, mscores = match_fn(dev(d0), dev(k0), dev(s0), dev(m0), dev(d1), dev(k1), dev(s1), dev(m1))
            matches = matches.cpu().numpy()
            mscores = mscores.float().cpu().numpy()
            for i, (a, c) in enumerate(chunk):
                pair = names_to_pair(a, c)  # nested h5 group (hloc layout)
                g = out.create_group(pair)
                na = n0s[i]
                g.create_dataset("matches0", data=matches[i, :na].astype(np.int32))
                g.create_dataset(
                    "matching_scores0", data=mscores[i, :na].astype(np.float32)
                )
    feats.close()
    return export_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", required=True)
    ap.add_argument("--features", required=True)
    ap.add_argument("--export_fn", required=True)
    ap.add_argument("--conf", default="gml", choices=list(CONFS))
    ap.add_argument("--weight_path", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    return match_from_paths(
        read_pairs(args.pairs),
        args.features,
        args.export_fn,
        args.conf,
        args.weight_path,
        args.batch_size,
        device=args.device,
    )


if __name__ == "__main__":
    main()
