"""Matcher configs and the engine's match functions
(pram_tpu/cli/match_features.py:1-90).

``build_match_fn`` returns the engine's match function, a closure that gives
``matches0``, the form the localizer and the tracker take. (The JAX
package's closure gives ``(matches0, matching_scores0)``, which its
localizer cannot take: ROADMAP §3.) The pair-list h5 matcher
(``match_from_paths``) writes hloc h5 files through h5py, which the port does
not use (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

import torch

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


def _matches(model, threshold: float = 0.2, uses_scores: bool = False):
    """Matcher closure (the module's forward and mutual check, as the JAX
    package's ``with_scores`` applies them): fn(...) -> matches0; with
    ``uses_scores`` the module also takes the keypoint scores (GM)."""
    from pram_tpu_torch.engine.matching import with_scores

    fn = with_scores(model, threshold, uses_scores)
    return torch.no_grad()(lambda *args: fn(*args)[0])


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


def build_match_fn(conf_name: str, weight_path: Optional[str] = None, device="cuda"):
    """Create the engine match_fn for a matcher config; it returns
    ``matches0``.

    ``weight_path``: a reference torch checkpoint, or the repo's flax
    ``.msgpack`` (the format the repo ships its weights in); GM
    (``GMConfig()``, with the keypoint scores) takes only the latter."""
    name = CONFS[conf_name]["model"]["name"]
    if name == "nearest_neighbor":
        from pram_tpu_torch.models.nn_matcher import mutual_nn_match

        def fn(d0, nk0, s0, m0, d1, nk1, s1, m1):
            return mutual_nn_match(d0, d1, m0, m1, None, None).matches0

        return fn
    if name == "gml":
        return _matches(load_matcher("gml", weight_path, device))
    if name == "adagml":
        return _matches(load_matcher("adagml", weight_path, device))
    if name == "gm":
        return _matches(load_matcher("gm", weight_path, device), uses_scores=True)
    raise ValueError(f"unknown matcher {conf_name}")

