"""The int8 SFD2 extractor against the float one at the Aachen operating
point (1024 x 768 views, 4096 keypoints), in pram_tpu and in the port, on
the CPU in f32, and print one JSON object.

    JAX_PLATFORMS=cpu python3 tests/aachen_int8_agreement.py [--views 2]

The views are ``chip_smoke.py:aachen_views``' (the rendered world at
focal 500, the principal point at the centre): the int8 extractors are
calibrated on its 2 calibration views (seed 99) and both extractors run
on the first ``--views`` of its 8 queries (seed 11), as phase 25 of
``chip_smoke.py`` does on the card in bf16, with
``weights/sfd2_rendered.msgpack``. For each package the descriptor
cosines of int8 against float on the keypoints both extractors found
(``chip_smoke.py:common_cosines``): their count, minimum, mean, the share
below 0.99 and quantiles, so the card's distribution can be read against
the JAX package's own. About 4 minutes and 6 GB a view on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from chip_smoke import AACHEN_H, AACHEN_KPTS, AACHEN_W, INT8_FLOAT_COS, aachen_views, common_cosines
from pram_tpu.models.sfd2 import ResNet4x as JaxResNet4x
from pram_tpu.models.sfd2 import extract as jax_extract
from pram_tpu.models.sfd2 import preprocess_image as jax_preprocess
from pram_tpu.models.sfd2_int8 import quantize_extractor as jax_quantize_extractor
from pram_tpu_torch.engine.rendered_guard import SFD2_W
from pram_tpu_torch.models.convert import load_sfd2
from pram_tpu_torch.models.sfd2 import extract, preprocess_image
from pram_tpu_torch.models.sfd2_int8 import quantize_extractor
from pram_tpu_torch.ops import keypoints as tkp


def spread(cos: np.ndarray) -> dict:
    return dict(common=int(cos.size), min=float(cos.min()), mean=float(cos.mean()),
                below=float((cos < INT8_FLOAT_COS).mean()),
                quantiles_001_01_05=[float(v) for v in np.quantile(cos, [0.001, 0.01, 0.5])])


def jax_feats(out) -> dict:
    k = out["keypoints"]
    return {"keypoints": tkp.Keypoints(*(torch.from_numpy(np.array(a)) for a in (k.xy, k.scores, k.mask))),
            "descriptors": torch.from_numpy(np.array(out["descriptors"]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=2, help="queries extracted, one at a time (default 2)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    calib, _ = aachen_views(np, 2, 99)
    views = aachen_views(np, 8, 11)[0][: args.views]
    kw = dict(max_keypoints=AACHEN_KPTS, conf_th=1e-4)

    jm = JaxResNet4x()
    tmpl = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, AACHEN_H, AACHEN_W, 3), jnp.float32))
    with open(SFD2_W, "rb") as f:
        variables = serialization.from_bytes(tmpl, f.read())
    jq_model, qparams = jax_quantize_extractor(jm, variables, jax_preprocess(jnp.asarray(calib)))
    model = load_sfd2(SFD2_W, device="cpu")
    tq_model = quantize_extractor(model, preprocess_image(torch.from_numpy(calib)))

    cos = {"pram_tpu": [], "port": []}
    for v in views:
        x = v[None]
        jf = jax_feats(jax_extract(jm, variables, jax_preprocess(jnp.asarray(x)), **kw))
        jq = jax_feats(jax_extract(jq_model, qparams, jax_preprocess(jnp.asarray(x)), **kw))
        cos["pram_tpu"].append(common_cosines(jq, jf))
        with torch.no_grad():
            tx = preprocess_image(torch.from_numpy(x))
            cos["port"].append(common_cosines(extract(tq_model, tx, **kw), extract(model, tx, **kw)))
    print(json.dumps({
        "views": args.views, "size": [AACHEN_W, AACHEN_H], "max_keypoints": AACHEN_KPTS, "dtype": "float32",
        **{name: spread(np.concatenate(c)) for name, c in cos.items()},
        "seconds": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()
