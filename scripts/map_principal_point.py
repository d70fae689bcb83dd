"""chip_smoke.py's phase 30 (map building) twice on the card: the COLMAP
camera's principal point at the renderer's (W/2, H/2), then at
(W/2 + 0.5, H/2 + 0.5) as the phase builds it.

    python3 scripts/map_principal_point.py

The renderer puts pixel centres at whole coordinates and triangulation adds
COLMAP's 0.5 to every keypoint, so only the second camera agrees with the
rendered images; the script reads what the half pixel does to the
triangulated points (their distance to the rendered surface, by track length,
ground-truth confirmation and triangulation angle) and to the built map's
localization. TF32 is on for matmuls throughout: KMeans's and best_of's
products must hold it off themselves, so the card's builds must still equal
the CPU's. Prints one JSON object a side. Needs a card.
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pram_tpu_torch import _build  # noqa: E402
from pram_tpu_torch.maps import colmap_io  # noqa: E402
from pram_tpu_torch.ops import (  # noqa: E402
    attention,
    attention_bwd,
    attention_qkv,
    conv_int8,
    convpair,
    cross_attention,
    mlp,
    mlp_bwd,
    nms,
    pnp,
    refine,
    sinkhorn,
    stem,
)

COUNTERS = (attention.LAUNCHES, mlp.LAUNCHES, pnp.LAUNCHES, cross_attention.LAUNCHES, sinkhorn.LAUNCHES,
            refine.LAUNCHES, stem.LAUNCHES, nms.LAUNCHES, attention_qkv.LAUNCHES, attention_bwd.LAUNCHES,
            mlp_bwd.LAUNCHES, conv_int8.LAUNCHES, convpair.LAUNCHES)
PATH = ("self_attention", "residual_mlp", "ransac_score", "gn_polish", "cross_attention", "sinkhorn", "refine_nn",
        "fused_stem", "nms")
CAMERA = colmap_io.ColmapCamera


def reset():
    for c in COUNTERS:
        for k in c:
            c[k] = 0


def read():
    return {k: v for c in COUNTERS for k, v in c.items()}


def renderer_centre_camera(cid, model, width, height, params):
    """The phase's one camera with its principal point 0.5 px back, at the
    renderer's; the cameras read back from the model are built as written."""
    colmap_io.ColmapCamera = CAMERA
    p = np.asarray(params, np.float64).copy()
    assert model == "PINHOLE" and width == cs.MAP_W
    p[2:4] -= 0.5
    return CAMERA(cid, model, width, height, p)


def main():
    if not torch.cuda.is_available():
        print("map_principal_point: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = True
    dev = torch.device("cuda", 0)
    cs.log(f"card: {cs.nvidia_smi()}; torch {torch.__version__} cuda {torch.version.cuda}; matmul TF32 on")
    _build.library()
    for side, camera in (("W/2", renderer_centre_camera), ("W/2 + 0.5", CAMERA)):
        colmap_io.ColmapCamera = camera
        t = time.perf_counter()
        out = cs.run_mapping_phase(torch, np, dev, torch.bfloat16, reset, read, PATH)
        colmap_io.ColmapCamera = CAMERA
        print(json.dumps(dict(
            principal_point=side, seconds=time.perf_counter() - t, triangulation=out["triangulation"],
            localization={k: v for k, v in out["localization"].items() if k != "launches"},
            card_vs_cpu=out["card_vs_cpu"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
