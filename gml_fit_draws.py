"""Fit the synthetic GML on the card from several initial draws and print,
for each, how far the fit went and the validation's recall.

    python3 gml_fit_draws.py

Each run is ``cli.train_synthetic_gml.main`` as a user calls it (600 Adam
steps of batch 8 at 2e-4, bf16 over f32 masters, the validation on 32
queries), with the generator of GML's flax-like init seeded with 0 (the
package's own draw), 1, 2 and 3; then two more runs from seed 0: one
whose Fourier encoding ``Wr`` is redrawn at ``lecun_normal``'s scale
(stddev 1 / sqrt(2)) in place of flax's ``normal(1)``, and one whose
training steps take the plain path in f32 (the validation in bf16
through the kernels, as always). One JSON line a run: the mean loss over
the first and the last 50 steps, their ratio, steps/s and the
validation's figures, with the card's name and power limit. About 7
minutes on an H100.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import torch


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def run(seed: int, wr_lecun: bool = False, plain_f32: bool = False) -> dict:
    from pram_tpu_torch.cli import train_synthetic_gml as cli
    from pram_tpu_torch.models import common, gml
    from pram_tpu_torch.train import matcher

    make_step = matcher.make_matcher_train_step
    flax_init = gml.flax_init_

    def init(module, _generator):
        flax_init(module, torch.Generator().manual_seed(seed))
        if wr_lecun:
            common.lecun_normal_(module.poseenc.Wr.weight, torch.Generator().manual_seed(seed))
        return module

    def step(model, lr, compute_dtype):
        return make_step(model, lr, None if plain_f32 else compute_dtype)

    def mark(stage, **state):
        if plain_f32 and stage in ("pool", "train"):
            state["model"].use_kernels = stage == "train"

    gml.flax_init_, matcher.make_matcher_train_step = init, step
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = cli.main(["--out", f"{tmp}/gml.pt"], mark=mark)
    finally:
        gml.flax_init_, matcher.make_matcher_train_step = flax_init, make_step
    losses = res["losses"]
    first, last = sum(losses[:50]) / len(losses[:50]), sum(losses[-50:]) / len(losses[-50:])
    return dict(seed=seed, wr_lecun=wr_lecun, plain_f32=plain_f32, loss_first50=first, loss_last50=last,
                last_over_first=last / first, steps_per_s=res["steps_per_s"], **res["validation"], card=card())


def main() -> int:
    if not torch.cuda.is_available():
        print("gml_fit_draws: no CUDA device", file=sys.stderr)
        return 1
    runs = [dict(seed=s) for s in (0, 1, 2, 3)] + [dict(seed=0, wr_lecun=True), dict(seed=0, plain_f32=True)]
    for r in runs:
        print(json.dumps(run(**r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
