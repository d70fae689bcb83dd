"""Time kernel 6 (``pram_tpu_torch/ops/sinkhorn.py:sinkhorn``) on the card
at given problem shapes and print one JSON line a shape: the instance the
card takes there (``instance``: the cluster size, or -1 for the wide
instance), ms a call by CUDA events, the plain version's ms, and the
largest error of the real block against the plain version, with the
card's name and power limit.

    python3 sinkhorn_instances.py [--shapes 1x1000x1024 8x1000x1024]

The similarities are N(0, 3^2) from a seeded generator, 10% of the rows
and 40% of the columns padded, 20 iterations, dustbin 1.0; the default
shapes are the online CLI's GML problem at ``--max_keypoints 1000`` (a
1000-keypoint frame against a 1024-keypoint map frame) one frame at a
time and in batches. Run it from two checkouts in one call to compare
their instances (about 1 minute on an H100, the build included).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from pram_tpu_torch.ops import sinkhorn


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def ms_a_call(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["1x1000x1024", "4x1000x1024", "32x1000x1024"],
                    help="problems as BxNxM")
    args = ap.parse_args()
    dev = torch.device("cuda")
    name = card()
    for shape in args.shapes:
        b, n, m = (int(v) for v in shape.split("x"))
        g = torch.Generator().manual_seed(n + m)
        sim = (3.0 * torch.randn(b, n, m, generator=g)).to(dev)
        m0 = (torch.rand(b, n, generator=g) > 0.1).to(dev)
        m1 = (torch.rand(b, m, generator=g) > 0.4).to(dev)
        args_ = (sim, torch.tensor(1.0, device=dev), 20, m0, m1)
        with torch.no_grad():
            got = sinkhorn.sinkhorn(*args_)
            ref = sinkhorn.sinkhorn_matching(*args_)
            err = (got[:, :n, :m] - ref[:, :n, :m]).abs().max().item()
            print(json.dumps({
                "shape": [b, n, m], "instance": sinkhorn.instance(n, m, dev)[0],
                "ms": ms_a_call(lambda: sinkhorn.sinkhorn(*args_)),
                "plain_ms": ms_a_call(lambda: sinkhorn.sinkhorn_matching(*args_), iters=5, warmup=1),
                "max_abs_err": err, "card": name,
            }), flush=True)


if __name__ == "__main__":
    main()
