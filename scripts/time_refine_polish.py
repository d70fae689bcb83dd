"""Time kernels 7 (refinement NN) and 4 (LO / Gauss-Newton polish) of the
package under a directory, on the card, at GML's and AdaGML's shapes.

    python3 scripts/time_refine_polish.py <directory holding pram_tpu_torch>

The package is imported from that directory, so a checkout of another commit
(``git archive <commit> pram_tpu_torch | tar -x -C parent_tree``) is timed
beside this one in the same call. The inputs are the card tests' builders
(``tests/test_torch_cuda.py``), the timers chip_smoke.py's: a call by CUDA
events (``ms``) and the kernel alone by torch.profiler (``dev``). Prints
ptxas's report of both sources, then one JSON object a case. Needs a card.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [sys.argv[1], str(REPO), str(REPO / "tests")]

import torch  # noqa: E402

from chip_smoke import cuda_ms, launch_ms, nvidia_smi  # noqa: E402
from pram_tpu_torch import _build  # noqa: E402
from pram_tpu_torch.geometry.rotations import so3_exp  # noqa: E402
from pram_tpu_torch.ops import pnp, refine  # noqa: E402
from test_torch_cuda import _pnp_problems, _rand, _refine_tie_case  # noqa: E402


def report(kind, shape, fn, word):
    dev_ms = [v for k, v in launch_ms(torch, fn, want=lambda k: word in k).items() if word in k]
    row = dict(ms=cuda_ms(torch, fn), dev=dev_ms[0] if dev_ms else None)
    print(sys.argv[1], kind, shape, json.dumps(row), flush=True)


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(sys.argv[1], nvidia_smi(), flush=True)
    _build.library()
    for src in ("refine.cu", "pnp.cu"):
        for k in _build.ptxas_report(src):
            print(sys.argv[1], "ptxas", src, json.dumps(k), flush=True)
    for b, n, p in ((32, 512, 2048), (8, 4096, 4096)):
        args = _refine_tie_case(torch.Generator().manual_seed(p + n), b, n, p, dev)
        report("refine", (b, n, p), lambda: refine.refine_nn(*args), "refine")
    for p, n in ((32, 512), (8, 4096)):
        g = torch.Generator().manual_seed(n + p)
        cam, R, t, xyz, uv, mask = _pnp_problems(g, p, n)
        R0 = so3_exp(_rand(g, p, 3, scale=0.02)) @ R
        t0 = t + _rand(g, p, 3, scale=0.05)
        args = [a.to(dev).contiguous() for a in (cam, R0, t0, xyz, uv, mask)] + [8.0, 32]
        report("polish", (p, n), lambda: pnp.gn_polish(*args, gn_iters=5, lo_rounds=1), "polish")


if __name__ == "__main__":
    main()
