"""Time kernel 3 (RANSAC scoring) of the package under a directory on the
card, so that a checkout of another commit (``git archive <commit>
pram_tpu_torch | tar -x -C parent_tree``) is timed beside this one in the
same call.

    python3 scripts/time_score.py <directory holding pram_tpu_torch> [--sweep]

At GML's 32 x 512 x 512 and ``chip_smoke.SCORE_SHAPES``, on
``chip_smoke.score_case``'s inputs (pinhole cameras, points in view; GML's
and the first 10240-point shape also with distortion), it prints one JSON
object a shape: a call by CUDA events (``ms``), the kernel by
torch.profiler (``device_ms``), the wrapper's host time a call
(``host_us``: the least and the median of 7 runs of 200 calls queued
without a synchronize, taken before any torch.profiler session in the
process, and again after them) and the bound, or the package's refusal
(``chip_smoke.py`` checks the counts). ``--sweep`` needs this commit's C
entry: it adds the kernel's time with the point axis cut into fractions
and multiples of the slices ``score_slices`` picks, and the parts of the
host time: the C entry alone (``entry_us``: the output's zeroing and the
launch; ``entry_one_slice_us``: the launch alone), the output's
allocation, and the stream lookup by ``torch.cuda.current_stream`` and by
``_build.stream_of``. Needs a card.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from chip_smoke import SCORE_SHAPES, cuda_ms, launch_ms, nvidia_smi, score_bound, score_case  # noqa: E402

sys.path.insert(0, sys.argv[1])
from pram_tpu_torch import _build  # noqa: E402
from pram_tpu_torch.ops import pnp  # noqa: E402

SHAPES = [("gml", (32, 512, 512), False), *((label, shape, False) for label, shape in SCORE_SHAPES),
          ("gml_distorted", (32, 512, 512), True), ("matching_128_distorted", (32, 512, 10240), True)]


def host_us(fn, n: int = 200, runs: int = 7) -> list:
    """[least, median] host microseconds a call of ``fn`` over ``runs`` runs
    of ``n`` calls, each run queued without a synchronize."""
    per_call = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    per_call.sort()
    return [round(per_call[0], 2), round(per_call[runs // 2], 2)]


def device_ms(fn):
    found = [v for k, v in launch_ms(torch, fn, want=lambda k: "ransac" in k).items() if "ransac" in k]
    return found[0] if found else None


def sweep_host(args, P, K, N) -> dict:
    """The host time's parts (see the module's docstring)."""
    dev = args[0].device
    out = torch.empty((P, K), dtype=torch.int32, device=dev)
    entry = c_entry(args, out)
    picked = pnp.score_slices(P, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    return dict(slices=picked, entry_us=host_us(lambda: entry(picked)), entry_one_slice_us=host_us(lambda: entry(1)),
                alloc_us=host_us(lambda: torch.empty((P, K), dtype=torch.int32, device=dev)),
                current_stream_us=host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
                stream_of_us=host_us(lambda: _build.stream_of(dev)))


def sweep_device(args, P, K, N, picked) -> dict:
    """The kernel's device ms with the point axis in fractions and
    multiples of the ``picked`` slices."""
    entry = c_entry(args, torch.empty((P, K), dtype=torch.int32, device=args[0].device))
    cut = sorted({max(1, picked // 4), max(1, picked // 2), picked, 2 * picked, 4 * picked})
    return dict(device_ms_by_slices={s: device_ms(lambda s=s: entry(s)) for s in cut})


def c_entry(args, out):
    """This commit's C entry on ``args`` into ``out``, by its slice count."""
    lib = _build.library()
    ptrs = [a.data_ptr() for a in args[:7]]
    stream = _build.stream_of(args[0].device)
    P, K = args[3].shape
    N = args[6].shape[1]

    def entry(s):
        status = lib.pram_ransac_score(*ptrs, args[7], out.data_ptr(), P, K, N, s, stream)
        assert status == 0, status
    return entry


def main():
    tag = sys.argv[1]
    dev = torch.device("cuda", 0)
    sweep = "--sweep" in sys.argv
    print(tag, nvidia_smi(), flush=True)
    _build.library()
    # host times first, before any torch.profiler session in the process,
    # and again after them (host_us_after_profiler)
    cases = []
    for label, (P, K, N), distorted in SHAPES:
        args = [a.to(dev).contiguous() for a in score_case(torch, torch.Generator().manual_seed(N + K),
                                                           P, K, N, distorted)] + [8.0]
        row = dict(shape=[P, K, N], distorted=distorted, **score_bound(args[0], K, N))
        try:
            pnp.ransac_score(*args)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(tag, label, json.dumps(dict(row, refused=str(e))), flush=True)
            continue
        row.update(ms=cuda_ms(torch, lambda: pnp.ransac_score(*args)),
                   host_us=host_us(lambda: pnp.ransac_score(*args)))
        if sweep and not distorted:
            row.update(sweep_host(args, P, K, N))
        cases.append((label, args, row))
    for label, args, row in cases:
        P, K, N = row["shape"]
        row["device_ms"] = device_ms(lambda: pnp.ransac_score(*args))
        if sweep and not row["distorted"]:
            row.update(sweep_device(args, P, K, N, row["slices"]))
        row["host_us_after_profiler"] = host_us(lambda: pnp.ransac_score(*args))
        print(tag, label, json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
