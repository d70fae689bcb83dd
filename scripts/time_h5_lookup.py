"""Time the port's HDF5 reader and writer (pram_tpu_torch/io/h5.py) on hloc
files of Aachen's size, through the getters ``run_triangulation`` calls.

    python3 scripts/time_h5_lookup.py <directory holding pram_tpu_torch> [images ...]

The package is imported from that directory, so a checkout of another commit
(``git archive <commit> pram_tpu_torch | tar -x -C parent_tree``) is timed
beside this one in the same call. For each image count (default 100 and
5300, Aachen's database), the script writes a features file (``db/NNNNN.jpg``
groups of 64 keypoints, f32 ``keypoints`` / ``scores`` / 128 x 64
``descriptors``) and a match file (each image paired with the next 10, hloc's
nested pair names), recording the seconds and the peak of Python memory
(tracemalloc) of each write. Then it times ``get_keypoints`` and
``get_matches`` (each opens the file, as ``run_triangulation`` calls them),
``list_h5_names`` once, and a lookup of a name in an open file, on a seeded
sample of names. Host only; no card. Prints one JSON object an image count.
"""

import json
import os
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [sys.argv[1] if len(sys.argv) > 1 else str(REPO)]

import numpy as np  # noqa: E402

from pram_tpu_torch.io import h5  # noqa: E402
from pram_tpu_torch.maps import parsers  # noqa: E402

KPTS, DIM, PAIRS_AN_IMAGE, CALLS = 64, 128, 10, 300


def write_traced(path, fill):
    """Seconds and tracemalloc peak (bytes) of writing a file."""
    tracemalloc.start()
    t = time.perf_counter()
    with h5.File(path, "w") as f:
        fill(f)
    secs = time.perf_counter() - t
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return secs, peak


def per_call_ms(fn, args) -> float:
    t = time.perf_counter()
    for a in args:
        fn(*a)
    return (time.perf_counter() - t) * 1e3 / len(args)


def run(n: int, tmp: str) -> dict:
    rng = np.random.RandomState(0)
    names = [f"db/{i:05d}.jpg" for i in range(n)]
    pairs = [(names[i], names[(i + k) % n]) for i in range(n) for k in range(1, PAIRS_AN_IMAGE + 1)]
    feats, matches = os.path.join(tmp, f"feats_{n}.h5"), os.path.join(tmp, f"matches_{n}.h5")

    def fill_feats(f):
        for name in names:
            g = f.create_group(name)
            g.create_dataset("keypoints", data=rng.rand(KPTS, 2).astype(np.float32) * 1024)
            g.create_dataset("scores", data=rng.rand(KPTS).astype(np.float32))
            g.create_dataset("descriptors", data=rng.randn(DIM, KPTS).astype(np.float32))
            g.create_dataset("image_size", data=np.array([1024, 768]))

    def fill_matches(f):
        for a, b in pairs:
            g = f.create_group(parsers.names_to_pair(a, b))
            g.create_dataset("matches0", data=rng.randint(-1, KPTS, KPTS).astype(np.int32))
            g.create_dataset("matching_scores0", data=rng.rand(KPTS).astype(np.float32))

    out = {"images": n, "pairs": len(pairs)}
    out["write_feats_s"], out["write_feats_peak_bytes"] = write_traced(feats, fill_feats)
    out["write_matches_s"], out["write_matches_peak_bytes"] = write_traced(matches, fill_matches)
    out["feats_bytes"], out["matches_bytes"] = os.path.getsize(feats), os.path.getsize(matches)
    sample = np.random.RandomState(1).choice(n, min(CALLS, n), replace=False)
    psample = np.random.RandomState(2).choice(len(pairs), min(CALLS, len(pairs)), replace=False)
    out["calls"] = len(sample)
    out["get_keypoints_ms"] = per_call_ms(parsers.get_keypoints, [(feats, names[i]) for i in sample])
    out["get_matches_ms"] = per_call_ms(parsers.get_matches, [(matches, *pairs[i]) for i in psample])
    t = time.perf_counter()
    assert len(parsers.list_h5_names(feats)) == n
    out["list_h5_names_s"] = time.perf_counter() - t
    with h5.File(feats, "r") as f:
        out["open_file_lookup_ms"] = per_call_ms(lambda name: f[name]["keypoints"].shape, [(names[i],) for i in sample])
    # the whole of run_triangulation's reads at this size, extrapolated from the samples
    out["triangulation_reads_s"] = (out["get_keypoints_ms"] * n + out["get_matches_ms"] * len(pairs)) / 1e3
    return out


def main():
    counts = [int(v) for v in sys.argv[2:]] or [100, 5300]
    print(sys.argv[1] if len(sys.argv) > 1 else str(REPO), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for n in counts:
            print(json.dumps(run(n, tmp)), flush=True)


if __name__ == "__main__":
    main()
