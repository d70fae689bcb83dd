"""The JAX CLI beside the port's CPU path on the frames that
``scripts/online_keypoints.py`` kept: does ``pram_tpu`` lose the frames
after the jump at 1024 keypoints as the port does?

Reads ``OUT/online`` (the map, the config and the PNG and JPEG frames that
``scripts/online_keypoints.py`` wrote on the card) and runs, on the CPU,
``pram_tpu.cli.online_localization.main`` and
``pram_tpu_torch.cli.online_localization.main --device cpu`` on frames
11-15, PNG and JPEG, at 512 and at 1024 keypoints, and at 1024 with the semantic gate off
(``semantic_matching: false``: every keypoint matched against the VRF
frame, where the gate keeps the keypoints voting for the landmark and the
landmark's own points once it has ``min_kpts`` votes). Frame 11 comes
first, so it relocalizes, as it does after the jump. For every relocalization it
records the five landmarks the recognizer ranks first, their first-rank
votes, the landmark accepted and the inliers; for every frame the pose
error. The JAX CLI runs with its ``build_match_fn`` closure giving the
matches alone, as ``tests/test_torch_cli.py`` runs it (its fault, in
ROADMAP.md section 3), and reads the repo's flax ``.msgpack`` weights
where it takes torch checkpoints (``pram_tpu.models.convert`` patched for
the run). Prints one line a frame and writes ``OUT/witness.json``. The
config holds absolute paths: OUT must lie where the card's run wrote it.

Usage (from the repository root; about five minutes):
  JAX_PLATFORMS=cpu python scripts/online_keypoints_witness.py --dir OUT
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FRAMES = range(11, 16)
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


def jax_ranked(dmap, cfg, seg_logits, mask, k: int = 5) -> dict:
    """``pram_tpu``'s ``rank_candidates`` on one query, as
    ``online_keypoints.ranked_landmarks`` gives the port's."""
    import numpy as np
    from pram_tpu.engine.localizer import rank_candidates

    rank = rank_candidates(dmap.seg_vrf_slot, dmap.vrf_frame_idx, seg_logits[0], mask[0],
                           dataclasses.replace(cfg, seg_k=k))
    top1 = np.argmax(np.asarray(seg_logits[0]), axis=-1)[np.asarray(rank.mask)] - 1
    sids = np.asarray(rank.sids).tolist()
    return {"sids": sids, "votes": [int((top1 == s).sum()) for s in sids]}


@contextlib.contextmanager
def msgpack_weights():
    """``pram_tpu.models.convert``'s checkpoint readers made to read a flax
    ``.msgpack`` file: SFD2's holds its variables, SegNetViT's and GML's
    their params."""
    from flax import serialization
    from pram_tpu.models import convert

    def restore(path):
        with open(path, "rb") as f:
            return serialization.msgpack_restore(f.read())

    names = ("load_torch_state_dict", "convert_sfd2", "convert_segnetvit", "convert_gml")
    real = {n: getattr(convert, n) for n in names}
    convert.load_torch_state_dict = str
    convert.convert_sfd2 = restore
    convert.convert_segnetvit = lambda path, **k: {"params": restore(path)}
    convert.convert_gml = lambda path: {"params": restore(path)}
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(convert, n, fn)


def run_jax(argv: list) -> tuple:
    """The JAX CLI on ``argv``; returns (records, relocalization events):
    a record a frame (its last tracking or relocalization result)."""
    import numpy as np
    from pram_tpu.cli import match_features as j_match_features
    from pram_tpu.cli import online_localization as j_online
    from pram_tpu.engine.localizer import Localizer
    from pram_tpu.engine.tracker import Tracker

    build, track, localize = j_match_features.build_match_fn, Tracker.track, Localizer.localize_batch
    events, results = [], []

    def matches_only(*a, **k):
        fn = build(*a, **k)
        return lambda *x: fn(*x)[0]

    def tracked(self, *a, **k):
        res = track(self, *a, **k)
        if res is not None:
            results.append(("tracked", res.success, res.qvec, res.tvec, res.num_inliers))
        return res

    def localized(self, key, camera, kpts, scores, descs, mask, seg_logits):
        res = localize(self, key, camera, kpts, scores, descs, mask, seg_logits)
        ev = jax_ranked(self.dmap, self.cfg, seg_logits, mask)
        ev.update(accepted=int(res.matched_sid[0]), inliers=int(res.num_inliers[0]), success=bool(res.success[0]))
        events.append(ev)
        results.append(("relocalized", res.success[0], res.qvec[0], res.tvec[0], res.num_inliers[0]))
        return res

    recs = []

    def frame_print(line, *a, **k):
        if line.startswith("["):
            mode, ok, q, t, n = results[-1]
            recs.append({"name": line.split(":")[0].split("] ")[1], "mode": mode, "success": bool(ok),
                         "qvec": np.asarray(q, np.float64), "tvec": np.asarray(t, np.float64), "inliers": int(n)})

    j_match_features.build_match_fn, Tracker.track, Localizer.localize_batch = matches_only, tracked, localized
    j_online.print = frame_print
    try:
        with msgpack_weights():
            j_online.main(argv)
    finally:
        j_match_features.build_match_fn, Tracker.track, Localizer.localize_batch = build, track, localize
        del j_online.print
    return recs, events


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", required=True, help="scripts/online_keypoints.py's --out")
    args = ap.parse_args()

    import numpy as np
    import torch

    import online_keypoints as ok
    from pram_tpu_torch.cli import online_localization as cli_online
    from pram_tpu_torch.engine import localizer as localizer_mod
    from pram_tpu_torch.cli.inference import scene_configs
    from pram_tpu_torch.core.config import load_config
    from pram_tpu_torch.engine.rendered_guard import FOCAL, GML_W, HEIGHT, REC_W, SFD2_W, WIDTH
    from pram_tpu_torch.maps.loader import load_multi_map

    root = Path(args.dir) / "online"
    poses = [ln.split() for ln in (root / "images" / "queries_poses.txt").read_text().splitlines()]
    qvecs = np.array([[float(v) for v in p[1:5]] for p in poses])[list(FRAMES)]
    tvecs = np.array([[float(v) for v in p[5:8]] for p in poses])[list(FRAMES)]
    pmap = load_multi_map(scene_configs(load_config(str(root / "config.yaml"))), with_compress=False)
    cam = (FOCAL, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    counts = [ok.view_counts(np, pmap, q, t, cam) for q, t in zip(qvecs, tvecs)]
    out = {}
    with tempfile.TemporaryDirectory(prefix="pram_witness_") as tmp:
        ungated = Path(tmp) / "config_ungated.yaml"
        ungated.write_text((root / "config.yaml").read_text().replace("localization:\n",
                                                                      "localization:\n  semantic_matching: false\n"))
        for kind, img_dir in (("png", root / "images"), ("jpeg", root / "images_jpeg")):
            lines = (img_dir / "queries_with_intrinsics.txt").read_text().splitlines()
            queries = Path(tmp) / f"queries_{kind}.txt"
            queries.write_text("".join(lines[i] + "\n" for i in FRAMES))
            for kpts, cfg, tag in ((512, root / "config.yaml", ""), (1024, root / "config.yaml", ""),
                                   (1024, ungated, "_ungated")):
                argv = ["--config", str(cfg), "--image_dir", str(img_dir), "--queries", str(queries),
                        "--rec_weight_path", REC_W, "--feat_weight_path", SFD2_W, "--matcher_weight_path", GML_W,
                        "--max_keypoints", str(kpts)]
                for key, run in ((f"jax_{kind}_{kpts}{tag}", lambda: run_jax(argv)),
                                 (f"port_cpu_{kind}_{kpts}{tag}", lambda: ok.run_online(cli_online, localizer_mod,
                                                                                   argv + ["--device", "cpu"]))):
                    t = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        recs, events = run()
                    rows = ok.frame_table(np, torch, recs, events, qvecs, tvecs, counts)
                    for r in rows:
                        r["frame"] += FRAMES[0]
                    out[key] = dict(seconds=time.perf_counter() - t, frames=rows)
                    for r in rows:
                        rel = r.get("reloc", {})
                        print(f"{key:26s} frame {r['frame']} {r['mode']:11s} ok={r['ok']} inliers={r['inliers']} "
                              f"ranked={rel.get('sids')} votes={rel.get('votes')} overlap={rel.get('overlap')} "
                              f"in_view={rel.get('in_view')} accepted={rel.get('accepted')} best={r['best']}",
                              flush=True)
    (Path(args.dir) / "witness.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
