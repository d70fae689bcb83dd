"""The online CLI at 512 and 1024 keypoints on chip_smoke.py phase 22's
frames, frame by frame: which frames fail at the CLI's default of 1024, and
whether the card's kernels, the recognizer or the matcher is the cause.

Builds phase 22's online inputs under ``OUT/online`` (the rendered world's
map, built by SFD2 in bf16 on the card, and 32 frames along its path as PNG)
and runs ``cli.online_localization.main`` on them:

- on the card at 512 and at 1024 keypoints (phase 22's config: one
  landmark tried a relocalization, ``seg_k`` 1);
- at 1024 with ``--device cpu`` (f32, every kernel's plain version);
- on the card at 1024 with ``seg_k`` 10 (the ten landmarks the recognizer
  ranks first are matched and solved, the first that localizes taken);
- the same frames written as JPEG (q95 4:2:0, as phase 32 writes them) on
  the card at 512 and 1024, and at 1024 with ``--device cpu``.

For every frame of a run it records the mode, the inliers and the pose
error; for every relocalization the five landmarks the recognizer ranks
first (``rank_segments``), their first-rank votes, how many of their VRF
frame's map points and of their own map points lie inside the frame's
ground-truth view, and the landmark accepted; for every frame the landmark
whose VRF overlaps its view most. Writes ``OUT/runs.json``, and keeps the
map, the config and the PNG and JPEG frames 10-16 under ``OUT/online`` for
``scripts/online_keypoints_witness.py``, which runs the JAX CLI and the
port's CPU path on them.

Usage (on a CUDA machine, from the repository root):
  python3 scripts/online_keypoints.py --out OUT
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WITNESS_FRAMES = range(10, 17)  # the frames kept for the witness: the jump at 11 and its neighbours


def ranked_landmarks(localizer_mod, dmap, cfg, seg_logits, mask, k: int = 5) -> dict:
    """The ``k`` landmarks ``rank_candidates`` ranks first for one query
    (``seg_logits [1, N, C]``, ``mask [1, N]``) and each one's top-1 votes
    among the keypoints it keeps."""
    import torch

    rank = localizer_mod.rank_candidates(dmap.seg_vrf_slot, dmap.vrf_frame_idx, seg_logits, mask,
                                         dataclasses.replace(cfg, seg_k=k))
    top1 = torch.argmax(seg_logits[0], dim=-1)[rank.mask[0]] - 1
    sids = rank.sids[0].tolist()
    return {"sids": sids, "votes": [int((top1 == s).sum()) for s in sids]}


def view_counts(np, pmap, qvec, tvec, cam) -> tuple:
    """For every landmark, the number of its VRF frame's map points and of
    its own map points inside the view of a pose (in front of the camera
    and inside the image; occlusion ignored): what matching against the
    landmark can find at most, without and with the semantic gate that
    keeps the landmark's own points. -1 for a landmark without a VRF."""
    import torch

    from pram_tpu_torch.geometry.rotations import qvec2rotmat

    f, cx, cy, w, h = cam
    x = pmap.point_xyz @ qvec2rotmat(torch.tensor(qvec, dtype=torch.float64)).numpy().T + tvec
    z = np.maximum(x[:, 2], 1e-9)
    u, v = f * x[:, 0] / z + cx, f * x[:, 1] / z + cy
    inside = (x[:, 2] > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    per_frame = np.append(inside, False)[pmap.frame_point_idx].sum(-1)  # index -1 reads the appended False
    slot = pmap.seg_vrf_slot
    own = np.bincount(pmap.point_seg[inside], minlength=slot.shape[0])[: slot.shape[0]]
    vrf = per_frame[pmap.vrf_frame_idx[np.maximum(slot, 0)]]
    return np.where(slot >= 0, vrf, -1).tolist(), np.where(slot >= 0, own, -1).tolist()


def run_online(cli_online, localizer_mod, argv: list) -> tuple:
    """``cli.online_localization.main(argv)`` with every relocalization's
    ranked landmarks recorded; returns (records, relocalization events)."""
    import contextlib
    import io

    real = localizer_mod.Localizer.localize_batch
    events = []

    def localize_batch(self, generator, camera, kpts, scores, descs, mask, seg_logits, *a, **k):
        res = real(self, generator, camera, kpts, scores, descs, mask, seg_logits, *a, **k)
        ev = ranked_landmarks(localizer_mod, self.dmap, self.cfg, seg_logits, mask)
        ev.update(accepted=int(res.matched_sid[0]), inliers=int(res.num_inliers[0]),
                  success=bool(res.success[0]))
        events.append(ev)
        return res

    localizer_mod.Localizer.localize_batch = localize_batch
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            recs = cli_online.main(argv)
    finally:
        localizer_mod.Localizer.localize_batch = real
    return recs, events


def frame_table(np, torch, recs, events, qvecs, tvecs, counts) -> list:
    """One row a frame: mode, success, inliers, errors, the landmark whose
    VRF overlaps its view most (``best``: [sid, points]), and for a
    relocalized frame its ranked and accepted landmarks with their
    ``view_counts`` (``counts[i]``, frame i's)."""
    from pram_tpu_torch.geometry.rotations import compute_pose_error

    q_err, t_err = compute_pose_error(torch.tensor(np.stack([r["qvec"] for r in recs])).double(),
                                      torch.tensor(np.stack([r["tvec"] for r in recs])).double(),
                                      torch.tensor(qvecs), torch.tensor(tvecs).double())
    it = iter(events)
    rows = []
    for i, r in enumerate(recs):
        row = dict(frame=i, mode=r["mode"], success=bool(r["success"]), inliers=r["inliers"],
                   deg=float(q_err[i]), m=float(t_err[i]),
                   best=[int(np.argmax(counts[i][0])), int(np.max(counts[i][0]))],
                   ok=bool(r["success"]) and float(t_err[i]) < 0.05 and float(q_err[i]) < 5.0)
        if r["mode"] == "relocalized":
            ev = row["reloc"] = next(it)
            ev["overlap"] = [counts[i][0][s] if s >= 0 else -1 for s in ev["sids"]]
            ev["in_view"] = [counts[i][1][s] if s >= 0 else -1 for s in ev["sids"]]
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="a directory that does not exist yet")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("online_keypoints: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pram_tpu_torch.cli import online_localization as cli_online
    from pram_tpu_torch.engine import localizer as localizer_mod
    from pram_tpu_torch.engine.rendered_guard import FOCAL, GML_W, HEIGHT, REC_W, SFD2_W, WIDTH
    from pram_tpu_torch.maps.loader import load_multi_map
    from pram_tpu_torch.cli.inference import scene_configs
    from pram_tpu_torch.core.config import load_config

    out = Path(args.out)
    root = out / "online"
    root.mkdir(parents=True, exist_ok=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    loc = {"seg_k": 1, "threshold": 8.0, "min_inliers": 32, "do_refinement": True,
           "matching_method": "gml", "refinement_method": "projection"}  # phase 22's
    oi = cs.write_online_inputs(torch, np, dev, bf16, root, loc)
    cfg10 = cs.write_configs(root, "Rendered", "scene", 112, {
        "network": "segnetvit", "use_mid_feature": True, "layers": 15,
        "localization": {**loc, "seg_k": 10, "with_compress": False}}, config_dir=root / "seg_k10")
    pmap = load_multi_map(scene_configs(load_config(str(oi["cfg"]))), with_compress=False)
    cam = (FOCAL, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT)
    counts = [view_counts(np, pmap, q, t, cam) for q, t in zip(oi["qvecs"], oi["tvecs"])]
    # the same frames as JPEG, as chip_smoke.py phase 32 writes them
    jpg_dir = root / "images_jpeg"
    jpg_dir.mkdir()
    for name, img in zip(oi["fnames"], oi["imgs"]):
        cs.write_jpeg(jpg_dir / name.replace(".png", ".jpg"), cs.uint8_image(np, img), 95)
    cs.write_queries(jpg_dir, [f.replace(".png", ".jpg") for f in oi["fnames"]], oi["qvecs"], oi["tvecs"],
                     ("PINHOLE", WIDTH, HEIGHT, (FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2)))
    weights = ["--rec_weight_path", REC_W, "--feat_weight_path", SFD2_W, "--matcher_weight_path", GML_W]
    runs = {}
    png, cfg1 = oi["img_dir"], oi["cfg"]
    for key, img_dir, cfg, kpts, device in (
            ("card_512", png, cfg1, 512, "cuda"), ("card_1024", png, cfg1, 1024, "cuda"),
            ("cpu_1024", png, cfg1, 1024, "cpu"), ("card_1024_seg_k10", png, cfg10, 1024, "cuda"),
            ("card_jpeg_512", jpg_dir, cfg1, 512, "cuda"), ("card_jpeg_1024", jpg_dir, cfg1, 1024, "cuda"),
            ("cpu_jpeg_1024", jpg_dir, cfg1, 1024, "cpu")):
        t = time.perf_counter()
        recs, events = run_online(cli_online, localizer_mod, [
            "--config", str(cfg), "--image_dir", str(img_dir), "--queries",
            str(img_dir / "queries_with_intrinsics.txt"), *weights, "--max_keypoints", str(kpts), "--device", device])
        rows = frame_table(np, torch, recs, events, oi["qvecs"], oi["tvecs"], counts)
        runs[key] = dict(seconds=time.perf_counter() - t, localized=sum(r["ok"] for r in rows),
                         failed=[r["frame"] for r in rows if not r["ok"]], frames=rows)
        print(f"{key}: {runs[key]['localized']}/{len(rows)} within 5 cm / 5 deg, failed {runs[key]['failed']}, "
              f"{runs[key]['seconds']:.1f} s", flush=True)
        for r in rows:
            if "reloc" in r or not r["ok"]:
                print(f"  frame {r['frame']:2d} {r['mode']:11s} ok={r['ok']} inliers={r['inliers']} "
                      f"ranked={r.get('reloc', {}).get('sids')} votes={r.get('reloc', {}).get('votes')} "
                      f"overlap={r.get('reloc', {}).get('overlap')} in_view={r.get('reloc', {}).get('in_view')} "
                      f"accepted={r.get('reloc', {}).get('accepted')} best={r['best']}", flush=True)
    for img_dir in (oi["img_dir"], jpg_dir):
        for p in img_dir.glob("frame_*"):
            if int(p.stem[6:9]) not in WITNESS_FRAMES:
                p.unlink()
    (out / "runs.json").write_text(json.dumps(dict(gpu=cs.nvidia_smi(), runs=runs)))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
