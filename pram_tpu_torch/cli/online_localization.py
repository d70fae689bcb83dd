"""Online localization: raw images -> tracking / relocalization stream
(pram_tpu/cli/online_localization.py).

Rebuild of inference.py --online + localization/loc_by_rec_online.py:24-225:
read query images from disk in trajectory order, extract (SFD2), recognize
(SegNetViT), then either track frame-to-frame or relocalize against the map;
fall back to full relocalization whenever tracking is lost
(loc_by_rec_online.py:181-189).

Usage:
  python -m pram_tpu_torch.cli.online_localization --config C --image_dir D \\
      --queries queries_with_intrinsics.txt [--device cpu]

Images are PNG or ``.npy`` (``io/image.py``; JPEG raises). Weights are
reference torch checkpoints, as for the JAX CLI, or the repo's flax
``.msgpack`` files. It runs on the CUDA card, in bf16, unless ``--device
cpu`` is given (f32, as the JAX CLI). ``main`` returns one record a frame.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time

import numpy as np
import torch


def _clock(device) -> float:
    """Host time after the device's queued work (the card's time, not the
    launch queue's)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def main(argv=None):
    from pram_tpu_torch.cli.inference import WEIGHT_HELP, load_recognizer, not_ported, scene_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--queries", required=True,
                    help="queries_with_intrinsics.txt (trajectory order)")
    ap.add_argument("--rec_weight_path", default=None, help=WEIGHT_HELP)
    ap.add_argument("--feat_weight_path", default=None, help=WEIGHT_HELP)
    ap.add_argument("--matcher_weight_path", default=None, help=WEIGHT_HELP)
    ap.add_argument("--max_keypoints", type=int, default=1024)
    ap.add_argument("--save_vis", default=None,
                    help="frame dumps (not ported: utils/visualization.py, ROADMAP queue 1 item 4)")
    ap.add_argument("--no_tracking", action="store_true")
    ap.add_argument("--viewer_port", type=int, default=None,
                    help="the 3D viewer (not ported: viz/server.py, ROADMAP queue 1 item 4)")
    ap.add_argument("--viewer_host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.save_vis is not None:
        not_ported("--save_vis", "utils/visualization.py (ROADMAP queue 1 item 4)")
    if args.viewer_port is not None:
        not_ported("--viewer_port", "viz/server.py (ROADMAP queue 1 item 4)")

    from pram_tpu_torch.cli.extract_features import CONFS, _pad_to_multiple, build_extractor, load_image
    from pram_tpu_torch.cli.match_features import build_match_fn, model_dtype
    from pram_tpu_torch.core.config import load_config
    from pram_tpu_torch.engine.localizer import Localizer, LocResult
    from pram_tpu_torch.engine.tracker import Tracker
    from pram_tpu_torch.geometry.camera import Camera, make_camera
    from pram_tpu_torch.maps.device import to_device
    from pram_tpu_torch.maps.loader import load_multi_map
    from pram_tpu_torch.maps.parsers import parse_image_list_with_intrinsics
    from pram_tpu_torch.models.sfd2 import extract, preprocess_image

    device = torch.device(args.device)
    cfg = load_config(args.config)

    # ---- map
    dtype = model_dtype(device)
    pmap = load_multi_map(scene_configs(cfg), with_compress=cfg.with_compress)
    dmap = to_device(pmap, device, desc_dtype=dtype)

    # ---- models
    sfd2, _, _ = build_extractor(CONFS["sfd2"], args.feat_weight_path, device)
    rec = load_recognizer(cfg.network, {
        "descriptor_dim": 256, "output_dim": cfg.output_dim,
        "n_class": pmap.n_class, "n_layers": cfg.layers,
    }, args.rec_weight_path, device)

    match_fn = build_match_fn(cfg.matching_method, args.matcher_weight_path, device)
    localizer = Localizer(dmap, match_fn, cfg.localization)
    tracker = Tracker(dmap, match_fn, cfg.localization)
    seg_vrf_slot = pmap.seg_vrf_slot

    queries = parse_image_list_with_intrinsics(args.queries)
    times = {"feat": [], "rec": [], "loc": [], "total": []}
    records = []
    n_ok = 0

    for qi, (qname, qinfo) in enumerate(queries):
        model_name, width, height, params = qinfo
        cam = make_camera(model_name, params, width, height, device=device)
        t0 = _clock(device)
        img, _, _ = load_image(osp.join(args.image_dir, qname), False, None)
        img = _pad_to_multiple(img)
        feats = extract(
            sfd2, preprocess_image(torch.from_numpy(img).to(device)[None]).to(dtype),
            max_keypoints=args.max_keypoints, conf_th=0.005,
        )
        kps = feats["keypoints"]
        t1 = _clock(device)
        logits = rec(
            feats["seg_descriptors"],
            kps.xy / torch.tensor([width, height], dtype=torch.float32, device=device) - 0.5,
            mask=kps.mask,
        )["prediction"].float()
        t2 = _clock(device)

        res, mode = None, "tracked"
        if not args.no_tracking and not tracker.lost:
            res = tracker.track(
                torch.Generator().manual_seed(qi), cam,
                kps.xy[0], kps.scores[0], feats["descriptors"][0], kps.mask[0],
            )
        if res is None or not bool(res.success):
            # full relocalization
            mode = "relocalized"
            loc = localizer.localize_batch(
                torch.Generator().manual_seed(100000 + qi),
                Camera(cam.params[None], cam.size[None]),
                kps.xy, kps.scores, feats["descriptors"], kps.mask, logits,
            )
            res = LocResult(*[x[0] for x in loc])
            if bool(res.success):
                tracker.update_from_localization(
                    kps.xy[0], kps.scores[0], feats["descriptors"][0], kps.mask[0], res,
                    int(seg_vrf_slot[max(int(res.matched_sid), 0)]),
                )
        t3 = _clock(device)
        ok = bool(res.success)
        n_ok += ok
        dts = {"feat": t1 - t0, "rec": t2 - t1, "loc": t3 - t2, "total": t3 - t0}
        for k, v in dts.items():
            times[k].append(v)
        records.append({
            "name": qname, "success": ok, "qvec": res.qvec.cpu().numpy(),
            "tvec": res.tvec.cpu().numpy(), "inliers": int(res.num_inliers), "mode": mode,
            "ms": {k: 1000.0 * v for k, v in dts.items()},
        })
        print(
            f"[{qi+1}/{len(queries)}] {qname}: "
            f"{'ok' if ok else 'FAIL'} inliers={int(res.num_inliers)} "
            f"t={1000*(t3-t0):.1f}ms"
        )

    print(
        "success {}/{}; mean times (ms): ".format(n_ok, len(queries))
        + ", ".join(
            f"{k}={1000*np.mean(v):.1f}" for k, v in times.items() if v
        )
    )
    return records


if __name__ == "__main__":
    main()
