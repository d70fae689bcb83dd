"""Fit the 9-layer GML matcher on the bench's synthetic scene
(scripts/train_synthetic_gml.py).

Usage:
  python -m pram_tpu_torch.cli.train_synthetic_gml [--steps 600] [--batch 8] [--lr 2e-4]
      [--out weights/gml_synthetic_torch.pt] [--eval_only] [--device cpu]
  python -m pram_tpu_torch.cli.train_synthetic_gml --recognizer [--steps 400] [--batch 8]
      [--lr 3e-4] [--out weights/segnetvit_synthetic_torch.pt] [--device cpu]

The full-size GML (9 layers, d 256, the bench's configuration) trains on
query-versus-reference-frame pairs rendered from bench.py's synthetic scene
(512 query keypoints against a frame's 1024 tokens) with the assignment NLL
and Adam, from the flax-like init of ``models/gml.py`` (the card has no jax,
so the JAX script's init cannot be carried over). A pool of ``min(steps,
64)`` batches stays on the device and is cycled. Then pose recall is
validated through the localizer (32 queries, the trained weights in the
CLIs' type, kernel 6's Sinkhorn) and printed as one JSON line.

On the card the step runs bf16 over f32 masters (kernels 1, 2, 5 and 13-15
take bf16), where the JAX script trains in f32 on XLA; the recall check
guards the difference. ``--out`` is a torch checkpoint (``weights/*_torch.pt``
is gitignored); ``--eval_only`` reads it, or a flax ``weights/*.msgpack``
through ``models/convert.py:load_gml``.

``--recognizer`` ports the script's ``fit_recognizer``: SegNetViT nc113 over
the scene's 128-d descriptors, the background-weighted CE, Adam, its
accuracy logged, the weights saved in bf16.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene():
    """The bench's synthetic scene (bench.py:99-103) and the generator
    that made it."""
    from pram_tpu_torch.maps.synthetic import make_synthetic_scene

    rng = np.random.RandomState(0)
    return rng, make_synthetic_scene(
        rng, n_cluster=16, points_per_cluster=400, n_ref_frames=12,
        desc_dim=128, width=640, height=480,
        max_kp_per_frame=1024, max_ref_points=2048,
    )


def make_batch(scene, rng, batch, noise_px=0.3, desc_noise=0.05):
    """Query-vs-reference-frame pairs with ground-truth assignments.

    Side 0 is a rendered query's keypoints (N = 512), side 1 a reference
    frame's keypoint table (M = 1024), as the localizer calls the matcher.
    gt[i] is the frame row holding the query keypoint's 3D point, M
    (dustbin) where the frame lacks it, -1 on a padded row. Returns numpy
    ``(d0, k0, m0, d1, k1, m1, gt)``.
    """
    pmap = scene.map
    n_frames = pmap.frame_point_idx.shape[0]
    m = pmap.frame_point_idx.shape[1]

    d0, k0, m0, d1, k1, m1, gts = [], [], [], [], [], [], []
    for _ in range(batch):
        q = scene.render_query(rng, noise_px=noise_px, desc_noise=desc_noise)
        fi = rng.randint(n_frames)
        f_pt = pmap.frame_point_idx[fi]  # [M] point indices, -1 invalid
        row_of = {int(p): j for j, p in enumerate(f_pt) if p >= 0}
        gt = np.full((q["keypoints"].shape[0],), m, np.int32)
        for i, p in enumerate(q["point_idx"]):
            if p >= 0 and int(p) in row_of:
                gt[i] = row_of[int(p)]
        gt = np.where(q["mask"], gt, -1)

        d0.append(q["descriptors"])
        k0.append(q["keypoints"])
        m0.append(q["mask"])
        d1.append(pmap.point_desc[np.clip(f_pt, 0, None)])
        k1.append(pmap.frame_kp_uv[fi])
        m1.append(pmap.frame_kp_mask[fi])
        gts.append(gt)
    return (
        np.stack(d0), np.stack(k0), np.stack(m0),
        np.stack(d1), np.stack(k1), np.stack(m1), np.stack(gts),
    )


def make_pool(scene, rng, steps, batch, device, width, height):
    """``min(steps, 64)`` batches on ``device``, keypoints normalized as the
    localizer normalizes them: ``(d0, d1, nk0, nk1, m0, m1, gt)`` each, in
    GML's argument order."""
    from pram_tpu_torch.engine.localizer import normalize_kpts_like_reference

    w = torch.tensor(float(width), device=device)
    h = torch.tensor(float(height), device=device)
    pool = []
    for _ in range(min(steps, 64)):
        d0, k0, m0, d1, k1, m1, gt = (torch.from_numpy(a).to(device) for a in make_batch(scene, rng, batch))
        pool.append((d0, d1, normalize_kpts_like_reference(k0, w, h), normalize_kpts_like_reference(k1, w, h),
                     m0, m1, gt.long()))
    return pool


def resolve(path):
    """A relative path is taken from the repository's root, as the JAX
    script takes it."""
    return path if os.path.isabs(path) else os.path.join(ROOT, path)


def load_gml_weights(path, config, device):
    """The f32 GML of a checkpoint written by ``--out`` or of a flax
    ``.msgpack``."""
    from pram_tpu_torch.models.convert import load_gml
    from pram_tpu_torch.models.gml import GML

    if path.endswith(".msgpack"):
        return load_gml(path, config, device=device)
    model = GML(config)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    return model.to(device)


def validate(model, scene, rng, device):
    """Pose recall through the GML localizer at the bench's operating point:
    32 queries, the weights in the CLIs' type, routed by ground-truth
    logits. Returns the JSON line's dict."""
    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.engine.localizer import LocConfig, Localizer
    from pram_tpu_torch.engine.matching import make_gml_match_fn
    from pram_tpu_torch.geometry.camera import Camera
    from pram_tpu_torch.geometry.rotations import compute_pose_error
    from pram_tpu_torch.maps.device import to_device

    width, height = scene.width, scene.height
    dtype = model_dtype(device)
    gml = copy.deepcopy(model).to(device, dtype).eval()
    cfg = LocConfig(
        seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
        do_refinement=True, gn_iters=5, lo_rounds=1,
    )
    loc = Localizer(to_device(scene.map, device, desc_dtype=dtype), make_gml_match_fn(gml), cfg)

    batch = 32
    queries = [scene.render_query(rng, noise_px=0.3) for _ in range(batch)]

    def stack(key, dt=np.float32):
        return torch.from_numpy(np.stack([q[key] for q in queries]).astype(dt)).to(device)

    gt_seg = np.stack([q["gt_seg"] for q in queries])
    cls = np.where(gt_seg >= 0, gt_seg + 1, 0)
    logits = np.full((batch, gt_seg.shape[1], scene.map.n_class), -10.0, np.float32)
    np.put_along_axis(logits, cls[..., None], 10.0, axis=2)
    cam = Camera(
        torch.tensor([500.0, 500.0, width / 2, height / 2, 0, 0, 0, 0], device=device).repeat(batch, 1),
        torch.tensor([float(width), float(height)], device=device).repeat(batch, 1),
    )
    with torch.no_grad():
        res = loc.localize_batch(
            torch.Generator().manual_seed(7), cam, stack("keypoints"), stack("scores"),
            stack("descriptors").to(dtype), stack("mask", bool), torch.from_numpy(logits).to(device),
        )
    qe, te = compute_pose_error(res.qvec.cpu().double(), res.tvec.cpu().double(),
                                torch.from_numpy(np.stack([q["qvec"] for q in queries])),
                                torch.from_numpy(np.stack([q["tvec"] for q in queries])).double())
    success = res.success.cpu().numpy()
    te, qe = te.numpy(), qe.numpy()
    ok = success & (te < 0.05) & (qe < 5.0)
    return {
        "recall_5cm5deg_gml": float(ok.mean()),
        "success_rate": float(success.mean()),
        "median_t_err": float(np.median(te)),
        "median_q_err": float(np.median(qe)),
        "device": str(device),
    }


def _parser(steps, lr, out):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--out", default=out)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None, mark=None):
    """Train (unless ``--eval_only``), save, validate; returns ``{"losses":
    [...], "steps_per_s", "validation": {...}}`` (``--recognizer``: see
    :func:`fit_recognizer`). ``mark(stage, **state)``, if given, is called
    with ``pool`` (the model, the pool and the step, before the first step),
    ``train`` (the model, after the last step, synchronized) and
    ``validate``."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--recognizer" in argv:
        argv.remove("--recognizer")
        return fit_recognizer(argv)
    ap = _parser(600, 2e-4, "weights/gml_synthetic_torch.pt")
    ap.add_argument("--eval_only", action="store_true")
    args = ap.parse_args(argv)

    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.models.gml import GML, GMLConfig
    from pram_tpu_torch.train.matcher import make_matcher_train_step

    device = torch.device(args.device)
    mark = mark or (lambda stage, **state: None)
    rng, scene = build_scene()
    config = GMLConfig()
    # the JAX script draws one batch for flax's init: drawn here too, so the
    # pool and the validation queries come from the same generator state
    make_batch(scene, rng, args.batch)
    out_path = resolve(args.out)
    result = {"losses": [], "steps_per_s": None}
    if args.eval_only:
        model = load_gml_weights(out_path, config, device)
    else:
        model = GML(config).to(device)
        compute = model_dtype(device) if device.type == "cuda" else None
        step = make_matcher_train_step(model, args.lr, compute)
        pool = make_pool(scene, rng, args.steps, args.batch, device, scene.width, scene.height)
        mark("pool", model=model, pool=pool, step=step)
        losses = []
        t0 = sync(device)
        for it in range(args.steps):
            losses.append(step(*pool[it % len(pool)])["loss"])
            if it % 50 == 0 or it == args.steps - 1:
                print(f"step {it}: loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
        t1 = sync(device)
        mark("train", model=model)
        result["losses"] = torch.stack(losses).float().cpu().tolist() if losses else []
        result["steps_per_s"] = args.steps / max(t1 - t0, 1e-9)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        torch.save({"model": model.state_dict(), "config": vars(config), "steps": args.steps}, out_path)
        print(f"saved {out_path}")
    result["validation"] = validate(model, scene, rng, device)
    mark("validate")
    print(json.dumps(result["validation"]))
    return result


def fit_recognizer(argv=None):
    """SegNetViT nc113 on the scene's rendered queries (the JAX script's
    ``fit_recognizer``); returns ``{"losses", "accuracy"}``."""
    args = _parser(400, 3e-4, "weights/segnetvit_synthetic_torch.pt").parse_args(argv)

    from pram_tpu_torch.cli.match_features import model_dtype
    from pram_tpu_torch.models.segnetvit import SegNetViT, SegNetViTConfig
    from pram_tpu_torch.train.losses import seg_accuracy, seg_loss_weighted
    from pram_tpu_torch.train.matcher import make_adam
    from pram_tpu_torch.train.trainer import cast_forward

    device = torch.device(args.device)
    rng, scene = build_scene()
    width, height = scene.width, scene.height
    cfg = SegNetViTConfig(descriptor_dim=128, n_class=113)
    model = SegNetViT(cfg).to(device)
    compute = model_dtype(device) if device.type == "cuda" else None

    def make_rec_batch(batch):
        qs = [scene.render_query(rng, noise_px=0.3, desc_noise=0.05) for _ in range(batch)]
        descs = np.stack([q["descriptors"] for q in qs])
        nk = np.stack([q["keypoints"] for q in qs]) / [width, height] - 0.5
        gt = np.stack([np.where(q["gt_seg"] >= 0, q["gt_seg"] + 1, 0) for q in qs])
        mask = np.stack([q["mask"] for q in qs])
        return tuple(torch.from_numpy(a).to(device) for a in (
            descs.astype(np.float32), nk.astype(np.float32), gt, mask))

    make_rec_batch(args.batch)  # the JAX script's init batch
    opt = make_adam(model.parameters(), args.lr)

    def step(d, k, g, m):
        if compute is not None:
            d = d.to(compute)
        logits = cast_forward(model, compute, d, k, m)["prediction"].float()
        loss = seg_loss_weighted(logits, g, m, weight_background=0.1)
        corr, _ = seg_accuracy(logits.detach(), g, m)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), corr

    pool = [make_rec_batch(args.batch) for _ in range(min(args.steps, 48))]
    losses, acc = [], None
    t0 = time.perf_counter()
    for it in range(args.steps):
        loss, acc = step(*pool[it % len(pool)])
        losses.append(loss)
        if it % 50 == 0 or it == args.steps - 1:
            print(f"rec step {it}: loss {float(loss):.4f} acc {float(acc):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    out_path = resolve(args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    state = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v) for k, v in model.state_dict().items()}
    torch.save({"model": state, "config": vars(cfg), "steps": args.steps}, out_path)
    accuracy = float(acc) if acc is not None else float("nan")
    print(f"saved {out_path} (final acc {accuracy:.3f})")
    return {"losses": torch.stack(losses).float().cpu().tolist() if losses else [], "accuracy": accuracy}


if __name__ == "__main__":
    main()
