"""Image-level recall guard: the whole query path on the rendered world
(pram_tpu/engine/rendered_guard.py).

Rendered query images go through SFD2 extraction (stem and NMS kernels on
the card) -> SegNetViT recognition -> GML matching -> RANSAC PnP ->
projection refinement, and recall and match precision are computed against
the renderer's exact ground-truth poses. The map is built by the same
extractor, on the same device, from 12 rendered reference views. Rendering
is numpy on the host; nothing is cached to disk.

``int8=True`` swaps the extractor for the int8 one
(``models/sfd2_int8.py``, the JAX bench's default, ``bench.py:236``): the
map build and the queries both run through it. ``int8_conv``,
``int8_mlp`` and ``int8_proj`` stand for ``PRAM_INT8_CONV``,
``PRAM_INT8_MLP`` and ``PRAM_INT8_PROJ``: the extractor's f32-tail conv
kernel, and SegNetViT's and GML's int8 MLPs and projections.

Also provides the kernel-vs-plain extraction A/B check
(:func:`extraction_ab_check`).
"""

from __future__ import annotations

import os
import numpy as np
import torch

from pram_tpu_torch.engine.localizer import LocConfig, Localizer, LocResult
from pram_tpu_torch.engine.matching import make_gml_match_fn
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error
from pram_tpu_torch.maps.device import to_device
from pram_tpu_torch.maps.packed import _qvec2rotmat_np
from pram_tpu_torch.maps.rendered import RenderedScene, build_rendered_scene, make_world, query_pose
from pram_tpu_torch.models.convert import load_gml, load_segnetvit, load_sfd2, load_sfd2_int8
from pram_tpu_torch.models.gml import GMLConfig
from pram_tpu_torch.models.segnetvit import SegNetViTConfig
from pram_tpu_torch.models.sfd2 import extract, preprocess_image

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(REPO, "weights")
SFD2_W = os.path.join(WEIGHTS_DIR, "sfd2_rendered.msgpack")
GML_W = os.path.join(WEIGHTS_DIR, "gml_rendered.msgpack")
REC_W = os.path.join(WEIGHTS_DIR, "segnetvit_rendered.msgpack")

WIDTH, HEIGHT = 640, 480
FOCAL = 500.0
N_KPTS = 512
MAP_KPTS = 1024


def render_views(n: int, seed: int, world=None) -> tuple:
    """``n`` query views of the rendered world (``RenderedScene.render_query``
    with ``RandomState(seed)``): images ``[n, H, W, 3]`` f32 in [0, 1],
    qvecs ``[n, 4]`` f64, tvecs ``[n, 3]`` f32 (world-to-camera)."""
    world = world if world is not None else make_world(np.random.RandomState(0))
    scene = RenderedScene(world, (FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2), WIDTH, HEIGHT, None, [])
    rng = np.random.RandomState(seed)
    qs = [scene.render_query(rng) for _ in range(n)]
    return tuple(np.stack([q[k] for q in qs]) for k in ("image", "qvec", "tvec"))


def calibration_views(world=None) -> np.ndarray:
    """The int8 extractor's 4 calibration images ``[4, H, W, 3]`` f32 in [0,
    1]: views at ``query_pose(RandomState(99))``, as the JAX guard renders
    them (``pram_tpu/engine/rendered_guard.py``)."""
    world = world if world is not None else make_world(np.random.RandomState(0))
    rng = np.random.RandomState(99)
    cam = (FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2)
    return np.stack([world.render(*query_pose(rng), cam, WIDTH, HEIGHT) for _ in range(4)]).astype(np.float32)


def load_extractor(device, dtype, int8: bool = False, int8_conv: bool = True):
    """The guard's SFD2: float, or int8 calibrated on :func:`calibration_views`
    (preprocessed in f32) from the weights as cast to ``dtype``."""
    if not int8:
        return load_sfd2(SFD2_W, device=device, dtype=dtype)
    calib = preprocess_image(torch.from_numpy(calibration_views()))
    return load_sfd2_int8(SFD2_W, calib, device=device, dtype=dtype, conv_kernel=int8_conv)


def apply_noise(images: np.ndarray, rng) -> np.ndarray:
    """Eval-time photometric perturbation (brightness/contrast/pixel)."""
    out = np.empty_like(images)
    for i, img in enumerate(images):
        img = img * (1.0 + rng.randn() * 0.05) + rng.randn() * 0.03
        img = img + rng.randn(*img.shape).astype(np.float32) * 0.01
        out[i] = np.clip(img, 0.0, 1.0)
    return out


class RenderedGuard:
    """Loads the three rendered-world models, builds the map on ``device``
    with the port's extractor, and localizes rendered queries.

    ``batch`` is the number of queries a pipeline call takes (and the chunk
    of reference views the map build extracts at once). ``int8`` and the
    three switches as in the module's note; all off is the float guard.
    """

    def __init__(
        self, batch: int = 32, device="cuda", dtype: torch.dtype = torch.bfloat16,
        int8: bool = False, int8_mlp: bool = False, int8_proj: bool = False,
        int8_conv: bool = True,
    ):
        self.batch = batch
        self.device = torch.device(device)
        self.dtype = dtype
        self.int8 = int8
        self.sfd2 = load_extractor(device, dtype, int8, int8_conv)
        self.rec = load_segnetvit(REC_W, SegNetViTConfig(n_class=113), device=device, dtype=dtype)
        self.gml = load_gml(GML_W, GMLConfig(), device=device, dtype=dtype)
        for model in (self.rec, self.gml):
            model.int8_mlp, model.int8_proj = int8_mlp, int8_proj

        def extract_np(images):
            out = [
                self.extract(images[i : i + batch], MAP_KPTS)
                for i in range(0, images.shape[0], batch)
            ]
            kps = [o["keypoints"] for o in out]
            return (
                np.concatenate([k.xy.cpu().numpy() for k in kps]),
                np.concatenate([k.scores.float().cpu().numpy() for k in kps]),
                np.concatenate([o["descriptors"].float().cpu().numpy() for o in out]),
                np.concatenate([k.mask.cpu().numpy() for k in kps]),
            )

        self.scene = build_rendered_scene(
            extract_np, np.random.RandomState(0), width=WIDTH, height=HEIGHT,
            n_ref=12, kp_per_ref=MAP_KPTS, max_ref_points=2048,
        )
        self.n_class = self.scene.map.n_class
        self.cfg = LocConfig(
            seg_k=1, min_inliers=32, threshold=8.0, num_hypotheses=128,
            do_refinement=True, gn_iters=5, lo_rounds=1,
        )
        self.loc = Localizer(
            to_device(self.scene.map, device, desc_dtype=dtype),
            make_gml_match_fn(self.gml, self.gml.config.match_threshold),
            self.cfg,
        )
        cam_p = torch.tensor([FOCAL, FOCAL, WIDTH / 2, HEIGHT / 2, 0, 0, 0, 0]).repeat(batch, 1)
        cam_s = torch.tensor([float(WIDTH), float(HEIGHT)]).repeat(batch, 1)
        self.camera = Camera(cam_p.to(device), cam_s.to(device))

    @torch.no_grad()
    def extract(self, images, max_keypoints: int) -> dict:
        """SFD2 extraction of ``images [B, H, W, 3]`` (numpy or tensor, f32
        in [0, 1]) on the guard's device, at ``conf_th=1e-4``."""
        x = torch.as_tensor(images).to(self.device, torch.float32)
        return extract(
            self.sfd2, preprocess_image(x).to(self.dtype),
            max_keypoints=max_keypoints, conf_th=1e-4,
        )

    @torch.no_grad()
    def front(self, images):
        """images -> the localizer's inputs ``(kpts, scores, descs, mask,
        logits)``: 512 keypoints, SegNetViT on the 256-d tokens at
        ``kpts / [W, H] - 0.5``, logits sliced to the map's classes."""
        feats = self.extract(images, N_KPTS)
        kps = feats["keypoints"]
        norm = kps.xy / torch.tensor([float(WIDTH), float(HEIGHT)], device=self.device) - 0.5
        logits = self.rec(feats["seg_descriptors"], norm, kps.mask)["prediction"]
        return (
            kps.xy,
            kps.scores.float(),
            feats["descriptors"].to(self.dtype),
            kps.mask,
            logits[:, :, : self.n_class].float(),
        )

    @torch.no_grad()
    def pipeline(self, generator: torch.Generator, images):
        """``(front outputs, LocResult)`` for one batch of ``batch`` images;
        ``generator`` (CPU) draws the RANSAC hypotheses."""
        inputs = self.front(images)
        return inputs, self.loc.localize_batch(generator, self.camera, *inputs)

    def recall(
        self, n_queries: int = 128, noise: bool = True, seed: int = 11,
        t_th: float = 0.05, q_th: float = 5.0, px_th: float = 3.0,
    ) -> dict:
        """Localize ``n_queries`` rendered queries (``RandomState(seed)``,
        photometric noise from ``RandomState(seed + 1)``); recall@(t_th,
        q_th), and the share of matched keypoints whose map point reprojects
        through the ground-truth pose within ``px_th`` px."""
        imgs_all, qvecs_all, tvecs_all = render_views(n_queries, seed, self.scene.world)
        if noise:
            imgs_all = apply_noise(imgs_all, np.random.RandomState(seed + 1))
        n_ok = prec_num = prec_den = 0
        t_errs, q_errs = [], []
        for start in range(0, n_queries, self.batch):
            n = min(self.batch, n_queries - start)
            sl = slice(start, start + n)
            imgs, qvecs, tvecs = imgs_all[sl], qvecs_all[sl], tvecs_all[sl]
            if n < self.batch:
                pad = self.batch - n
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            (kxy, _, _, kmask, _), res = self.pipeline(torch.Generator().manual_seed(7 + start), imgs)
            qe, te = compute_pose_error(
                res.qvec[:n].cpu(), res.tvec[:n].cpu(), torch.from_numpy(qvecs).float(),
                torch.from_numpy(tvecs),
            )
            qe, te = qe.numpy(), te.numpy()
            ok = res.success[:n].cpu().numpy() & (te < t_th) & (qe < q_th)
            n_ok += int(ok.sum())
            t_errs.extend(te.tolist())
            q_errs.extend(qe.tolist())
            num, den = match_precision(res, kxy, kmask, qvecs, tvecs, px_th)
            prec_num += num
            prec_den += den
        return {
            "recall": round(n_ok / max(n_queries, 1), 4),
            "n_queries": n_queries,
            "match_precision": round(prec_num / max(prec_den, 1), 4),
            "matches_per_query": round(prec_den / max(n_queries, 1), 1),
            "median_t_err": round(float(np.median(t_errs)), 4),
            "median_q_err": round(float(np.median(q_errs)), 4),
        }


def match_precision(res: LocResult, kxy, kmask, qvecs, tvecs, px_th: float = 3.0):
    """(correct, matched) over the first ``len(qvecs)`` queries: a matched
    keypoint is correct when its map point reprojects through the
    ground-truth pose within ``px_th`` px of it."""
    n = len(qvecs)
    kpi = res.kpt_point_idx[:n].cpu().numpy()
    kxyz = res.kpt_xyz[:n].cpu().numpy().astype(np.float64)
    kxy = kxy[:n].cpu().numpy().astype(np.float64)
    kmask = kmask[:n].cpu().numpy()
    num = den = 0
    for i in range(n):
        matched = (kpi[i] >= 0) & kmask[i]
        if not matched.any():
            continue
        xc = kxyz[i][matched] @ _qvec2rotmat_np(qvecs[i]).T + tvecs[i]
        z = np.clip(xc[:, 2], 1e-6, None)
        uv = np.stack([xc[:, 0] / z * FOCAL + WIDTH / 2, xc[:, 1] / z * FOCAL + HEIGHT / 2], -1)
        err = np.linalg.norm(uv - kxy[i][matched], axis=-1)
        num += int((err < px_th).sum())
        den += int(matched.sum())
    return num, den


def extraction_agreement(fa: dict, fb: dict) -> dict:
    """Keypoint-set agreement (intersection over union of the integer pixel
    sets, averaged over images) and descriptor cosine on the common set of
    two :func:`extract` outputs."""
    agree, desc_cos = [], []
    for i in range(fa["keypoints"].mask.shape[0]):
        sets = []
        for f in (fa, fb):
            m = f["keypoints"].mask[i].cpu().numpy()
            k = f["keypoints"].xy[i].cpu().numpy().astype(np.int64)[m]
            d = f["descriptors"][i].float().cpu().numpy()[m]
            sets.append(({tuple(p): j for j, p in enumerate(k.tolist())}, d))
        (ia, da), (ib, db) = sets
        inter = ia.keys() & ib.keys()
        agree.append(len(inter) / max(len(ia.keys() | ib.keys()), 1))
        desc_cos.extend(float((da[ia[p]] * db[ib[p]]).sum()) for p in inter)
    return {
        "kpt_set_agreement": round(float(np.mean(agree)), 4),
        "desc_cos_min": round(float(np.min(desc_cos)), 4),
        "desc_cos_mean": round(float(np.mean(desc_cos)), 4),
    }


@torch.no_grad()
def extraction_ab_check(
    n_images: int = 4, seed: int = 13, device="cuda", dtype: torch.dtype = torch.bfloat16,
    int8: bool = False,
) -> dict:
    """Kernel path vs plain path of the extractor on the same ``device``, on
    ``n_images`` rendered views: :func:`extraction_agreement`. The float
    extractor's kernel path has the stem and NMS kernels, its plain path the
    unfused ConvBNReLU stem and plain NMS; the int8 extractor's kernel path
    has the stem, conv and NMS kernels, its plain path their plain versions.
    On CUDA tensors this is the only caller that asks for the plain path."""
    model = load_extractor(device, dtype, int8)
    imgs, _, _ = render_views(n_images, seed)
    x = preprocess_image(torch.from_numpy(imgs).to(device)).to(dtype)
    kw = dict(max_keypoints=N_KPTS, conf_th=1e-4)
    fa = extract(model, x, use_nms_kernel=True, **kw)
    if int8:
        model.use_kernels = False
    else:
        model.use_stem_kernel = False
    fb = extract(model, x, use_nms_kernel=False, **kw)
    out = extraction_agreement(fa, fb)
    out["device"] = str(torch.device(device))
    return out
