"""Batched hierarchical relocalization over device maps (pram_tpu/engine/localizer.py).

All ``seg_k`` candidate landmarks of every query are matched and PnP-solved
together, then the first candidate in recognition-rank order that clears the
inlier gate is taken. Stages, each written with an explicit batch axis B:

  1. background pre-filter (mask instead of drop)
  2. segment ranking (closed form)
  3. semantic consistency gate (histograms)
  4. batched matching against the candidates' VRF keypoint tables
  5. batched PnP / RANSAC (geometry/pnp.py)
  6. candidate selection
  7. refinement, by projection (default): the chosen landmark's covisible
     points are projected with the first pose, matched to the query by a
     gated top-2 nearest neighbour (``ops/refine.py``), and PnP runs again;
     or by matching (``refinement_method="matching"``): the query is matched
     against the chosen landmark's covisible frames in one matcher call,
     and one RANSAC runs over all their correspondences stacked

``Localizer`` also has the reference's two-pass forms: auto refinement
(matching refinement only for frames with few first-stage inliers) and the
adaptive step (one candidate first, the full sweep only when a frame fails).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pram_tpu_torch.geometry.camera import Camera, project
from pram_tpu_torch.geometry.pnp import ransac_pnp
from pram_tpu_torch.geometry.rotations import rotmat2qvec
from pram_tpu_torch.maps.device import DeviceMap
from pram_tpu_torch.ops.refine import refine_nn


@dataclass(frozen=True)
class LocConfig:
    """Localization hyperparameters (as pram_tpu's LocConfig)."""

    seg_k: int = 10
    n_rank: int = 4
    min_kpts: int = 128
    min_matches: int = 4
    min_inliers: int = 32
    threshold: float = 8.0
    do_refinement: bool = True
    semantic_matching: bool = True
    pre_filtering_th: float = 0.95
    num_hypotheses: int = 256
    gn_iters: int = 8
    lo_rounds: int = 2
    match_threshold: float = 0.2  # matcher mutual-max gate (read by the match_fn's maker)
    projection_ratio: float = 0.995  # refinement NN ratio test
    refinement_method: str = "projection"  # 'projection' | 'matching'
    covisibility_frame: int = 20  # covisible frames matching refinement uses
    max_vrf_kpts: Optional[int] = None  # the reference's cap of matcher tokens; read by nothing


def normalize_kpts_like_reference(kpts, width, height):
    """Keypoint normalization with the reference's swapped-axis convention:
    center (H/2, W/2), scale 0.7 * max(W, H). ``width``/``height`` ``[...]``
    broadcast over ``kpts [..., N, 2]``."""
    size = torch.stack([height, width], dim=-1)[..., None, :]
    center = size / 2.0
    scaling = size.amax(dim=-1, keepdim=True) * 0.7
    return (kpts - center) / scaling


def rank_segments(logits, mask, *, seg_k: int, n_rank: int = 4):
    """Rank candidate landmarks from per-keypoint recognition logits.

    Every class's priority is (first recognition rank at which a keypoint
    votes for it, then its vote count at that rank, descending); background
    (class 0) is excluded and returned sids are map segment ids (class - 1).

    Args:
      logits: ``[B, N, C]``; mask: ``[B, N]``.

    Returns:
      (sids ``[B, seg_k]`` (-1 invalid), kpt_masks ``[B, seg_k, N]``,
       valid ``[B, seg_k]``).
    """
    b, n, c = logits.shape
    r = min(n_rank, c)
    ids = torch.topk(logits, r, dim=-1).indices  # [B, N, R]
    onehot = F.one_hot(ids, c) * mask[:, :, None, None].to(torch.int64)
    counts = onehot.sum(dim=1)  # [B, R, C]
    has = counts > 0
    first_rank = torch.argmax(has.to(torch.int32), dim=1)  # [B, C]
    any_rank = has.any(dim=1)
    cnt_first = torch.gather(counts, 1, first_rank[:, None])[:, 0]  # [B, C]

    big = 2**30
    n_plus = n + 1
    key = first_rank * n_plus + (n_plus - 1 - cnt_first)
    cls = torch.arange(c, device=logits.device)
    key = torch.where(any_rank & (cls > 0)[None], key, big)
    order = torch.argsort(key, dim=-1, stable=True)[:, :seg_k]  # [B, seg_k]
    valid = torch.gather(key, 1, order) < big

    r_of = torch.gather(first_rank, 1, order)  # [B, seg_k]
    ids_t = ids.transpose(1, 2)  # [B, R, N]
    voted = torch.gather(ids_t, 1, r_of[:, :, None].expand(-1, -1, n))
    kpt_masks = (voted == order[:, :, None]) & mask[:, None]
    sids = torch.where(valid, order - 1, -1)
    return sids, kpt_masks, valid


def _histogram(sids, valid, n_seg):
    """Per-segment counts ``[..., n_seg]`` of ``sids [..., N]`` where valid."""
    oh = F.one_hot(torch.clamp(sids, 0, n_seg - 1), n_seg)
    return (oh * (valid & (sids >= 0))[..., None].to(oh.dtype)).sum(dim=-2)


def _semantic_consistency(q_sids, q_mask, ref_sids, ref_mask, n_seg, overlap_ratio=0.5):
    """check_semantic_consistency via histograms.

    q_sids/q_mask ``[B, N]``; ref_sids/ref_mask ``[B, S, K]`` -> ``[B, S]``.
    """
    q_hist = _histogram(q_sids, q_mask, n_seg)[:, None]  # [B, 1, n_seg]
    r_hist = _histogram(ref_sids, ref_mask, n_seg)  # [B, S, n_seg]
    both = (q_hist > 0) & (r_hist > 0)
    overlap_q = torch.where(both, q_hist, 0).sum(-1)
    overlap_r = torch.where(both, r_hist, 0).sum(-1)
    nq = torch.clamp(q_mask.sum(-1, keepdim=True), min=1)
    nr = torch.clamp(ref_mask.sum(-1), min=1)
    return torch.minimum(overlap_q / nq, overlap_r / nr) >= overlap_ratio


class LocResult(NamedTuple):
    """Per-query localization output, batched ``[B, ...]``."""

    qvec: torch.Tensor  # [B, 4]
    tvec: torch.Tensor  # [B, 3]
    R: torch.Tensor  # [B, 3, 3]
    success: torch.Tensor  # [B] bool
    num_inliers: torch.Tensor  # [B] int32
    matched_order: torch.Tensor  # [B] candidate rank that succeeded (-1 fail)
    matched_sid: torch.Tensor  # [B] accepted landmark id (-1 fail)
    initial_num_inliers: torch.Tensor  # [B]
    kpt_point_idx: torch.Tensor  # [B, N] index into map points (-1 invalid)
    kpt_xyz: torch.Tensor  # [B, N, 3]


MatchFn = Callable[..., torch.Tensor]


class VrfTables(NamedTuple):
    """Gathered per-candidate VRF keypoint tables ``[B, S, K, ...]``."""

    pt_idx: torch.Tensor
    uv: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor
    xyz: torch.Tensor
    desc: torch.Tensor
    sids: torch.Tensor
    w: torch.Tensor  # [B, S]
    h: torch.Tensor  # [B, S]


class RefineSet(NamedTuple):
    """Gathered covisible-point set for projection refinement ``[B, Pr, ...]``."""

    pt_idx: torch.Tensor  # [B, Pr] (-1 invalid)
    xyz: torch.Tensor  # [B, Pr, 3]
    desc: torch.Tensor  # [B, Pr, D]


class CoreResult(NamedTuple):
    """Pre-refinement localization state (steps 1-6), batched."""

    R0: torch.Tensor
    t0: torch.Tensor
    inl0: torch.Tensor
    any_ok: torch.Tensor
    pick: torch.Tensor
    picked_slot: torch.Tensor
    picked_sid: torch.Tensor
    kpt_point_idx: torch.Tensor
    kpt_xyz: torch.Tensor


class RankResult(NamedTuple):
    """Candidate routing state (steps 1-2), batched."""

    mask: torch.Tensor  # [B, N] post-prefilter keypoint validity
    q_sids: torch.Tensor  # [B, N]
    sids: torch.Tensor  # [B, S]
    kpt_masks: torch.Tensor  # [B, S, N]
    cand_valid: torch.Tensor  # [B, S]
    safe_slots: torch.Tensor  # [B, S]
    frames: torch.Tensor  # [B, S]


def rank_candidates(seg_vrf_slot, vrf_frame_idx, seg_logits, mask, cfg: LocConfig) -> RankResult:
    """Steps 1-2: background pre-filter + candidate landmark ranking."""
    n_seg = seg_vrf_slot.shape[0]
    if cfg.pre_filtering_th > 0:
        seg_scores = torch.softmax(seg_logits.float(), dim=-1)
        non_bg = seg_scores[..., 0] < cfg.pre_filtering_th
        enough = (non_bg & mask).sum(-1) >= 0.4 * mask.sum(-1)
        mask = torch.where(enough[:, None], mask & non_bg, mask)

    q_sids = torch.argmax(seg_logits, dim=-1) - 1
    sids, kpt_masks, cand_valid = rank_segments(
        seg_logits, mask, seg_k=cfg.seg_k, n_rank=cfg.n_rank
    )
    slots = torch.where(
        sids >= 0, seg_vrf_slot[torch.clamp(sids, 0, n_seg - 1)], -1
    )
    cand_valid = cand_valid & (slots >= 0)
    safe_slots = torch.clamp(slots, 0, vrf_frame_idx.shape[0] - 1)
    frames = vrf_frame_idx[safe_slots]
    return RankResult(mask, q_sids, sids, kpt_masks, cand_valid, safe_slots, frames)


def gather_vrf_tables(dmap: DeviceMap, frames: torch.Tensor) -> VrfTables:
    """Plain-indexing VRF table gather. frames ``[...]``."""
    ref_pt_idx = dmap.frame_point_idx[frames]
    safe_pt = torch.clamp(ref_pt_idx, 0, dmap.point_xyz.shape[0] - 1)
    size = dmap.frame_size[frames]
    return VrfTables(
        pt_idx=ref_pt_idx,
        uv=dmap.frame_kp_uv[frames],
        score=dmap.frame_kp_score[frames],
        mask=dmap.frame_kp_mask[frames],
        xyz=dmap.point_xyz[safe_pt],
        desc=dmap.point_desc[safe_pt],
        sids=torch.where(ref_pt_idx >= 0, dmap.point_seg[safe_pt], -1),
        w=size[..., 0],
        h=size[..., 1],
    )


def gather_refine_set(dmap: DeviceMap, slot: torch.Tensor) -> RefineSet:
    """Plain-indexing projection-refinement point set of VRF slots ``[B]``."""
    pt_idx = dmap.vrf_ref_point_idx[slot]
    safe = torch.clamp(pt_idx, 0, dmap.point_xyz.shape[0] - 1)
    return RefineSet(pt_idx=pt_idx, xyz=dmap.point_xyz[safe], desc=dmap.point_desc[safe])


def match_pnp_core(
    match_fn: MatchFn,
    camera: Camera,  # params [B, 8], size [B, 2]
    kpts: torch.Tensor,  # [B, N, 2]
    scores: torch.Tensor,  # [B, N]
    descs: torch.Tensor,  # [B, N, D]
    rank: RankResult,
    tabs: VrfTables,  # [B, S, K, ...]
    n_seg: int,
    cfg: LocConfig,
    generator: Optional[torch.Generator] = None,
    triplets: Optional[torch.Tensor] = None,
) -> CoreResult:
    """Steps 3-6: semantic gate, batched matching, batched PnP, selection.

    RANSAC draws its hypotheses from ``generator`` (a CPU generator) unless
    ``triplets [B * S, num_hypotheses, 3]`` are given.
    """
    b, n = kpts.shape[:2]
    s = cfg.seg_k
    mask = rank.mask
    ref_mask = tabs.mask & rank.cand_valid[..., None]

    if cfg.semantic_matching:
        consistent = _semantic_consistency(rank.q_sids, mask, tabs.sids, ref_mask, n_seg)
        enough_kpts = rank.kpt_masks.sum(-1) >= cfg.min_kpts
        use_sem = consistent & enough_kpts & (rank.sids >= 0)
        q_mask_c = torch.where(use_sem[..., None], rank.kpt_masks & mask[:, None], mask[:, None])
        ref_mask_c = torch.where(
            use_sem[..., None], ref_mask & (tabs.sids == rank.sids[..., None]), ref_mask
        )
    else:
        q_mask_c = mask[:, None].expand(-1, s, -1)
        ref_mask_c = ref_mask

    nk0 = normalize_kpts_like_reference(kpts, camera.size[:, 0], camera.size[:, 1])
    nk1 = normalize_kpts_like_reference(tabs.uv, tabs.w, tabs.h)

    def flat(t):
        return t.reshape((b * s,) + t.shape[2:])

    def rep(t):
        return flat(t[:, None].expand((b, s) + t.shape[1:]))

    matches = match_fn(
        rep(descs), rep(nk0), rep(scores), flat(q_mask_c),
        flat(tabs.desc), flat(nk1), flat(tabs.score), flat(ref_mask_c),
    ).reshape(b, s, n)

    m_valid = matches >= 0
    safe_m = torch.clamp(matches, 0, tabs.xyz.shape[2] - 1)
    m_xyz = torch.gather(tabs.xyz, 2, safe_m[..., None].expand(-1, -1, -1, 3))
    m_pt_idx = torch.where(m_valid, torch.gather(tabs.pt_idx, 2, safe_m), -1)
    enough_matches = m_valid.sum(-1) >= cfg.min_matches

    cam_p = rep(camera.params)
    pnp = ransac_pnp(
        Camera(cam_p, rep(camera.size)),
        rep(kpts + 0.5),  # the reference adds the half-pixel COLMAP offset
        flat(m_xyz).float().contiguous(),
        flat(m_valid).contiguous(),
        generator=generator,
        triplets=triplets,
        inlier_threshold=cfg.threshold,
        num_hypotheses=cfg.num_hypotheses,
        min_inliers=cfg.min_inliers,
        gn_iters=cfg.gn_iters,
        lo_rounds=cfg.lo_rounds,
    )
    pnp_R = pnp.R.reshape(b, s, 3, 3)
    pnp_t = pnp.t.reshape(b, s, 3)
    pnp_n = pnp.num_inliers.reshape(b, s)
    pnp_inl = pnp.inliers.reshape(b, s, n)

    ok = pnp.success.reshape(b, s) & rank.cand_valid & enough_matches
    order_idx = torch.arange(s, device=kpts.device)[None]
    pick = torch.argmin(torch.where(ok, order_idx, s), dim=1)
    any_ok = ok.any(dim=1)
    best_by_inl = torch.argmax(torch.where(rank.cand_valid, pnp_n, -1), dim=1)
    pick = torch.where(any_ok, pick, best_by_inl)

    ar = torch.arange(b, device=kpts.device)
    return CoreResult(
        R0=pnp_R[ar, pick],
        t0=pnp_t[ar, pick],
        inl0=pnp_n[ar, pick],
        any_ok=any_ok,
        pick=pick,
        picked_slot=rank.safe_slots[ar, pick],
        picked_sid=torch.where(any_ok, rank.sids[ar, pick], -1),
        kpt_point_idx=torch.where(pnp_inl[ar, pick], m_pt_idx[ar, pick], -1),
        kpt_xyz=m_xyz[ar, pick],
    )


def project_refine_set(camera: Camera, rset: RefineSet, R0, t0):
    """Pixels ``[B, Pr, 2]`` of the refinement points under the first pose,
    and whether each is a real point in front of the camera (0 < z < 100)
    and inside the image ``[B, Pr]``."""
    uv, z = project(camera, R0, t0, rset.xyz.float())
    w = camera.size[:, 0:1]
    h = camera.size[:, 1:2]
    in_img = (
        (z > 0) & (z < 100.0)
        & (uv[..., 0] >= 0) & (uv[..., 0] < w)
        & (uv[..., 1] >= 0) & (uv[..., 1] < h)
        & (rset.pt_idx >= 0)
    )
    return uv.contiguous(), in_img.contiguous()


def refine_projection_core(
    camera: Camera,  # params [B, 8], size [B, 2]
    kpts: torch.Tensor,  # [B, N, 2]
    descs: torch.Tensor,  # [B, N, D]
    mask: torch.Tensor,  # [B, N]
    rset: RefineSet,
    R0: torch.Tensor,  # [B, 3, 3]
    t0: torch.Tensor,  # [B, 3]
    cfg: LocConfig,
    generator: Optional[torch.Generator] = None,
    triplets: Optional[torch.Tensor] = None,
):
    """Projection refinement on a pre-gathered covisible point set.

    Returns ``(R, t, num_inliers, success, kpt_point_idx, matched_xyz)``.
    RANSAC draws from ``generator`` unless ``triplets [B, num_hypotheses, 3]``
    are given.
    """
    pt_idx = rset.pt_idx
    xyz = rset.xyz.float()
    uv, in_img = project_refine_set(camera, rset, R0, t0)
    # gated top-2 NN; the similarity accumulates in f32, which the 0.995
    # ratio test needs (bf16 sums flip it)
    nn_idx, _, keep = refine_nn(
        descs.contiguous(), rset.desc.contiguous(), kpts.float().contiguous(),
        uv, in_img, mask.contiguous(), 2.0 * cfg.threshold, cfg.projection_ratio,
    )
    m_xyz = torch.gather(xyz, 1, nn_idx[..., None].expand(-1, -1, 3))
    m_pt_idx = torch.where(keep, torch.gather(pt_idx, 1, nn_idx), -1)
    res = ransac_pnp(
        camera,
        kpts + 0.5,
        m_xyz.contiguous(),
        keep.contiguous(),
        generator=generator,
        triplets=triplets,
        inlier_threshold=cfg.threshold,
        num_hypotheses=cfg.num_hypotheses,
        min_inliers=cfg.min_inliers,
        gn_iters=cfg.gn_iters,
        lo_rounds=cfg.lo_rounds,
    )
    kpt_point_idx = torch.where(res.inliers, m_pt_idx, -1)
    return res.R, res.t, res.num_inliers, res.success, kpt_point_idx, m_xyz


def _refine_by_projection(
    dmap: DeviceMap, camera: Camera, kpts, descs, mask, slot, R0, t0, cfg: LocConfig,
    generator: Optional[torch.Generator] = None, triplets: Optional[torch.Tensor] = None,
):
    """refine_pose_by_projection (singlemap3d.py:367-498): the precomputed
    covisible point set of each frame's VRF slot ``[B]`` is projected with
    the first pose, matched to the query by the gated top-2 NN and ratio
    test, and PnP runs again (:func:`refine_projection_core`)."""
    return refine_projection_core(
        camera, kpts, descs, mask, gather_refine_set(dmap, slot), R0, t0, cfg, generator, triplets
    )


def gather_covis_tables(dmap: DeviceMap, slot: torch.Tensor, cfg: LocConfig):
    """The first ``covisibility_frame`` covisible frames of VRF slots ``[B]``:
    (valid ``[B, C]``, their tables ``[B, C, K, ...]``)."""
    covis = dmap.vrf_covis[slot][:, : cfg.covisibility_frame]
    frames = torch.clamp(covis, 0, dmap.frame_point_idx.shape[0] - 1)
    return covis >= 0, gather_vrf_tables(dmap, frames)


def refine_matching_core(
    match_fn: MatchFn,
    camera: Camera,  # params [B, 8], size [B, 2]
    kpts: torch.Tensor,  # [B, N, 2]
    scores: torch.Tensor,  # [B, N]
    descs: torch.Tensor,  # [B, N, D]
    mask: torch.Tensor,  # [B, N]
    cvalid: torch.Tensor,  # [B, C]
    tabs: VrfTables,  # [B, C, K, ...]
    cfg: LocConfig,
    generator: Optional[torch.Generator] = None,
    triplets: Optional[torch.Tensor] = None,
):
    """Matching refinement on pre-gathered covisible frame tables.

    One matcher call over the ``B * C`` (query, frame) pairs; each query's
    ``C * N`` matches are stacked (a keypoint once per frame, with the
    half-pixel offset) into one RANSAC problem, and each keypoint takes the
    first frame whose match is an inlier. Returns ``(R, t, num_inliers,
    success, kpt_point_idx, kpt_xyz)``. RANSAC draws from ``generator``
    unless ``triplets [B, num_hypotheses, 3]`` are given.
    """
    b, n = kpts.shape[:2]
    c = cvalid.shape[1]
    ref_mask = tabs.mask & cvalid[..., None]
    nk0 = normalize_kpts_like_reference(kpts, camera.size[:, 0], camera.size[:, 1])
    nk1 = normalize_kpts_like_reference(tabs.uv, tabs.w, tabs.h)

    def flat(t):
        return t.reshape((b * c,) + t.shape[2:])

    def rep(t):
        return flat(t[:, None].expand((b, c) + t.shape[1:]))

    matches = match_fn(
        rep(descs), rep(nk0), rep(scores), rep(mask),
        flat(tabs.desc), flat(nk1), flat(tabs.score), flat(ref_mask),
    ).reshape(b, c, n)

    m_valid = (matches >= 0) & mask[:, None]
    safe_m = torch.clamp(matches, 0, tabs.xyz.shape[2] - 1)
    m_xyz = torch.gather(tabs.xyz, 2, safe_m[..., None].expand(-1, -1, -1, 3))  # [B, C, N, 3]
    m_pt = torch.where(m_valid, torch.gather(tabs.pt_idx, 2, safe_m), -1)

    res = ransac_pnp(
        camera,
        (kpts + 0.5)[:, None].expand(b, c, n, 2).reshape(b, c * n, 2),
        m_xyz.reshape(b, c * n, 3).float().contiguous(),
        m_valid.reshape(b, c * n),
        generator=generator,
        triplets=triplets,
        inlier_threshold=cfg.threshold,
        num_hypotheses=cfg.num_hypotheses,
        min_inliers=cfg.min_inliers,
        gn_iters=cfg.gn_iters,
        lo_rounds=cfg.lo_rounds,
    )
    inl = res.inliers.reshape(b, c, n)
    pick_c = torch.argmax(inl.to(torch.int32), dim=1)  # the first inlier frame
    has = inl.any(dim=1)
    kpt_point_idx = torch.where(has, torch.gather(m_pt, 1, pick_c[:, None])[:, 0], -1)
    kpt_xyz = torch.gather(m_xyz, 1, pick_c[:, None, :, None].expand(-1, 1, -1, 3))[:, 0]
    return res.R, res.t, res.num_inliers, res.success, kpt_point_idx, kpt_xyz


def finalize_result(core: CoreResult, refinement: Optional[Tuple] = None) -> LocResult:
    """Step 7 merge + output packing.

    ``refinement`` is ``(R, t, num_inliers, ok, kpt_point_idx, kpt_xyz)``
    of :func:`refine_projection_core` or :func:`refine_matching_core`; its
    pose is taken where it succeeded and the first stage did too.
    """
    R_fin, t_fin, inl_fin = core.R0, core.t0, core.inl0
    kpt_point_idx, kpt_xyz = core.kpt_point_idx, core.kpt_xyz
    if refinement is not None:
        Rr, tr, inl_r, ref_ok, r_pt_idx, r_xyz = refinement
        use = ref_ok & core.any_ok
        R_fin = torch.where(use[:, None, None], Rr, R_fin)
        t_fin = torch.where(use[:, None], tr, t_fin)
        inl_fin = torch.where(use, inl_r, inl_fin)
        kpt_point_idx = torch.where(use[:, None], r_pt_idx, kpt_point_idx)
        kpt_xyz = torch.where(use[:, None, None], r_xyz, kpt_xyz)
    return LocResult(
        qvec=rotmat2qvec(R_fin),
        tvec=t_fin,
        R=R_fin,
        success=core.any_ok,
        num_inliers=inl_fin,
        matched_order=torch.where(core.any_ok, core.pick, -1),
        matched_sid=core.picked_sid,
        initial_num_inliers=core.inl0,
        kpt_point_idx=kpt_point_idx,
        kpt_xyz=kpt_xyz,
    )


def merge_results(take_first: torch.Tensor, first: LocResult, second: LocResult) -> LocResult:
    """Per frame: ``first``'s fields where ``take_first [B]``, else ``second``'s."""
    return LocResult(*(
        torch.where(take_first.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        for a, b in zip(first, second)
    ))


class Localizer:
    """Device map + matcher + batched localization step."""

    def __init__(self, dmap: DeviceMap, match_fn: MatchFn, cfg: LocConfig):
        if cfg.refinement_method not in ("projection", "matching"):
            raise ValueError(f"unknown refinement_method {cfg.refinement_method!r}")
        self.dmap = dmap
        self.match_fn = match_fn
        self.cfg = cfg

    @torch.no_grad()
    def localize_batch(
        self, generator: torch.Generator, camera: Camera, kpts, scores, descs,
        mask, seg_logits, triplets: Optional[torch.Tensor] = None,
        refine_triplets: Optional[torch.Tensor] = None,
    ) -> LocResult:
        """Localize a batch: camera ``[B, ...]``, arrays ``[B, N, ...]``.

        ``generator`` is a CPU ``torch.Generator``; it draws the RANSAC
        hypotheses, so one seed gives the same triplets on every device.
        ``triplets [B * seg_k, H, 3]`` fix the first RANSAC's hypotheses and
        ``refine_triplets [B, H, 3]`` the refinement's.
        """
        n_seg = self.dmap.seg_vrf_slot.shape[0]
        rank = rank_candidates(
            self.dmap.seg_vrf_slot, self.dmap.vrf_frame_idx, seg_logits, mask, self.cfg
        )
        tabs = gather_vrf_tables(self.dmap, rank.frames)
        core = match_pnp_core(
            self.match_fn, camera, kpts, scores, descs, rank, tabs, n_seg,
            self.cfg, generator=generator, triplets=triplets,
        )
        refinement = None
        if self.cfg.do_refinement and self.cfg.refinement_method == "matching":
            # refine_pose_by_matching against the chosen landmark's covisible frames
            cvalid, ctabs = gather_covis_tables(self.dmap, core.picked_slot, self.cfg)
            refinement = refine_matching_core(
                self.match_fn, camera, kpts, scores, descs, rank.mask, cvalid, ctabs,
                self.cfg, generator, refine_triplets,
            )
        elif self.cfg.do_refinement:
            # refine_pose_by_projection on the chosen landmark's VRF
            refinement = _refine_by_projection(
                self.dmap, camera, kpts, descs, rank.mask, core.picked_slot, core.R0, core.t0,
                self.cfg, generator, refine_triplets,
            )
        return finalize_result(core, refinement)

    @torch.no_grad()
    def localize_batch_auto_refine(
        self, generator: torch.Generator, camera: Camera, kpts, scores, descs,
        mask, seg_logits, trust_inliers: int = 64,
        triplets: Optional[Tuple] = None, rerun_triplets: Optional[Tuple] = None,
    ) -> LocResult:
        """Auto refinement (the reference's multimap3d.py:251-255): the
        projection refinement's result is kept for frames whose first stage
        found >= ``trust_inliers`` inliers; if some frame found fewer, the
        whole batch reruns with matching refinement and those frames take
        the rerun's result.

        Whether the rerun is needed is decided by one host read of a bool
        (a synchronize), as pram_tpu decides it for a sharded map; pram_tpu's
        replicated map keeps it on the device with ``lax.cond``. The rerun
        draws its hypotheses from ``generator`` after the first pass's, or
        from ``rerun_triplets``; ``triplets`` and ``rerun_triplets`` are each
        ``(triplets, refine_triplets)`` of :meth:`localize_batch`.
        """
        first = self.localize_batch(generator, camera, kpts, scores, descs, mask, seg_logits,
                                    *(triplets or ()))
        trusted = first.initial_num_inliers >= trust_inliers
        if self.cfg.refinement_method == "matching" or bool(trusted.all()):
            return first
        by_matching = Localizer(self.dmap, self.match_fn,
                                dataclasses.replace(self.cfg, refinement_method="matching"))
        rerun = by_matching.localize_batch(generator, camera, kpts, scores, descs, mask, seg_logits,
                                           *(rerun_triplets or ()))
        return merge_results(trusted, first, rerun)

    @torch.no_grad()
    def localize_batch_adaptive(
        self, generator: torch.Generator, camera: Camera, kpts, scores, descs,
        mask, seg_logits, triplets: Optional[Tuple] = None,
        rerun_triplets: Optional[Tuple] = None,
    ) -> LocResult:
        """Two-phase early exit (the reference's multimap3d.py:114-239): a
        pass over the top-ranked landmark only (``seg_k = 1``); if some frame
        fails it, the full ``seg_k`` sweep runs on the batch and the failed
        frames take its result.

        Whether the sweep is needed is decided by one host read of a bool
        (a synchronize), as pram_tpu decides it for a sharded map; pram_tpu's
        replicated map keeps it on the device with ``lax.cond``. The sweep
        draws its hypotheses from ``generator`` after the first pass's, or
        from ``rerun_triplets``; ``triplets`` and ``rerun_triplets`` are each
        ``(triplets, refine_triplets)`` of :meth:`localize_batch`.
        """
        top1 = Localizer(self.dmap, self.match_fn, dataclasses.replace(self.cfg, seg_k=1))
        first = top1.localize_batch(generator, camera, kpts, scores, descs, mask, seg_logits, *(triplets or ()))
        if self.cfg.seg_k == 1 or bool(first.success.all()):
            return first
        sweep = self.localize_batch(generator, camera, kpts, scores, descs, mask, seg_logits,
                                    *(rerun_triplets or ()))
        return merge_results(first.success, first, sweep)
