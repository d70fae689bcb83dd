"""Relocalization evaluation: pose-recall buckets and stage timing
(pram_tpu/engine/evaluator.py).

Rebuild of the reference benchmark path loc_by_rec_eval
(localization/loc_by_rec_eval.py:25-299): stream query frames through
relocalization in fixed-size batches, tally pose errors against the standard
recall buckets, and keep the per-stage time dict {feat, rec, loc, ref,
total} that is the reference's observability surface.

Streaming is double-buffered as in the JAX package: a producer thread pulls
batches (host numpy work only) into a bounded queue, and up to
``pipeline_depth`` localizations stay queued on the device before their
results are read back and tallied. The uploads to the device happen on the
consuming thread.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pram_tpu_torch.engine.localizer import Localizer
from pram_tpu_torch.geometry.camera import Camera
from pram_tpu_torch.geometry.rotations import compute_pose_error

# indoor buckets (loc_by_rec_eval.py:272-279)
INDOOR_BUCKETS = ((0.05, 5.0), (0.25, 2.0), (0.5, 5.0), (5.0, 10.0))
# Aachen/outdoor convention (localizer.py:80)
OUTDOOR_BUCKETS = ((0.25, 2.0), (0.5, 5.0), (5.0, 10.0))


@dataclass
class EvalReport:
    """Aggregate evaluation results."""

    n_total: int = 0
    n_success: int = 0
    bucket_counts: List[int] = field(default_factory=list)
    buckets: Tuple = INDOOR_BUCKETS
    q_errors: List[float] = field(default_factory=list)
    t_errors: List[float] = field(default_factory=list)
    # time_results entries are AMORTIZED wall-clock (interval between drains
    # / batch size), not per-batch device latency; the first drained batch
    # also absorbs the pipeline fill (and the first calls' set-up): its
    # interval is recorded here and excluded by steady_fps()
    time_results: Dict[str, List[float]] = field(
        default_factory=lambda: {
            "feat": [], "rec": [], "loc": [], "ref": [], "total": []
        }
    )
    warmup_time: float = 0.0
    warmup_frames: int = 0
    failed_cases: List[str] = field(default_factory=list)

    def recall(self) -> Dict[str, float]:
        n = max(self.n_total, 1)
        out = {}
        for (t_th, q_th), c in zip(self.buckets, self.bucket_counts):
            out[f"{t_th}m/{q_th}deg"] = c / n
        return out

    def fps(self) -> float:
        tot = sum(self.time_results["total"])
        return self.n_total / tot if tot > 0 else 0.0

    def steady_fps(self) -> float:
        """Throughput excluding the warm-up drain (pipeline fill)."""
        tot = sum(self.time_results["total"]) - self.warmup_time
        n = self.n_total - self.warmup_frames
        return n / tot if tot > 0 and n > 0 else self.fps()

    def summary(self) -> str:
        rec = ", ".join(
            f"{k}: {v * 100:.1f}%" for k, v in self.recall().items()
        )
        med_q = np.median(self.q_errors) if self.q_errors else float("nan")
        med_t = np.median(self.t_errors) if self.t_errors else float("nan")
        lines = [
            f"total {self.n_total}, success {self.n_success}",
            f"recall: {rec}",
            f"median err: {med_t:.3f}m / {med_q:.2f}deg",
            f"throughput: {self.fps():.1f} frames/sec",
        ]
        for k, v in self.time_results.items():
            if v:
                lines.append(f"time[{k}]: {np.mean(v) * 1000:.2f} ms/frame")
        return "\n".join(lines)


def evaluate_queries(
    localizer: Localizer,
    batches: Iterable[Dict],
    buckets=INDOOR_BUCKETS,
    generator: Optional[torch.Generator] = None,
    log_fn=print,
    log_interval: int = 10,
    pipeline_depth: int = 2,
    prefetch: int = 2,
    method: str = "plain",
    prepare: Optional[Callable[[Dict], Dict]] = None,
) -> EvalReport:
    """Run the engine over batched queries and tally recall.

    Each batch dict: camera_params [B,8], camera_size [B,2], keypoints
    [B,N,2], scores [B,N], descriptors [B,N,D], mask [B,N], seg_logits
    [B,N,C], gt_qvec [B,4], gt_tvec [B,3], names (list, optional), as numpy
    arrays or tensors. ``prepare`` (optional) runs on the consuming thread on
    each batch before its dispatch: work that touches the device, such as
    recognition filling in ``seg_logits``. Set ``pipeline_depth=0,
    prefetch=0`` for the fully synchronous loop.

    ``generator`` (a CPU ``torch.Generator``, seeded 0 by default) draws
    every batch's RANSAC hypotheses in turn, where the JAX package splits a
    key per batch. ``method``: "plain" (localize_batch), "adaptive" (one
    candidate first, the full sweep only when a frame fails) or
    "auto_refine".
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    report = EvalReport(buckets=buckets, bucket_counts=[0] * len(buckets))
    device = localizer.dmap.point_xyz.device

    if prefetch > 0:
        q: _queue.Queue = _queue.Queue(maxsize=prefetch)

        def _produce():
            # a failed iterable (e.g. unreadable feature file) must not look
            # like a normal end-of-stream: ship the exception to the consumer
            try:
                for item in batches:
                    q.put(item)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                q.put(exc)
            else:
                q.put(None)

        threading.Thread(target=_produce, daemon=True).start()

        def batch_iter():
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        source = batch_iter()
    else:
        source = iter(batches)

    t_last = time.perf_counter()
    inflight = collections.deque()

    def drain(entry):
        nonlocal t_last
        bidx, names, res, qe_d, te_d = entry
        qe = qe_d.cpu().numpy()
        te = te_d.cpu().numpy()
        success = res.success.cpu().numpy()
        now = time.perf_counter()
        dt = now - t_last
        t_last = now
        b = qe.shape[0]
        if report.warmup_frames == 0:
            # first drain: interval includes the pipeline fill
            report.warmup_time = dt
            report.warmup_frames = b
        names = names if names is not None else [
            f"b{bidx}_{i}" for i in range(b)
        ]
        for i in range(b):
            report.n_total += 1
            report.time_results["total"].append(dt / b)
            report.time_results["loc"].append(dt / b)
            if success[i]:
                report.n_success += 1
                report.q_errors.append(float(qe[i]))
                report.t_errors.append(float(te[i]))
                for j, (t_th, q_th) in enumerate(buckets):
                    if te[i] <= t_th and qe[i] <= q_th:
                        report.bucket_counts[j] += 1
            else:
                report.failed_cases.append(names[i])
                report.q_errors.append(180.0)
                report.t_errors.append(float("inf"))
        if log_fn is not None and (bidx + 1) % log_interval == 0:
            log_fn(
                f"[{report.n_total}] "
                + ", ".join(
                    f"{v * 100:.1f}%" for v in report.recall().values()
                )
            )

    attr = {
        "plain": "localize_batch",
        "adaptive": "localize_batch_adaptive",
        "auto_refine": "localize_batch_auto_refine",
    }[method]
    dispatch = getattr(localizer, attr)

    f32, desc_dtype = torch.float32, localizer.dmap.point_desc.dtype

    def up(x, dtype):
        return torch.as_tensor(x).to(device, dtype)

    for bidx, batch in enumerate(source):
        if prepare is not None:
            batch = prepare(batch)
        res = dispatch(
            generator,
            Camera(up(batch["camera_params"], f32), up(batch["camera_size"], f32)),
            up(batch["keypoints"], f32),
            up(batch["scores"], f32),
            up(batch["descriptors"], desc_dtype),
            up(batch["mask"], torch.bool),
            up(batch["seg_logits"], f32),
        )
        # pose errors computed on the device, queued behind the localization
        qe_d, te_d = compute_pose_error(
            res.qvec, res.tvec, up(batch["gt_qvec"], f32), up(batch["gt_tvec"], f32)
        )
        inflight.append((bidx, batch.get("names"), res, qe_d, te_d))
        while len(inflight) > pipeline_depth:
            drain(inflight.popleft())

    while inflight:
        drain(inflight.popleft())
    return report
