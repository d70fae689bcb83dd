"""Stage timers (pram_tpu/core/profiling.py).

The reference's observability is per-stage wall clock dicts
(loc_by_rec_eval.py:78-84,259-268, frame.py:63-66); here the same
stage-time dict is a context-manager API. On a CUDA device every stage
ends with ``torch.cuda.synchronize``, so a stage's time is the card's work,
not the time to queue its launches.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall-clock per named stage (feat/rec/loc/ref/total).

    ``device``: the device the stages run on; a CUDA device is synchronized
    at the end of every stage.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.times: Dict[str, list] = defaultdict(list)
        self.device = torch.device(device) if device is not None else None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[name].append(time.perf_counter() - t0)

    def means_ms(self) -> Dict[str, float]:
        return {
            k: 1000.0 * sum(v) / max(len(v), 1)
            for k, v in self.times.items()
        }

    def summary(self) -> str:
        return ", ".join(
            f"{k}={v:.2f}ms" for k, v in self.means_ms().items()
        )
