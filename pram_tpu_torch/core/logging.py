"""Training/eval observability: text log + TensorBoard + JSONL metrics
(pram_tpu/core/logging.py).

The reference's logging surface (trainer.py:85-87,224-252: tensorboard
scalars, an append-mode log.txt, a run-name tag from the hyperparameters)
with a machine-readable metrics.jsonl beside it. TensorBoard is optional,
as in the JAX package: without ``tensorboard`` the text and JSONL files
are written all the same.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Any, Dict


class MetricsLogger:
    """``log.txt`` (appended, echoed to stdout), ``metrics.jsonl`` (one
    record a call: step, wall time, scalars) and, where TensorBoard imports,
    its scalars under ``tb/``."""

    def __init__(self, save_dir: str, use_tensorboard: bool = True):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        self._txt = open(osp.join(save_dir, "log.txt"), "a")
        self._jsonl = open(osp.join(save_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(osp.join(save_dir, "tb"))
            except Exception:
                self._tb = None

    def log_text(self, text: str):
        print(text)
        self._txt.write(text + "\n")
        self._txt.flush()

    def log_scalars(self, scalars: Dict[str, Any], step: int):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._txt.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def run_name_tag(config: Dict[str, Any]) -> str:
    """Run name from the hyperparameters (trainer.py:59-77's convention)."""
    return "{}_{}_L{}_B{}_K{}_nc{}".format(
        time.strftime("%Y%m%d_%H%M%S"),
        config.get("network", "segnetvit"),
        config.get("layers", 15),
        config.get("batch_size", 32),
        config.get("max_keypoints", 512),
        config.get("n_class", 0),
    )
