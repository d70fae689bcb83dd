"""Batch assembly: stacked fixed-shape numpy batches with worker threads
(pram_tpu/data/loader.py).

Replacement for torch DataLoader + ``collect_batch``
(dataset/utils.py:17-31) and DistributedSampler (train.py:82-98): every
sample is already fixed-shape, so collation is a plain stack; per-epoch
shuffling is reseeded deterministically per (seed, epoch) like the
reference's ``sampler.set_epoch`` (trainer.py:362); for multi-host data
parallelism each host takes its ``host_id``-strided shard of the epoch
permutation. A small thread pool keeps the host side ahead of the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


def collate(items: List[Dict]) -> Dict:
    """Stack a list of samples into one batch (strings pass through as lists)."""
    out = {}
    for k in items[0].keys():
        vals = [it[k] for it in items]
        if isinstance(vals[0], (str, list)):
            out[k] = vals
        else:
            out[k] = np.stack(vals)
    return out


class BatchLoader:
    """Epoch iterator over a dataset with train-time RNG threading.

    Args:
      dataset: object with __len__ and get_train_item(idx, rng) /
        get_test_item(idx) (SceneDataset or MultiSceneDataset).
      batch_size: global batch size (the per-step batch).
      train: use the sampling/augmenting item path (default: the eval
        items in dataset order; the JAX class trains by default).
      num_hosts / host_id: shard the permutation for multi-host input
        pipelines (each host feeds its slice of the global batch).
      num_workers: prefetch threads (0 = synchronous).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        train: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 0,
        its_per_epoch: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = num_workers
        self.its_per_epoch = its_per_epoch

    def _indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(n) if self.train else np.arange(n)
        idx = idx[self.host_id :: self.num_hosts]
        if self.its_per_epoch is not None:
            need = self.its_per_epoch * self.batch_size
            reps = int(np.ceil(need / max(len(idx), 1)))
            idx = np.tile(idx, reps)[:need]
        return idx

    def _item(self, i: int, rng) -> Dict:
        if self.train:
            return self.dataset.get_train_item(i, rng)
        return self.dataset.get_test_item(i)

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        idx = self._indices(epoch)
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1

        def make_batch(b):
            rng = np.random.RandomState(
                (self.seed + epoch) * 100003 + b
            )
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            return collate([self._item(int(i), rng) for i in sel])

        if self.num_workers <= 0:
            for b in range(nb):
                yield make_batch(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = object()

        def worker(worker_id):
            for b in range(worker_id, nb, self.num_workers):
                q.put((b, make_batch(b)))
            q.put((None, stop))

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        buf: Dict[int, Dict] = {}
        done = 0
        nxt = 0
        while done < self.num_workers or buf or nxt < nb:
            b, item = q.get()
            if item is stop:
                done += 1
                if done == self.num_workers and nxt >= nb:
                    break
                continue
            buf[b] = item
            while nxt in buf:
                yield buf.pop(nxt)
                nxt += 1
        for t in threads:
            t.join(timeout=1)
