"""Batch assembly: stacked fixed-shape numpy batches with worker threads
(pram_tpu/data/loader.py, its eval half).

Replacement for torch DataLoader + ``collect_batch``
(dataset/utils.py:17-31) and DistributedSampler (train.py:82-98): every
sample is already fixed-shape, so collation is a plain stack; items come in
dataset order, and for multi-host pipelines each host takes its
``host_id``-strided shard. A small thread pool keeps the host side ahead of
the device. The training order (a shuffle reseeded per epoch) waits for a
training CLI of the port.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

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
    """Epoch iterator over a dataset's eval items.

    Args:
      dataset: object with __len__ and get_test_item(idx) (SceneDataset or
        MultiSceneDataset).
      batch_size: global batch size.
      num_hosts / host_id: shard the items for multi-host input
        pipelines (each host feeds its slice of the global batch).
      num_workers: prefetch threads (0 = synchronous).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        drop_last: bool = True,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = num_workers

    def epoch(self) -> Iterator[Dict]:
        idx = np.arange(len(self.dataset))[self.host_id :: self.num_hosts]
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1

        def make_batch(b):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            return collate([self.dataset.get_test_item(int(i)) for i in sel])

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
