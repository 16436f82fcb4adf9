"""Infinite shuffled index stream and a prefetching loader (torch
counterpart of ``sherf_tpu/data/sampler.py``; reference misc.py:113-147,
training_loop.py:179-180).

Worker threads build raw numpy items; ``collate`` and the host-to-device
copy run on the consumer's thread in ``__next__``, so no worker thread
issues CUDA work.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

# batches of raw items kept ready
PREFETCH = 2
# seconds close() waits for the workers to finish the items in hand
CLOSE_TIMEOUT_S = 60.0


class InfiniteSampler:
    """(misc.InfiniteSampler) — deterministic, shardable, windowed shuffle;
    the same indices as the JAX package's for the same arguments."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_size <= 0:
            raise ValueError(f"dataset_size {dataset_size} must be positive")
        self.size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class PrefetchLoader:
    """Builds the items of ``batch_size`` sampled indices on a pool of
    ``num_workers`` threads, keeps ``PREFETCH`` batches of raw items ready,
    and collates one on each ``next()``.  A worker's exception is raised by
    the ``next()`` that would have returned its batch.

    While the loader is open, torch's intra-op threads are bounded to the
    machine's cores over ``num_workers`` (each worker runs a CPU SMPL
    forward); ``close()`` restores the count and stops the workers."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 sampler: InfiniteSampler, num_workers: int = 3):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._torch_threads = torch.get_num_threads()
        torch.set_num_threads(max(1, min(self._torch_threads,
                                         (os.cpu_count() or 1)
                                         // self.num_workers)))
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, x) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(x, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        it = iter(self.sampler)
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not self._stop.is_set():
                    idxs = [next(it) for _ in range(self.batch_size)]
                    if not self._put(list(pool.map(self.dataset.__getitem__,
                                                   idxs))):
                        return
        except Exception as e:  # noqa: BLE001 — handed to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        items = self.q.get()
        if isinstance(items, Exception):
            raise RuntimeError("a data loader worker failed") from items
        return self.collate_fn(items)

    def close(self):
        self._stop.set()
        self._thread.join(CLOSE_TIMEOUT_S)
        torch.set_num_threads(self._torch_threads)
        if self._thread.is_alive():
            raise RuntimeError(
                f"the data loader did not stop in {CLOSE_TIMEOUT_S} s")
