"""Host-side input pipeline (the port of ``tdrn_tpu/data/loader.py``).

A thread pool fetches and augments samples (cv2 and numpy release the GIL)
and a producer thread keeps ``prefetch`` batches in flight in a bounded
queue. Indices come from one ``np.random.default_rng(seed)`` permutation an
epoch, and a dataset with ``sample(index, salt)`` draws each sample's
randomness from (seed, epoch, index), so the batch stream for a seed is the
JAX package's, whatever the thread count. Batches are torch tensors
(images float32, boxes float32, labels int32, valid bool), in pinned host
memory with ``pin_memory=True`` (a CUDA machine), ready for a
``non_blocking`` copy to the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from tdrn_tpu_torch.data.vid import collate_clips
from tdrn_tpu_torch.data.voc import collate_batch

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class PrefetchLoader:
    """Infinite shuffled batch iterator with background prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 8,
        clip_mode: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_clips if clip_mode else collate_batch
        self.pin_memory = pin_memory
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _index_stream(self) -> Iterator[tuple]:
        """Yields (epoch, index); the epoch salts per-sample augmentation."""
        n = len(self.dataset)
        epoch = 0
        while True:
            for i in self.rng.permutation(n):
                yield epoch, int(i)
            epoch += 1

    def _fetch(self, job: tuple):
        epoch, i = job
        # A fresh generator per call, seeded by (seed, epoch, index):
        # deterministic under the pool (numpy Generators are not thread-safe).
        if hasattr(self.dataset, "sample"):
            return self.dataset.sample(i, epoch)
        return self.dataset[i]

    def _to_torch(self, arrays) -> Batch:
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        if self.pin_memory:
            out = tuple(t.pin_memory() for t in out)
        return out

    def _produce(self):
        stream = self._index_stream()
        while not self._stop.is_set():
            try:
                idxs = [next(stream) for _ in range(self.batch_size)]
                samples = list(self.pool.map(self._fetch, idxs))
                batch = self._to_torch(self.collate(samples))
            except Exception as e:
                if self._stop.is_set():
                    return  # shutdown race: the pool is already closed
                batch = e  # re-raised by the consumer
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        batch = self.q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        self._stop.set()
        self.pool.shutdown(wait=False, cancel_futures=True)


def make_loader(
    dataset,
    batch_size: int,
    num_workers: int = 8,
    clip_mode: bool = False,
    seed: int = 0,
    prefetch: int = 4,
    pin_memory: bool = False,
) -> PrefetchLoader:
    return PrefetchLoader(dataset, batch_size, num_workers, clip_mode, seed, prefetch, pin_memory)
