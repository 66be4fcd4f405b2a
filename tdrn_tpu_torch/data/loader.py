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

import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from tdrn_tpu_torch.data.vid import collate_clips
from tdrn_tpu_torch.data.voc import collate_batch

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def index_stream(n: int, seed: int) -> Iterator[Tuple[int, int]]:
    """Yields (epoch, index) forever, one seeded permutation of range(n) an
    epoch; the epoch salts each sample's augmentation."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while True:
        for i in rng.permutation(n):
            yield epoch, int(i)
        epoch += 1


def fetch(dataset, job: Tuple[int, int]):
    """The sample of ``job`` = (epoch, index)."""
    epoch, i = job
    # A fresh generator per call, seeded by (seed, epoch, index):
    # deterministic under the pool (numpy Generators are not thread-safe).
    if hasattr(dataset, "sample"):
        return dataset.sample(i, epoch)
    return dataset[i]


def to_torch(arrays, pin_memory: bool) -> Batch:
    """A collated batch of numpy arrays as torch tensors, pinned if asked."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return tuple(t.pin_memory() for t in out) if pin_memory else out


class Prefetcher:
    """A daemon thread that keeps ``depth`` items of the iterator ``source``
    in a bounded queue, off the consumer's thread. An exception in
    ``source`` takes its item's place and is raised by ``get``; after
    ``stop`` the thread ends once the item it waits for arrives."""

    def __init__(self, source: Iterator, depth: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(source,), daemon=True)
        self.thread.start()

    def _run(self, source: Iterator):
        while not self.stopped.is_set():
            try:
                item = next(source)
            except Exception as e:
                if self.stopped.is_set():
                    return  # shutdown race: the source is already closed
                item = e  # re-raised by the consumer
            while not self.stopped.is_set():
                try:
                    self.q.put(item, timeout=1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def get(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self, join_s: float = 0.0):
        """Stop the thread; wait up to ``join_s`` seconds for it to end."""
        self.stopped.set()
        if join_s:
            self.thread.join(join_s)


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
        self.seed = seed
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.prefetcher = Prefetcher(self._batches(pin_memory), prefetch)

    def _batches(self, pin_memory: bool) -> Iterator[Batch]:
        """Collated batches, each batch's samples fetched by the pool."""
        stream = index_stream(len(self.dataset), self.seed)
        fetch_one = functools.partial(fetch, self.dataset)
        while True:
            idxs = [next(stream) for _ in range(self.batch_size)]
            yield to_torch(self.collate(list(self.pool.map(fetch_one, idxs))), pin_memory)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self.prefetcher.get()

    def close(self):
        self.prefetcher.stop()
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
