"""Worker-process input pipeline: the port's counterpart of
``tdrn_tpu/data/grain_pipeline.py::make_grain_loader``.

The JAX package's production loader is grain's, whose worker processes
decode and augment in parallel outside the interpreter lock; ``grain.python``
imports JAX, so the port builds the same thing on
``torch.utils.data.DataLoader``:

* :class:`EpochIndexSampler` yields ``(epoch, index)`` from one
  ``np.random.default_rng(seed).permutation(n)`` an epoch, the index stream
  of the thread loader (``data/loader.py``), grouped into global batches of
  ``batch_size`` (``BatchSampler``, ``drop_last``);
* each global batch is cut into ``world`` equal shards and rank ``r`` keeps
  rows ``[r*B/w, (r+1)*B/w)``, the counterpart of grain's
  ``ShardByJaxProcess``: the ranks' batches concatenated are the one-process
  batch, and the shuffle and the augmentation salt stay global;
* a worker fetches each ``(epoch, index)`` through ``dataset.sample(index,
  epoch)``, whose randomness is drawn from (seed, epoch, index), and
  collates the batch with ``collate_batch`` or, in clip mode,
  ``collate_clips`` ((T, B, ...)).

So the batch stream for a seed is the thread loader's bit for bit, whatever
the worker count, and the thread loader's is the JAX package's. Workers are
started by ``spawn`` (a process that already holds a CUDA context or OpenCV's
thread pool must not fork) and run OpenCV and PyTorch on one thread each;
``num_workers=0`` fetches in the calling process. A worker's exception is
raised again in the consumer, and ``close()`` stops and joins the workers.

A worker hands its batch over in a shared-memory block of its own
(``multiprocessing.shared_memory``), named after the loader, and sends only
the block's name and the arrays' layout through the DataLoader's pipe. A
thread of the consumer's process (``loader.Prefetcher``) copies the arrays
once, straight into pinned memory with ``pin_memory``, unlinks the block and
holds the batch ready; the batches further ahead are the DataLoader's own
(``prefetch_factor`` a worker). ``close()`` unlinks the blocks of batches
still in flight. Pickled through the pipe, a voc_320 batch of 32 (39.3 MB)
capped the loader near 60-140 images/s on the H100's host at any worker
count; PyTorch's own shared-memory tensors abort a worker that exits with a
batch in flight (SIGABRT, PyTorch 2.11 there and 2.13 here), which the
DataLoader reports as a failure at ``close()``.
"""

from __future__ import annotations

import glob
import multiprocessing
import os
from multiprocessing import shared_memory
from typing import Iterator, Tuple

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, Dataset, Sampler

from tdrn_tpu_torch.data.loader import Batch, Prefetcher, fetch, index_stream, to_torch
from tdrn_tpu_torch.data.vid import collate_clips
from tdrn_tpu_torch.data.voc import collate_batch

CLOSE_JOIN_S = 60  # the longest close() waits for the batch in flight to the producer


class EpochIndexSampler(Sampler):
    """Infinite ``(epoch, index)`` stream: one seeded permutation an epoch."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return index_stream(self.n, self.seed)


class ShardedBatchSampler(Sampler):
    """Global batches of ``batch_size`` from ``sampler``; yields rank's
    contiguous share of each."""

    def __init__(self, sampler: Sampler, batch_size: int, rank: int = 0, world: int = 1):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of world {world}")
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not split over {world} ranks")
        self.batches = BatchSampler(sampler, batch_size, drop_last=True)
        per = batch_size // world
        self.rows = slice(rank * per, (rank + 1) * per)

    def __iter__(self):
        for batch in self.batches:
            yield batch[self.rows]


class _SampleSource(Dataset):
    """Map-style view of a dataset keyed by ``(epoch, index)``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, job: Tuple[int, int]):
        return fetch(self.dataset, job)


class _SharedBatch:
    """Worker side: collate the batch into a new shared-memory block and
    return (its name, each array's shape, dtype and offset)."""

    def __init__(self, clip_mode: bool, prefix: str):
        self.collate = collate_clips if clip_mode else collate_batch
        self.prefix = prefix
        self.count = 0  # batches this worker has made

    def __call__(self, samples):
        arrays = [np.ascontiguousarray(a) for a in self.collate(samples)]
        worker = torch.utils.data.get_worker_info().id
        self.count += 1
        shm = shared_memory.SharedMemory(f"{self.prefix}{worker}_{self.count}", create=True,
                                         size=sum(a.nbytes for a in arrays))
        layout, offset = [], 0
        for a in arrays:
            np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=offset)[...] = a
            layout.append((a.shape, a.dtype.str, offset))
            offset += a.nbytes
        shm.close()
        return shm.name, layout


def _take_shared(name: str, layout, pin_memory: bool) -> Batch:
    """Consumer side: a _SharedBatch's arrays as torch tensors, copied once
    out of its block (into pinned memory with ``pin_memory``); then the block
    is unlinked. No view of the block outlives the copy, so it can close."""
    shm = shared_memory.SharedMemory(name)
    try:
        out = []
        for shape, dtype, offset in layout:
            view = torch.from_numpy(np.ndarray(shape, dtype, buffer=shm.buf, offset=offset))
            out.append(view.pin_memory() if pin_memory else view.clone())
            del view
        return tuple(out)
    finally:
        shm.close()
        shm.unlink()


def _one_thread_worker(_worker_id: int) -> None:
    """Each worker computes on one thread: the parallelism is the workers."""
    torch.set_num_threads(1)
    try:
        import cv2
    except ImportError:  # only the augmentation needs cv2
        return
    cv2.setNumThreads(1)


class ProcessLoader:
    """Infinite shuffled batch iterator over worker processes. A
    ``Prefetcher`` thread takes each batch from the DataLoader and its
    shared-memory block and holds it ready as torch tensors (pinned with
    ``pin_memory``), off the consumer's thread."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 8,
        clip_mode: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        pin_memory: bool = False,
        rank: int = 0,
        world: int = 1,
    ):
        self.workers = workers = num_workers > 0
        # Unique among the loaders of every process on the host.
        self.shm_prefix = f"tdrn_{os.getpid()}_{id(self):x}_"
        self.loader = DataLoader(
            _SampleSource(dataset),
            batch_sampler=ShardedBatchSampler(EpochIndexSampler(len(dataset), seed),
                                              batch_size, rank, world),
            num_workers=num_workers,
            collate_fn=(_SharedBatch(clip_mode, self.shm_prefix) if workers
                        else collate_clips if clip_mode else collate_batch),
            worker_init_fn=_one_thread_worker if workers else None,
            multiprocessing_context=multiprocessing.get_context("spawn") if workers else None,
            prefetch_factor=prefetch if workers else None,
            persistent_workers=workers,
        )
        self._it = iter(self.loader)
        self.prefetcher = Prefetcher(self._batches(pin_memory), 1)

    def _batches(self, pin_memory: bool) -> Iterator[Batch]:
        for batch in self._it:
            yield (_take_shared(*batch, pin_memory) if self.workers
                   else to_torch(batch, pin_memory))

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self.prefetcher.get()

    @property
    def worker_pids(self):
        """The pids of the worker processes (empty with ``num_workers=0``)."""
        return [w.pid for w in getattr(self._it, "_workers", [])]

    def close(self):
        """Stop the producer (it ends once the batch it waits for arrives),
        then stop and join the workers."""
        self.prefetcher.stop(CLOSE_JOIN_S)
        shutdown = getattr(self._it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()
        for path in glob.glob(f"/dev/shm/{self.shm_prefix}*"):  # batches never taken
            shared_memory.SharedMemory(os.path.basename(path)).unlink()


def make_process_loader(
    dataset,
    batch_size: int,
    num_workers: int = 8,
    clip_mode: bool = False,
    seed: int = 0,
    prefetch: int = 2,
    pin_memory: bool = False,
    rank: int = 0,
    world: int = 1,
) -> ProcessLoader:
    return ProcessLoader(dataset, batch_size, num_workers, clip_mode, seed, prefetch,
                         pin_memory, rank, world)
