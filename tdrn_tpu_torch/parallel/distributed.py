"""Multi-process bootstrap (the port of ``tdrn_tpu/parallel/distributed.py``).

One process a card (or, on the CPU, a process a rank), joined by
``torch.distributed``: NCCL between CUDA devices, gloo on the CPU. The
launcher is ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in each process:

    torchrun --nproc_per_node 4 train_torch.py ... --multihost

or, by hand on every host, ``RANK``/``WORLD_SIZE`` in the environment and
``--coordinator host0:1234``. The training code needs nothing else: the
train step sums its gradients and positive counts over the ranks
(train/trainer.py with a parallel/mesh.py mesh).
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from tdrn_tpu_torch import _build

INIT_TIMEOUT = datetime.timedelta(minutes=5)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_device(device=None) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` for ``None`` or ``"cuda"``, the
    device itself where it names an index or the CPU. Through
    ``_build.resolve_device``, so it raises on a machine without CUDA unless
    asked for the CPU."""
    dev = _build.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return dev


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> int:
    """Join the process group (a no-op when one process is all there is).

    Rank and world come from the arguments, else from ``RANK`` and
    ``WORLD_SIZE``; the rendezvous is ``tcp://<coordinator_address>``, else
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). The backend is NCCL when the
    rank's device (:func:`local_device` of ``device``) is CUDA and gloo on the
    CPU, unless ``backend`` names one. With no world asked for, in the
    arguments or the environment, nothing is initialized and the rank is 0;
    a world that cannot be formed raises. Returns this process's rank.
    """
    if dist.is_initialized():
        return dist.get_rank()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None:
        print("distributed init skipped (no world size given or in WORLD_SIZE)")
        return 0
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        if world != 1:
            raise ValueError(f"a world of {world} needs process_id or RANK")
        rank = 0
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError("no rendezvous: pass coordinator_address (host:port) or set "
                         "MASTER_ADDR and MASTER_PORT")
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=INIT_TIMEOUT)
    return dist.get_rank()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_batch_to_local(global_batch: int) -> int:
    """Per-process batch share for a process-sharded input pipeline."""
    n = process_count()
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n


def free_port() -> int:
    """A TCP port free on localhost now (for a rendezvous on this host)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, address: str, args, results) -> None:
    value = fn(rank, world, address, *args)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    results.put((rank, value))


def spawn_ranks(fn: Callable[..., Any], world: int, *args) -> List[Any]:
    """Run ``fn(rank, world, address, *args)`` in ``world`` spawned processes
    and return each rank's result, in rank order. ``address`` is a free
    ``localhost:<port>`` for :func:`init_distributed`; ``fn`` must be a
    module-level function and its result picklable without torch tensors
    (a tensor crosses processes by a handle that dies with its rank; send
    numpy arrays). Each rank leaves the process group it joined. A rank that raises
    stops the others and the error is raised here."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank_main, args=(fn, world, f"localhost:{free_port()}", args,
                                                 results),
                               nprocs=world, join=False, start_method="spawn")
    got = {}
    while len(got) < world:  # read while waiting: a large result fills the pipe
        try:
            rank, value = results.get(timeout=0.5)
            got[rank] = value
        except queue.Empty:
            if procs.join(timeout=0) and len(got) < world:
                raise RuntimeError(f"{world - len(got)} rank(s) exited without a result")
    while not procs.join():
        pass
    return [got[r] for r in range(world)]
