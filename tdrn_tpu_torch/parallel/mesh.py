"""Data-parallel mesh and sharding (the port of ``tdrn_tpu/parallel/mesh.py``).

The JAX package declares a 1-D ``data`` mesh, shards the batch axes and
replicates the params; XLA inserts the gradient ``psum``. Here the mesh is
the process group of ``torch.distributed`` (parallel/distributed.py), one
rank a device, and the collectives are explicit:

  * :func:`shard_batch_tree` gives a rank its rows of a host batch: rows
    ``[r*B/w, (r+1)*B/w)`` along B, or along the per-frame B of a
    ``(T, B, ...)`` clip, never along T (the rows
    data/process_loader.py gives rank ``r`` of each global batch);
  * :func:`replicate_tree` broadcasts rank 0's tree, so replicas are equal
    by construction, not by each rank drawing the same values;
  * :func:`all_reduce_sum_` sums tensors over the ranks in place through one
    flat buffer a dtype (one collective a step for the gradients, not one a
    parameter); the train step (train/trainer.py) sums its gradients and
    positive counts with it.

Every collective here is an ``all_reduce`` or a ``broadcast``, which gloo
runs on CUDA tensors as well as NCCL does; :func:`all_gather` is an
``all_reduce`` of a zero-filled buffer with one slot a rank, exact because
``x + 0 == x``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tdrn_tpu_torch.parallel.distributed import local_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a step spans: ``group`` is None in a single process."""

    group: Optional[Any]
    rank: int
    world: int
    device: torch.device
    axis: str = DATA_AXIS


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialized process group, this rank on
    ``local_device(device)``; a one-rank mesh without a group when
    torch.distributed is not initialized."""
    dev = local_device(device)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)


def batch_sharding(mesh: Mesh) -> int:
    """The axis a batch is split along: B of (B, ...)."""
    return 0


def clip_batch_sharding(mesh: Mesh) -> int:
    """(T, B, ...) clips: the per-frame batch axis, not time."""
    return 1


def replicated(mesh: Mesh) -> None:
    """No axis is split."""
    return None


def _flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """The leaves of a tree of tuples, NamedTuples, lists and dicts, and the
    function that rebuilds the tree from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], rebuild


def _rows(x, axis: int, mesh: Mesh) -> torch.Tensor:
    x = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    n = x.shape[axis]
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not split over {mesh.world} ranks")
    per = n // mesh.world
    return x.narrow(axis, mesh.rank * per, per).to(mesh.device, non_blocking=True)


def shard_batch_tree(tree, mesh: Mesh, leading_time_axis: bool = False):
    """The rank's rows of every array of a host batch (a tree of tensors or
    numpy arrays), on the mesh's device."""
    axis = clip_batch_sharding(mesh) if leading_time_axis else batch_sharding(mesh)
    leaves, rebuild = _flatten(tree)
    return rebuild([_rows(x, axis, mesh) for x in leaves])


def _by_dtype(tensors: Sequence[torch.Tensor]):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> Sequence[torch.Tensor]:
    """Sum each tensor over the ranks, in place, through one flat buffer a
    dtype. A no-op on a mesh without a group."""
    if mesh.group is None or not tensors:
        return tensors
    for idx in _by_dtype(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))
    return tensors


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(world, *t.shape): rank r's ``t`` in slot r on every rank, by an
    all_reduce SUM of a zero-filled buffer (exact: x + 0 == x)."""
    buf = t.new_zeros((mesh.world,) + tuple(t.shape))
    buf[mesh.rank] = t
    if mesh.group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def replicate_tree(tree, mesh: Mesh):
    """Rank 0's tree on every rank: each tensor leaf on the mesh's device,
    broadcast through one flat buffer a dtype, and the other leaves (step
    counts) by ``broadcast_object_list``. Every rank passes a tree of the
    same structure, shapes and dtypes; the values of ranks above 0 are
    replaced."""
    leaves, rebuild = _flatten(tree)
    out = [x.detach().to(mesh.device) if isinstance(x, torch.Tensor) else x for x in leaves]
    if mesh.group is None:
        return rebuild(out)
    tensor_ix = [i for i, x in enumerate(out) if isinstance(x, torch.Tensor)]
    for idx in _by_dtype([out[i] for i in tensor_ix]):
        members = [tensor_ix[i] for i in idx]
        flat = torch.cat([out[i].reshape(-1) for i in members])
        dist.broadcast(flat, src=0, group=mesh.group)
        for i, part in zip(members, flat.split([out[i].numel() for i in members])):
            out[i] = part.view_as(out[i]).clone()  # a storage of its own (checkpoints)
    other = sorted(set(range(len(out))) - set(tensor_ix))
    if other:
        objs = [out[i] for i in other]
        dist.broadcast_object_list(objs, src=0, group=mesh.group)
        for i, v in zip(other, objs):
            out[i] = v
    return rebuild(out)
