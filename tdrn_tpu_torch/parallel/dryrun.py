"""One data-parallel clip-mode train step over N processes (the port of
``__graft_entry__.py::dryrun_multichip``).

    python -m tdrn_tpu_torch.parallel.dryrun N [tiny|vid_320|vid_320_full] [--device cpu]

spawns N ranks joined by torch.distributed: gloo on the CPU; on CUDA, NCCL
with a card a rank where the machine has N cards, else gloo with every rank
on the one card named. Each rank draws its own initial weights (seed 0 +
rank); ``replicate_tree`` makes rank 0's the params of all. The global
batch is one clip of T=2 frames a rank, the JAX dry run's frames and
targets; each rank takes its clip with ``shard_batch_tree(...,
leading_time_axis=True)`` and runs ``make_train_step(clip_mode=True,
mesh=...)``. The loss must be finite and equal on every rank and the
updated params equal on every rank; rank 0 prints the ``ok`` line.

Geometries (the JAX dry run's): ``tiny`` is TINY_64 at width 0.125 and 32
TCB channels, ``vid_320`` VID_320 (6375 priors) at width 0.25 and 64,
``vid_320_full`` VID_320 at width 1.0 and 256.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.parallel.distributed import init_distributed, spawn_ranks

GEOMETRIES = ("tiny", "vid_320", "vid_320_full")
T = 2
G = 4


def geometry_args(geometry: str):
    """(config, input size, width_mult, TCB channels)."""
    from tdrn_tpu_torch.config import TINY_64, VID_320

    if geometry == "tiny":
        return TINY_64, 64, 0.125, 32
    if geometry == "vid_320_full":
        return VID_320, 320, 1.0, 256
    if geometry == "vid_320":
        return VID_320, 320, 0.25, 64
    raise ValueError(f"unknown geometry {geometry!r} (one of {GEOMETRIES})")


def global_batch(batch: int, size: int):
    """The JAX dry run's batch: seeded normal frames (T, B, size, size, 3) and
    one valid 0.2-0.6 box of class 0 a frame among G slots."""
    from tdrn_tpu_torch.train import Targets

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randn(T, batch, size, size, 3).astype(np.float32))
    boxes = torch.from_numpy(np.tile(np.asarray([[0.2, 0.2, 0.6, 0.6]], np.float32),
                                     (T, batch, G, 1)))
    labels = torch.zeros((T, batch, G), dtype=torch.int32)
    valid = torch.from_numpy(np.tile(np.asarray([True, False, False, False]), (T, batch, 1)))
    return frames, Targets(boxes, labels, valid)


def _rank(rank: int, world: int, address: str, geometry: str, device: str, backend: str):
    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.parallel.mesh import all_gather, make_mesh, replicate_tree, shard_batch_tree
    from tdrn_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    if device == "cpu":
        torch.set_num_threads(1)
    elif backend == "nccl":
        device = f"cuda:{rank}"
    init_distributed(address, world, rank, backend=backend, device=device)
    mesh = make_mesh(device)
    cfg, size, width, tcb = geometry_args(geometry)
    model = build_detector(cfg, temporal=True, tcb_channels=tcb, width_mult=width, device="cpu")
    weights.init_weights(model, torch.Generator().manual_seed(rank))  # unequal draws
    model = model.to(mesh.device)
    opt = make_optimizer(base_lr=1e-3, warmup_steps=1)
    ts = replicate_tree(init_train_state(model, opt), mesh)
    frames, targets = shard_batch_tree(global_batch(world, size), mesh, leading_time_axis=True)
    step = make_train_step(model, opt, clip_mode=True, mesh=mesh)
    ts, metrics = step(ts, frames, targets)
    loss = metrics["loss"]
    losses = all_gather(loss, mesh)
    flat = torch.cat([v.reshape(-1) for v in ts.params.values()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0, group=mesh.group)
    same_params = bool(torch.equal(flat, ref))
    return dict(loss=float(loss), losses=losses.cpu().numpy(), same_params=same_params,
                num_pos_arm=float(metrics["num_pos_arm"]), priors=cfg.num_priors)


def dryrun_multichip(n_devices: int, geometry: str = "vid_320", device=None) -> dict:
    """One full data-parallel clip-mode train step over ``n_devices`` ranks
    (module docstring); raises unless the loss is finite and equal on every
    rank and the updated params are equal on every rank. Returns rank 0's
    readings."""
    geometry_args(geometry)
    dev = _build.resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= n_devices:
        backend = "nccl"
    name = "cpu" if dev.type == "cpu" else str(dev if dev.index is not None else "cuda:0")
    out = spawn_ranks(_rank, n_devices, geometry, name, backend)
    r0 = out[0]
    if not np.isfinite(r0["loss"]):
        raise AssertionError(f"dryrun_multichip: loss {r0['loss']}")
    for r, o in enumerate(out):
        if not np.array_equal(o["losses"], r0["losses"]) or o["loss"] != r0["loss"]:
            raise AssertionError(f"dryrun_multichip: rank {r} saw losses {o['losses']}, "
                                 f"rank 0 {r0['losses']}")
        if not o["same_params"]:
            raise AssertionError(f"dryrun_multichip: rank {r}'s params differ from rank 0's")
    print(f"dryrun_multichip({n_devices}, {geometry}): ok, priors={r0['priors']}, "
          f"loss={r0['loss']:.4f}", flush=True)
    return dict(r0, backend=backend, device=name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks (processes)")
    ap.add_argument("geometry", nargs="?", default="vid_320", choices=GEOMETRIES)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no fallback to the CPU")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n, args.geometry, args.device)


if __name__ == "__main__":
    main()
