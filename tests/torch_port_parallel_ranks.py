"""Rank functions of the port's multi-process CPU tests
(tests/test_torch_port_parallel.py and tests/test_torch_port_spatial.py).

Each runs in a process spawned by tdrn_tpu_torch.parallel.distributed's
``spawn_ranks``, joins a gloo group on the CPU at one torch thread, and
returns numpy arrays (a tensor does not outlive its rank). This module
imports torch and the port only, so a rank starts without JAX.
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import torch

from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.parallel import (all_reduce_sum_, init_distributed, make_mesh,
                                     replicate_tree, shard_batch_tree)
from tdrn_tpu_torch.train import Targets, init_train_state, make_optimizer, make_train_step

SMALL = dict(width_mult=0.125, tcb_channels=32)
PARAM_SEED = 7  # rank 0's draw; rank r draws PARAM_SEED + r


def tiny_model(clip: bool, seed: int = PARAM_SEED):
    model = build_detector(tcfg.TINY_64, temporal=clip, device="cpu", **SMALL)
    return weights.load_random_params(model, seed)


def _join(rank, world, address):
    torch.set_num_threads(1)
    init_distributed(address, world, rank, device="cpu")
    return make_mesh("cpu")


def _flat(params) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in params.values()])


def _equals_rank0(t: torch.Tensor, mesh) -> bool:
    ref = t.clone()
    torch.distributed.broadcast(ref, src=0, group=mesh.group)
    return bool(torch.equal(t, ref))


def _numpy(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def dp_rank(rank, world, address, cases):
    """Each case: one data-parallel step on the rank's rows of a global batch
    (``x``, ``boxes``, ``labels``, ``valid``; (T, B, ...) with ``clip``) from
    rank 0's params (every rank draws its own, replicate_tree broadcasts
    rank 0's). With ``averaged`` also a per-rank step: each rank's loss
    divided by its own counts, the updated params averaged over the ranks
    (with no momentum history, weight decay or clip, the mean update is
    the update of the mean gradient: a DDP-style step)."""
    mesh = _join(rank, world, address)
    out = {}
    for case in cases:
        clip = case["clip"]
        model = tiny_model(clip, PARAM_SEED + rank)
        opt = make_optimizer(**case["opt"])
        drawn = init_train_state(model, opt)
        ts = replicate_tree(drawn, mesh)
        batch = (torch.from_numpy(case["x"]), Targets(*(torch.from_numpy(case[k])
                                                         for k in ("boxes", "labels", "valid"))))
        x, tg = shard_batch_tree(batch, mesh, leading_time_axis=clip)
        new, met = make_train_step(model, opt, clip_mode=clip, mesh=mesh)(ts, x, tg)
        res = dict(metrics={k: float(v) for k, v in met.items()},
                   drawn_equal=_equals_rank0(_flat(drawn.params), mesh),
                   replicated_equal=_equals_rank0(_flat(ts.params), mesh),
                   updated_equal=_equals_rank0(_flat(new.params), mesh),
                   local_rows=int(x.shape[1 if clip else 0]))
        if case.get("averaged"):
            own, own_met = make_train_step(model, opt, clip_mode=clip)(ts, x, tg)
            mean = all_reduce_sum_(list(own.params.values()), mesh)
            res["averaged"] = _numpy({k: v / world for k, v in zip(own.params, mean)})
            res["local_num_pos_arm"] = float(own_met["num_pos_arm"])
        if rank == 0:
            res["params"] = _numpy(new.params)
        out[case["name"]] = res
    return out


def spatial_rank(rank, world, address, cases, x, state):
    """Each case: ``spatial_forward`` of the model built from ``build`` (seed
    ``seed``) on the frames ``x`` (and ``state`` where ``temporal``), with the
    port's detect_topk where ``detect``; every rank returns its outputs."""
    from tdrn_tpu_torch.ops.detection import detect_topk
    from tdrn_tpu_torch.ops.priors import prior_boxes
    from tdrn_tpu_torch.parallel.spatial import make_spatial_mesh, spatial_forward

    _join(rank, world, address)
    mesh = make_spatial_mesh("cpu")
    out = {}
    for case in cases:
        model = weights.load_random_params(
            build_detector(tcfg.TINY_64, device="cpu", **case["build"]), case["seed"])
        detect_fn = None
        if case.get("detect"):
            priors = prior_boxes(tcfg.TINY_64, "cpu")
            detect_fn = lambda preds: detect_topk(preds, priors, tcfg.TINY_64)  # noqa: E731
        st = [torch.from_numpy(s) for s in state] if case["build"]["temporal"] else None
        got, new_state = spatial_forward(model, mesh, detect_fn)(torch.from_numpy(x), st)
        out[case["name"]] = dict(
            out=[t.numpy().copy() for t in got if t is not None],
            state=None if new_state is None else [s.numpy().copy() for s in new_state])
    return out


def train_multihost_rank(rank, world, address, root, save_folder, argv):
    """train_torch.py --multihost in this rank (its env as torchrun sets it,
    the 21-class TINY_64 ``voc_tiny`` registered), recording the calls of the
    worker-process loader; (final params, last metrics, loader calls, stdout)."""
    from tdrn_tpu_torch.data import process_loader

    import train_torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    tcfg.CONFIGS["voc_tiny"] = dataclasses.replace(tcfg.TINY_64, name="voc_tiny", num_classes=21)
    calls, make = [], process_loader.make_process_loader

    def recording(dataset, **kw):
        calls.append({k: kw[k] for k in ("batch_size", "rank", "world", "seed")})
        return make(dataset, **kw)

    process_loader.make_process_loader = recording
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        ts, logged = train_torch.main(argv + [
            "--data_root", root, "--save_folder", os.path.join(save_folder, f"rank{rank}"),
            "--multihost", "--coordinator", address])
    return _numpy(ts.params), ts.step, logged, calls, text.getvalue()
