"""The port's data-parallel training (tdrn_tpu_torch/parallel, the mesh step of
train/trainer.py, train_torch.py --multihost) on the CPU: gloo ranks spawned
at one torch thread each (tests/torch_port_parallel_ranks.py), TINY_64 at
width 0.125 and 32 TCB channels.

  * the data-parallel step at 2 and 4 ranks against the port's one-process
    step on the same global batch of 8, image and clip mode (T=2, the
    per-frame B sharded): loss within 1e-5 relative, every updated param
    within 2e-5 (tests/test_distributed.py:83-84, tests/test_sharding.py:64),
    the updated params equal on every rank;
  * a batch whose ranks hold different numbers of positives: the summed
    step (global counts) matches the one-process step, a per-rank
    normalized, averaged step does not;
  * replicate_tree: the ranks drew different weights, and hold rank 0's
    after it;
  * the 2-rank step against the JAX package's make_train_step on its
    8-device mesh (tests/test_sharding.py:44-64), the JAX state from the
    port's seeded draw (weights.params_to_jax);
  * train_torch.py --multihost at 2 ranks on a generated mini-VOC, 2 steps:
    equal params on both ranks, only rank 0 writing, the worker-process
    loader given the global batch;
  * dryrun_multichip(2, "tiny").
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.parallel import batch_sharding
from tdrn_tpu.parallel import make_mesh as j_mesh
from tdrn_tpu.parallel import replicate_tree as j_replicate
from tdrn_tpu.parallel import shard_batch_tree as j_shard
from tdrn_tpu.train import Targets as JTargets
from tdrn_tpu.train import TrainState as JTrainState
from tdrn_tpu.train import make_optimizer as j_optimizer
from tdrn_tpu.train import make_train_step as j_train_step
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.parallel import mesh as tmesh
from tdrn_tpu_torch.parallel.distributed import spawn_ranks
from tdrn_tpu_torch.parallel.dryrun import dryrun_multichip
from tdrn_tpu_torch.train import Targets, init_train_state, make_optimizer, make_train_step
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_train_data import _write_voc

B, T, G = 8, 2, 5
OPT = dict(base_lr=1e-2, warmup_steps=1)
PLAIN_SGD = dict(OPT, weight_decay=0.0, grad_clip_norm=0.0)  # the update is -lr * grad
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
# The JAX step compiles at XLA's lowest backend optimization level (as in
# tests/test_torch_port_train_step.py): the same IEEE fp32 operations.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(clip: bool, seed: int, unequal: bool = False):
    """A global batch of B images (or T x B frames) with up to G boxes of
    0.1-0.4 a side; ``unequal``: the second half of the rows hold one box of
    0.05 a side, the first half all G at 0.2-0.5, so the ranks of a 2-rank
    mesh hold very different numbers of positives."""
    rng = np.random.default_rng(seed)
    lead = (T, B) if clip else (B,)
    x = rng.uniform(-120.0, 130.0, lead + (64, 64, 3)).astype(np.float32)
    xy = rng.uniform(0.0, 0.5, lead + (G, 2))
    wh = rng.uniform(0.1, 0.4, lead + (G, 2))
    valid = rng.random(lead + (G,)) < 0.7
    valid[..., 0] = True
    if unequal:
        wh[..., :B // 2, :, :] = rng.uniform(0.2, 0.5, wh[..., :B // 2, :, :].shape)
        valid[..., :B // 2, :] = True
        wh[..., B // 2:, :, :] = 0.05
        valid[..., B // 2:, 1:] = False
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, tcfg.TINY_64.num_classes - 1, lead + (G,)).astype(np.int32)
    return dict(x=x, boxes=boxes, labels=labels, valid=valid)


def _one_process(case):
    """The port's one-process step on the whole global batch."""
    model = ranks.tiny_model(case["clip"])
    opt = make_optimizer(**case["opt"])
    tg = Targets(*(torch.from_numpy(case[k]) for k in ("boxes", "labels", "valid")))
    ts, met = make_train_step(model, opt, clip_mode=case["clip"])(
        init_train_state(model, opt), torch.from_numpy(case["x"]), tg)
    return {k: float(v) for k, v in met.items()}, {k: v.numpy() for k, v in ts.params.items()}


CASES = {
    "image": dict(clip=False, opt=OPT, **_batch(False, 11)),
    "clip": dict(clip=True, opt=OPT, **_batch(True, 12)),
    "unequal": dict(clip=False, opt=PLAIN_SGD, averaged=True, **_batch(False, 13, unequal=True)),
}
WORLD_CASES = {2: ("image", "clip", "unequal"), 4: ("image", "clip")}


def _jax_mesh_step():
    """The JAX package's step on the image case's batch, sharded over its 8
    CPU devices, from the port's seeded params: (metrics, params)."""
    case = CASES["image"]
    model = ranks.tiny_model(False)
    jm = j_build(jcfg.TINY_64, temporal=False, **ranks.SMALL)
    jo = j_optimizer(**OPT)
    jp = jax.tree.map(jnp.asarray, weights.params_to_jax(model.state_dict()))
    mesh = j_mesh()
    assert mesh.devices.size == 8
    jts = j_replicate(JTrainState(jp, jo.init(jp), jnp.zeros((), jnp.int32)), mesh)
    images = jax.device_put(jnp.asarray(case["x"]), batch_sharding(mesh))
    targets = j_shard(JTargets(*(jnp.asarray(case[k]) for k in ("boxes", "labels", "valid"))),
                      mesh)
    step = j_train_step(jm, jo).lower(jts, images, targets).compile(
        compiler_options=FAST_COMPILE)
    jts, jmet = step(jts, images, targets)
    jparams = weights.params_from_jax(jax.tree.map(np.asarray, jts.params))
    return {k: float(v) for k, v in jmet.items()}, {k: v.numpy() for k, v in jparams.items()}


@pytest.fixture(scope="module")
def runs():
    """(world -> [each rank's results by case name], case -> one-process
    run, the JAX mesh step). The ranks of both worlds run while this
    process computes the references."""
    with ThreadPoolExecutor(len(WORLD_CASES)) as pool:
        pending = {w: pool.submit(spawn_ranks, ranks.dp_rank, w,
                                  [dict(CASES[n], name=n) for n in names])
                   for w, names in WORLD_CASES.items()}
        single = {n: _one_process(c) for n, c in CASES.items()}
        jax_run = _jax_mesh_step()
        return {w: f.result() for w, f in pending.items()}, single, jax_run


def _max_param_diff(a, b):
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.mark.parametrize("world,case", [(w, n) for w, names in WORLD_CASES.items()
                                        for n in names])
def test_dp_step_matches_one_process(runs, world, case):
    by_world, single, _ = runs
    met, params = single[case]
    rank0 = by_world[world][0][case]
    got = rank0["metrics"]
    assert got.keys() == met.keys()
    for k in met:
        assert got[k] == pytest.approx(met[k], rel=LOSS_RTOL), (k, got[k], met[k])
    assert _max_param_diff(rank0["params"], params) <= PARAM_ATOL
    for r, res in enumerate(rank_res[case] for rank_res in by_world[world]):
        assert res["local_rows"] == B // world
        assert res["replicated_equal"] and res["updated_equal"], r
        assert res["metrics"] == got, r  # every rank reports the global metrics


def test_unequal_positives_need_the_global_count(runs):
    """The summed step is the one-process step; the per-rank normalized,
    averaged step is not, by far more than the bound."""
    by_world, single, _ = runs
    r0, r1 = (by_world[2][r]["unequal"] for r in (0, 1))
    assert r0["local_num_pos_arm"] > 3 * r1["local_num_pos_arm"] > 0
    params = single["unequal"][1]
    assert _max_param_diff(r0["params"], params) <= PARAM_ATOL
    assert _max_param_diff(r0["averaged"], params) > 50 * PARAM_ATOL


def test_replicate_tree_broadcasts_rank0(runs):
    by_world, _, _ = runs
    for world in WORLD_CASES:
        results = by_world[world]
        assert all(r["image"]["replicated_equal"] for r in results)
        assert not all(r["image"]["drawn_equal"] for r in results)  # the draws differed


def test_dp_step_matches_jax_mesh_step(runs):
    """The 2-rank step (image mode) against the JAX package's jitted step
    with the batch sharded over its 8 CPU devices, from the same params."""
    by_world, _, (jmet, jparams) = runs
    got = by_world[2][0]["image"]
    assert got["metrics"].keys() == jmet.keys()
    for k, v in jmet.items():
        assert got["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert _max_param_diff(got["params"], jparams) <= PARAM_ATOL


def test_train_torch_multihost(tmp_path):
    """Two ranks, 2 steps of voc_tiny with the worker-process loader (in
    process) at --batch_size 2 a process."""
    root = str(tmp_path / "voc")
    _write_voc(root, np.random.default_rng(21))
    argv = ["--dataset", "voc_tiny", "--image_sets", "2007:trainval", "--batch_size", "2",
            "--max_iter", "2", "--save_every", "2", "--device", "cpu", "--width_mult", "0.125",
            "--tcb_channels", "32", "--warmup", "1", "--log_every", "1", "--loader",
            "processes", "--num_workers", "0"]
    out = spawn_ranks(ranks.train_multihost_rank, 2, root, str(tmp_path / "ck"), argv)
    (p0, step0, log0, calls0, text0), (p1, step1, log1, calls1, _) = out
    assert step0 == step1 == 2
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    assert np.isfinite(log0["loss"]) and log0["loss"] == log1["loss"]
    for r, calls in enumerate((calls0, calls1)):
        assert calls == [dict(batch_size=4, rank=r, world=2, seed=0)]
    ck0 = tmp_path / "ck" / "rank0"
    assert sorted(os.listdir(ck0)) == ["2", "metrics.jsonl", "model_meta.json"]
    assert not (tmp_path / "ck" / "rank1").exists()
    assert "process 0/2 on cpu" in text0


def test_dryrun_multichip_tiny(capsys):
    res = dryrun_multichip(2, "tiny", device="cpu")
    assert np.isfinite(res["loss"]) and res["same_params"] and res["priors"] == 255
    assert "dryrun_multichip(2, tiny): ok" in capsys.readouterr().out


def test_shard_batch_tree_rows():
    """Rows along B, the per-frame B of a clip, never T; a batch that does
    not split raises."""
    x = torch.arange(2 * 8).reshape(2, 8)
    for rank in range(4):
        m = tmesh.Mesh(None, rank, 4, torch.device("cpu"))
        got = tmesh.shard_batch_tree({"a": x, "b": (x.numpy(),)}, m, leading_time_axis=True)
        assert torch.equal(got["a"], x[:, 2 * rank:2 * rank + 2])
        assert torch.equal(got["b"][0], x[:, 2 * rank:2 * rank + 2])
        assert torch.equal(tmesh.shard_batch_tree(x.T, m), x.T[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError):
        tmesh.shard_batch_tree(torch.zeros(6), tmesh.Mesh(None, 0, 4, torch.device("cpu")))
