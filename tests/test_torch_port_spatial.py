"""The port's H-split forward (tdrn_tpu_torch/parallel/spatial.py) on the CPU:
gloo ranks spawned at one torch thread each (tests/torch_port_parallel_ranks.py),
TINY_64 at width 0.125 and 32 TCB channels, two 64x64 frames.

  * 4 ranks, the conv stem, temporal off and on (the state included) and
    with detect_fn: against the port's one-process forward and the JAX
    package's model.apply (and its detect_topk), at the 2e-4 of
    tests/test_spatial.py:31-38;
  * 4 ranks, the fused stem on its plain version (so K3's halo handling is
    checked here) and the fused2 stem (K3 + K4 as one segment), against the
    one-process forward;
  * 2 ranks, ResNet-101 with GroupNorm at width 0.0625 (the norms take the
    whole frame's statistics across the bands), against the one-process
    forward;
  * every rank returns the same outputs; a frame whose H does not split
    into equal bands raises.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.ops.detection import detect_topk as j_detect_topk
from tdrn_tpu.ops.priors import prior_boxes as j_prior_boxes
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.detection import detect_topk
from tdrn_tpu_torch.ops.priors import prior_boxes
from tdrn_tpu_torch.parallel.distributed import spawn_ranks
from tdrn_tpu_torch.parallel.mesh import Mesh
from tdrn_tpu_torch.parallel.spatial import spatial_forward
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-4  # rtol and atol, tests/test_spatial.py
SMALL = dict(width_mult=0.125, tcb_channels=32)
VGG = {
    "conv": dict(build=dict(temporal=False, **SMALL), seed=9),
    "conv_temporal": dict(build=dict(temporal=True, **SMALL), seed=9),
    "conv_detect": dict(build=dict(temporal=False, **SMALL), seed=10, detect=True),
    "fused_temporal": dict(build=dict(temporal=True, stem="fused", **SMALL), seed=11),
    "fused2": dict(build=dict(temporal=False, stem="fused2", **SMALL), seed=12),
}
RESNET = {
    "resnet_group": dict(build=dict(temporal=False, backbone="resnet101", backbone_norm="group",
                                    width_mult=0.0625, tcb_channels=32), seed=13),
}
JAX_CASES = ("conv", "conv_temporal", "conv_detect")


def _inputs():
    rng = np.random.default_rng(31)
    x = (rng.normal(size=(2, 64, 64, 3)) * 30).astype(np.float32)
    model = build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL)
    state = [(rng.normal(size=tuple(s.shape)) * 0.5).astype(np.float32)
             for s in model.zero_state(2)]
    return x, state


X, STATE = _inputs()


def _model(case):
    return weights.load_random_params(
        build_detector(tcfg.TINY_64, device="cpu", **case["build"]), case["seed"])


def _one_process(case):
    model = _model(case)
    st = [torch.from_numpy(s) for s in STATE] if case["build"]["temporal"] else None
    with torch.no_grad():
        preds, new_state = model(torch.from_numpy(X), st)
        if case.get("detect"):
            preds = detect_topk(preds, prior_boxes(tcfg.TINY_64, "cpu"), tcfg.TINY_64)
    return ([t.numpy() for t in preds if t is not None],
            None if new_state is None else [s.numpy() for s in new_state])


def _jax(case):
    """The JAX package's model.apply (and detect_topk) on the same params,
    frames and state: (outputs, state) in the port's layouts."""
    jm = j_build(jcfg.TINY_64, **case["build"])
    jp = jax.tree.map(jnp.asarray, weights.params_to_jax(_model(case).state_dict()))
    st = [jnp.asarray(s.transpose(0, 2, 3, 1)) for s in STATE] if case["build"]["temporal"] \
        else None  # the JAX state is NHWC

    def fwd(p, x, s):
        preds, new_state = jm.apply(p, x, s)
        if case.get("detect"):
            return j_detect_topk(preds, j_prior_boxes(jcfg.TINY_64), jcfg.TINY_64), new_state
        return preds, new_state

    out, new_state = jax.jit(fwd)(jp, jnp.asarray(X), st)
    out = [out.boxes, out.scores] if case.get("detect") else out
    return ([np.asarray(t) for t in out],
            None if st is None else [np.asarray(s).transpose(0, 3, 1, 2) for s in new_state])


@pytest.fixture(scope="module")
def runs():
    """case -> (every rank's outputs and state, the one-process forward);
    case -> the JAX forward. The ranks of both meshes run while this
    process computes the references."""
    with ThreadPoolExecutor(2) as pool:
        pending = {world: (cases, pool.submit(
            spawn_ranks, ranks.spatial_rank, world,
            [dict(c, name=n) for n, c in cases.items()], X, STATE))
            for world, cases in ((4, VGG), (2, RESNET))}
        single = {n: _one_process(c) for n, c in {**VGG, **RESNET}.items()}
        jax_runs = {n: _jax(VGG[n]) for n in JAX_CASES}
        out = {}
        for cases, future in pending.values():
            per_rank = future.result()
            out.update({n: ([r[n] for r in per_rank], single[n]) for n in cases})
    return out, jax_runs


def _close(got, want, what):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", list(VGG) + list(RESNET))
def test_spatial_matches_one_process(runs, name):
    per_rank, (ref, ref_state) = runs[0][name]
    first = per_rank[0]
    _close(first["out"], ref, f"{name} outputs")
    if ref_state is not None:
        _close(first["state"], ref_state, f"{name} state")
    for r, res in enumerate(per_rank):
        assert all(np.array_equal(a, b) for a, b in zip(res["out"], first["out"])), r
        if ref_state is not None:
            assert all(np.array_equal(a, b) for a, b in zip(res["state"], first["state"])), r


@pytest.mark.parametrize("name", JAX_CASES)
def test_spatial_matches_jax(runs, name):
    got = runs[0][name][0][0]
    want, want_state = runs[1][name]
    # Detections: the boxes and scores (the port's classes are compared
    # with its own one-process forward above).
    _close(got["out"][:len(want)], want, name)
    if want_state is not None:
        _close(got["state"], want_state, f"{name} state")


def test_uneven_bands_raise():
    """The check comes before any collective, so a mesh without a group
    shows it."""
    fwd = spatial_forward(ranks.tiny_model(False), Mesh(None, 0, 3, torch.device("cpu")))
    with pytest.raises(ValueError, match="equal bands"):
        fwd(torch.zeros(1, 64, 64, 3), None)
