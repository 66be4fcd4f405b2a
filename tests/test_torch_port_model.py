"""The port's weights conversion, TDRN forward and StreamingDetector against the
JAX package at TINY_64, width_mult 0.125, 32 TCB channels: the same JAX
params drive both sides, the same seeded numpy inputs feed both."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import StreamingDetector, make_single_image_forward
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.detection import RawPredictions

SMALL = dict(tcb_channels=32, width_mult=0.125)
# Raw predictions and state of one forward: fp32 reassociation only, with
# the conv stem and with the fused stem alike (both sides round to bf16 at the
# same points). Measured: 3.6e-6 (conv), 4.1e-6 (fused).
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _params(temporal):
    """JAX init params; the conv and fused stems share one param tree."""
    cfg = jcfg.TINY_64
    model = j_build(cfg, temporal=temporal, **SMALL)
    x = jnp.zeros((1, cfg.size, cfg.size, 3), jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, None))


def _jax_model_and_params(stem, temporal, cfg=jcfg.TINY_64):
    return j_build(cfg, temporal=temporal, stem=stem, **SMALL), _params(temporal)


def _port_model(params, stem, temporal, cfg=tcfg.TINY_64):
    model = build_detector(cfg, temporal=temporal, stem=stem, device="cpu", **SMALL)
    return weights.load_jax_params(model, params)


def test_weights_round_trip_exact():
    _, params = _jax_model_and_params("conv", True)
    sd = weights.params_from_jax(params)
    back = weights.params_to_jax(sd)
    flat_a = dict(weights._flatten_tree(params["params"]))
    flat_b = dict(weights._flatten_tree(back["params"]))
    assert flat_a.keys() == flat_b.keys()
    for path, leaf in flat_a.items():
        assert leaf.dtype == flat_b[path].dtype and np.array_equal(leaf, flat_b[path]), path
    model = build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL)
    assert set(sd) == set(model.state_dict())
    # Bare trees load too; a missing key, an extra key or a bad shape raises.
    weights.load_jax_params(model, params["params"])
    bad = dict(sd)
    bad.pop("backbone.conv1_1.bias")
    with pytest.raises(RuntimeError):
        model.load_state_dict(bad, strict=True)
    tree = weights.params_to_jax(sd)
    tree["params"]["odm"]["conf0"]["kernel"] = np.zeros((3, 3, 32, 5), np.float32)
    with pytest.raises(RuntimeError):
        weights.load_jax_params(model, tree)
    tree = weights.params_to_jax(sd)
    tree["params"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError):
        weights.load_jax_params(model, tree)


@pytest.mark.parametrize("stem", ["conv", "fused"])
@pytest.mark.parametrize("temporal", [True, False])
def test_forward_matches_jax(stem, temporal):
    jmodel, params = _jax_model_and_params(stem, temporal)
    model = _port_model(params, stem, temporal)
    cfg = jcfg.TINY_64
    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 255, (2, cfg.size, cfg.size, 3)) - 117.0).astype("f4")
    state = [rng.normal(0, 0.5, (2, f, f, 32)).astype("f4") for f in cfg.feature_maps]
    jstate_in = [jnp.asarray(s) for s in state] if temporal else None
    jpreds, jstate = jmodel.apply(params, jnp.asarray(x), jstate_in)
    tstate_in = [torch.from_numpy(s.transpose(0, 3, 1, 2).copy()) for s in state]
    with torch.no_grad():
        tpreds, tstate = model(torch.from_numpy(x), tstate_in if temporal else None)
    for name in RawPredictions._fields:
        np.testing.assert_allclose(
            getattr(tpreds, name).numpy(), np.asarray(getattr(jpreds, name)),
            atol=ATOL, rtol=0, err_msg=name,
        )
    if temporal:
        for k, (t, j) in enumerate(zip(tstate, jstate)):
            np.testing.assert_allclose(
                t.numpy().transpose(0, 2, 3, 1), np.asarray(j), atol=ATOL, rtol=0,
                err_msg=f"state{k}",
            )
    else:
        assert tstate is None and jstate is None


# Streaming through the fused stem: the resize differs by up to 5e-5 pixel
# levels between the two stacks, and the stem then rounds x to bf16, whose
# ulp is 0.5 at 100, so a pixel near a rounding boundary lands one ulp apart
# on the two sides. Measured over the 5 steps: state 1.1e-3, scores 1.3e-4.
STATE_ATOL = 5e-3
SCORE_ATOL = 5e-4


def _same_detections(t, j, lanes):
    ts, js = t.scores.numpy()[lanes], np.asarray(j.scores)[lanes]
    tb, jb = t.boxes.numpy()[lanes], np.asarray(j.boxes)[lanes]
    np.testing.assert_allclose(ts, js, atol=SCORE_ATOL, rtol=0)
    same = np.all(np.abs(tb - jb) < 1e-2, axis=-1)
    assert same.mean() > 0.9
    np.testing.assert_allclose(tb[same], jb[same], atol=STATE_ATOL, rtol=0)


def test_streaming_matches_jax():
    """3 streams x 5 steps of 96x80 frames through both detectors (fused
    cascade, fused stem); lane 1 resets before step 3, lane 2 skips step 4."""
    cfg_j = dataclasses.replace(jcfg.TINY_64, fused_cascade=True)
    cfg_t = dataclasses.replace(tcfg.TINY_64, fused_cascade=True)
    jmodel, params = _jax_model_and_params("fused", True, cfg_j)
    model = _port_model(params, "fused", True, cfg_t)
    jdet = JStreamingDetector(jmodel, params, num_streams=3)
    tdet = StreamingDetector(model, num_streams=3, device="cpu")
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (5, 3, 96, 80, 3), dtype=np.uint8)
    for i in range(5):
        if i == 3:
            jdet.reset([1])
            tdet.reset([1])
        active = np.array([1, 1, 0 if i == 4 else 1], np.float32)
        j = jdet.detect(frames[i], active=active)
        t = tdet.detect(frames[i], active=active)
        assert t.boxes.shape == (3, cfg_t.top_k, 4)
        _same_detections(t, j, np.nonzero(active)[0])
        for k, (ts, js) in enumerate(zip(tdet.state, jdet._state)):
            np.testing.assert_allclose(
                ts.numpy().transpose(0, 2, 3, 1), np.asarray(js), atol=STATE_ATOL,
                rtol=0, err_msg=f"step {i} state{k}",
            )


def test_single_image_forward_matches_streaming_first_step():
    cfg = dataclasses.replace(tcfg.TINY_64, fused_cascade=True)
    model = build_detector(cfg, stem="fused", device="cpu", **SMALL)
    frames = np.random.default_rng(2).integers(0, 256, (2, 96, 80, 3), dtype=np.uint8)
    one = make_single_image_forward(model)(torch.from_numpy(frames))
    det = StreamingDetector(model, num_streams=2, device="cpu").detect(frames)
    assert torch.equal(one.scores, det.scores) and torch.equal(one.boxes, det.boxes)
