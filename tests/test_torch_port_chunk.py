"""The port's chunked streaming, clip forward and conv1_1 transforms against the
JAX package at TINY_64, width_mult 0.125, 32 TCB channels: the same JAX params
drive both sides (weights.params_from_jax), the same seeded numpy inputs feed
both.

- TDRN at chunk=2 and StreamingDetector(chunk=2), reset at the chunk boundary
  included (mirrors tests/test_chunk_streaming.py);
- make_clip_forward;
- fold_mean_params / pad_stem_params (exact) and the transformed forwards
  (mirrors tests/test_precision.py), with the reference's refusals.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.inference import make_clip_forward as j_clip_forward
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.ops.preprocess import preprocess_batch as j_preprocess
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import StreamingDetector, make_clip_forward
from tdrn_tpu_torch.models.detector import TDRN, build_detector
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.utils import precision as tprec

SMALL = dict(tcb_channels=32, width_mult=0.125)
# Raw predictions and state of a forward, port against JAX: fp32
# reassociation only (the end-to-end forward's tolerance,
# tests/test_torch_parity.py).
ATOL = 1e-4
# End-to-end streaming with the conv stem, fp32 (tests/test_chunk_streaming.py).
SCORE_ATOL = 5e-6
STATE_ATOL = 1e-5
# Clip forward, port against JAX: detections.
DET_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _params():
    model = j_build(jcfg.TINY_64, temporal=True, **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, None))


def _models(stem="conv", cfg_j=jcfg.TINY_64, cfg_t=tcfg.TINY_64):
    jmodel = j_build(cfg_j, temporal=True, stem=stem, **SMALL)
    tmodel = build_detector(cfg_t, temporal=True, stem=stem, device="cpu", **SMALL)
    return jmodel, weights.load_jax_params(tmodel, _params())


def _nchw(s):
    return torch.from_numpy(np.ascontiguousarray(s.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _forward_pair(jmodel, jparams, tmodel, x, state):
    """Both forwards on the same x (NHWC) and state (per scale, NHWC); the
    JAX one jitted (one XLA compile instead of one per op: ~2 s here against
    ~13 s eagerly, the same values to 3e-7)."""
    jp, js = jax.jit(jmodel.apply)(jparams, jnp.asarray(x), [jnp.asarray(s) for s in state])
    with torch.no_grad():
        tp, ts = tmodel(torch.from_numpy(x), [_nchw(s) for s in state])
    return (jp, js), (tp, ts)


def _assert_forward_close(j, t, atol=ATOL):
    (jp, js), (tp, ts) = j, t
    for name in RawPredictions._fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   atol=atol, rtol=0, err_msg=name)
    for k, (a, b) in enumerate(zip(ts, js)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=f"state{k}")


def test_chunk_model_matches_jax():
    """chunk=2 forward over 2 frames x 2 streams, frame-major, against the JAX
    model at chunk=2; and against two chunk=1 forwards of the port."""
    jmodel, tmodel = _models()
    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 255, (4, 64, 64, 3)) - 117.0).astype("f4")
    state = [rng.normal(0, 0.5, (2, f, f, 32)).astype("f4") for f in jcfg.TINY_64.feature_maps]
    t2 = tmodel.clone(chunk=2)
    assert t2.chunk == 2 and tmodel.chunk == 1 and t2.backbone is tmodel.backbone
    _assert_forward_close(*_forward_pair(jmodel.clone(chunk=2), _params(), t2, x, state))
    with torch.no_grad():
        p2, s2 = t2(torch.from_numpy(x), [_nchw(s) for s in state])
        p0, s0 = tmodel(torch.from_numpy(x[:2]), [_nchw(s) for s in state])
        p1, s1 = tmodel(torch.from_numpy(x[2:]), s0)
    for name in RawPredictions._fields:
        both = torch.cat([getattr(p0, name), getattr(p1, name)])
        np.testing.assert_allclose(getattr(p2, name).numpy(), both.numpy(), atol=2e-5, rtol=0)
    for a, b in zip(s2, s1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


def _sorted_scores(det, i=None):
    return np.sort(np.asarray(det.scores if i is None else det.scores[i]), axis=-1)


def test_streaming_chunk2_matches_jax():
    """2 streams x 4 frames in two chunk=2 steps, lane 1 reset at the chunk
    boundary: against the port's chunk=1 detector (as the JAX package holds
    its own) and against JAX's chunk=2 detector."""
    jmodel, tmodel = _models()
    streams, n = 2, 4
    frames = np.random.RandomState(0).randint(0, 255, (n, streams, 64, 64, 3), np.uint8)
    ref = StreamingDetector(tmodel, num_streams=streams, device="cpu")
    det2 = StreamingDetector(tmodel, num_streams=streams, chunk=2, device="cpu")
    jdet2 = JStreamingDetector(jmodel, _params(), num_streams=streams, chunk=2)
    ref_dets = []
    for t in range(n):
        if t == 2:
            ref.reset([1])
        ref_dets.append(ref.detect(frames[t]))
    out_a = det2.detect(frames[0:2])
    jout_a = jdet2.detect(frames[0:2])
    det2.reset([1])
    jdet2.reset([1])
    out_b = det2.detect(frames[2:4])
    jout_b = jdet2.detect(frames[2:4])
    assert out_a.boxes.shape == (2, streams, tcfg.TINY_64.top_k, 4)
    assert out_a.classes.shape == (2, streams, tcfg.TINY_64.top_k)
    for t, out, jout in zip(range(n), (out_a, out_a, out_b, out_b), (jout_a, jout_a, jout_b, jout_b)):
        i = t % 2
        np.testing.assert_allclose(_sorted_scores(out, i), _sorted_scores(ref_dets[t]),
                                   atol=SCORE_ATOL, rtol=0, err_msg=f"frame {t} vs chunk 1")
        np.testing.assert_allclose(_sorted_scores(out, i), _sorted_scores(jout, i),
                                   atol=SCORE_ATOL, rtol=0, err_msg=f"frame {t} vs JAX")
    for k, (s2, s1, js) in enumerate(zip(det2.state, ref.state, jdet2._state)):
        np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=STATE_ATOL, rtol=0)
        np.testing.assert_allclose(_nhwc(s2), np.asarray(js), atol=STATE_ATOL, rtol=0,
                                   err_msg=f"state{k} vs JAX")
    with pytest.raises(ValueError, match="uint8"):
        det2.detect(frames[0])  # (S, H, W, 3) where (chunk, S, H, W, 3) is due


def test_chunk_reset_applies_at_chunk_boundary():
    _, tmodel = _models()
    frames = np.random.RandomState(1).randint(0, 255, (2, 1, 64, 64, 3), np.uint8)
    det = StreamingDetector(tmodel, num_streams=1, chunk=2, device="cpu")
    det.detect(frames)
    det.reset([0])
    fresh = det.detect(frames)
    clean = StreamingDetector(tmodel, num_streams=1, chunk=2, device="cpu").detect(frames)
    assert torch.equal(fresh.scores, clean.scores) and torch.equal(fresh.boxes, clean.boxes)


def test_state_is_updated_in_place():
    """det.state holds the live buffers: a step writes them in place, so a
    caller that keeps a snapshot clones it."""
    _, tmodel = _models()
    det = StreamingDetector(tmodel, num_streams=2, device="cpu")
    live = det.state
    before = [s.clone() for s in live]
    det.detect(np.random.RandomState(2).randint(0, 255, (2, 64, 64, 3), np.uint8))
    assert all(a is b for a, b in zip(det.state, live))
    assert not any(torch.equal(a, b) for a, b in zip(live, before))


def test_clone_shares_parameters_not_registries():
    """TDRN.clone shares every parameter and submodule, but registering a
    module, buffer or parameter on the copy leaves the original as it was."""
    _, tmodel = _models()
    t2 = tmodel.clone(chunk=2)
    assert all(a is b for a, b in zip(t2.parameters(), tmodel.parameters()))
    t2.extra = torch.nn.Linear(2, 2)
    t2.register_buffer("scratch", torch.zeros(1))
    t2.register_parameter("gain", torch.nn.Parameter(torch.ones(1)))
    t2.odm = torch.nn.Identity()
    names = dict(tmodel.named_children())
    assert "extra" not in names and not isinstance(names["odm"], torch.nn.Identity)
    assert "scratch" not in dict(tmodel.named_buffers())
    assert "gain" not in dict(tmodel.named_parameters())
    assert tmodel.chunk == 1


@pytest.mark.parametrize("form", ["numpy", "tensor", "bool tensor"])
def test_detect_takes_the_active_mask_as_array_or_tensor(form):
    """active as numpy or as a tensor gives the same step (the JAX detect
    takes device arrays as well)."""
    _, tmodel = _models()
    frames = np.random.RandomState(3).randint(0, 255, (2, 2, 64, 64, 3), np.uint8)
    mask = np.array([1.0, 0.0], np.float32)
    given = {"numpy": mask, "tensor": torch.from_numpy(mask),
             "bool tensor": torch.from_numpy(mask > 0)}[form]
    ref = StreamingDetector(tmodel, num_streams=2, device="cpu")
    det = StreamingDetector(tmodel, num_streams=2, device="cpu")
    for f in frames:
        want = ref.detect(f, active=mask)
        got = det.detect(f, active=given)
        assert torch.equal(got.scores, want.scores) and torch.equal(got.boxes, want.boxes)
    assert all(torch.equal(a, b) for a, b in zip(det.state, ref.state))
    # Lane 1 never ran: its state is still zero; lane 0 advanced.
    assert all(not s[1].any() and s[0].any() for s in det.state)


def test_clip_forward_matches_jax():
    """(T=3, B=2) clip of 72x64 frames (resized): the port's per-frame loop
    against the JAX scan, with the fused cascade."""
    cfg_j = dataclasses.replace(jcfg.TINY_64, fused_cascade=True)
    cfg_t = dataclasses.replace(tcfg.TINY_64, fused_cascade=True)
    jmodel, tmodel = _models(cfg_j=cfg_j, cfg_t=cfg_t)
    frames = np.random.default_rng(3).integers(0, 256, (3, 2, 72, 64, 3), dtype=np.uint8)
    j = j_clip_forward(jmodel)(_params(), jnp.asarray(frames))
    run = make_clip_forward(tmodel, device="cpu")
    t = run(frames)
    assert t.boxes.shape == (3, 2, cfg_t.top_k, 4) and t.classes.dtype == torch.int32
    js, jb, jc = (np.asarray(a) for a in (j.scores, j.boxes, j.classes))
    np.testing.assert_allclose(t.scores.numpy(), js, atol=DET_ATOL, rtol=0)
    # Boxes within DET_ATOL and classes exactly, where a score is not tied
    # with a neighbour in rank (near-ties may swap between the two stacks).
    untied = np.ones_like(js, bool)
    gap = np.abs(np.diff(js, axis=-1)) > 2 * DET_ATOL
    untied[..., 1:] &= gap
    untied[..., :-1] &= gap
    assert untied.mean() > 0.5
    np.testing.assert_allclose(t.boxes.numpy()[untied], jb[untied], atol=DET_ATOL, rtol=0)
    assert np.array_equal(t.classes.numpy()[untied], jc[untied])
    # The state starts at zero on every call: a second run repeats the first.
    again = run(frames)
    assert torch.equal(again.scores, t.scores) and torch.equal(again.boxes, t.boxes)


# --- fold-mean and pad-stem -------------------------------------------------


def _frames(seed, hw=(64, 64)):
    return np.random.RandomState(seed).randint(0, 255, (2, *hw, 3), np.uint8)


def test_fold_mean_params_match_jax():
    jmodel, tmodel = _models()
    jm, jp = jprec.apply_fold_mean(jmodel, _params())
    sd = tprec.fold_mean_params(tmodel.state_dict(), tcfg.TINY_64)
    want = weights.params_from_jax(jp)
    assert sd.keys() == want.keys()
    for key in sd:
        assert torch.equal(sd[key], want[key]), key
    assert sd["backbone.conv1_1.weight"].shape[1] == 4
    # The s2d stem's (O, 12, 3, 3) kernel folds position by position, as the
    # JAX package folds it.
    s2d = weights.load_random_params(build_detector(tcfg.TINY_64, stem="s2d", device="cpu", **SMALL), 1)
    tree = weights.params_to_jax(s2d.state_dict())
    want = weights.params_from_jax(jprec.fold_mean_params(tree, jcfg.TINY_64, stem="s2d"))
    got = tprec.fold_mean_params(s2d.state_dict(), tcfg.TINY_64, stem="s2d")
    assert got.keys() == want.keys() and got["backbone.conv1_1.weight"].shape[1] == 16
    for key in got:
        assert torch.equal(got[key], want[key]), key


def test_pad_stem_params_match_jax():
    jmodel, tmodel = _models()
    _, jp = jprec.apply_pad_stem(jmodel, _params(), pad_to=8)
    sd = tprec.pad_stem_params(tmodel.state_dict(), 8)
    want = weights.params_from_jax(jp)
    for key in sd:
        assert torch.equal(sd[key], want[key]), key
    assert sd["backbone.conv1_1.weight"].shape[1] == 8
    with pytest.raises(ValueError):
        tprec.pad_stem_params(tmodel.state_dict(), 3)


@pytest.mark.parametrize("hw", [(64, 64), (80, 96)])
def test_fold_mean_preprocess_matches_jax(hw):
    frames = _frames(4, hw)
    got = preprocess_batch(torch.from_numpy(frames), tcfg.TINY_64, fold_mean=True)
    want = np.asarray(j_preprocess(jnp.asarray(frames), jcfg.TINY_64, fold_mean=True))
    assert got.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got[..., 3], torch.ones(2, 64, 64))


def _raw(model, frames, fold):
    x = preprocess_batch(torch.from_numpy(frames), model.cfg, model.dtype, fold)
    with torch.no_grad():
        return model(x, model.zero_state(2))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-9))


def test_fold_mean_forward_matches_jax_and_the_unfolded_model():
    jmodel, tmodel = _models()
    frames = _frames(4)
    jm, jp = jprec.apply_fold_mean(jmodel, _params())
    tm = tprec.apply_fold_mean(tmodel)
    assert tm.fold_mean and not tmodel.fold_mean and tm.backbone.conv1_1.in_channels == 4
    x = np.asarray(j_preprocess(jnp.asarray(frames), jcfg.TINY_64, fold_mean=True))
    zero = [np.zeros((2, f, f, 32), "f4") for f in jcfg.TINY_64.feature_maps]
    _assert_forward_close(*_forward_pair(jm, jp, tm, x, zero))
    # The fold is exact up to reassociation (tests/test_precision.py: 1e-5).
    for a, b in zip(_raw(tm, frames, True)[0], _raw(tmodel, frames, False)[0]):
        assert _rel(a, b) < 1e-5


def test_pad_stem_forward_matches_jax_and_the_unpadded_model():
    jmodel, tmodel = _models()
    frames = _frames(6)
    jm, jp = jprec.apply_pad_stem(jmodel, _params(), pad_to=8)
    tm = tprec.apply_pad_stem(tmodel, 8)
    assert tm.pad_stem == 8 and tm.backbone.conv1_1.in_channels == 8
    x = np.asarray(j_preprocess(jnp.asarray(frames), jcfg.TINY_64))
    zero = [np.zeros((2, f, f, 32), "f4") for f in jcfg.TINY_64.feature_maps]
    _assert_forward_close(*_forward_pair(jm, jp, tm, x, zero))
    for a, b in zip(_raw(tm, frames, False)[0], _raw(tmodel, frames, False)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fold_first", [True, False])
def test_fold_mean_composes_with_bf16(fold_first):
    """Fold then bf16, or bf16 then fold: fp32 predictions, the bf16 carry,
    and the raw predictions close to the JAX package's composition."""
    jmodel, tmodel = _models()
    frames = _frames(5)
    if fold_first:
        tm = tprec.apply_inference_precision(tprec.apply_fold_mean(tmodel), "bf16")
        jm, jp = jprec.apply_inference_precision(*jprec.apply_fold_mean(jmodel, _params()), "bf16")
    else:
        tm = tprec.apply_fold_mean(tprec.apply_inference_precision(tmodel, "bf16"))
        jm, jp = jprec.apply_fold_mean(*jprec.apply_inference_precision(jmodel, _params(), "bf16"))
    assert tm.fold_mean and tm.dtype == torch.bfloat16
    assert tm.backbone.conv1_1.weight.dtype == torch.bfloat16
    preds, state = _raw(tm, frames, True)
    assert preds.odm_conf.dtype == torch.float32 and state[0].dtype == torch.bfloat16
    x = j_preprocess(jnp.asarray(frames), jcfg.TINY_64, jm.dtype, fold_mean=True)
    jpreds, _ = jax.jit(jm.apply)(jp, x, jm.zero_state(2))
    for a, b in zip(preds, jpreds):
        # bf16 convs summed in other orders (tests/test_torch_port_serving.py).
        assert _rel(a, torch.from_numpy(np.asarray(b, np.float32))) < 5e-2


def test_transforms_refuse_as_the_reference_does():
    for stem in ("fused", "fused2"):
        jmodel, tmodel = _models(stem)
        with pytest.raises(ValueError):
            jprec.apply_fold_mean(jmodel, _params())
        with pytest.raises(ValueError):
            tprec.apply_fold_mean(tmodel)
        with pytest.raises(ValueError):
            jprec.apply_pad_stem(jmodel, _params())
        with pytest.raises(ValueError):
            tprec.apply_pad_stem(tmodel)
        with pytest.raises(ValueError):
            TDRN(tcfg.TINY_64, stem=stem, fold_mean=True, **SMALL)


def test_streaming_fold_mean_chunk2_matches_unfolded():
    """The streaming step with both: fold-mean preprocess at chunk 2 against
    the plain model at chunk 1."""
    _, tmodel = _models()
    frames = np.random.RandomState(7).randint(0, 255, (2, 2, 64, 64, 3), np.uint8)
    det = StreamingDetector(tprec.apply_fold_mean(tmodel), num_streams=2, chunk=2, device="cpu")
    ref = StreamingDetector(tmodel, num_streams=2, device="cpu")
    out = det.detect(frames)
    for i in range(2):
        want = ref.detect(frames[i])
        np.testing.assert_allclose(_sorted_scores(out, i), _sorted_scores(want), atol=1e-5, rtol=0)
