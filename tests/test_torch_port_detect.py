"""The port's detect tail (detect, detect_topk, prefilter_overflow) against the
JAX package on identical random RawPredictions, with the fused cascade on and
off and the prefilter off and at 512, at TINY_64 and vid_320 shapes."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.ops import detection as JD
from tdrn_tpu.ops.priors import prior_boxes as j_prior_boxes
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch.ops import detection as TD
from tdrn_tpu_torch.ops.priors import prior_boxes

ATOL = 1e-5


def _raw(cfg, b, seed):
    """Random logits, nudged so no anchor's top class score lies within 1e-5
    of conf_thresh (the overflow flag is then decided away from rounding)."""
    rng = np.random.default_rng(seed)
    p, c = cfg.num_priors, cfg.num_classes
    raw = [
        (rng.normal(size=(b, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(b, p, 2)) * 2).astype("f4"),
        (rng.normal(size=(b, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(b, p, c)) * 3).astype("f4"),
    ]
    sm = torch.softmax(torch.from_numpy(raw[3]), -1)[..., 1:].amax(-1).numpy()
    near = np.abs(sm - cfg.conf_thresh) < 1e-4
    raw[3][near, 0] -= 1.0  # lowers background, raises every class score
    return raw


@pytest.mark.parametrize("name,b", [("tiny_64", 2), ("vid_320", 2)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("prefilter", [0, 512])
def test_detect_tail_matches_jax(name, b, fused, prefilter):
    tc = dataclasses.replace(
        tcfg.get_config(name), fused_cascade=fused, prefilter_anchors=prefilter
    )
    jc = dataclasses.replace(
        jcfg.get_config(name), fused_cascade=fused, prefilter_anchors=prefilter
    )
    raw = _raw(tc, b, seed=7)
    tpreds = TD.RawPredictions(*map(torch.from_numpy, raw))
    jpreds = JD.RawPredictions(*map(jnp.asarray, raw))
    tpri, jpri = prior_boxes(tc, "cpu"), j_prior_boxes(jc)

    got = TD.detect(tpreds, tpri, tc).numpy()
    ref = np.asarray(JD.detect(jpreds, jpri, jc))
    assert got.shape == ref.shape == (b, tc.num_classes, tc.top_k, 5)
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)

    k = 50
    got_t = TD.detect_topk(tpreds, tpri, tc, top_k=k)
    ref_t = jax.tree.map(np.asarray, JD.detect_topk(jpreds, jpri, jc, top_k=k))
    assert got_t.classes.dtype == torch.int32
    np.testing.assert_array_equal(got_t.classes.numpy(), ref_t.classes)
    np.testing.assert_allclose(got_t.scores.numpy(), ref_t.scores, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_t.boxes.numpy(), ref_t.boxes, atol=ATOL, rtol=0)
    on = prefilter and prefilter < tc.num_priors
    if on:
        np.testing.assert_array_equal(
            got_t.prefilter_overflow.numpy(), ref_t.prefilter_overflow
        )
        np.testing.assert_array_equal(
            TD.prefilter_overflow(tpreds, tpri, tc).numpy(), ref_t.prefilter_overflow
        )
    else:
        assert got_t.prefilter_overflow is None and ref_t.prefilter_overflow is None


def test_prefilter_overflow_both_ways():
    """A sparse frame (few anchors above conf_thresh) keeps the flag False; a
    dense one sets it, on both branches."""
    cfg = tcfg.VID_320
    raw = _raw(cfg, 2, seed=3)
    raw[3][0, :, 0] += 40.0  # frame 0: background dominates everywhere
    preds = TD.RawPredictions(*map(torch.from_numpy, raw))
    for fused in (False, True):
        c = dataclasses.replace(cfg, fused_cascade=fused, prefilter_anchors=512)
        flag = TD.detect_topk(preds, prior_boxes(c, "cpu"), c).prefilter_overflow
        assert flag.tolist() == [False, True]


def test_unported_selection_raises():
    cfg = tcfg.TINY_64
    preds = TD.RawPredictions(*map(torch.from_numpy, _raw(cfg, 1, seed=0)))
    pri = prior_boxes(cfg, "cpu")
    for bad in (dict(approx_topk=True), dict(prefilter_anchors=64, prefilter_recall=0.9)):
        with pytest.raises(NotImplementedError):
            TD.detect(preds, pri, dataclasses.replace(cfg, **bad))
