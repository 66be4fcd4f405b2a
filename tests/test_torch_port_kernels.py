"""The port's three kernel wrappers, on the CPU (their plain versions), held
against the JAX package: K1 cascade vs fused_refine_cascade (interpret mode)
and decode_two_stage, K2 NMS suppression (through the port's nms_fixed and
class_aware_nms_cm) vs nms.nms_fixed and the Pallas sweep, K3 stem vs
fused_stem_stage1 (interpret mode). Inputs come from seeded numpy."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.ops import boxes as JB
from tdrn_tpu.ops import nms as JN
from tdrn_tpu.ops import nms_pallas as JNP
from tdrn_tpu.ops.cascade_pallas import fused_refine_cascade as j_cascade
from tdrn_tpu.ops.detection import RawPredictions as JRaw
from tdrn_tpu.ops.detection import decode_two_stage as j_decode
from tdrn_tpu.ops.priors import prior_boxes_np as j_priors
from tdrn_tpu.ops.stem_pallas import fused_stem_stage1 as j_stem
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch.ops import nms as TN
from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
from tdrn_tpu_torch.ops.stem import fused_stem_stage1
from tests.test_geometry import random_boxes

T = torch.from_numpy


# --- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny_64", "vid_320"])
def test_cascade_plain_matches_jax(name):
    cfg, jc = tcfg.get_config(name), jcfg.get_config(name)
    p, c = cfg.num_priors, cfg.num_classes
    rng = np.random.default_rng(0)
    raw = [
        (rng.normal(size=(2, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(2, p, 2)) * 2).astype("f4"),
        (rng.normal(size=(2, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(2, p, c)) * 2).astype("f4"),
    ]
    priors = j_priors(jc)
    boxes, scores_cm = fused_refine_cascade(
        RawPredictions(*map(T, raw)), torch.tensor(priors), cfg
    )
    jpreds = JRaw(*map(jnp.asarray, raw))
    kb, ks = j_cascade(jpreds, jnp.asarray(priors), jc, interpret=True)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(kb), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(scores_cm.numpy(), np.asarray(ks), atol=1e-5, rtol=1e-4)
    # decode_two_stage goes through xyxy and back: fp32 rounding apart.
    db, ds = j_decode(jpreds, jnp.asarray(priors), jc)
    ref_cm = np.asarray(ds).transpose(0, 2, 1).copy()
    ref_cm[:, 0, :] = 0.0
    np.testing.assert_allclose(boxes.numpy(), np.asarray(db), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(scores_cm.numpy(), ref_cm, atol=1e-5, rtol=1e-4)


def test_cascade_per_anchor_is_the_class_max():
    """The prefilter's per-anchor score: the max of the C stored scores,
    background row included, bit for bit, and JAX's max over its kernel's
    class rows (tdrn_tpu/ops/detection.py) at the K1 tolerance."""
    cfg, jc = tcfg.TINY_64, jcfg.TINY_64
    p, c = cfg.num_priors, cfg.num_classes
    rng = np.random.default_rng(1)
    raw = [
        (rng.normal(size=(3, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(3, p, 2)) * 2).astype("f4"),
        (rng.normal(size=(3, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(3, p, c)) * 2).astype("f4"),
    ]
    priors = j_priors(jc)
    preds = RawPredictions(*map(T, raw))
    boxes, scores_cm = fused_refine_cascade(preds, torch.tensor(priors), cfg)
    top = torch.full((3, p), -1.0)
    b2, s2 = fused_refine_cascade(preds, torch.tensor(priors), cfg, per_anchor=top)
    assert torch.equal(b2, boxes) and torch.equal(s2, scores_cm)
    assert torch.equal(top, scores_cm.amax(dim=1))
    assert bool((top == 0).any()) and bool((top > 0).any())  # ARM-filtered anchors too
    _, ks = j_cascade(JRaw(*map(jnp.asarray, raw)), jnp.asarray(priors), jc, interpret=True)
    np.testing.assert_allclose(top.numpy(), np.asarray(jnp.max(ks, axis=1)), atol=1e-5, rtol=1e-4)


# --- K2 ---------------------------------------------------------------------


def _nms_case(case, seed):
    """(boxes (P, 4), scores (P,), top_k, score_thresh) for one NMS case."""
    rng = np.random.RandomState(seed)
    if case == "random":  # tests/test_nms_pallas.py::test_matches_reference
        return random_boxes(rng, 300), rng.uniform(0, 1, 300).astype("f4"), 100, 0.0
    if case == "padding":  # ... ::test_score_thresh_and_padding
        boxes = np.array([[0.1, 0.1, 0.2, 0.2], [0.5, 0.5, 0.6, 0.6]], "f4")
        return boxes, np.array([0.5, 0.005], "f4"), 10, 0.01
    if case == "ties":  # exact score ties, lowest index ranks first
        scores = rng.choice(np.array([0.0, 0.2, 0.5, 0.9], "f4"), 150)
        return random_boxes(rng, 150), scores, 60, 0.0
    if case == "degenerate":  # zero-area and inverted boxes among real ones
        boxes = random_boxes(rng, 120)
        boxes[::3, 2] = boxes[::3, 0]
        boxes[1::7, 3] = boxes[1::7, 1] - 0.05
        boxes[2::11] = boxes[2::11, :1]
        return boxes, rng.uniform(0, 1, 120).astype("f4"), 80, 0.0
    if case == "sparse":  # 16 positive scores: the sorted row ends in 184 empty slots
        scores = np.zeros(300, "f4")
        scores[rng.choice(300, 16, replace=False)] = rng.uniform(0.1, 1, 16)
        return random_boxes(rng, 300), scores, 200, 0.0
    if case == "few":  # fewer candidates than top_k, duplicates included
        boxes = random_boxes(rng, 12)
        boxes[5] = boxes[4]
        return boxes, rng.uniform(0, 1, 12).astype("f4"), 50, 0.01
    raise ValueError(case)


CASES = [("random", 0), ("random", 1), ("random", 2), ("padding", 0),
         ("ties", 3), ("degenerate", 4), ("few", 5), ("sparse", 6)]


@pytest.mark.parametrize("case,seed", CASES)
def test_nms_fixed_matches_jax(case, seed):
    boxes, scores, top_k, thresh = _nms_case(case, seed)
    got = TN.nms_fixed(T(boxes), T(scores), 0.45, top_k=top_k, score_thresh=thresh)
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    for ref in (
        JN.nms_fixed(jb, js, 0.45, top_k=top_k, score_thresh=thresh),
        JNP.nms_fixed_pallas(jb, js, 0.45, top_k=top_k, score_thresh=thresh, interpret=True),
    ):
        np.testing.assert_array_equal(got.keep.numpy(), np.asarray(ref.keep))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-6)
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=1e-6)
    assert got.scores.shape == (top_k,) and got.boxes.shape == (top_k, 4)


@pytest.mark.parametrize("k", [65, 200])
@pytest.mark.parametrize("thresh", [0.0, 0.45])
def test_suppress_sorted_matches_jax_on_sparse_rows(k, thresh):
    """Score-sorted rows whose positive scores end early, with zeros inside
    them, and an all-empty row (what the kernel's n_valid and empty-slot
    skips see): the keep mask equals JAX's greedy fixpoint (nms.py) and its
    Pallas sweep (interpret mode), exactly, at thresholds 0 and 0.45."""
    rng = np.random.RandomState(k)
    n = 4
    boxes = np.stack([random_boxes(rng, k) for _ in range(n)])
    scores = np.sort(rng.uniform(0.01, 1, (n, k)).astype("f4"), -1)[:, ::-1].copy()
    scores[0, 16:] = 0.0  # ends early
    scores[1, 3::7] = 0.0  # zeros inside the row
    scores[2] = 0.0  # all empty
    scores[3, k // 2:] = 0.0  # both
    scores[3, 1:k // 2:5] = 0.0
    got = suppress_sorted(T(boxes), T(scores), thresh).numpy()
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    ref_pallas = np.asarray(JNP.suppress_sorted(jb, js, thresh, interpret=True))
    for r in range(n):
        keep = JN._greedy_keep_fixpoint(JB.iou(jb[r], jb[r]), js[r] > 0.0, thresh)
        np.testing.assert_array_equal(got[r] > 0, np.asarray(keep))
    np.testing.assert_array_equal(got, ref_pallas)
    assert not got[2].any() and (got[0, 16:] == 0).all()


@pytest.mark.parametrize("num_boxes,top_k", [(200, 60), (40, 100)])
def test_class_aware_nms_matches_jax(num_boxes, top_k):
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, num_boxes)
    cls_scores = rng.uniform(0, 1, (num_boxes, 7)).astype("f4")
    cls_scores[rng.rand(num_boxes) < 0.3, 2] = 0.5  # ties inside one class
    jb, js = jnp.asarray(boxes), jnp.asarray(cls_scores)
    ref = np.asarray(JN.class_aware_nms(jb, js, 0.45, top_k=top_k, score_thresh=0.01))
    ref_pallas = np.asarray(JNP.class_aware_nms_pallas(
        jb, js, 0.45, top_k=top_k, score_thresh=0.01, interpret=True))
    scores_cm = cls_scores.T.copy()
    scores_cm[0] = 0.0
    got_cm = TN.class_aware_nms_cm(T(boxes), T(scores_cm), 0.45, top_k, 0.01).numpy()
    got = TN.class_aware_nms(T(boxes), T(cls_scores), 0.45, top_k, 0.01).numpy()
    for g in (got_cm, got):
        assert g.shape == ref.shape == (7, top_k, 5)
        np.testing.assert_array_equal(g[..., 0] > 0, ref[..., 0] > 0)
        np.testing.assert_allclose(g, ref, atol=1e-6)
        np.testing.assert_allclose(g, ref_pallas, atol=1e-6)


# --- K3 ---------------------------------------------------------------------

# bf16 tolerance, relative to max|ref|: o1 is rounded to bf16 after a 27-term
# fp32 sum whose order differs between XLA and the port, so an o1 value on a
# rounding boundary can land one bf16 ulp apart; that moves an output by
# about ulp(o1) * |k2|, near 1e-4 of max|ref| at these scales. Measured here
# over 8 draws: at most 4e-6. chip_smoke.py holds the kernel to the same bound.
STEM_BF16_REL_TOL = 1e-3


def _stem_inputs(b, h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(b, h, w, 3)).astype("f4"),
        (rng.normal(size=(3, 3, 3, n)) * 0.3).astype("f4"),
        rng.normal(size=(n,)).astype("f4"),
        (rng.normal(size=(3, 3, n, n)) * 0.1).astype("f4"),
        rng.normal(size=(n,)).astype("f4"),
    ]


# (1, 32, 52, 16): W ragged, the last 16-wide tile of the card's kernel is
# partial, as in chip_smoke.py's ragged check (the JAX function needs H % 16 == 0).
@pytest.mark.parametrize("b,h,w,n", [(1, 64, 64, 8), (2, 32, 48, 16), (1, 32, 52, 16)])
def test_stem_plain_matches_jax_fp32(b, h, w, n):
    args = _stem_inputs(b, h, w, n)
    got = fused_stem_stage1(*map(T, args), compute_dtype=torch.float32)
    ref = j_stem(*map(jnp.asarray, args), compute_dtype=jnp.float32, interpret=True)
    assert got.shape == (b, h // 2, w // 2, n) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,w,n", [(1, 64, 64, 8), (2, 32, 48, 16), (1, 32, 52, 16)])
def test_stem_plain_matches_jax_bf16(b, h, w, n):
    args = _stem_inputs(b, h, w, n, seed=1)
    got = fused_stem_stage1(*map(T, args)).numpy()
    ref = np.asarray(j_stem(*map(jnp.asarray, args), interpret=True), "f4")
    assert got.dtype == np.float32 and got.shape == ref.shape
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < STEM_BF16_REL_TOL, rel
    got_bf16 = fused_stem_stage1(*map(T, args), out_dtype=torch.bfloat16)
    assert got_bf16.dtype == torch.bfloat16
