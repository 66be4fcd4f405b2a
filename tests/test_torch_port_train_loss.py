"""The port's training targets and loss against the JAX package's, with no
backbone: seeded raw predictions and padded targets on the TINY_64 and the
VID_320 priors (6375), with a zero-GT image, all-invalid padding rows and
two GTs sharing a best prior (the later one must win).

  * encode, match and match_batch (shared and per-image refined priors):
    conf targets exact, loc targets and matched IoUs within 1e-6
    (tests/test_refine_match.py);
  * the mining masks: exact, equal-CE ties included;
  * multibox_loss and refine_multibox_loss: values and metrics within 1e-5
    relative, gradients with respect to the four prediction tensors within
    1e-5 of max|ref| against jax.grad.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.ops import boxes as jboxes
from tdrn_tpu.ops import matching as jmatch
from tdrn_tpu.ops.detection import RawPredictions as JRaw
from tdrn_tpu.ops.priors import prior_boxes as j_priors
from tdrn_tpu.train import loss as jloss
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch.ops import boxes as tboxes
from tdrn_tpu_torch.ops import matching as tmatch
from tdrn_tpu_torch.ops.detection import RawPredictions as TRaw
from tdrn_tpu_torch.train import loss as tloss
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

MATCH_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
CFGS = {"tiny_64": (jcfg.TINY_64, tcfg.TINY_64), "vid_320": (jcfg.VID_320, tcfg.VID_320)}
# The JAX functions jitted at XLA's lowest backend optimization level: one
# quick compile a shape, and the same IEEE fp32 operations as eager dispatch
# (at the default level XLA's fused CPU loops round some IoUs otherwise: one
# VID_320 image of this module then took another best prior, a flipped near-tie).
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
j_match = jax.jit(jmatch.match, compiler_options=FAST_COMPILE)
j_match_batch = jax.jit(jmatch.match_batch, compiler_options=FAST_COMPILE)
j_mine = jax.jit(jloss._mine_negatives, static_argnums=3, compiler_options=FAST_COMPILE)


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _targets(rng, batch, g, num_classes):
    """Padded GT: image 0 has no valid row, image 1 valid rows then padding,
    image 2 two identical boxes (a shared best prior) of different labels."""
    xy = rng.uniform(0.0, 0.6, (batch, g, 2))
    wh = rng.uniform(0.05, 0.4, (batch, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, num_classes - 1, (batch, g)).astype(np.int32)
    valid = rng.random((batch, g)) < 0.8
    valid[0] = False
    valid[1, g // 2:] = False
    boxes[1, g // 2:] = 0.0  # zero padding rows
    boxes[2, 1] = boxes[2, 0]
    valid[2, :2] = True
    labels[2, :2] = (0, 1)
    return boxes, labels, valid


@pytest.fixture(scope="module", params=sorted(CFGS))
def case(request):
    jc, tc = CFGS[request.param]
    priors = np.asarray(j_priors(jc))
    rng = np.random.default_rng(3)
    batch, g = 4, 6
    boxes, labels, valid = _targets(rng, batch, g, tc.num_classes)
    p = priors.shape[0]
    preds = [rng.normal(0.0, 1.0, (batch, p, k)).astype(np.float32)
             for k in (4, 2, 4, tc.num_classes)]
    return dict(jc=jc, tc=tc, priors=priors, boxes=boxes, labels=labels, valid=valid,
                preds=preds)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _same_match(a, b):
    np.testing.assert_array_equal(np.asarray(a.conf_targets), b.conf_targets.numpy())
    np.testing.assert_allclose(b.loc_targets.numpy(), np.asarray(a.loc_targets), rtol=0,
                               atol=MATCH_ATOL)
    np.testing.assert_allclose(b.matched_ious.numpy(), np.asarray(a.matched_ious), rtol=0,
                               atol=MATCH_ATOL)


def test_encode_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.7, (3, 50, 2))
    matched = np.concatenate([xy, xy + rng.uniform(0.01, 0.3, (3, 50, 2))], -1).astype(np.float32)
    priors = np.concatenate([rng.uniform(0.1, 0.9, (3, 50, 2)),
                             rng.uniform(0.02, 0.5, (3, 50, 2))], -1).astype(np.float32)
    want = np.asarray(jboxes.encode(*_j(matched, priors), (0.1, 0.2)))
    got = tboxes.encode(*_t(matched, priors), (0.1, 0.2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MATCH_ATOL)


def test_match_single_image(case):
    for i in range(case["boxes"].shape[0]):
        args = (case["boxes"][i], case["labels"][i], case["valid"][i], case["priors"])
        _same_match(j_match(*_j(*args)),
                    tmatch.match(*_t(*args), 0.5, (0.1, 0.2)))


def test_match_batch_shared_and_refined_priors(case):
    gt = (case["boxes"], case["labels"], case["valid"])
    _same_match(j_match_batch(*_j(*gt, case["priors"])),
                tmatch.match_batch(*_t(*gt, case["priors"])))
    # Per-image refined anchors: the ARM loc decoded against the priors.
    refined = np.asarray(_jit(lambda loc, pr: jboxes.center_size(jboxes.decode(
        loc * 0.5, pr, (0.1, 0.2))))(jnp.asarray(case["preds"][0]), jnp.asarray(case["priors"])))
    _same_match(j_match_batch(*_j(*gt, refined)), tmatch.match_batch(*_t(*gt, refined)))


def test_match_semantics(case):
    """No positive where every GT row is invalid; a shared best prior goes
    to the later GT with overlap 2.0; loc targets are zero on background."""
    m = tmatch.match_batch(*_t(case["boxes"], case["labels"], case["valid"], case["priors"]))
    assert int((m.conf_targets[0] > 0).sum()) == 0
    assert float(m.loc_targets[0].abs().max()) == 0.0
    forced = m.matched_ious[2] == 2.0
    assert bool(forced.any())
    # boxes 0 and 1 of image 2 are equal, so they claim the same best prior: label 1 wins.
    best = int(torch.argmax(tboxes.iou(torch.from_numpy(case["boxes"][2, :1]),
                                       tboxes.point_form(torch.from_numpy(case["priors"])))[0]))
    assert int(m.conf_targets[2, best]) == 1 + 1
    bg = m.conf_targets == 0
    assert float(m.loc_targets[bg].abs().max()) == 0.0
    with pytest.raises(ValueError):
        tmatch.match_batch(*_t(case["boxes"], case["labels"], case["valid"],
                               case["priors"][None, None]))


def test_mining_masks_exact_with_ties():
    rng = np.random.default_rng(5)
    b, p = 3, 997
    # One decimal: many equal CE values, so the tie order decides.
    ce = np.round(rng.uniform(0, 3, (b, p)), 1).astype(np.float32)
    pos = rng.random((b, p)) < 0.05
    pos[2] = False  # no positive: no negative either
    eligible = rng.random((b, p)) < 0.9
    for ratio in (3.0, 0.5):
        want = np.asarray(j_mine(*_j(ce, pos, eligible), ratio))
        got = tloss._mine_negatives(*_t(ce, pos, eligible), ratio).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 0 and not got[2].any()


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_refine_multibox_loss_values_and_grads(case):
    jt = jloss.Targets(*_j(case["boxes"], case["labels"], case["valid"]))
    tt = tloss.Targets(*_t(case["boxes"], case["labels"], case["valid"]))

    def jfn(*p):
        return jloss.refine_multibox_loss(JRaw(*p), jnp.asarray(case["priors"]), jt, case["jc"])

    (jv, jm), jg = _jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True))(
        *_j(*case["preds"]))
    tp = [t.requires_grad_(True) for t in _t(*[p.copy() for p in case["preds"]])]
    tv, tm = tloss.refine_multibox_loss(TRaw(*tp), torch.from_numpy(case["priors"]), tt,
                                        case["tc"])
    tg = torch.autograd.grad(tv, tp)
    assert _rel(tv.detach(), jv) <= LOSS_RTOL
    assert jm.keys() == tm.keys()
    for k in jm:
        assert _rel(tm[k].detach(), jm[k]) <= LOSS_RTOL, k
    assert float(tm["num_pos_arm"]) > 1 and float(tm["num_pos_odm"]) > 1
    for name, want, got in zip(("arm_loc", "arm_conf", "odm_loc", "odm_conf"), jg, tg):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_REL, (name, err)


def test_multibox_loss_values_and_grads(case):
    jt = jloss.Targets(*_j(case["boxes"], case["labels"], case["valid"]))
    tt = tloss.Targets(*_t(case["boxes"], case["labels"], case["valid"]))
    loc, conf = case["preds"][2], case["preds"][3]

    def jfn(lp, cp):
        return jloss.multibox_loss(lp, cp, jnp.asarray(case["priors"]), jt, case["jc"])

    (jv, jm), jg = _jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        *_j(loc, conf))
    tp = [t.requires_grad_(True) for t in _t(loc.copy(), conf.copy())]
    tv, tm = tloss.multibox_loss(*tp, torch.from_numpy(case["priors"]), tt, case["tc"])
    tg = torch.autograd.grad(tv, tp)
    assert _rel(tv.detach(), jv) <= LOSS_RTOL
    for k in jm:
        assert _rel(tm[k].detach(), jm[k]) <= LOSS_RTOL, k
    for want, got in zip(jg, tg):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= GRAD_REL


def test_smooth_l1_and_cross_entropy():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_array_equal(tloss.smooth_l1(torch.from_numpy(x)).numpy(),
                                  np.asarray(jloss.smooth_l1(jnp.asarray(x))))
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (5, 7, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (5, 7)).astype(np.int32)
    np.testing.assert_allclose(tloss._cross_entropy(*_t(logits, labels)).numpy(),
                               np.asarray(jloss._cross_entropy(*_j(logits, labels))),
                               rtol=1e-6, atol=1e-6)
