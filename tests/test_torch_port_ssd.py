"""The port's plain SSD baseline (models/ssd.py) and its approximate-selection
options against the JAX package.

SSD at TINY_64, width_mult 0.125: the forward on the same seeded weights and
inputs, and ``ssd_detect_topk`` on the same raw predictions. The selection
options ``approx_topk`` and ``prefilter_recall < 1``: the port selects
exactly, ties lowest index first, and on the CPU the JAX package's
``lax.approx_max_k`` falls back to the exact top-k with the same tie order
(checked here on tie-heavy scores), so the detect tails agree index for
index, at TINY_64 and at the 512 geometry's 16,320 priors (no backbone)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import ssd as jssd
from tdrn_tpu.ops import detection as JD
from tdrn_tpu.ops.priors import prior_boxes as j_prior_boxes
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models import ssd as tssd
from tdrn_tpu_torch.ops import detection as TD
from tdrn_tpu_torch.ops import nms as TN
from tdrn_tpu_torch.ops.priors import prior_boxes
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(width_mult=0.125)
ATOL = 1e-4  # forward, fp32 reassociation (tests/test_torch_port_model.py)
DET_ATOL = 1e-5  # decode and NMS (tests/test_nms_pallas.py)
SEL_ATOL = 1e-6  # detect tails on identical predictions


def _leaf_shapes(tree):
    return {path: tuple(v.shape) for path, v in weights._flatten_tree(tree["params"])}


@functools.lru_cache(maxsize=None)
def _ssd_pair():
    jmodel = jssd.build_ssd(jcfg.TINY_64, **SMALL)
    tmodel = weights.load_random_params(tssd.build_ssd(tcfg.TINY_64, device="cpu", **SMALL), 2)
    tree = weights.params_to_jax(tmodel.state_dict())
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    assert _leaf_shapes(tree) == _leaf_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x))
    assert "multibox" in tree["params"]
    return jmodel, tmodel, tree


def test_ssd_forward_and_detect_match_jax():
    jmodel, tmodel, tree = _ssd_pair()
    x = (np.random.default_rng(3).uniform(0, 255, (2, 64, 64, 3)) - 117.0).astype("f4")
    jloc, jconf = jax.jit(jmodel.apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        tloc, tconf = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(tloc.numpy(), np.asarray(jloc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), atol=ATOL, rtol=0)
    # The detect tail on the same (JAX's) predictions, scaled so that scores
    # spread over many classes and anchors.
    loc, conf = np.array(jloc), np.array(jconf) * 20.0
    k = 50
    ref = jax.tree.map(np.asarray, jssd.ssd_detect_topk(
        jnp.asarray(loc), jnp.asarray(conf), j_prior_boxes(jcfg.TINY_64), jcfg.TINY_64, top_k=k))
    got = tssd.ssd_detect_topk(torch.from_numpy(loc), torch.from_numpy(conf),
                               prior_boxes(tcfg.TINY_64, "cpu"), tcfg.TINY_64, top_k=k)
    assert got.classes.dtype == torch.int32 and got.scores.shape == (2, k)
    assert (got.scores > 0).sum() > 20
    np.testing.assert_array_equal(got.classes.numpy(), ref.classes)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, atol=DET_ATOL, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes, atol=DET_ATOL, rtol=0)
    det = tssd.ssd_detect(torch.from_numpy(loc), torch.from_numpy(conf),
                          prior_boxes(tcfg.TINY_64, "cpu"), tcfg.TINY_64)
    jdet = np.asarray(jssd.ssd_detect(jnp.asarray(loc), jnp.asarray(conf),
                                      j_prior_boxes(jcfg.TINY_64), jcfg.TINY_64))
    assert det.shape == jdet.shape == (2, 4, 200, 5)
    np.testing.assert_allclose(det.numpy(), jdet, atol=DET_ATOL, rtol=0)


def test_ssd_builds_with_resnet101_and_bf16():
    m = tssd.build_ssd(tcfg.TINY_64, backbone="resnet101", width_mult=0.0625, device="cpu",
                       dtype=torch.bfloat16)
    assert m.backbone.stem.weight.dtype == torch.bfloat16
    with torch.no_grad():
        loc, conf = m(torch.zeros(1, 64, 64, 3))
    assert loc.dtype == conf.dtype == torch.float32
    assert loc.shape == (1, tcfg.TINY_64.num_priors, 4)
    with pytest.raises(NotImplementedError):
        tssd.build_ssd(tcfg.TINY_64, device="cpu", dtype=torch.float16)


# --- approx_topk and prefilter_recall < 1 ------------------------------------


def _ties(rng, shape):
    s = rng.choice(np.linspace(0.0, 1.0, 7), shape).astype(np.float32)
    s[rng.random(shape) < 0.6] = 0.0  # score fields are mostly zero
    return s


@pytest.mark.parametrize("recall", [1.0, 0.95, 0.9])
def test_top_k_tie_order_matches_approx_max_k(recall):
    """On tie-heavy scores, the JAX package's approx_max_k on the CPU returns
    lax.top_k's indices, lowest index first among ties, and so does the
    port's selection with approx set."""
    rng = np.random.default_rng(int(recall * 100))
    for n, k in ((255, 64), (6375, 512), (16320, 512), (16320, 200)):
        s = _ties(rng, (2, n))
        jv, ji = jax.lax.approx_max_k(jnp.asarray(s), k, recall_target=recall)
        tv, ti = TN._top_k(torch.from_numpy(s), k, approx=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.asarray(ji), np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1]))


def _raw(cfg, b, seed):
    rng = np.random.default_rng(seed)
    p, c = cfg.num_priors, cfg.num_classes
    return [
        (rng.normal(size=(b, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(b, p, 2)) * 2).astype("f4"),
        (rng.normal(size=(b, p, 4)) * 0.5).astype("f4"),
        (rng.normal(size=(b, p, c)) * 3).astype("f4"),
    ]


@pytest.mark.parametrize("name,fused", [("tiny_64", False), ("tiny_64", True), ("vid_512", False)])
@pytest.mark.parametrize("option", ["approx_topk", "prefilter_recall"])
def test_selection_options_match_jax(name, fused, option):
    """detect and detect_topk with the option on, against the JAX package:
    indices and tie order exact (classes equal), values within 1e-6. At
    vid_512, logits sharpened so that many anchors tie at zero after the ARM
    filter."""
    kw = dict(approx_topk=True) if option == "approx_topk" else dict(prefilter_recall=0.9)
    prefilter = 64 if name == "tiny_64" else 512
    over = dict(fused_cascade=fused, prefilter_anchors=prefilter, **kw)
    tc = dataclasses.replace(tcfg.get_config(name), **over)
    jc = dataclasses.replace(jcfg.get_config(name), **over)
    raw = _raw(tc, 2, seed=21)
    if name == "vid_512":
        raw[1] *= 4.0  # about half of the anchors pass the ARM filter
    tpreds = TD.RawPredictions(*map(torch.from_numpy, raw))
    jpreds = JD.RawPredictions(*map(jnp.asarray, raw))
    tpri, jpri = prior_boxes(tc, "cpu"), j_prior_boxes(jc)
    got = TD.detect(tpreds, tpri, tc).numpy()
    ref = np.asarray(JD.detect(jpreds, jpri, jc))
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_allclose(got, ref, atol=SEL_ATOL, rtol=0)
    got_t = TD.detect_topk(tpreds, tpri, tc, top_k=100)
    ref_t = jax.tree.map(np.asarray, JD.detect_topk(jpreds, jpri, jc, top_k=100))
    np.testing.assert_array_equal(got_t.classes.numpy(), ref_t.classes)
    np.testing.assert_allclose(got_t.scores.numpy(), ref_t.scores, atol=SEL_ATOL, rtol=0)
    np.testing.assert_allclose(got_t.boxes.numpy(), ref_t.boxes, atol=SEL_ATOL, rtol=0)
    np.testing.assert_array_equal(got_t.prefilter_overflow.numpy(), ref_t.prefilter_overflow)
