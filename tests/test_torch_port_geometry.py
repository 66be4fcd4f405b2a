"""The port's config, priors, box ops and preprocess against the JAX package."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.ops import boxes as JB
from tdrn_tpu.ops.preprocess import preprocess_batch as j_preprocess
from tdrn_tpu.ops.priors import prior_boxes_np as j_priors
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch.ops import boxes as TB
from tdrn_tpu_torch.ops.preprocess import preprocess_batch, preprocess_frame
from tdrn_tpu_torch.ops.priors import prior_boxes, prior_boxes_np


@pytest.mark.parametrize("name", sorted(jcfg.CONFIGS))
def test_config_fields_equal(name):
    ours, ref = tcfg.get_config(name), jcfg.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.num_priors == ref.num_priors
    assert ours.anchors_per_cell == ref.anchors_per_cell
    assert [f.name for f in dataclasses.fields(tcfg.DetectorConfig)] == [
        f.name for f in dataclasses.fields(jcfg.DetectorConfig)
    ]


@pytest.mark.parametrize("name", sorted(jcfg.CONFIGS))
def test_priors_bit_equal(name):
    ours = prior_boxes_np(tcfg.get_config(name))
    ref = j_priors(jcfg.get_config(name))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref)
    assert np.array_equal(prior_boxes(tcfg.get_config(name), "cpu").numpy(), ref)


def _rand_xyxy(rng, *shape):
    cxy = rng.uniform(0.1, 0.9, shape + (2,))
    wh = rng.uniform(0.0, 0.4, shape + (2,))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype("f4")


def test_box_ops_match():
    rng = np.random.default_rng(0)
    a, b = _rand_xyxy(rng, 3, 40), _rand_xyxy(rng, 3, 30)
    a[0, :5, 2] = a[0, :5, 0]  # zero-width boxes
    t = torch.from_numpy
    pairs = [
        (TB.point_form(t(a)), JB.point_form(jnp.asarray(a))),
        (TB.center_size(t(a)), JB.center_size(jnp.asarray(a))),
        (TB.intersect(t(a), t(b)), JB.intersect(jnp.asarray(a), jnp.asarray(b))),
        (TB.area(t(a)), JB.area(jnp.asarray(a))),
        (TB.iou(t(a), t(b)), JB.iou(jnp.asarray(a), jnp.asarray(b))),
    ]
    loc = (rng.normal(size=(3, 40, 4)) * 0.5).astype("f4")
    pri = np.array(JB.center_size(jnp.asarray(a)))
    pairs.append((TB.decode(t(loc), t(pri)), JB.decode(jnp.asarray(loc), jnp.asarray(pri))))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


# (source H, W): a downscale, an upscale and the identity.
@pytest.mark.parametrize("hw", [(96, 80), (48, 40), (64, 64)])
def test_preprocess_matches(hw):
    cfg = tcfg.TINY_64
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    got = preprocess_batch(torch.from_numpy(frames), cfg)
    ref = np.asarray(j_preprocess(jnp.asarray(frames), jcfg.TINY_64))
    assert got.shape == (2, 64, 64, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    one = preprocess_frame(torch.from_numpy(frames[1]), cfg)
    np.testing.assert_allclose(one.numpy(), ref[1], atol=1e-3, rtol=0)
