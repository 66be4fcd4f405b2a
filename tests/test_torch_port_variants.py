"""The port's other VGG stems (s2d, poly, poly2) and temporal cells (light,
hybrid) against the JAX package at TINY_64, width_mult 0.125, 32 TCB
channels: one forward and a 3-step stream each, the s2d fold-mean kernel,
and the cells' pass-through initialisation.

The weights are a seeded draw through the port (weights.load_random_params),
converted to the JAX layout, and the converted tree must have exactly the
keys and shapes of the JAX model's own init (jax.eval_shape): both sides
then run the same parameters on the same seeded numpy inputs."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.models import temporal as jtemporal
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models import temporal as ttemporal
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.utils import precision as tprec
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(tcb_channels=32, width_mult=0.125)
ATOL = 1e-4  # fp32 reassociation only (tests/test_torch_port_model.py)

VARIANTS = {
    "s2d": dict(stem="s2d"),
    "poly": dict(stem="poly"),
    "poly2": dict(stem="poly2"),
    "light": dict(temporal_cell="light"),
    "hybrid": dict(temporal_cell="hybrid"),
}


def _leaf_shapes(tree):
    return {path: tuple(v.shape) for path, v in weights._flatten_tree(tree["params"])}


def jax_tree(jmodel, tmodel, seed):
    """The port model's seeded draw in the JAX layout, after checking that its
    keys and shapes are those of the JAX model's own init."""
    weights.load_random_params(tmodel, seed)
    tree = weights.params_to_jax(tmodel.state_dict())
    cfg = jmodel.cfg
    x = jnp.zeros((1, cfg.size, cfg.size, 3), jnp.float32)
    ref = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, None)
    assert _leaf_shapes(tree) == _leaf_shapes(ref)
    return tree


@functools.lru_cache(maxsize=None)
def _pair(name):
    kw = VARIANTS[name]
    jmodel = j_build(jcfg.TINY_64, **kw, **SMALL)
    tmodel = build_detector(tcfg.TINY_64, device="cpu", **kw, **SMALL)
    return jmodel, tmodel, jax_tree(jmodel, tmodel, seed=11)


def _nchw(s):
    return torch.from_numpy(np.ascontiguousarray(s.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    jmodel, tmodel, tree = _pair(name)
    cfg = jcfg.TINY_64
    rng = np.random.default_rng(1)
    x = (rng.uniform(0, 255, (2, cfg.size, cfg.size, 3)) - 117.0).astype("f4")
    state = [rng.normal(0, 0.5, (2, f, f, 32)).astype("f4") for f in cfg.feature_maps]
    jpreds, jstate = jax.jit(jmodel.apply)(tree, jnp.asarray(x), [jnp.asarray(s) for s in state])
    with torch.no_grad():
        tpreds, tstate = tmodel(torch.from_numpy(x), [_nchw(s) for s in state])
    for field in RawPredictions._fields:
        np.testing.assert_allclose(getattr(tpreds, field).numpy(),
                                   np.asarray(getattr(jpreds, field)), atol=ATOL, rtol=0,
                                   err_msg=field)
    for k, (t, j) in enumerate(zip(tstate, jstate)):
        np.testing.assert_allclose(t.numpy().transpose(0, 2, 3, 1), np.asarray(j),
                                   atol=ATOL, rtol=0, err_msg=f"state{k}")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_stream_matches_jax(name):
    """2 streams x 3 steps of 64x64 frames (no resize, the plain decode: the
    fused cascade is held in tests/test_torch_port_model.py); lane 1 resets
    before step 2. Scores and state at ATOL; the boxes of the same
    candidates at ATOL."""
    jmodel, tmodel, tree = _pair(name)
    jdet = JStreamingDetector(jmodel, tree, num_streams=2)
    tdet = StreamingDetector(tmodel, num_streams=2, device="cpu")
    frames = np.random.default_rng(2).integers(0, 256, (3, 2, 64, 64, 3), dtype=np.uint8)
    for i in range(3):
        if i == 2:
            jdet.reset([1])
            tdet.reset([1])
        j, t = jdet.detect(frames[i]), tdet.detect(frames[i])
        np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores), atol=ATOL, rtol=0)
        same = np.all(np.abs(t.boxes.numpy() - np.asarray(j.boxes)) < 1e-2, axis=-1)
        assert same.mean() > 0.95, same.mean()
        np.testing.assert_allclose(t.boxes.numpy()[same], np.asarray(j.boxes)[same],
                                   atol=ATOL, rtol=0)
        for k, (ts, js) in enumerate(zip(tdet.state, jdet._state)):
            np.testing.assert_allclose(ts.numpy().transpose(0, 2, 3, 1), np.asarray(js),
                                       atol=ATOL, rtol=0, err_msg=f"step {i} state{k}")


def test_poly_stems_equal_the_conv_stem():
    """poly and poly2 run the conv stem's parameters, exactly rearranged."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(-117, 138, (2, 64, 64, 3)).astype("f4"))
    models = {s: build_detector(tcfg.TINY_64, stem=s, device="cpu", **SMALL)
              for s in ("conv", "poly", "poly2")}
    weights.load_random_params(models["conv"], 5)
    with torch.no_grad():
        ref, _ = models["conv"](x)
        for s in ("poly", "poly2"):
            models[s].load_state_dict(models["conv"].state_dict(), strict=True)
            got, _ = models[s](x)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_fold_mean_s2d_params_equal_jax_and_fold_exactly():
    jmodel, tmodel, tree = _pair("s2d")
    _, jp = jprec.apply_fold_mean(jmodel, tree)
    sd = tprec.fold_mean_params(tmodel.state_dict(), tcfg.TINY_64, stem="s2d")
    want = weights.params_from_jax(jp)
    assert sd.keys() == want.keys()
    for key in sd:
        assert torch.equal(sd[key], want[key]), key
    assert sd["backbone.conv1_1.weight"].shape[1] == 16
    # The folded model on raw pixels + ones equals the model on mean-subtracted input.
    folded = tprec.apply_fold_mean(tmodel)
    assert folded.fold_mean and folded.backbone.conv1_1.in_channels == 16
    frames = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), np.uint8))
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    with torch.no_grad():
        got, _ = folded(preprocess_batch(frames, tcfg.TINY_64, fold_mean=True))
        ref, _ = tmodel(preprocess_batch(frames, tcfg.TINY_64))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


# --- pass-through init: tests/test_temporal_init.py's properties -------------


def _cell_out(cls, c, x, h, **kw):
    cell = cls(c, generator=torch.Generator().manual_seed(0), **kw)
    with torch.no_grad():
        return cell(x, h)


@pytest.mark.parametrize("cls", [ttemporal.ConvGRUCell, ttemporal.LightGRUCell])
def test_passthrough_init_preserves_features(cls):
    c = 32
    x = torch.from_numpy(np.random.RandomState(0).randn(2, c, 8, 8).astype("f4") * 0.5)
    out = _cell_out(cls, c, x, torch.zeros_like(x)).numpy()
    target = float(jax.nn.sigmoid(2.0)) * np.tanh(x.numpy())
    assert np.corrcoef(out.ravel(), target.ravel())[0, 1] > 0.95
    assert np.abs(out - target).mean() / np.abs(target).mean() < 0.35


@pytest.mark.parametrize("cls", [ttemporal.ConvGRUCell, ttemporal.LightGRUCell])
def test_xavier_init_option_destroys_features(cls):
    c = 32
    x = torch.from_numpy(np.random.RandomState(1).randn(2, c, 8, 8).astype("f4") * 0.5)
    out = _cell_out(cls, c, x, torch.zeros_like(x), passthrough_init=False).numpy()
    assert abs(np.corrcoef(out.ravel(), np.tanh(x.numpy()).ravel())[0, 1]) < 0.6


@pytest.mark.parametrize("cls", [ttemporal.ConvGRUCell, ttemporal.LightGRUCell])
def test_passthrough_keeps_state_dynamics(cls):
    c = 16
    x = torch.from_numpy(np.random.RandomState(2).randn(1, c, 4, 4).astype("f4"))
    out0 = _cell_out(cls, c, x, torch.zeros_like(x))
    out1 = _cell_out(cls, c, x, torch.ones_like(x))
    assert (out0 - out1).abs().max().item() > 1e-3


def test_passthrough_init_values_and_cell_layout():
    """The z bias, the center-tap identities and the hybrid layout, as the
    JAX package builds them (cell_kind: light on scale 0 only)."""
    c = 8
    g = ttemporal.ConvGRUCell(c, generator=torch.Generator().manual_seed(0))
    assert torch.equal(g.gates.bias[:c], torch.full((c,), 2.0)) and not g.gates.bias[c:].any()
    eye = g.cand.weight[:, :c, 1, 1] - torch.eye(c)
    assert eye.abs().max() < 0.1 * np.sqrt(6 / (9 * 3 * c))  # 0.1 x the xavier limit
    lt = ttemporal.LightGRUCell(c, generator=torch.Generator().manual_seed(0))
    assert torch.equal(lt.gate.bias, torch.full((c,), 2.0))
    assert ((lt.dw.weight[:, 0, 1, 1] - 1.0).abs() < 0.1).all()
    assert lt.dw.weight.shape == (2 * c, 1, 3, 3)
    for cell in ("convgru", "light", "hybrid"):
        tp = ttemporal.TemporalPropagation(4, c, cell)
        kinds = [type(getattr(tp, f"gru{k}")).__name__ for k in range(4)]
        want = [jtemporal.cell_kind(cell, k) for k in range(4)]
        assert kinds == ["LightGRUCell" if w == "light" else "ConvGRUCell" for w in want]
        assert [ttemporal.cell_kind(cell, k) for k in range(4)] == want
    # The draw follows the generator: the same seed gives the same cell.
    a = ttemporal.LightGRUCell(c, generator=torch.Generator().manual_seed(3))
    b = ttemporal.LightGRUCell(c, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
