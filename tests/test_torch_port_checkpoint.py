"""The port's checkpoint restore against the JAX package's: a TINY_64 orbax
checkpoint written by the JAX CheckpointManager, converted by
tools/orbax_to_torch.py, restores in tdrn_tpu_torch bit for bit (int8 QConv
trees included); the port's load_inference_model detects as the JAX one does
in fp32, bf16 and int8 (one scales file read by both packages); meta
defaults, the subtree-tolerant graft (temporal <-> non-temporal) with the
reference's missing/extra counts, the refusals, random_init and scales
files across the two packages. TINY_64, width_mult 0.125, 32 TCB channels,
one JAX init for the module."""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import load_inference_model as j_load
from tdrn_tpu.inference import make_single_image_forward as j_single
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.train import init_train_state, make_optimizer
from tdrn_tpu.train.checkpoint import CheckpointManager
from tdrn_tpu.train.checkpoint import graft_params as j_graft
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu.utils import quantize as jq
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import load_inference_model, make_single_image_forward
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.train import checkpoint
from tdrn_tpu_torch.utils import precision as tprec
from tdrn_tpu_torch.utils import quantize as tq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import orbax_to_torch  # noqa: E402

SMALL = dict(tcb_channels=32, width_mult=0.125)
META = {"dataset": "tiny_64", "backbone": "vgg16", "temporal": True, "stem": "conv",
        "temporal_cell": "convgru", "backbone_norm": "frozen", "tcb_channels": 32,
        "width_mult": 0.125}
STEP = 5
# Detections, port against JAX on the same frames. fp32: sorted scores and
# boxes at the end-to-end forward's 1e-4 (tests/test_torch_port_model.py).
# bf16, and int8 (bf16 underneath): the serving file's bounds
# (tests/test_torch_port_serving.py): sorted scores within 2e-2 of their max,
# at least 95 % of the port's detections found in the JAX list (class, box
# within 1e-2, score within 1e-2).
FP32_ATOL = 1e-4
SCORE_REL_TOL = 2e-2
MATCH_SHARE = 0.95


def _tree_equal(a, b):
    fa, fb = dict(weights._flatten_tree(a)), dict(weights._flatten_tree(b))
    return fa.keys() == fb.keys() and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """An fp32 orbax checkpoint (train state at step 5 with its meta) and an
    int8 one (the same params quantized by the JAX package), each converted
    by tools/orbax_to_torch.py; a scales file calibrated by the port."""
    base = tmp_path_factory.mktemp("ckpt")
    jmodel = j_build(jcfg.TINY_64, temporal=True, **SMALL)
    ts = init_train_state(jmodel, jax.random.PRNGKey(0), make_optimizer(warmup_steps=1), batch=1)
    ts = ts._replace(step=jnp.asarray(STEP, jnp.int32))
    mgr = CheckpointManager(str(base / "orbax"), save_every=5)
    mgr.save_meta(META)
    assert mgr.maybe_save(ts, force=True)
    mgr.wait()
    mgr.close()
    params = jax.tree.map(np.asarray, ts.params)

    # The scales: the port's calibration of the bf16 profile on seeded frames.
    m16 = tprec.apply_inference_precision(weights.load_jax_params(
        build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL), params), "bf16")
    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    scales = tq.calibrate_act_scales(
        m16, preprocess_batch(torch.from_numpy(frames), m16.cfg, m16.dtype), tcb=True, gru=True)
    tq.save_act_scales(str(base / "scales.json"), scales)

    _, qparams = jq.apply_int8_backbone(jmodel, params, act_scales=scales)
    qmgr = CheckpointManager(str(base / "orbax_int8"), save_every=5)
    assert qmgr.maybe_save(ts._replace(params=qparams), force=True)
    qmgr.wait()
    qmgr.close()

    for src in ("orbax", "orbax_int8"):
        orbax_to_torch.main(["--src", str(base / src), "--out", str(base / f"{src}_torch")])
    return dict(base=base, params=params, qparams=jax.tree.map(np.asarray, qparams),
                scales=str(base / "scales.json"))


def test_converted_params_equal_the_jax_restore(ckpt):
    base = ckpt["base"]
    assert checkpoint.latest_step(str(base / "orbax_torch")) == STEP
    assert checkpoint.load_meta(str(base / "orbax_torch")) == META
    for src, want in (("orbax", ckpt["params"]), ("orbax_int8", ckpt["qparams"])):
        mgr = CheckpointManager(str(base / src))
        restored = mgr._restore_numpy(STEP)["params"]
        mgr.close()
        assert _tree_equal(restored, want)  # the JAX restore itself is exact
        ref = weights.params_from_jax(restored)
        got = checkpoint.load_params(str(base / f"{src}_torch"))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    q = checkpoint.load_params(str(base / "orbax_int8_torch"))
    assert q["backbone.conv1_1.weight"].dtype == torch.int8
    assert q["backbone.conv1_1.wscale"].dtype == torch.float32
    assert q["backbone.conv1_1.xscale"].dim() == 0
    # A --step that is not there raises.
    with pytest.raises(Exception):
        orbax_to_torch.convert(str(base / "orbax"), str(base / "nowhere"), step=STEP + 1)


def _frames():
    return np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)


def _matched_share(t, j):
    tb, ts, tc = t
    jb, js, jc = j
    hits = [
        np.any((jc == tc[q]) & np.all(np.abs(jb - tb[q]) < 1e-2, -1) & (np.abs(js - ts[q]) < 1e-2))
        for q in range(len(ts)) if ts[q] > 0
    ]
    return np.mean(hits)


@pytest.fixture(scope="module")
def jax_loaded(ckpt):
    """The JAX package's load_inference_model of the fp32 checkpoint (one
    JAX init for the module)."""
    return j_load(str(ckpt["base"] / "orbax"), verbose=False)


def _jax_precision(jl, precision, scales_file):
    """The JAX model in ``precision``, as its load_inference_model's
    apply_precision makes it (inference.py:272-288)."""
    if precision == "int8":
        m, p = jprec.apply_inference_precision(jl.model, jl.params, "bf16")
        return jq.apply_int8_backbone(m, p, act_scales=jq.load_act_scales(scales_file))
    return jprec.apply_inference_precision(jl.model, jl.params, precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_load_inference_model_detects_as_jax(ckpt, jax_loaded, precision):
    base = ckpt["base"]
    jl = jax_loaded
    jmodel, jparams = _jax_precision(jl, precision, ckpt["scales"])
    tl = load_inference_model(str(base / "orbax_torch"), device="cpu", precision=precision,
                              int8_scales=ckpt["scales"] if precision == "int8" else None)
    assert (tl.cfg.name, tl.step, tl.meta) == (jl.cfg.name, jl.step, jl.meta) == ("tiny_64", STEP, META)
    # The restored weights are the JAX restore's, bit for bit (after the
    # same precision transform on both sides).
    ref = weights.params_from_jax(jparams)
    got = tl.model.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k].to(ref[k].dtype), ref[k]), k
    frames = _frames()
    jd = j_single(jmodel)(jparams, jnp.asarray(frames))
    td = make_single_image_forward(tl.model)(torch.from_numpy(frames))
    for b in range(len(frames)):
        t = tuple(x[b].numpy() for x in (td.boxes, td.scores, td.classes))
        j = tuple(np.asarray(x[b]) for x in (jd.boxes, jd.scores, jd.classes))
        ts_sorted, js_sorted = np.sort(t[1]), np.sort(j[1])
        if precision == "fp32":
            np.testing.assert_allclose(ts_sorted, js_sorted, atol=FP32_ATOL, rtol=0)
            same = np.all(np.abs(t[0] - j[0]) < 1e-2, -1)  # by rank
            assert same.mean() > 0.9
            np.testing.assert_allclose(t[0][same], j[0][same], atol=FP32_ATOL, rtol=0)
        else:
            assert np.abs(ts_sorted - js_sorted).max() <= SCORE_REL_TOL * js_sorted.max()
            assert _matched_share(t, j) >= MATCH_SHARE


def test_meta_defaults_rebuild_the_model(tmp_path):
    """A light cell and width 0.125 restore from the meta alone; flags override it."""
    model = build_detector(tcfg.TINY_64, temporal_cell="light", device="cpu", **SMALL)
    weights.load_random_params(model, 4)
    checkpoint.save_params(str(tmp_path), 3, model.state_dict())
    checkpoint.save_params(str(tmp_path), 12, model.state_dict())  # the newest wins
    checkpoint.save_meta(str(tmp_path), {**META, "temporal_cell": "light"})
    lm = load_inference_model(str(tmp_path), device="cpu", verbose=False)
    assert lm.model.temporal_cell == "light" and lm.model.tcb_channels == 32
    assert lm.model.backbone.conv1_1.out_channels == 8 and lm.step == 12
    for k, v in model.state_dict().items():
        assert torch.equal(lm.model.state_dict()[k], v), k
    assert load_inference_model(str(tmp_path), temporal=False, device="cpu",
                                verbose=False).model.temporal_enabled is False
    # A flag overrides the meta; another cell's subtree is only reported.
    other = load_inference_model(str(tmp_path), temporal_cell="convgru", device="cpu")
    assert other.model.temporal_cell == "convgru"


def _counts(out):
    return len(out[1]), len(out[2])


def test_graft_matches_the_reference_counts(ckpt, capsys):
    """temporal <-> non-temporal, and a shape mismatch: the port's graft
    reports as many missing and extra subtrees as the JAX package's, on the
    same trees; the restore through both packages' load_inference_model."""
    sds = {t: build_detector(tcfg.TINY_64, temporal=t, device="cpu", **SMALL).state_dict()
           for t in (True, False)}
    wide = build_detector(tcfg.TINY_64, temporal=True, device="cpu", tcb_channels=32,
                          width_mult=0.25).state_dict()
    for src, tmpl in ((sds[True], sds[False]), (sds[False], sds[True]), (wide, sds[True])):
        got = checkpoint.graft_params(src, tmpl)
        want = j_graft(weights.params_to_jax(src), weights.params_to_jax(tmpl))
        assert _counts(got) == _counts(want) and _counts(got) != (0, 0)
        assert got[0].keys() == tmpl.keys()
        for k, v in got[0].items():  # matching leaves from src, the rest from the template
            assert v is (src[k] if k in src and src[k].shape == tmpl[k].shape else tmpl[k]), k
    out = checkpoint.graft_params(sds[True], sds[False])
    assert out[2] == ["temporal"] and out[1] == []
    # The restores: a temporal checkpoint into a frame model, the JAX
    # package's (CheckpointManager.restore_params, as its
    # load_inference_model restores) against the port's.
    base = ckpt["base"]
    frame_model = j_build(jcfg.TINY_64, temporal=False, **SMALL)
    tmpl = jax.eval_shape(frame_model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32), None)
    mgr = CheckpointManager(str(base / "orbax"))
    jout = mgr.restore_params(tmpl)
    mgr.close()
    tout = checkpoint.restore_params(str(base / "orbax_torch"), sds[False])
    assert _counts(tout) == _counts(jout) == (0, 1)
    capsys.readouterr()
    load_inference_model(str(base / "orbax_torch"), temporal=False, device="cpu")
    assert capsys.readouterr().out.startswith(
        "restore: 0 template subtree(s) kept at init [], 1 checkpoint subtree(s) unused ['temporal']")


def test_refusals_raise_the_reference_exceptions(ckpt, tmp_path, capsys):
    """The exception types and messages of tdrn_tpu/inference.py:245-309."""
    base = ckpt["base"]
    # A checkpoint of another geometry: ValueError (non-temporal subtrees).
    for kw in (dict(tcb_channels=16), dict(dataset="voc_320")):
        with pytest.raises(ValueError, match="checkpoint/model mismatch"):
            load_inference_model(str(base / "orbax_torch"), device="cpu", **kw)
    # No checkpoint: FileNotFoundError.
    (tmp_path / checkpoint.META_FILENAME).write_text(json.dumps(META))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        load_inference_model(str(tmp_path), device="cpu")
    # int8 without scales: ValueError.
    with pytest.raises(ValueError, match="int8_scales"):
        load_inference_model(str(base / "orbax_torch"), precision="int8", device="cpu")
    # A ResNet meta without backbone_norm warns, in the reference's words.
    rdir = tmp_path / "resnet"
    checkpoint.save_meta(str(rdir), {"dataset": "tiny_64", "backbone": "resnet101",
                                     "width_mult": 0.0625, "tcb_channels": 32})
    capsys.readouterr()
    load_inference_model(str(rdir), random_init=True, device="cpu")
    warned = capsys.readouterr().out
    assert warned.startswith("WARNING: resnet checkpoint meta lacks 'backbone_norm'; assuming "
                             "'frozen'. A GroupNorm-trained checkpoint restores into a FrozenBN ")
    load_inference_model(str(rdir), random_init=True, backbone_norm="group", device="cpu")
    assert "WARNING" not in capsys.readouterr().out


def test_random_init_creates_no_directory(tmp_path):
    missing = tmp_path / "nowhere"
    lm = load_inference_model(str(missing), random_init=True, dataset="tiny_64",
                              tcb_channels=32, seed=3, device="cpu")
    assert not missing.exists() and lm.step == 0 and lm.meta == {}
    # The seeded template: the same seed, the same weights.
    again = build_detector(tcfg.TINY_64, tcb_channels=32, device="cpu")
    weights.load_random_params(again, 3)
    assert all(torch.equal(a, b) for a, b in
               zip(lm.model.state_dict().values(), again.state_dict().values()))
    assert checkpoint.latest_step(str(missing)) is None
    assert checkpoint.load_params(str(missing)) is None


def test_scales_files_cross_the_packages(ckpt, tmp_path):
    scales = tq.load_act_scales(ckpt["scales"])
    assert jq.load_act_scales(ckpt["scales"]) == scales  # port -> JAX
    path = str(tmp_path / "j.json")
    jq.save_act_scales(path, scales)
    assert tq.load_act_scales(path) == scales  # JAX -> port
    with open(path) as f, open(ckpt["scales"]) as g:
        assert json.load(f) == json.load(g)
