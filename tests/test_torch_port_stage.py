"""The port's K4 wrapper (fused VGG stage 2), the fused2 backbone, the
resident-bf16 precision transform and bf16 weight loading, held against the
JAX package at TINY_64, width_mult 0.125, 32 TCB channels, on seeded numpy
inputs."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.ops.stem_pallas import fused_conv_stage as j_stage
from tdrn_tpu.utils import precision as JP
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.stem import fused_conv_stage
from tdrn_tpu_torch.utils import precision as TP

T = torch.from_numpy
SMALL = dict(tcb_channels=32, width_mult=0.125)


# --- K4 ---------------------------------------------------------------------

# bf16 tolerance, relative to max|ref|, as for K3
# (tests/test_torch_port_kernels.py): conv1's output is rounded to bf16 after
# an fp32 sum whose order differs between XLA and the port, so a value on a
# rounding boundary can land one ulp apart. Measured here: at most 1.4e-7.
# chip_smoke.py holds the kernel to the same bound.
STAGE_BF16_REL_TOL = 1e-3


def _stage_inputs(cin, cmid, cout, seed, h=64, w=32):
    """The scales of tests/test_stem_pallas.py's stage test, at its shape
    (1, 64, 32) unless h, w are given."""
    rng = np.random.default_rng(seed)
    b = 1
    return [
        rng.normal(size=(b, h, w, cin)).astype("f4"),
        (rng.normal(size=(3, 3, cin, cmid)) * 0.2).astype("f4"),
        rng.normal(size=(cmid,)).astype("f4"),
        (rng.normal(size=(3, 3, cmid, cout)) * 0.1).astype("f4"),
        rng.normal(size=(cout,)).astype("f4"),
    ]


# (8, 16, 16) at 32x52: W ragged, the last 16-wide tile of the card's kernel
# is partial, as in chip_smoke.py's ragged check (the JAX function needs
# H % 8 == 0).
STAGE_CASES = [(8, 16, 16, 64, 32), (16, 8, 24, 64, 32), (8, 16, 16, 32, 52)]


@pytest.mark.parametrize("cin,cmid,cout,h,w", STAGE_CASES)
def test_conv_stage_plain_matches_jax_fp32(cin, cmid, cout, h, w):
    args = _stage_inputs(cin, cmid, cout, seed=3, h=h, w=w)
    got = fused_conv_stage(*map(T, args), compute_dtype=torch.float32)
    ref = j_stage(*map(jnp.asarray, args), compute_dtype=jnp.float32, interpret=True)
    assert got.shape == (1, h // 2, w // 2, cout) == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cin,cmid,cout,h,w", STAGE_CASES)
def test_conv_stage_plain_matches_jax_bf16(cin, cmid, cout, h, w):
    args = _stage_inputs(cin, cmid, cout, seed=4, h=h, w=w)
    got = fused_conv_stage(*map(T, args))
    ref = np.asarray(j_stage(*map(jnp.asarray, args), interpret=True), "f4")
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel < STAGE_BF16_REL_TOL, rel
    # bf16 x and kernels (fp32 biases) give the same result bit for bit: the
    # stage rounds them to bf16 first. bf16 output is the fp32 one rounded.
    x, k1, b1, k2, b2 = map(T, args)
    bf = lambda t: t.to(torch.bfloat16)
    got16 = fused_conv_stage(bf(x), bf(k1), b1, bf(k2), b2, out_dtype=torch.float32)
    assert torch.equal(got16, got)
    out16 = fused_conv_stage(bf(x), bf(k1), b1, bf(k2), b2)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, bf(got))


# --- fused2 forward and the bf16 profile -------------------------------------

# fp32 forward through the fused2 stem: reassociation only (both sides round
# to bf16 at the same points in the two fused stages), as in
# tests/test_torch_port_model.py. Measured: 4.1e-6.
FP32_ATOL = 1e-4
# Resident bf16: every conv of the backbone, TCB and GRU rounds its output to
# bf16 on both sides, but XLA and oneDNN sum in other orders, so a value can
# land one bf16 ulp (2^-8 relative) apart and the difference grows through
# the layers. Relative to max|ref|, the JAX package's own bound for bf16
# against fp32 (tests/test_precision.py). Measured: predictions 8.2e-3,
# carried state 2.9e-2 (on the 2x2 and 1x1 maps, whose max|ref| is small).
BF16_REL_TOL = 5e-2


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = j_build(jcfg.TINY_64, temporal=True, stem="fused2", **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, None))


def _models():
    """(JAX fused2 model, its params, the port's fused2 model with them)."""
    params = _jax_params()
    jmodel = j_build(jcfg.TINY_64, temporal=True, stem="fused2", **SMALL)
    model = build_detector(tcfg.TINY_64, stem="fused2", device="cpu", **SMALL)
    return jmodel, params, weights.load_jax_params(model, params)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (2, 64, 64, 3)) - 117.0).astype("f4")
    state = [rng.normal(0, 0.5, (2, f, f, 32)).astype("f4") for f in jcfg.TINY_64.feature_maps]
    return x, state


def _nchw(state):
    return [torch.from_numpy(s.transpose(0, 3, 1, 2).copy()) for s in state]


def _rel(port, ref):
    ref = np.asarray(ref, "f4")
    return np.abs(port.float().numpy() - ref).max() / np.abs(ref).max()


def test_fused2_forward_matches_jax_fp32():
    jmodel, params, model = _models()
    x, state = _inputs(0)
    jpreds, jstate = jmodel.apply(params, jnp.asarray(x), [jnp.asarray(s) for s in state])
    with torch.no_grad():
        tpreds, tstate = model(torch.from_numpy(x), _nchw(state))
    for name in RawPredictions._fields:
        np.testing.assert_allclose(
            getattr(tpreds, name).numpy(), np.asarray(getattr(jpreds, name)),
            atol=FP32_ATOL, rtol=0, err_msg=name,
        )
    for k, (t, j) in enumerate(zip(tstate, jstate)):
        np.testing.assert_allclose(
            t.numpy().transpose(0, 2, 3, 1), np.asarray(j), atol=FP32_ATOL, rtol=0,
            err_msg=f"state{k}",
        )


def test_bf16_transform_casts_the_same_modules_as_jax():
    jmodel, params, model = _models()
    assert TP.FP32_SUBTREES == JP.FP32_SUBTREES
    m16 = TP.apply_inference_precision(model, "bf16")
    p16 = JP.cast_params_bf16(params)
    assert m16 is not model and m16.dtype == torch.bfloat16 and m16.head_dtype == torch.float32
    names = {n for n, _ in m16.named_children()}
    assert names == set(p16["params"])
    for name, module in m16.named_children():
        jdt = {str(leaf.dtype) for leaf in jax.tree.leaves(p16["params"][name])}
        tdt = {str(p.dtype).removeprefix("torch.") for p in module.parameters()}
        assert tdt == jdt, (name, tdt, jdt)
    # The model it was made from is untouched.
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.dtype == torch.float32
    for precision in (None, "fp32", "float32"):
        assert TP.apply_inference_precision(model, precision) is model
    with pytest.raises(ValueError):
        TP.apply_inference_precision(model, "int4")
    # The conv1_1 transforms refuse the fused2 stem, as the reference does.
    for transform, jtransform in ((TP.apply_fold_mean, JP.apply_fold_mean),
                                  (TP.apply_pad_stem, JP.apply_pad_stem)):
        with pytest.raises(ValueError, match="stem"):
            jtransform(jmodel, params)
        with pytest.raises(ValueError, match="stem"):
            transform(model)


def test_bf16_forward_matches_jax():
    """fp32 predictions and a bf16 carry on both sides, within BF16_REL_TOL."""
    jmodel, params, model = _models()
    jm16, jp16 = JP.apply_inference_precision(jmodel, params, "bf16")
    m16 = TP.apply_inference_precision(model, "bf16")
    x, state = _inputs(1)
    jpreds, jstate = jm16.apply(
        jp16, jnp.asarray(x, jnp.bfloat16), [jnp.asarray(s, jnp.bfloat16) for s in state]
    )
    with torch.no_grad():
        tpreds, tstate = m16(
            torch.from_numpy(x).bfloat16(), [s.bfloat16() for s in _nchw(state)]
        )
    for name in RawPredictions._fields:
        t, j = getattr(tpreds, name), getattr(jpreds, name)
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        assert _rel(t, j) < BF16_REL_TOL, (name, _rel(t, j))
    for t, j in zip(tstate, jstate):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert _rel(t.permute(0, 2, 3, 1), j) < BF16_REL_TOL
    assert all(s.dtype == torch.bfloat16 for s in m16.zero_state(2))


def test_build_detector_bf16_dtypes():
    model = build_detector(
        dataclasses.replace(tcfg.TINY_64, fused_cascade=True), stem="fused2",
        dtype=torch.bfloat16, head_dtype=torch.float32, device="cpu", **SMALL,
    )
    dtypes = {n: {p.dtype for p in m.parameters()} for n, m in model.named_children()}
    assert dtypes["backbone"] == dtypes["tcb"] == dtypes["temporal"] == {torch.bfloat16}
    assert dtypes["arm"] == dtypes["odm"] == dtypes["l2norm0"] == {torch.float32}
    both16 = build_detector(tcfg.TINY_64, dtype=torch.bfloat16, device="cpu", **SMALL)
    assert both16.head_dtype == torch.bfloat16
    assert {p.dtype for p in both16.odm.parameters()} == {torch.bfloat16}
    x = torch.from_numpy(_inputs(2)[0]).bfloat16()
    with torch.no_grad():
        preds, state = both16(x, both16.zero_state(2))
    assert all(t.dtype == torch.float32 for t in preds)
    assert all(s.dtype == torch.bfloat16 for s in state)


def test_bf16_weights_round_like_jax():
    """Loading a JAX tree into a bf16 model rounds to nearest even, as
    astype(bfloat16) does; params_to_jax of it gives fp32 numpy."""
    _, params, model = _models()
    rng = np.random.default_rng(6)
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype("f4"), params)
    m16 = TP.apply_inference_precision(model, "bf16")
    weights.load_jax_params(m16, tree)
    back = weights.params_to_jax(m16.state_dict())["params"]
    cast = JP.cast_params_bf16(tree)["params"]
    for name, want in cast.items():
        for path, leaf in weights._flatten_tree(want):
            got = dict(weights._flatten_tree(back[name]))[path]
            assert got.dtype == np.float32, (name, path)
            np.testing.assert_array_equal(got, np.asarray(leaf, "f4"), err_msg=f"{name}/{path}")
