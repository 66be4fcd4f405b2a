"""The port's int8 pieces against the JAX package, on the CPU: QConv alone
(its plain K5 route) on identical int8 parameters; the weight quantization
(``quantize_backbone_params``) bit for bit; the activation calibration
(``calibrate_act_scales``, max and percentile); the validation surface and
the scales files; the int8 accumulation against ``torch._int_mm``; the
quantized param tree's round trip through weights.py; and the dtypes a
QConv keeps through a cast.

Models are TINY_64 at width 0.125 (ResNet-101 at 0.0625) with 32 TCB
channels; their weights are a seeded draw through the port, converted to the
JAX layout and checked against the JAX model's own param shapes
(jax.eval_shape). Each model and its JAX calibration are built once (cached)."""

import functools
import json
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.models.layers import QConv as JQConv
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu.utils import quantize as jq
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.models.layers import QConv
from tdrn_tpu_torch.ops.qconv import qconv, qconv_plain, quantize_act
from tdrn_tpu_torch.utils import precision as tprec
from tdrn_tpu_torch.utils import quantize as tq

log = logging.getLogger(__name__)

MODELS = {
    "vgg": dict(),
    "light": dict(temporal_cell="light"),
    "hybrid": dict(temporal_cell="hybrid"),
    "s2d": dict(stem="s2d", temporal_cell="light"),
    "resnet": dict(backbone="resnet101"),
}
CALIB_REL = 1e-5  # calibrated scales, port against JAX (fp32 activations, other sum orders)


def _leaf_shapes(tree):
    return {path: tuple(v.shape) for path, v in weights._flatten_tree(tree["params"])}


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX model, port model, JAX tree): one seeded draw through the port."""
    kw = dict(MODELS[name])
    small = dict(tcb_channels=32, width_mult=0.0625 if kw.get("backbone") else 0.125)
    jmodel = j_build(jcfg.TINY_64, **kw, **small)
    tmodel = build_detector(tcfg.TINY_64, device="cpu", **kw, **small)
    weights.load_random_params(tmodel, 11)
    tree = weights.params_to_jax(tmodel.state_dict())
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    assert _leaf_shapes(tree) == _leaf_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, None))
    return jmodel, tmodel, tree


def calib_frames():
    rng = np.random.default_rng(12)
    return (rng.uniform(0, 255, (3, 64, 64, 3)) - 117.0).astype("f4")


@functools.lru_cache(maxsize=None)
def jax_scales(name, percentile=None):
    jmodel, _, tree = pair(name)
    return jq.calibrate_act_scales(jmodel, tree, jnp.asarray(calib_frames()), tcb=True,
                                   gru=True, percentile=percentile)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# --- (a) QConv alone --------------------------------------------------------

GEOMETRIES = {  # (kernel, stride, dilation)
    "3x3": (3, 1, 1), "3x3_dil3": (3, 1, 3), "3x3_s2": (3, 2, 1),
    "1x1": (1, 1, 1), "1x1_s2": (1, 2, 1), "7x7_s2": (7, 2, 1),
}


def _qconv_params(rng, k, cin, cout):
    kernel = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    wscale = rng.uniform(1e-3, 5e-3, cout).astype(np.float32)
    xscale = np.float32(rng.uniform(2.0, 6.0))
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return kernel, wscale, xscale, bias


def _ulps(a, b):
    """Distance in units in the last place between two fp32 arrays."""
    ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)  # a monotone integer line
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("cin", [3, 12])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_qconv_matches_jax_qconv(geometry, cin):
    """The port's QConv (quantize_act, K5's plain route, the epilogue) against
    the JAX QConv on identical int8 parameters and input: bf16 outputs equal,
    fp32 within 1 ulp (which held is logged). The input reaches past xscale,
    so the clip to +-127 is exercised."""
    k, s, d = GEOMETRIES[geometry]
    rng = np.random.default_rng(100 * list(GEOMETRIES).index(geometry) + cin)
    kernel, wscale, xscale, bias = _qconv_params(rng, k, cin, 24)
    x = (rng.normal(0, 3.0, (2, 13, 15, cin))).astype(np.float32)
    params = {"params": {"kernel": jnp.asarray(kernel), "wscale": jnp.asarray(wscale),
                         "xscale": jnp.asarray(xscale), "bias": jnp.asarray(bias)}}
    held = []
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        xin = np.array(jnp.asarray(x, jdt), np.float32)  # the input in the compute dtype
        ref = JQConv(24, (k, k), stride=s, dilation=d, dtype=jdt).apply(params, jnp.asarray(xin, jdt))
        mod = QConv(cin, 24, k, s, d, dtype=tdt)
        mod.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 0, 1, 2).copy()),
                             "wscale": torch.from_numpy(wscale),
                             "xscale": torch.from_numpy(np.asarray(xscale)),
                             "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            got = mod(torch.from_numpy(xin).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == tdt and tuple(got.shape) == ref.shape
        a, b = got.float().numpy(), np.asarray(ref, np.float32)
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(a, b)
            held.append("bf16 equal")
        else:
            ulps = int(_ulps(a, b).max())
            assert ulps <= 1, f"fp32 output {ulps} ulps from JAX's"
            held.append("fp32 bit-equal" if ulps == 0 else "fp32 within 1 ulp")
    log.info("QConv %s Cin %d: %s", geometry, cin, ", ".join(held))


def test_quantize_act_rounds_like_jax():
    """Half-way values round to even, the clip is +-127 (never -128), 127 /
    xscale is an fp32 op; the padded channels are zero and the layout NHWC."""
    xscale = np.float32(3.7)
    steps = np.arange(-140, 141, dtype=np.float32) * 0.5
    x = np.concatenate([steps * (xscale / np.float32(127.0)), [-1e9, 1e9, -0.0]]).astype(np.float32)
    x = x[: (x.size // 3) * 3].reshape(1, 3, -1, 1)  # NCHW, 3 channels
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (127.0 / jnp.asarray(xscale))), -127, 127)
                     .astype(jnp.int8))
    got = quantize_act(torch.from_numpy(x), torch.tensor(xscale))
    assert got.dtype == torch.int8 and got.shape == (1, x.shape[2], 1, 16) and got.is_contiguous()
    np.testing.assert_array_equal(got[..., :3].permute(0, 3, 1, 2).numpy(), ref)
    assert int(got[..., 3:].abs().max()) == 0 and int(got.min()) == -127


# --- (b) weight quantization ------------------------------------------------


@pytest.mark.parametrize("name,precision", [("vgg", "fp32"), ("vgg", "bf16"), ("resnet", "fp32")])
def test_quantize_backbone_params_bit_equal_to_jax(name, precision):
    """int8 kernels, wscale, xscale and bias bit-equal to the JAX package's,
    VGG with tcb and gru, ResNet with tcb, from fp32 and from bf16 weights."""
    jmodel, tmodel, tree = pair(name)
    scales = dict(jax_scales(name))
    if name == "resnet":
        scales = {k: v for k, v in scales.items() if not k.startswith("gru")}
    if precision == "bf16":
        jmodel, tree = jprec.apply_inference_precision(jmodel, tree, "bf16")
        tmodel = tprec.apply_inference_precision(tmodel, "bf16")
    ref = jq.quantize_backbone_params(tree, scales)
    got = weights.params_to_jax(tq.quantize_backbone_params(tmodel.state_dict(), scales))
    n_int8 = 0
    for path, leaf in weights._flatten_tree(ref["params"]):
        a, b = _get(got["params"], path), np.asarray(leaf)
        if b.dtype == jnp.bfloat16:
            b = b.astype(np.float32)
        assert a.shape == b.shape, path
        if b.dtype == np.int8:
            n_int8 += 1
            assert a.dtype == np.int8, path
        np.testing.assert_array_equal(a.view(np.uint8) if a.dtype == np.int8 else a,
                                      b.view(np.uint8) if b.dtype == np.int8 else b, err_msg=str(path))
    assert n_int8 == len(scales)


# --- (c) calibration --------------------------------------------------------


@pytest.mark.parametrize("percentile", [None, 99.9])
@pytest.mark.parametrize("name", ["vgg", "light", "hybrid", "resnet"])
def test_calibrate_act_scales_matches_jax(name, percentile):
    """The same keys in the same order, each scale within 1e-5 (relative) of
    the JAX package's, for the max and for the 99.9th percentile."""
    _, tmodel, _ = pair(name)
    ref = jax_scales(name, percentile)
    got = tq.calibrate_act_scales(tmodel, torch.from_numpy(calib_frames()), tcb=True, gru=True,
                                  percentile=percentile)
    assert list(got) == list(ref)
    worst = max(abs(got[k] - ref[k]) / ref[k] for k in ref)
    log.info("calibration %s percentile %s: %d scales, worst rel %.3g", name, percentile,
             len(ref), worst)
    assert worst < CALIB_REL


def test_calibration_of_a_chunked_model_uses_chunk_1():
    _, tmodel, _ = pair("vgg")
    frames = torch.from_numpy(calib_frames())
    assert tq.calibrate_act_scales(tmodel.clone(chunk=2), frames, tcb=True) == \
        tq.calibrate_act_scales(tmodel, frames, tcb=True)


# --- (d) validation surface and scales files ---------------------------------


def _small(**kw):
    kw.setdefault("width_mult", 0.125)
    return build_detector(tcfg.TINY_64, tcb_channels=32, device="cpu", **kw)


@pytest.mark.parametrize("stem", ["poly", "poly2", "fused", "fused2"])
def test_int8_rejects_the_stems_jax_rejects(stem):
    scales = dict(jax_scales("vgg"))
    with pytest.raises(ValueError, match="conv/s2d"):
        tq.apply_int8_backbone(_small(stem=stem), act_scales=scales)
    jmodel = j_build(jcfg.TINY_64, stem=stem, tcb_channels=32, width_mult=0.125)
    with pytest.raises(ValueError, match="conv/s2d"):
        jq.apply_int8_backbone(jmodel, {"params": {}}, act_scales=scales)


def test_int8_validation_surface(tmp_path):
    """fold_mean, missing scales, non-positive scales, a gru cell-kind
    mismatch, gru on a non-temporal model and no calibration input are
    ValueErrors, as in the JAX package; an int8 VGG asked to run a fused stem
    raises too."""
    _, vgg, _ = pair("vgg")
    scales = dict(jax_scales("vgg"))
    with pytest.raises(ValueError, match="fold_mean"):
        tq.apply_int8_backbone(tprec.apply_fold_mean(vgg), act_scales=scales)
    with pytest.raises(ValueError, match="missing"):
        tq.apply_int8_backbone(vgg, act_scales={k: v for k, v in scales.items() if k != "conv4_2"})
    with pytest.raises(ValueError, match="missing"):
        tq.apply_int8_backbone(pair("resnet")[1], act_scales=scales)
    with pytest.raises(ValueError, match="non-positive"):
        tq.apply_int8_backbone(vgg, act_scales={**scales, "conv3_1": 0.0})
    light = pair("light")[1]
    with pytest.raises(ValueError, match="cell"):
        tq.apply_int8_backbone(light, act_scales=scales)  # convgru keys on light cells
    with pytest.raises(ValueError, match="cell"):
        jq._validate_gru_keys(pair("light")[0], scales)
    with pytest.raises(ValueError, match="temporal"):
        tq.apply_int8_backbone(_small(temporal=False), act_scales=scales)
    with pytest.raises(ValueError, match="temporal"):
        tq.calibrate_act_scales(_small(temporal=False), torch.zeros(1, 64, 64, 3), gru=True)
    with pytest.raises(ValueError, match="calib_frames"):
        tq.apply_int8_backbone(vgg)
    q = tq.apply_int8_backbone(vgg, act_scales=scales)
    assert q.quant and q.quant_tcb and q.quant_gru and not vgg.quant
    assert isinstance(q.backbone.conv1_1, QConv) and not isinstance(vgg.backbone.conv1_1, QConv)
    q.backbone.stem = "poly"
    with pytest.raises(ValueError, match="stems"):
        q(torch.zeros(1, 64, 64, 3), q.zero_state(1))
    for bad in ({**scales, "conv9_9": 1.0}, {**scales, "conv2_1": -1.0},
                {k: v for k, v in scales.items() if k != "conv1_1"}):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError):
            tq.load_act_scales(str(path))
        with pytest.raises(ValueError):
            jq.load_act_scales(str(path))


@pytest.mark.parametrize("name", ["vgg", "resnet"])
def test_scales_files_round_trip_across_packages(name, tmp_path):
    """The port's save/load round trip, a JAX-written file loading in the port
    and a port-written file in the JAX package, values exact."""
    scales = dict(jax_scales(name))
    tq.save_act_scales(str(tmp_path / "port.json"), scales)
    jq.save_act_scales(str(tmp_path / "jax.json"), scales)
    for src in ("port.json", "jax.json"):
        assert tq.load_act_scales(str(tmp_path / src)) == scales
    assert jq.load_act_scales(str(tmp_path / "port.json")) == scales


# --- (e) the int32 accumulation against torch._int_mm --------------------------


def test_qconv_plain_matches_int_mm_on_a_1x1():
    """A 1x1 stride-1 QConv is a GEMM over pixels: the plain version's
    dequantized output equals torch._int_mm's int32 accumulators put through
    the same two fp32 operations, bit for bit, on values that reach past
    2**24. The activations are the int8 values themselves in bf16 and fp32,
    quantized with s = 1 (exact)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 6, 7, 512)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 1, 1, 512)).astype(np.int8))
    x[0, 0, 0] = 127
    w[0] = 127  # one accumulator at 127^2 * 512 > 2**24
    fac = torch.from_numpy(rng.uniform(1e-5, 1e-4, 40).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, 40).astype(np.float32))
    acc = torch._int_mm(x.view(-1, 512), w.view(40, 512).t())
    assert int(acc.max()) == 127 * 127 * 512
    want = (acc.float() * fac + bias).view(2, 6, 7, 40)
    one = torch.tensor(1.0)
    for xd in (torch.bfloat16, torch.float32):
        xf = x.permute(0, 3, 1, 2).to(xd)
        for od in (torch.float32, torch.bfloat16):
            got = qconv(xf, w, one, fac, bias, out_dtype=od)
            assert torch.equal(got, want.to(od))
            assert torch.equal(got, qconv_plain(xf, w, one, fac, bias, 1, 1, od))


# --- (f) the quantized param tree through weights.py --------------------------


def test_quantized_tree_round_trips_through_weights():
    """The JAX package's quantized tree -> params_from_jax -> the port's int8
    model (strict load) -> params_to_jax gives the same tree: int8 kernels
    stay int8 (HWIO), wscale, bias and the 0-dim xscale fp32."""
    jmodel, tmodel, tree = pair("vgg")
    scales = dict(jax_scales("vgg"))
    _, jqt = jq.apply_int8_backbone(jmodel, tree, act_scales=scales)
    sd = weights.params_from_jax(jqt)
    assert sd["backbone.conv1_1.weight"].dtype == torch.int8
    assert sd["backbone.conv1_1.weight"].shape == (8, 3, 3, 3)  # (O, H, W, I)
    assert sd["temporal.gru0.cand.xscale"].shape == () and sd["tcb.tcb1.deconv.weight"].dtype == torch.float32
    q = tq.apply_int8_backbone(tmodel, act_scales=scales)
    weights.load_jax_params(q, jqt)
    back = weights.params_to_jax(q.state_dict())
    for path, leaf in weights._flatten_tree(jqt["params"]):
        a, b = _get(back["params"], path), np.asarray(leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # A load of random weights leaves the QConvs as they are.
    before = {k: v.clone() for k, v in q.state_dict().items() if k.startswith("backbone.conv")}
    weights.load_random_params(q, 5)
    assert all(torch.equal(v, q.state_dict()[k]) for k, v in before.items())


def test_qconv_keeps_its_dtypes_through_casts():
    """module.to(bf16), .bfloat16() and the bf16 transform leave a QConv's
    int8 weight int8 and its scales and bias fp32 (the JAX package keeps
    them fp32); only the device would move."""
    _, tmodel, _ = pair("vgg")
    q = tq.apply_int8_backbone(tmodel, act_scales=dict(jax_scales("vgg")))
    ref = {k: v.clone() for k, v in q.state_dict().items()}
    for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.bfloat16(), lambda m: m.float(),
                 lambda m: tprec.cast_params_bf16(m)):
        m = cast(q)
        for key in ("backbone.conv3_1", "tcb.tcb0.conv2", "temporal.gru1.gates"):
            mod = m.get_submodule(key)
            assert mod.weight.dtype == torch.int8
            assert mod.wscale.dtype == mod.xscale.dtype == mod.bias.dtype == torch.float32
            for leaf in ("weight", "wscale", "xscale", "bias"):
                assert torch.equal(getattr(mod, leaf), ref[f"{key}.{leaf}"])
