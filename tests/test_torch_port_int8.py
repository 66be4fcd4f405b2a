"""The port's int8 serving profile as a whole against the JAX package's, on
the CPU: the int8 detector (VGG-16 conv stem with tcb and gru over two
streaming steps, in fp32 and in the resident-bf16 profile; s2d + light;
ResNet-101 with tcb) on the same calibrated scales, the int8 activation
flips between the two counted and logged; StreamingDetector on an int8 model
at chunk 1 (against JAX's) and chunk 2; the single-image and clip forwards;
and ``bench_torch.py --int8``.

Models are TINY_64 at width 0.125 (ResNet-101 at 0.0625) with 32 TCB
channels, weights a seeded draw through the port checked against the JAX
model's param shapes (jax.eval_shape). A flip is one int8 activation that
the two packages quantize to neighbouring steps: a last-bit difference of a
float input that sits on a rounding boundary (K5 itself is exact)."""

import functools
import json
import logging

import flax.linen as fnn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.models.layers import QConv as JQConv
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu.utils import quantize as jq
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import StreamingDetector, make_clip_forward, make_single_image_forward
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.models.layers import QConv
from tdrn_tpu_torch.utils import precision as tprec
from tdrn_tpu_torch.utils import quantize as tq

log = logging.getLogger(__name__)

# Raw predictions and state, port against JAX, as a share of each output's
# max|ref|: fp32 the end-to-end forward's 1e-4 (tests/test_torch_parity.py),
# bf16 the JAX package's own bf16 bound (tests/test_precision.py).
REL = {"fp32": 1e-4, "bf16": 5e-2}
SCORE_ATOL = 1e-4  # streaming detections' sorted scores, port against JAX (fp32)
CHUNK_ATOL = 1e-5  # chunk 2 against chunk 1 in the port (tests/test_torch_port_chunk.py)

MODELS = {
    "vgg": dict(),
    "s2d_light": dict(stem="s2d", temporal_cell="light"),
    "resnet": dict(backbone="resnet101"),
}


def _leaf_shapes(tree):
    return {path: tuple(v.shape) for path, v in weights._flatten_tree(tree["params"])}


@functools.lru_cache(maxsize=None)
def int8_pair(name, precision="fp32"):
    """(JAX int8 model, its tree, port int8 model, scales): the same seeded
    draw, the same scales (tcb, and gru except on ResNet) for both. The
    scales are the port's calibration (calibrate_act_scales, held against
    the JAX package's in tests/test_torch_port_quantize.py); the JAX
    package's, an eager forward capturing intermediates, takes ~11 s a
    model here."""
    kw = dict(MODELS[name])
    small = dict(tcb_channels=32, width_mult=0.0625 if kw.get("backbone") else 0.125)
    jmodel = j_build(jcfg.TINY_64, **kw, **small)
    tmodel = build_detector(tcfg.TINY_64, device="cpu", **kw, **small)
    weights.load_random_params(tmodel, 21)
    tree = weights.params_to_jax(tmodel.state_dict())
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    assert _leaf_shapes(tree) == _leaf_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x0, None))
    if precision == "bf16":
        jmodel, tree = jprec.apply_inference_precision(jmodel, tree, "bf16")
        tmodel = tprec.apply_inference_precision(tmodel, "bf16")
    calib = (np.random.default_rng(22).uniform(0, 255, (3, 64, 64, 3)) - 117.0).astype("f4")
    gru = name != "resnet"
    scales = tq.calibrate_act_scales(tmodel, torch.from_numpy(calib).to(tmodel.dtype), tcb=True,
                                     gru=gru)
    jqm, jqt = jq.apply_int8_backbone(jmodel, tree, act_scales=scales)
    return jqm, jqt, tq.apply_int8_backbone(tmodel, act_scales=scales), scales


@functools.lru_cache(maxsize=None)
def _jax_apply_recording(jm):
    """The JAX int8 model's forward, jitted, returning each QConv's input by
    module path beside its outputs."""
    def run(jt, x, state):
        inputs = {}

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, JQConv) and context.method_name == "__call__":
                inputs[".".join(context.module.path)] = args[0].astype(jnp.float32)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(record):
            out = jm.apply(jt, x, state)
        return out, inputs

    return jax.jit(run)


def _port_apply_recording(tm, x, state):
    inputs, handles = {}, []
    for path, mod in tm.named_modules():
        if isinstance(mod, QConv):
            handles.append(mod.register_forward_pre_hook(
                lambda m, a, path=path: inputs.__setitem__(
                    path, a[0].float().permute(0, 2, 3, 1).numpy().copy())))
    try:
        with torch.no_grad():
            out = tm(x, state)
    finally:
        for h in handles:
            h.remove()
    return out, inputs


def _flips(jin, tin, jt):
    """(flipped int8 activations, of how many, largest step difference)."""
    flips = total = worst = 0
    for path, xj in jin.items():
        node = jt["params"]
        for p in path.split("."):
            node = node[p]
        inv = np.float32(127.0) / np.asarray(node["xscale"], np.float32)
        q = lambda x: np.clip(np.round(x * inv), -127, 127)
        d = np.abs(q(xj) - q(tin[path]))
        flips, total, worst = flips + int((d > 0).sum()), total + d.size, max(worst, int(d.max()))
    return flips, total, worst


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,precision", [("vgg", "fp32"), ("vgg", "bf16"),
                                            ("s2d_light", "fp32"), ("resnet", "fp32")])
def test_int8_model_matches_jax(name, precision):
    """Two streaming steps (one for ResNet, which runs its cells in float):
    raw predictions and the carried state within REL of max|ref| of the JAX
    int8 model's on the same scales; flips counted and logged (in fp32 at
    most one step each)."""
    jm, jt, tm, scales = int8_pair(name, precision)
    n_q = sum(isinstance(m, QConv) for m in tm.modules())
    assert n_q == len(scales) == sum(1 for k in weights._flatten_tree(jt["params"]) if k[0][-1] == "wscale")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if precision == "bf16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(23)
    jstate = jm.zero_state(2)
    tstate = tm.zero_state(2)
    tol = REL[precision]
    for step in range(1 if name == "resnet" else 2):
        x = (rng.uniform(0, 255, (2, 64, 64, 3)) - 117.0).astype("f4")
        (jp, jstate), jin = _jax_apply_recording(jm)(jt, jnp.asarray(x, jdt), jstate)
        jin = {k: np.asarray(v) for k, v in jin.items()}
        (tp, tstate), tin = _port_apply_recording(tm, torch.from_numpy(x).to(tdt), tstate)
        assert set(jin) == set(tin) and len(tin) == n_q
        assert all(t.dtype == tdt for t in tstate)
        worst = 0.0
        for a, b in zip(list(tp) + [_nhwc(s) for s in tstate],
                        list(jp) + list(jstate)):
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            rel = float(np.abs(a - b).max() / np.abs(b).max())
            worst = max(worst, rel)
        flips, total, step_max = _flips(jin, tin, jt)
        log.info("int8 %s %s step %d: max rel err %.3g (bound %g); %d of %d int8 activations "
                 "flipped, by at most %d step(s)", name, precision, step, worst, tol, flips, total,
                 step_max)
        assert worst < tol, f"step {step}: {worst} of max|ref|"
        if precision == "fp32":
            assert step_max <= 1


def _sorted_scores(det, i=None):
    return np.sort(np.asarray(det.scores if i is None else det.scores[i]), axis=-1)


def test_streaming_int8_matches_jax_and_chunk2():
    """2 streams x 4 frames of the fp32 int8 VGG with lane 1 reset after two
    frames: the port's chunk-1 detector against JAX's (sorted scores), and
    the port's chunk-2 detector against its chunk 1 (scores and state)."""
    jm, jt, tm, _ = int8_pair("vgg")
    frames = np.random.RandomState(24).randint(0, 255, (4, 2, 64, 64, 3), np.uint8)
    det = StreamingDetector(tm, num_streams=2, device="cpu")
    jdet = JStreamingDetector(jm, jt, num_streams=2)
    det2 = StreamingDetector(tm, num_streams=2, chunk=2, device="cpu")
    outs = []
    for t in range(4):
        if t == 2:
            det.reset([1])
            jdet.reset([1])
        out, jout = det.detect(frames[t]), jdet.detect(frames[t])
        np.testing.assert_allclose(_sorted_scores(out), _sorted_scores(jout), atol=SCORE_ATOL,
                                   rtol=0, err_msg=f"frame {t} vs JAX")
        outs.append(out)
    out_a = det2.detect(frames[0:2])
    det2.reset([1])
    out_b = det2.detect(frames[2:4])
    for t, o in enumerate((out_a, out_a, out_b, out_b)):
        np.testing.assert_allclose(_sorted_scores(o, t % 2), _sorted_scores(outs[t]),
                                   atol=CHUNK_ATOL, rtol=0, err_msg=f"frame {t} chunk 2")
    for s2, s1, js in zip(det2.state, det.state, jdet._state):
        np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=CHUNK_ATOL, rtol=0)
        a, b = _nhwc(s1), np.asarray(js, np.float32)
        assert np.abs(a - b).max() / np.abs(b).max() < REL["fp32"]


def test_single_image_and_clip_forwards_take_an_int8_model():
    """make_single_image_forward and make_clip_forward run an int8 model as
    they run any other: the clip's first frame equals a single-image call,
    a second clip repeats the first, and the QConvs ran."""
    _, _, tm, _ = int8_pair("vgg")
    frames = np.random.default_rng(25).integers(0, 256, (2, 2, 64, 64, 3), np.uint8)
    single = make_single_image_forward(tm)(torch.from_numpy(frames[0]))
    assert single.scores.shape == (2, tm.cfg.top_k)
    run = make_clip_forward(tm, device="cpu")
    clip = run(frames)
    assert clip.scores.shape == (2, 2, tm.cfg.top_k)
    np.testing.assert_allclose(clip.scores[0].numpy(), single.scores.numpy(), atol=1e-6, rtol=0)
    again = run(frames)
    assert torch.equal(again.scores, clip.scores) and torch.equal(again.boxes, clip.boxes)
    hits = []
    h = tm.backbone.conv1_1.register_forward_hook(lambda *a: hits.append(1))
    try:
        make_single_image_forward(tm)(torch.from_numpy(frames[0]))
    finally:
        h.remove()
    assert hits == [1]


def test_bench_torch_runs_the_int8_profile(capsys, monkeypatch):
    """bench_torch.py --int8 --int8_tcb --int8_gru on the CPU at tiny_64 (its
    main, in this process): one JSON line with int8 true, from the model that
    apply_int8_backbone returned to it, with the 37 QConvs of the profile
    computing in bf16 on fp32 scales."""
    import bench_torch

    made = []

    def spy(*args, **kwargs):
        made.append(tq.apply_int8_backbone(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(bench_torch, "apply_int8_backbone", spy)
    bench_torch.main(["--device", "cpu", "--config", "tiny_64", "--frames", "2", "--warmup", "1",
                      "--batch", "1", "--int8", "--int8_tcb", "--int8_gru"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["int8"] is True and row["device"] == "cpu" and row["value"] > 0
    (model,) = made
    assert model.quant and model.quant_tcb and model.quant_gru
    assert sum(isinstance(m, QConv) for m in model.modules()) == 37
    assert model.backbone.conv1_1.dtype == torch.bfloat16
    assert model.backbone.conv1_1.wscale.dtype == torch.float32
