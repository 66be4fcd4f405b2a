"""The port's train step against the JAX package's: TINY_64, width_mult
0.125, 32 TCB channels, B=2 (clips T=2), the port's seeded weights carried
into the JAX tree by weights.params_to_jax (no jit(model.init)); each JAX
step compiled once for the module.

  * the LR schedule exact at 0, warmup-1, warmup and each milestone's edges
    (against the JAX schedule and optax's piecewise_constant_schedule);
  * the optimizer's update (clip, weight decay, momentum) clipped and not;
  * two optimizer steps each in image mode, clip mode, clip mode with remat,
    bf16 compute (clip mode) and QAT (image mode, backbone and TCB scales):
    loss and metrics within 1e-4 relative (bf16: 5e-2); each leaf's momentum
    trace, and so its update (-lr * trace, the same fp32 lr), within 1e-4 of
    that leaf's max|ref| in fp32 and QAT_REL under QAT, and its params
    within that share of the update plus the rounding of the add; in bf16
    the traces within the reference's own bf16 rounding noise (see
    test_bf16_step_within_the_references_bf16_noise);
  * fake_quant_act / fake_quant_kernel bit-equal to the JAX package's, their
    straight-through gradients the identity, FQConv against the JAX FQConv;
  * apply_qat's refusals; split_qat_scales;
  * the port's trainable parameters map one to one, by name and shape, onto
    the leaves of the JAX params tree (VGG-16 with and without the temporal
    cells, ResNet-101 with its FrozenBN affines), so gradient, weight decay
    and update apply to the same set.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.models import detector as jdet
from tdrn_tpu.models import layers as jlayers
from tdrn_tpu.train import Targets as JTargets
from tdrn_tpu.train import TrainState as JTrainState
from tdrn_tpu.train import make_lr_schedule as j_schedule
from tdrn_tpu.train import make_optimizer as j_optimizer
from tdrn_tpu.train import make_train_step as j_train_step
from tdrn_tpu.utils import quantize as jq
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models import detector as tdet
from tdrn_tpu_torch.models import layers as tlayers
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.train import Targets, init_train_state, make_optimizer, make_train_step
from tdrn_tpu_torch.train.trainer import make_lr_schedule
from tdrn_tpu_torch.utils import quantize as tq
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(width_mult=0.125, tcb_channels=32)
B, T, G = 2, 2, 5
OPT = dict(base_lr=1e-2, warmup_steps=1)
LOSS_RTOL = 1e-4
FP32_REL = 1e-4
BF16_REL = 5e-2
# bf16 traces: the port's distance from the JAX bf16 step over the JAX bf16
# step's own distance from fp32 (measured 0.94 and 0.95 over two steps).
BF16_NOISE = 1.5
# QAT: measured 2.5e-6 at the first step (the fp32 steps: 3.2e-6 image,
# 3.7e-6 clip): the grids agree bit for bit and the convs sum in another
# order, so QAT is held at the fp32 bound.
QAT_REL = 1e-4
MODES = {
    # mode: (clip, remat, bf16, qat, leaf bound)
    "image": (False, False, False, False, FP32_REL),
    "clip": (True, False, False, False, FP32_REL),
    "clip_remat": (True, True, False, False, FP32_REL),
    "bf16_clip": (True, False, True, False, None),
    "qat_image": (False, False, False, True, QAT_REL),
}
# The JAX steps compile at XLA's lowest backend optimization level: half
# the compile time on a CPU, the same IEEE fp32 operations.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(clip: bool, seed: int):
    rng = np.random.default_rng(seed)
    lead = (T, B) if clip else (B,)
    x = rng.uniform(-120.0, 130.0, lead + (64, 64, 3)).astype(np.float32)
    xy = rng.uniform(0.0, 0.6, lead + (G, 2))
    wh = rng.uniform(0.1, 0.4, lead + (G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, tcfg.TINY_64.num_classes - 1, lead + (G,)).astype(np.int32)
    valid = rng.random(lead + (G,)) < 0.7
    valid[..., 0] = True
    return x, boxes, labels, valid


def _jax_trace(opt_state):
    """The momentum trace tree inside optax's chain state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _jax_trace(s)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def models():
    out = {}
    for clip in (False, True):
        tm = build_detector(tcfg.TINY_64, temporal=clip, device="cpu", **SMALL)
        weights.load_random_params(tm, 7)
        out[clip] = (tm, j_build(jcfg.TINY_64, temporal=clip, **SMALL))
    return out


@pytest.fixture(scope="module")
def qat_scales(models):
    tm = models[False][0]
    frames = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    return tq.calibrate_act_scales(tm, preprocess_batch(torch.from_numpy(frames), tcfg.TINY_64),
                                   tcb=True)


_JAX_RUNS = {}


@pytest.fixture(scope="module")
def run(models, qat_scales):
    """mode -> two optimizer steps of the JAX step and the port's from the
    same params and batches: per step (metrics, params, traces) of each. The
    remat mode is held against the JAX clip step without remat (remat
    changes when the forward runs, not what it computes; the port's remat
    run must also equal its run without remat bit for bit)."""

    def jax_steps(clip, bf16, qat):
        key = (clip, bf16, qat)
        if key in _JAX_RUNS:
            return _JAX_RUNS[key]
        tm, jm = models[clip]
        jo = j_optimizer(**OPT)
        jp = jax.tree.map(jnp.asarray, weights.params_to_jax(tm.state_dict()))
        jts = JTrainState(jp, jo.init(jp), jnp.zeros((), jnp.int32))
        jstep = j_train_step(jm, jo, clip_mode=clip, compute_dtype=jnp.bfloat16 if bf16 else None,
                             qat_scales=qat_scales if qat else None)
        out, compiled = [], None
        for i in range(2):
            x, boxes, labels, valid = _batch(clip, 100 + i)
            jt = JTargets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
            if compiled is None:
                compiled = jstep.lower(jts, jnp.asarray(x), jt).compile(
                    compiler_options=FAST_COMPILE)
            jts, jmet = compiled(jts, jnp.asarray(x), jt)
            out.append(({k: float(v) for k, v in jmet.items()},
                        weights.params_from_jax(jax.tree.map(np.asarray, jts.params)),
                        weights.params_from_jax(jax.tree.map(np.asarray, _jax_trace(jts.opt_state))),
                        int(jts.step)))
        _JAX_RUNS[key] = out
        return out

    def port_steps(clip, remat, bf16, qat):
        tm = models[clip][0]
        to = make_optimizer(**OPT)
        tts = init_train_state(tm, to)
        tstep = make_train_step(tm, to, clip_mode=clip, remat=remat,
                                compute_dtype=torch.bfloat16 if bf16 else None,
                                qat_scales=qat_scales if qat else None)
        out = []
        for i in range(2):
            x, boxes, labels, valid = _batch(clip, 100 + i)
            tts, tmet = tstep(tts, torch.from_numpy(x), Targets(
                torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid)))
            out.append(({k: float(v) for k, v in tmet.items()},
                        {k: v.clone() for k, v in tts.params.items()},
                        {k: v.clone() for k, v in tts.opt_state.trace.items()}, tts.step))
        return out

    def go(mode):
        clip, remat, bf16, qat, _ = MODES[mode]
        port = port_steps(clip, remat, bf16, qat)
        if remat:
            for a, b in zip(port, port_steps(clip, False, bf16, qat)):
                assert a[0] == b[0] and all(torch.equal(a[j][k], b[j][k])
                                            for j in (1, 2) for k in a[1])
        return list(zip(jax_steps(clip, bf16, qat), port))

    return go


def _same_metrics(mode, i, jmet, tmet, rtol):
    assert jmet.keys() == tmet.keys()
    for k in jmet:
        rel = abs(tmet[k] - jmet[k]) / max(abs(jmet[k]), 1e-30)
        assert rel <= rtol, (mode, i, k, tmet[k], jmet[k])


@pytest.mark.parametrize("mode", [m for m in MODES if not MODES[m][2]])
def test_two_steps_match_jax(run, mode):
    bound = MODES[mode][-1]
    for i, ((jmet, jparams, jtrace, jstep), (tmet, tparams, ttrace, tstep)) in enumerate(run(mode)):
        assert jstep == tstep == i + 1
        _same_metrics(mode, i, jmet, tmet, LOSS_RTOL)
        assert jparams.keys() == tparams.keys() == jtrace.keys() == ttrace.keys()
        # The update both packages apply is -lr(count) * trace with the same
        # fp32 lr (test_lr_schedule_exact), so the trace bound is the update
        # bound. The params then differ by at most that much of the update,
        # plus the rounding of p + u (one ulp of max|p|): an update is often
        # 1e-4 of its parameter, so p_new - p_old alone would not resolve it.
        lr = abs(float(make_lr_schedule(OPT["base_lr"], OPT["warmup_steps"])(i)))
        worst = 0.0
        for k in jparams:
            ref = float(jtrace[k].abs().max())
            if ref == 0.0:
                assert float(ttrace[k].abs().max()) == 0.0, (mode, i, k)
                continue
            worst = max(worst, float((ttrace[k] - jtrace[k]).abs().max()) / ref)
            slack = bound * lr * ref + 2.0 ** -23 * float(jparams[k].abs().max())
            assert float((tparams[k] - jparams[k]).abs().max()) <= 2 * slack, (mode, i, k)
        assert worst <= bound, (mode, i, worst)


def _global_rel(a, b, ref):
    """||a - b|| / ||ref|| over every leaf."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


def test_bf16_step_within_the_references_bf16_noise(run):
    """bf16 compute, two clip steps. The losses and metrics within 5e-2
    relative. A leaf's gradient in bf16 is not held to 5e-2 of its max: the
    JAX package's own bf16 step departs from its fp32 step by up to a third
    of a leaf's max|trace| on this module's inputs (XLA rounds bf16 at its fusion boundaries,
    PyTorch after each op). So the port's bf16 traces are held, over all
    leaves, at most BF16_NOISE times as far from the JAX bf16 step's as that
    step's are from the JAX fp32 step's, and the port's bf16 step no farther
    from its own fp32 step than that."""
    bf16, fp32 = run("bf16_clip"), run("clip")
    for i, ((jmet, _, jtrace, jstep), (tmet, tparams, ttrace, tstep)) in enumerate(bf16):
        assert jstep == tstep == i + 1
        _same_metrics("bf16_clip", i, jmet, tmet, BF16_REL)
        assert all(v.dtype == torch.float32 for v in [*tparams.values(), *ttrace.values()])
        assert all(float(v.abs().max()) > 0 for v in ttrace.values())
        j32, t32 = fp32[i][0][2], fp32[i][1][2]
        noise = _global_rel(jtrace, j32, j32)
        assert _global_rel(ttrace, jtrace, jtrace) <= BF16_NOISE * noise, i
        assert _global_rel(ttrace, t32, t32) <= BF16_NOISE * noise, i


def test_lr_schedule_exact():
    milestones = (800, 1000)
    jsched = j_schedule(1e-3, 500, milestones, 0.1)
    tsched = make_lr_schedule(1e-3, 500, milestones, 0.1)
    for step in (0, 1, 498, 499, 500, 501, 799, 800, 801, 999, 1000, 1001, 5000):
        want = np.asarray(jsched(jnp.asarray(step, jnp.int32)))
        got = tsched(step)
        assert got.dtype == np.float32 and got == want, (step, got, want)
    # The decay against optax's own schedule, at each milestone's edges.
    pw = optax.piecewise_constant_schedule(1e-3, {m: 0.1 for m in milestones})
    no_warmup = make_lr_schedule(1e-3, 0, milestones, 0.1)
    for m in milestones:
        for step in (m - 1, m, m + 1):
            assert no_warmup(step) == np.asarray(pw(jnp.asarray(step, jnp.int32))), step


@pytest.mark.parametrize("clip_norm", [1e-3, 1e6])
def test_optimizer_update_matches_optax(clip_norm):
    """A tiny clip norm forces the clip; a huge one leaves the gradient."""
    rng = np.random.default_rng(4)
    shapes = {"a.weight": (8, 3, 3, 3), "a.bias": (8,), "b.scale": (5,)}
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    jo = j_optimizer(1e-2, warmup_steps=2, grad_clip_norm=clip_norm)
    to = make_optimizer(1e-2, warmup_steps=2, grad_clip_norm=clip_norm)
    jstate, tstate = jo.init(p), to.init({k: torch.from_numpy(v) for k, v in p.items()})
    for i in range(3):
        g = {k: rng.normal(0, 3, s).astype(np.float32) for k, s in shapes.items()}
        jup, jstate = jo.update(g, jstate, p)
        tup, tstate = to.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                                {k: torch.from_numpy(v) for k, v in p.items()})
        jtr = _jax_trace(jstate)
        for k in shapes:
            want = np.asarray(jup[k])
            np.testing.assert_allclose(tup[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            np.testing.assert_allclose(tstate.trace[k].numpy(), np.asarray(jtr[k]), rtol=0,
                                       atol=1e-6 * np.abs(np.asarray(jtr[k])).max())
        assert tstate.count == i + 1
    norm = np.sqrt(sum((np.asarray(v) ** 2).sum() for v in g.values()))
    assert (norm > clip_norm) == (clip_norm < 1)


def test_fake_quant_bit_equal_and_straight_through():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 4, (2, 6, 5, 7)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        got = tlayers.fake_quant_act(xt, 3.7)
        want = jlayers.fake_quant_act(jnp.asarray(x).astype(jdt), 3.7)
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        r = torch.randn(xt.shape, generator=torch.Generator().manual_seed(0)).to(dt)
        (gx,) = torch.autograd.grad((got * r).sum(), xt)
        assert torch.equal(gx, r)
    w = rng.normal(0, 0.1, (8, 5, 3, 3)).astype(np.float32)  # OIHW
    w[3] = 0.0  # an all-zero output channel (step floored at 1e-12)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tlayers.fake_quant_kernel(wt)
    want = np.asarray(jlayers.fake_quant_kernel(jnp.asarray(w.transpose(2, 3, 1, 0))))
    np.testing.assert_array_equal(got.detach().numpy(), want.transpose(3, 2, 0, 1))
    (gw,) = torch.autograd.grad(got.sum(), wt)
    assert torch.equal(gw, torch.ones_like(wt))


@pytest.mark.parametrize("k,cin,stride", [(1, 1, 1), (3, 5, 2)])
def test_fqconv_matches_jax(k, cin, stride):
    """A 1x1 conv of one input channel is a product and an add: bit-equal;
    a strided 3x3 sums in another order: 1e-5 of max|ref|."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 2, (2, 9, 9, cin)).astype(np.float32)
    jmod = jlayers.FQConv(6, (k, k), stride=stride, xscale=4.0)
    jp = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(jp, jnp.asarray(x))).transpose(0, 3, 1, 2)
    conv = torch.nn.Conv2d(cin, 6, k, stride=stride, padding=k // 2)
    conv.load_state_dict({"weight": torch.from_numpy(np.asarray(jp["params"]["kernel"]).transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(np.asarray(jp["params"]["bias"]))})
    fq = tlayers.FQConv.like(conv, 4.0)
    assert fq.state_dict().keys() == conv.state_dict().keys()
    got = fq(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    if k == 1 and cin == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_apply_qat_refusals_and_keys(models, qat_scales):
    tm = models[False][0]
    qat = tq.apply_qat(tm, qat_scales)
    n_fq = sum(isinstance(m, tlayers.FQConv) for m in qat.modules())
    assert n_fq == len(qat_scales) and qat.qat_scales is not None
    assert qat.state_dict().keys() == tm.state_dict().keys()
    assert not any(isinstance(m, tlayers.FQConv) for m in tm.modules())
    s2d = build_detector(tcfg.TINY_64, stem="s2d", temporal=False, device="cpu", **SMALL)
    assert sum(isinstance(m, tlayers.FQConv) for m in tq.apply_qat(s2d, qat_scales).modules()) \
        == len(qat_scales)
    poly = build_detector(tcfg.TINY_64, stem="poly", temporal=False, device="cpu", **SMALL)
    temporal = models[True][0]
    gru = {"gru0/gates": 1.0, "gru0/cand": 1.0}
    bad = [
        (poly, qat_scales),  # a stem that rearranges conv1_1's kernel
        (tm, {k: v for k, v in qat_scales.items() if k != "conv3_1"}),  # missing key
        (tm, {**qat_scales, **gru}),  # gru keys on a non-temporal model
        (temporal, {**qat_scales, "gru0/gate": 1.0, "gru0/cand": 1.0}),  # light keys, convgru cell
        (tm, {**qat_scales, "conv1_1": 0.0}),  # non-positive scale
        (tq.apply_int8_backbone(tm, act_scales=qat_scales), qat_scales),  # an int8 model
    ]
    for model, scales in bad:
        with pytest.raises(ValueError):
            tq.apply_qat(model, scales)
    # The JAX package refuses the same poly stem and missing key.
    jpoly = j_build(jcfg.TINY_64, stem="poly", temporal=False, **SMALL)
    for model, scales in ((jpoly, qat_scales), (models[False][1], bad[1][1])):
        with pytest.raises(ValueError):
            jq.apply_qat(model, scales)


def test_split_qat_scales_matches_jax(qat_scales):
    pairs = tuple(sorted({**qat_scales, "gru1/gates": 2.0, "gru1/cand": 1.5}.items()))
    assert tdet.split_qat_scales(pairs) == jdet.split_qat_scales(pairs)


@pytest.mark.parametrize("build", [
    dict(backbone="vgg16", temporal=True),
    dict(backbone="vgg16", temporal=False),
    dict(backbone="resnet101", temporal=True, width_mult=0.0625),
])
def test_trainable_parameters_map_one_to_one(build):
    kw = {**SMALL, **build}
    tm = build_detector(tcfg.TINY_64, device="cpu", **kw)
    jm = j_build(jcfg.TINY_64, **kw)
    x = jnp.zeros((1, 64, 64, 3))
    state = jm.zero_state(1) if kw["temporal"] else None
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, state)
    want = {"/".join(p): tuple(s.shape) for p, s in _leaves(shapes["params"])}
    named = dict(tm.named_parameters())
    assert named.keys() == tm.state_dict().keys()  # no buffers: every leaf trains
    got = {"/".join(p): tuple(np.shape(v)) for p, v in
           weights._flatten_tree(weights.params_to_jax(named)["params"])}
    assert got == want
    if build["backbone"] == "resnet101":
        assert "backbone.stage1_0.bn1.scale" in named and "backbone.stem_bn.bias" in named


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_trainer_refuses_buffers_and_fp16(models, qat_scales):
    tm = models[False][0]
    opt = make_optimizer(**OPT)
    with pytest.raises(ValueError):
        init_train_state(tq.apply_int8_backbone(tm, act_scales=qat_scales), opt)
    with pytest.raises(NotImplementedError):
        make_train_step(tm, opt, compute_dtype=torch.float16)
