"""The port's ResNet-101 detector against the JAX package at TINY_64,
width_mult 0.0625, 32 TCB channels: frozen and group norms in fp32, frozen
in the resident-bf16 profile; and the torchvision ResNet layout
(weights.resnet_backbone_from_torchvision / load_resnet_backbone) against the
JAX package's rules on synthetic state dicts.

The weights are a seeded draw through the port, the norms' scales drawn too,
converted to the JAX layout and checked against the JAX model's own param
shapes (jax.eval_shape); the applies are jitted."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.models import resnet as jresnet
from tdrn_tpu.utils import precision as jprec
from tdrn_tpu.utils import torch_weights as jtw
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models import resnet as tresnet
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.utils.precision import apply_inference_precision
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(tcb_channels=32, width_mult=0.0625)
ATOL = 1e-4  # fp32, the port's forward bound (tests/test_torch_port_model.py)
# Group norm, fp32: the same bound as a share of each output's max|ref|.
# GroupNorm's E[x^2] - mean^2 over this width's small groups is ill-conditioned:
# on identical input the stem's norm already differs by 1.9e-6 (5e-7 of its
# max), and each norm multiplies a difference by up to 13x. Measured: 1.4e-4
# abs on the ARM locations (max|ref| 6.6, through L2Norm's scale of 10),
# 2.1e-5 of max|ref|; frozen norm 2.6e-6 abs. The norm alone is held at 1e-5
# abs below (test_group_norm_matches_flax_in_both_dtypes).
GROUP_REL = 1e-4
BF16_REL = 5e-2  # bf16, of max|ref| (tests/test_precision.py)


def _leaf_shapes(tree):
    return {path: tuple(v.shape) for path, v in weights._flatten_tree(tree["params"])}


@functools.lru_cache(maxsize=None)
def _pair(norm):
    """(JAX model, port model, JAX tree) with one seeded draw; the norms'
    scales are drawn too: uniform in [0.5, 1), and in [0.1, 0.3) for each
    residual branch's last norm (bn3), as trained ResNets damp their branches.
    With full-scale branches, GroupNorm over this width's groups of 16 values
    amplifies fp32 rounding about 1.5x a block, and after 33 blocks two fp32
    sums in different orders differ by 6e-2 (the JAX package against float64
    by more than the port does)."""
    jmodel = j_build(jcfg.TINY_64, backbone="resnet101", backbone_norm=norm, **SMALL)
    tmodel = build_detector(tcfg.TINY_64, backbone="resnet101", backbone_norm=norm,
                            device="cpu", **SMALL)
    weights.load_random_params(tmodel, 7)
    tree = weights.params_to_jax(tmodel.state_dict())
    rng = np.random.default_rng(8)
    for path, v in list(weights._flatten_tree(tree["params"])):
        if path[0] == "backbone" and path[-1] == "scale":
            node = tree["params"]
            for p in path[:-1]:
                node = node[p]
            low, high = (0.1, 0.3) if path[-2] == "bn3" else (0.5, 1.0)
            node["scale"] = rng.uniform(low, high, v.shape).astype(np.float32)
    weights.load_jax_params(tmodel, tree)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    assert _leaf_shapes(tree) == _leaf_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, None))
    return jmodel, tmodel, tree


def _inputs():
    rng = np.random.default_rng(9)
    x = (rng.uniform(0, 255, (2, 64, 64, 3)) - 117.0).astype("f4")
    state = [rng.normal(0, 0.5, (2, f, f, 32)).astype("f4") for f in jcfg.TINY_64.feature_maps]
    return x, state


def _run(jmodel, tree, tmodel, x, state):
    jpreds, jstate = jax.jit(jmodel.apply)(tree, jnp.asarray(x), [jnp.asarray(s) for s in state])
    tstate_in = [torch.from_numpy(np.ascontiguousarray(s.transpose(0, 3, 1, 2))) for s in state]
    with torch.no_grad():
        tpreds, tstate = tmodel(torch.from_numpy(x), tstate_in)
    return (jpreds, jstate), (tpreds, tstate)


@pytest.mark.parametrize("norm", ["frozen", "group"])
def test_resnet_detector_matches_jax(norm):
    jmodel, tmodel, tree = _pair(norm)
    assert isinstance(tmodel.backbone, tresnet.ResNetBackbone)
    assert tmodel.backbone.out_channels == (32, 64, 128, 32)  # 4w(128), 4w(256), 4w(512), w(512)
    (jp, js), (tp, ts) = _run(jmodel, tree, tmodel, *_inputs())
    for a, b in zip(list(tp) + list(ts), list(jp) + list(js)):
        a, b = a.numpy(), np.asarray(b)
        if a.ndim == 4:
            a = a.transpose(0, 2, 3, 1)
        tol = ATOL if norm == "frozen" else GROUP_REL * np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_resnet_detector_bf16_matches_jax():
    jmodel, tmodel, tree = _pair("frozen")
    jm, jtree = jprec.apply_inference_precision(jmodel, tree, "bf16")
    tm = apply_inference_precision(tmodel, "bf16")
    assert tm.backbone.stage3_22.bn3.scale.dtype == torch.bfloat16
    assert tm.backbone.stem.weight.dtype == torch.bfloat16 and tm.odm.loc0.weight.dtype == torch.float32
    x, state = _inputs()
    state = [s.astype(jnp.bfloat16) for s in state]
    jpreds, jstate = jax.jit(jm.apply)(jtree, jnp.asarray(x), [jnp.asarray(s) for s in state])
    tstate_in = [torch.from_numpy(np.asarray(s, np.float32).transpose(0, 3, 1, 2).copy()).bfloat16()
                 for s in state]
    with torch.no_grad():
        tpreds, tstate = tm(torch.from_numpy(x), tstate_in)
    assert tstate[0].dtype == torch.bfloat16
    for a, b in zip(list(tpreds) + list(tstate), list(jpreds) + list(jstate)):
        b = np.asarray(b, np.float32)
        a = a.float().numpy()
        if a.ndim == 4:
            a = a.transpose(0, 2, 3, 1)
        assert np.abs(a - b).max() / np.abs(b).max() < BF16_REL


def test_group_norm_matches_flax_in_both_dtypes():
    """The port's GroupNorm alone against flax's nn.GroupNorm(gcd(32, C)) at
    epsilon 1e-6, on inputs with a large mean (E[x^2] - mean^2 in fp32)."""
    import flax.linen as fnn

    rng = np.random.default_rng(10)
    for c in (8, 48, 64):
        x = (rng.normal(3.0, 2.0, (2, 5, 6, c))).astype("f4")
        scale = rng.uniform(0.5, 1.5, c).astype("f4")
        bias = rng.normal(0, 0.1, c).astype("f4")
        gn = tresnet.GroupNorm(c)
        gn.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            mod = fnn.GroupNorm(num_groups=int(np.gcd(32, c)), dtype=jdt)
            ref = mod.apply({"params": {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}},
                            jnp.asarray(x, jdt))
            gn.to(tdt)
            with torch.no_grad():
                got = gn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt))
            assert got.dtype == tdt
            got = got.float().numpy().transpose(0, 2, 3, 1)
            tol = 1e-5 if tdt == torch.float32 else 1e-2 * np.abs(np.asarray(ref, np.float32)).max()
            np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol, rtol=0)
        assert gn.groups == np.gcd(32, c)


def test_conv_chain_matches_jax():
    for depth in (50, 101, 152):
        assert tresnet.resnet_conv_chain(depth) == jresnet.resnet_conv_chain(depth)
    assert tresnet.DEPTHS == jresnet._DEPTHS


# --- the torchvision ResNet layout -------------------------------------------


def _torchvision_sd(backbone: torch.nn.Module, seed=None):
    """A synthetic torchvision ResNet state dict shaped for ``backbone``
    (random when seeded, else zeros and unit variances), with torchvision's
    extra keys (num_batches_tracked, fc)."""
    rng = np.random.default_rng(seed) if seed is not None else None
    draw = (lambda shape: rng.normal(0, 0.5, shape).astype("f4")) if rng else (
        lambda shape: np.zeros(shape, np.float32))
    sd = {}
    for key, v in backbone.state_dict().items():
        path = key.split(".")
        prefix = weights._resnet_torch_prefix(path[:-1])
        if prefix is None or path[-1] == "bias" and not path[-2].startswith(("bn", "stem_bn", "proj_bn")):
            continue
        shape = tuple(v.shape)
        if path[-1] == "weight":
            sd[f"{prefix}.weight"] = torch.from_numpy(draw(shape))
        elif path[-1] == "scale":
            sd[f"{prefix}.weight"] = torch.from_numpy(draw(shape) + 1.0)
            sd[f"{prefix}.bias"] = torch.from_numpy(draw(shape))
            sd[f"{prefix}.running_mean"] = torch.from_numpy(draw(shape))
            var = np.abs(draw(shape)) + 0.5 if rng else np.ones(shape, np.float32)
            sd[f"{prefix}.running_var"] = torch.from_numpy(var)
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.zeros(10, 4)
    return sd


def test_resnet_from_torchvision_matches_jax():
    """Depth 101 at width 0.25: the port's conversion equals the JAX
    package's on the same synthetic state dict, key for key, bit for bit."""
    backbone = tresnet.ResNetBackbone(101, width_mult=0.25)
    weights.load_random_params(backbone, 3)  # extra1/extra2 keep these values
    sd = _torchvision_sd(backbone, seed=4)
    got, loaded, skipped = weights.resnet_backbone_from_torchvision(sd, backbone.state_dict())
    template = weights.params_to_jax(backbone.state_dict())["params"]
    ref_tree, ref_loaded, ref_skipped = jtw.resnet_backbone_from_torchvision(
        {k: v.numpy() for k, v in sd.items()}, template)
    want = weights.params_from_jax({"params": ref_tree})
    assert got.keys() == want.keys() == backbone.state_dict().keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key
    to_port = lambda names: sorted(n.replace(".kernel", ".weight") for n in names)
    assert sorted(loaded) == to_port(ref_loaded) and sorted(skipped) == to_port(ref_skipped)
    assert sorted(skipped) == ["extra1.bias", "extra1.weight", "extra2.bias", "extra2.weight"]
    assert not got["stage2_0.proj.bias"].any()  # torchvision convs are bias-free
    # Strict on shapes.
    bad = dict(sd)
    bad["layer3.4.conv2.weight"] = torch.zeros(3, 3, 1, 1)
    with pytest.raises(ValueError, match="layer3.4.conv2"):
        weights.resnet_backbone_from_torchvision(bad, backbone.state_dict())


def test_load_resnet_backbone_from_a_file(tmp_path):
    model = build_detector(tcfg.TINY_64, backbone="resnet101", device="cpu", **SMALL)
    sd = _torchvision_sd(model.backbone, seed=5)
    path = tmp_path / "resnet101.pth"
    torch.save({"state_dict": sd}, path)
    _, loaded, skipped = weights.load_resnet_backbone(model, str(path))
    scale, bias = weights._fold_bn(sd, "layer1.0.bn2")
    assert torch.equal(model.backbone.stage1_0.bn2.scale, torch.from_numpy(scale))
    assert torch.equal(model.backbone.stage1_0.bn2.bias, torch.from_numpy(bias))
    assert torch.equal(model.backbone.stem.weight, sd["conv1.weight"])
    assert len(loaded) + len(skipped) == len(model.backbone.state_dict())


def test_full_width_resnet101_conversion_shapes():
    """Full width, depth 101, the port alone: every key converts at its shape."""
    model = build_detector(tcfg.VID_512, backbone="resnet101", temporal=False, device="cpu")
    sd = _torchvision_sd(model.backbone)
    assert sum(1 for k in sd if k.endswith("running_mean")) == 104  # 1 + 3 a block x 33 + 4 proj
    _, loaded, skipped = weights.load_resnet_backbone(model, sd)
    assert len(skipped) == 4 and len(loaded) == len(model.backbone.state_dict()) - 4
    assert model.backbone.out_channels == (512, 1024, 2048, 512)
    assert model.backbone.stage3_22.conv2.weight.shape == (256, 256, 3, 3)
