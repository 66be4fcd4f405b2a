"""K6 (ops/affine_act.py, csrc/affine_act.cu) on the CPU: its plain version
against the kernel's rounding sequence, the dispatch of models/resnet.py
to the modules' own ops wherever K6 does not apply (the CPU, gradients,
GroupNorm, fp32, hooks), the bottleneck's gradients, and the kernel's name
as the benchmark's trace classifies it. The kernel itself is held against
the plain version on the card (chip_smoke.py)."""

import os
import re
import types

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.roofline import KERNELS
from perfbench.trace import CONV_WORDS, kind
from tdrn_tpu_torch.models import resnet
from tdrn_tpu_torch.models.layers import FQConv
from tdrn_tpu_torch.ops.affine_act import Proj, affine_act, affine_act_plain
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
SHORTCUTS = ("none", "identity", "proj")


def _bits(t):
    """bf16 bit patterns, every NaN as one pattern."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int16)


def _map(gen, shape=(2, 16, 5, 3)):
    """A channels_last bf16 map with NaN, infinities, signed zeros, bf16
    subnormals and values near the bf16 overflow among its normal values."""
    x = torch.randn(shape, generator=gen) * 3.0
    flat = x.view(-1)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
                            1e-39, -1e-39, 3.0e38, -3.0e38])
    idx = torch.randperm(flat.numel(), generator=gen)[:special.numel()]
    flat[idx] = special
    return x.to(BF16).contiguous(memory_format=torch.channels_last)


def _vector(gen, c, low=-2.0, high=2.0):
    return (torch.rand(c, generator=gen) * (high - low) + low).to(BF16)


def _emulated_affine(c, conv_bias, scale, bias):
    """The kernel's conv bias and FrozenBN in fp32 arithmetic, rounded to
    bf16 after each op (fp32 values)."""
    r = lambda t: t.to(BF16).to(torch.float32)
    ch = lambda v: v.float()[:, None, None]
    t = c.float()
    if conv_bias is not None:
        t = r(t + ch(conv_bias))
    return r(r(t * ch(scale)) + ch(bias))


def _emulated(c, conv_bias, scale, bias, shortcut):
    """The kernel's whole sequence likewise, the ReLU last."""
    t = _emulated_affine(c, conv_bias, scale, bias)
    if isinstance(shortcut, Proj):
        shortcut = _emulated_affine(*shortcut)
    if shortcut is not None:
        t = (t + shortcut.float()).to(BF16).to(torch.float32)
    return torch.where(torch.isnan(t), t, torch.clamp_min(t, 0.0)).to(BF16)


def _operands(gen, conv_bias, shortcut, c):
    shape = (2, c, 5, 3)
    x = _map(gen, shape)
    cb = _vector(gen, c) if conv_bias else None
    sc = None
    if shortcut == "identity":
        sc = _map(gen, shape)
    elif shortcut == "proj":
        sc = Proj(_map(gen, shape), _vector(gen, c) if conv_bias else None, _vector(gen, c),
                  _vector(gen, c))
    return x, cb, _vector(gen, c), _vector(gen, c), sc


@pytest.mark.parametrize("channels", [8, 24])
@pytest.mark.parametrize("shortcut", SHORTCUTS)
@pytest.mark.parametrize("conv_bias", [True, False])
def test_plain_matches_the_kernels_rounding_sequence(conv_bias, shortcut, channels):
    """The plain version (PyTorch's bf16 ops) equals the sequence K6 computes
    (each op in fp32, rounded to bf16) bit for bit, NaN, infinities, signed
    zeros, subnormals and overflow included; on the CPU the wrapper runs the
    plain version into a new tensor and launches nothing."""
    gen = torch.Generator().manual_seed(100 * conv_bias + 10 * SHORTCUTS.index(shortcut)
                                        + channels)
    args = _operands(gen, conv_bias, shortcut, channels)
    want = _emulated(*args)
    got = affine_act_plain(*args)
    assert got.dtype == BF16 and got.shape == args[0].shape
    assert torch.equal(_bits(got), _bits(want))
    launches = affine_act.launches
    x0 = args[0].clone()
    out = affine_act(*args)
    assert affine_act.launches == launches
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(_bits(args[0]), _bits(x0))


def _unfused_block(blk, x):
    """Bottleneck.forward as the modules' own ops, with no dispatch."""
    shortcut = blk.proj_bn(blk.proj(x)) if hasattr(blk, "proj") else x
    y = F.relu(blk.bn1(blk.conv1(x)))
    y = F.relu(blk.bn2(blk.conv2(y)))
    return F.relu(blk.bn3(blk.conv3(y)) + shortcut)


def _block(norm, cin, features, stride, dtype, seed=0):
    torch.manual_seed(seed)
    blk = resnet.Bottleneck(cin, features, stride, norm)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("scale"):
                p.uniform_(0.5, 1.5)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1)
    return blk.to(dtype)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("norm", ["frozen", "group"])
def test_bottleneck_takes_the_plain_path_off_the_card(norm, dtype, grad):
    """On the CPU, with and without gradients, FrozenBN and GroupNorm, bf16
    and fp32: a bottleneck (identity and proj shortcut) equals its modules'
    own ops bit for bit, launches nothing, and each FrozenBN site (three a
    block) counts as unfused."""
    x = torch.randn(2, 32, 8, 8).to(dtype).contiguous(memory_format=torch.channels_last)
    for blk in (_block(norm, 32, 8, 1, dtype), _block(norm, 32, 16, 2, dtype)):
        assert hasattr(blk, "proj") == (blk.conv3.out_channels != 32 or blk.conv2.stride[0] != 1)
        launches, unfused = affine_act.launches, resnet.conv_norm.unfused
        with torch.set_grad_enabled(grad):
            got = blk(x)
            want = _unfused_block(blk, x)
        assert torch.equal(got, want)
        assert affine_act.launches == launches
        assert resnet.conv_norm.unfused == unfused + (3 if norm == "frozen" else 0)


def _card_like(dtype=BF16, channels_last=True, address=256):
    """What resnet._fuses reads of a tensor on the card."""
    return types.SimpleNamespace(
        is_cuda=True, dtype=dtype, data_ptr=lambda: address,
        is_contiguous=lambda memory_format=torch.contiguous_format:
            channels_last == (memory_format == torch.channels_last))


def test_dispatch_rule():
    """resnet._fuses: K6 for a bf16 FrozenBN after a bf16 nn.Conv2d of a
    multiple of 8 channels on a channels_last, 16-byte aligned input on the
    card without gradients; not on the CPU, under gradients, for GroupNorm,
    fp32, an FQConv, 12 channels, an NCHW or a misaligned input, or a hooked
    conv or norm."""
    conv = lambda cout=16, dtype=BF16: nn.Conv2d(8, cout, 1).to(dtype)
    bn = lambda c=16, dtype=BF16: resnet.FrozenBN(c).to(dtype)
    fuses = resnet._fuses
    with torch.no_grad():
        assert fuses(conv(), bn(), _card_like())
        assert not fuses(conv(), bn(), torch.zeros(1, 8, 2, 2, dtype=BF16))
        assert not fuses(conv(), resnet.GroupNorm(16).to(BF16), _card_like())
        assert not fuses(conv(dtype=torch.float32), bn(dtype=torch.float32),
                         _card_like(torch.float32))
        assert not fuses(conv(), bn(dtype=torch.float32), _card_like())
        assert not fuses(FQConv.like(conv(), 1.0), bn(), _card_like())
        assert not fuses(conv(12), bn(12), _card_like())
        assert not fuses(conv(), bn(), _card_like(channels_last=False))
        assert not fuses(conv(), bn(), _card_like(address=264))
        c, n = conv(), bn()
        for module in (c, n):
            handle = module.register_forward_hook(lambda *a: None)
            assert not fuses(c, n, _card_like())
            handle.remove()
        assert fuses(c, n, _card_like())
    assert not fuses(conv(), bn(), _card_like())  # gradients on


def test_identity_layout_decides_the_dispatch(monkeypatch):
    """Where _fuses holds, conv_norm hands a bf16 channels_last identity to
    K6's wrapper, and runs an NCHW or fp32 one on the modules' own ops
    (K6 raises on the card for such a shortcut); the bf16 ones give the
    same map."""
    calls = []
    monkeypatch.setattr(resnet, "_fuses", lambda *a: True)
    monkeypatch.setattr(resnet, "affine_act", lambda *a: calls.append(a) or affine_act(*a))
    torch.manual_seed(5)
    conv = nn.Conv2d(16, 16, 1, bias=False).to(BF16)  # the CPU adds a bias inside the conv
    bn = resnet.FrozenBN(16).to(BF16)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5)
        bn.bias.normal_(0.0, 0.1)
    x = torch.randn(2, 16, 4, 4).to(BF16).contiguous(memory_format=torch.channels_last)
    outs = []
    with torch.no_grad():
        for identity, fused in ((x, True), (x.contiguous(), False), (x.float(), False)):
            before, unfused = len(calls), resnet.conv_norm.unfused
            outs.append(resnet.conv_norm(conv, bn, x, identity=identity))
            assert len(calls) == before + fused
            assert resnet.conv_norm.unfused == unfused + (not fused)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bottleneck_gradients_unchanged(dtype):
    """The gradients of a proj bottleneck's input and parameters equal those
    of its modules' own ops, bit for bit."""
    blk = _block("frozen", 16, 8, 2, dtype, seed=3)
    x0 = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(4)).to(dtype)
    grads = []
    for fn in (blk, lambda t: _unfused_block(blk, t)):
        blk.zero_grad()
        x = x0.clone().requires_grad_(True)
        (fn(x).float() ** 2).sum().backward()
        grads.append([x.grad] + [p.grad for p in blk.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("norm,sites", [("frozen", 100), ("group", 0)])
def test_resnet101_counts_every_frozen_bn_site(norm, sites):
    """A ResNet-101 forward has 100 K6 sites (the stem and 33 bottlenecks x
    3); on the CPU each FrozenBN site runs unfused, none launches."""
    torch.manual_seed(0)
    net = resnet.ResNetBackbone(101, width_mult=0.125, norm=norm).to(BF16)
    launches, unfused = affine_act.launches, resnet.conv_norm.unfused
    with torch.inference_mode():
        out = net(torch.randn(1, 64, 64, 3).to(BF16))
    assert [o.shape[1] for o in out] == list(net.out_channels)
    assert affine_act.launches == launches
    assert resnet.conv_norm.unfused == unfused + sites


def _kernel_names():
    with open(os.path.join(ROOT, "tdrn_tpu_torch", "csrc", "affine_act.cu")) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    params = re.findall(r"__global__[^(]*\([^)]*\)\s+\w+\(([^)]*)\)", src)
    return names, params


def test_kernel_name_counts_as_elementwise():
    """The device trace files K6 under the passes it replaces (``other``,
    the model's elementwise time): its name and argument types hold none of
    perfbench.trace.CONV_WORDS and no perfbench.roofline.KERNELS key."""
    names, params = _kernel_names()
    assert names == ["affine_act_kernel"] and len(params) == 1
    types_ = [re.sub(r"\s*\b\w+$", "", p.replace("__restrict__", "").strip())
              for p in params[0].split(",")]
    for shortcut in range(3):
        demangled = (f"void (anonymous namespace)::{names[0]}<true, {shortcut}>"
                     f"({', '.join(types_)})")
        assert kind(demangled) == "other", demangled
        assert not any(w in demangled.lower() for w in CONV_WORDS)
        assert not any(k in demangled for k in KERNELS)
