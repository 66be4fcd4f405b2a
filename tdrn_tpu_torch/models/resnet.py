"""ResNet backbone (the port of ``tdrn_tpu/models/resnet.py``), NCHW.

ResNet-v1 bottleneck stacks emitting the detector's four scales:

    C3 (size/8, 4*w(128) ch), C4 (size/16, 4*w(256)), C5 (size/32, 4*w(512)),
    extra (size/64, w(512))  -- a RefineDet-style 1x1 + 3x3/2 extra stage.

The stem is a 7x7/2 conv (padding 3) and a 3x3/2 max-pool (padding 1).
Every stage's first block carries a ``proj`` shortcut: a strided 1x1 conv
with a bias, then its own norm.

``norm`` selects the normalization after each conv:
  * ``"frozen"``: a per-channel affine, ``(x * scale + bias)`` in the compute
    dtype (two roundings under bf16, as the JAX package's FrozenBN does).
    Pretrained torchvision BN statistics fold into it exactly (weights.py).
  * ``"group"``: GroupNorm over gcd(32, C) groups with epsilon 1e-6, its
    statistics (mean and E[x^2] - mean^2) and the affine in fp32 whatever the
    compute dtype, the result cast back once: flax's ``nn.GroupNorm``.
Under an H-split forward (parallel/spatial.py) a GroupNorm's statistics
cover the whole frame, not the rows a rank holds: within
:func:`group_norm_statistics` they come from the function it installs.
The leaves of both norms are named ``scale`` and ``bias``, as the JAX
param tree names them, so the key rules of weights.py apply unchanged.

The int8 serving profile (utils/quantize.py) turns the stem, every
bottleneck's conv1/conv2/conv3/proj and extra1/extra2 into QConvs
(models/layers.py); the norms stay separate passes in the compute dtype, so
a QConv's output is rounded once by its own cast and again by the norm, as
in the JAX package.

On the card, the stem's and each bottleneck's conv, bias, FrozenBN, shortcut
and ReLU ops after a conv run as one K6 pass (ops/affine_act.py), bit-equal
to them, where :func:`_fuses` finds its conditions; elsewhere (the CPU,
gradients, GroupNorm, fp32, hooked modules) the modules' own ops run.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch.models.layers import QConv, Segment, conv1x1, conv3x3, to_compute_dtype
from tdrn_tpu_torch.ops.affine_act import Proj, affine_act

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
NORMS = ("frozen", "group")
GROUP_NORM_EPS = 1e-6
# The stem's 7x7/2 conv and 3x3/2 max-pool: pooled row q reads input rows
# 4q - 5 to 4q + 5.
STEM_RADIUS, STEM_STRIDE = 5, 4

# (grouped input) -> (E[x], E[x^2]) over each group, installed by
# group_norm_statistics; None: the input's own statistics.
_group_statistics: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def group_norm_statistics(fn):
    """Within the block, every GroupNorm takes its mean and mean square from
    ``fn(g)``, g the fp32 input grouped as (B, groups, C/groups, H, W), each
    returned as (B, groups, 1, 1, 1)."""
    global _group_statistics
    prev, _group_statistics = _group_statistics, fn
    try:
        yield
    finally:
        _group_statistics = prev


def resnet_conv_chain(depth: int) -> List[str]:
    """The backbone's conv keys in dataflow order ("/"-joined, relative to the
    backbone); every stage-0 block has a ``proj`` shortcut conv."""
    keys = ["stem"]
    for si, n in enumerate(DEPTHS[depth], start=1):
        for bi in range(n):
            blk = f"stage{si}_{bi}"
            keys += [f"{blk}/conv1", f"{blk}/conv2", f"{blk}/conv3"]
            if bi == 0:
                keys.append(f"{blk}/proj")
    return keys + ["extra1", "extra2"]


class FrozenBN(nn.Module):
    """Per-channel affine (frozen batch-norm): y = x * scale + bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Two ops, so that bf16 rounds after the multiply and after the add.
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=gcd(32, C))`` in NCHW: fp32 statistics
    and affine, epsilon 1e-6, the result in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.groups = math.gcd(32, channels)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        grouped = (1, self.groups, c // self.groups, 1, 1)
        g = x.float().reshape(b, self.groups, c // self.groups, h, w)
        if _group_statistics is None:
            mean = g.mean(dim=(2, 3, 4), keepdim=True)
            var = ((g * g).mean(dim=(2, 3, 4), keepdim=True) - mean * mean).clamp_min(0.0)
        else:
            mean, mean_sq = _group_statistics(g)
            var = (mean_sq - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + GROUP_NORM_EPS) * self.scale.float().reshape(grouped)
        y = (g - mean) * mul + self.bias.float().reshape(grouped)
        return y.reshape(b, c, h, w).to(x.dtype)


def make_norm(norm: str, channels: int) -> nn.Module:
    if norm == "frozen":
        return FrozenBN(channels)
    if norm == "group":
        return GroupNorm(channels)
    raise ValueError(f"unknown resnet norm {norm!r} (one of {NORMS})")


def _hooked(m: nn.Module) -> bool:
    return bool(m._forward_hooks or m._forward_pre_hooks)


def _channels_last(t: torch.Tensor) -> bool:
    """channels_last-contiguous and 16-byte aligned: a map as K6 reads it."""
    return t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0


def _fuses(conv: nn.Module, norm: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``norm(conv(x))`` and what follows it go to K6: on the card,
    without gradients, a FrozenBN with bf16 leaves after a bf16 conv (a plain
    ``nn.Conv2d``, whose bias K6 adds, or a QConv, which adds its own) of a
    multiple of 8 channels, neither module hooked (a hook would miss its
    call), on a channels_last, 16-byte aligned ``x``. The conv's output is
    then channels_last too (cuDNN keeps its input's layout; a QConv writes
    NHWC), so K6 takes it: K6 raises on a map it cannot take."""
    bf16 = torch.bfloat16
    if not (x.is_cuda and not torch.is_grad_enabled() and isinstance(norm, FrozenBN)
            and norm.scale.dtype == bf16 and norm.bias.dtype == bf16
            and not _hooked(conv) and not _hooked(norm) and _channels_last(x)):
        return False
    if isinstance(conv, QConv):
        return conv.dtype == bf16 and conv.out_channels % 8 == 0
    return (type(conv) is nn.Conv2d and conv.weight.dtype == bf16 and x.dtype == bf16
            and (conv.bias is None or conv.bias.dtype == bf16) and conv.out_channels % 8 == 0)


def _conv_out(conv: nn.Module, x: torch.Tensor):
    """(conv's output without its bias, the bias): a QConv adds its own."""
    if isinstance(conv, QConv):
        return conv(x), None
    return conv._conv_forward(x, conv.weight, None), conv.bias


def conv_norm(conv: nn.Module, norm: nn.Module, x: torch.Tensor,
              identity: Optional[torch.Tensor] = None, proj=None) -> torch.Tensor:
    """``relu(norm(conv(x)) + shortcut)``: the shortcut ``identity``, or
    ``proj_norm(proj_conv(proj_x))`` for ``proj = (proj_conv, proj_norm,
    proj_x)``, or none. One K6 pass after the conv(s) where :func:`_fuses`
    holds for every conv and norm and ``identity`` is a bf16 map as K6 reads
    it; otherwise the modules' own ops, counted in ``conv_norm.unfused``
    where the norm is a FrozenBN."""
    if (_fuses(conv, norm, x) and (proj is None or _fuses(*proj))
            and (identity is None
                 or (identity.dtype == torch.bfloat16 and _channels_last(identity)))):
        c, conv_bias = _conv_out(conv, x)
        shortcut = identity
        if proj is not None:
            pconv, pnorm, px = proj
            shortcut = Proj(*_conv_out(pconv, px), pnorm.scale, pnorm.bias)
        return affine_act(c, conv_bias, norm.scale, norm.bias, shortcut)
    if isinstance(norm, FrozenBN):
        conv_norm.unfused += 1
    y = norm(conv(x))
    if proj is not None:
        y = y + proj[1](proj[0](proj[2]))
    elif identity is not None:
        y = y + identity
    return F.relu(y)


conv_norm.unfused = 0


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (4x width) with a residual; the shortcut
    is ``proj`` + ``proj_bn`` where the width or the stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1, norm: str = "frozen"):
        super().__init__()
        out = 4 * features
        self.conv1 = conv1x1(cin, features)
        self.bn1 = make_norm(norm, features)
        self.conv2 = conv3x3(features, features, stride=stride)
        self.bn2 = make_norm(norm, features)
        self.conv3 = conv1x1(features, out)
        self.bn3 = make_norm(norm, out)
        if cin != out or stride != 1:
            self.proj = nn.Conv2d(cin, out, 1, stride=stride)
            self.proj_bn = make_norm(norm, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_norm(self.conv1, self.bn1, x)
        y = conv_norm(self.conv2, self.bn2, y)
        if hasattr(self, "proj"):
            return conv_norm(self.conv3, self.bn3, y, proj=(self.proj, self.proj_bn, x))
        return conv_norm(self.conv3, self.bn3, y, identity=x)


class ResNetBackbone(nn.Module):
    """ResNet-50/101/152 emitting the four detection scales (NHWC in, NCHW out)."""

    def __init__(self, depth: int = 101, in_channels: int = 3, width_mult: float = 1.0,
                 norm: str = "frozen"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown resnet norm {norm!r} (one of {NORMS})")
        self.depth = depth
        w = lambda c: max(8, int(c * width_mult))
        self.stem = nn.Conv2d(in_channels, w(64), 7, stride=2, padding=3)
        self.stem_bn = make_norm(norm, w(64))
        cin = w(64)
        for si, (n, f) in enumerate(zip(DEPTHS[depth], (w(64), w(128), w(256), w(512)))):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                setattr(self, f"stage{si + 1}_{bi}", Bottleneck(cin, f, stride, norm))
                cin = 4 * f
        self.extra1 = conv1x1(cin, w(256))
        self.extra2 = conv3x3(w(256), w(512), stride=2)
        self.out_channels = (4 * w(128), 4 * w(256), 4 * w(512), w(512))

    def forward(self, x_nhwc: torch.Tensor) -> List[torch.Tensor]:
        sources, x = [], x_nhwc
        for seg in self.segments():
            x = seg.fn(x)
            if seg.source:
                sources.append(x)
        return sources

    def segments(self) -> List[Segment]:
        """The forward as a chain: the stem (NHWC in, NCHW out), each
        bottleneck (the last of stages 2-4 give C3, C4 and C5; C3 is the
        first source) and the extra stage."""
        segs = [Segment(self._stem_map, STEM_RADIUS, STEM_STRIDE)]
        for si, n in enumerate(DEPTHS[self.depth]):
            for bi in range(n):
                block = getattr(self, f"stage{si + 1}_{bi}")
                stride = 2 if (bi == 0 and si > 0) else 1
                segs.append(Segment(block, 1, stride, si >= 1 and bi == n - 1))
        segs.append(Segment(self._extra, 1, 2, True))
        return segs

    def _stem_map(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = to_compute_dtype(x_nhwc, self.stem).permute(0, 3, 1, 2)
        return F.max_pool2d(conv_norm(self.stem, self.stem_bn, x), 3, 2, padding=1)

    def _extra(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.extra2(F.relu(self.extra1(x))))
