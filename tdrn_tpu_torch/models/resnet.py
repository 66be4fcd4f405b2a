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
The leaves of both norms are named ``scale`` and ``bias``, as the JAX
param tree names them, so the key rules of weights.py apply unchanged.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch.models.layers import conv1x1, conv3x3

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
NORMS = ("frozen", "group")
GROUP_NORM_EPS = 1e-6


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
        mean = g.mean(dim=(2, 3, 4), keepdim=True)
        var = ((g * g).mean(dim=(2, 3, 4), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + GROUP_NORM_EPS) * self.scale.float().reshape(grouped)
        y = (g - mean) * mul + self.bias.float().reshape(grouped)
        return y.reshape(b, c, h, w).to(x.dtype)


def make_norm(norm: str, channels: int) -> nn.Module:
    if norm == "frozen":
        return FrozenBN(channels)
    if norm == "group":
        return GroupNorm(channels)
    raise ValueError(f"unknown resnet norm {norm!r} (one of {NORMS})")


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
        shortcut = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + shortcut)


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
        x = x_nhwc.to(self.stem.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        sources = []
        for si, n in enumerate(DEPTHS[self.depth]):
            for bi in range(n):
                x = getattr(self, f"stage{si + 1}_{bi}")(x)
            if si >= 1:  # C3, C4, C5
                sources.append(x)
        y = F.relu(self.extra1(x))
        sources.append(F.relu(self.extra2(y)))
        return sources
