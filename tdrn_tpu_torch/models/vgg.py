"""VGG-16 (reduced-fc) backbone (the port of ``tdrn_tpu/models/vgg.py``), NCHW.

The VGG-16 conv stack with fc6/fc7 replaced by the dilated conv6 (dilation 3)
and 1x1 conv7, plus conv6_1/conv6_2, emitting the four ARM source maps:
conv4_3 (size/8), conv5_3 (size/16), conv7 (size/32, after the stride-2
pool5) and conv6_2 (size/64).

``stem="fused"`` runs stage 1 (conv1_1 + relu + conv1_2 + relu + pool1) as
the K3 wrapper (ops/stem.py) on the same ``conv1_1``/``conv1_2`` parameters,
so a ``stem="conv"`` checkpoint serves it unchanged. ``stem="fused2"`` also
runs stage 2 (conv2_1, conv2_2, pool2) as the K4 wrapper on K3's NHWC output.
The convolutions compute in the dtype of the backbone's parameters.
``in_channels`` is 3, 4 under the fold-mean transform (rgb + ones) and the
padded count under pad-stem (utils/precision.py); both are conv-stem only.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch.models.layers import conv1x1, conv3x3
from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1

# (num_convs, channels) per VGG stage.
_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
STEMS = ("conv", "fused", "fused2")


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0).contiguous()


class VGG16Reduced(nn.Module):
    """VGG-16 with reduced-fc surgery; returns the 4 ARM source feature maps.

    ``width_mult`` scales every channel count as ``max(8, int(c * width_mult))``.
    """

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0, stem: str = "conv"):
        super().__init__()
        if stem not in STEMS:
            raise NotImplementedError(f"stem={stem!r} is not ported yet (ported: {STEMS})")
        self.stem = stem
        w = lambda c: max(8, int(c * width_mult))
        cin = in_channels
        for si, (n, ch) in enumerate(_STAGES):
            for ci in range(n):
                setattr(self, f"conv{si + 1}_{ci + 1}", conv3x3(cin, w(ch)))
                cin = w(ch)
        self.conv6 = conv3x3(cin, w(1024), dilation=3)
        self.conv7 = conv1x1(w(1024), w(1024))
        self.conv6_1 = conv1x1(w(1024), w(256))
        self.conv6_2 = conv3x3(w(256), w(512), stride=2)

    def forward(self, x_nhwc: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, in_channels) preprocessed frames, NHWC; returns NCHW maps."""
        dtype = self.conv1_1.weight.dtype
        x_nhwc = x_nhwc.to(dtype)
        start_stage = 0
        if self.stem in ("fused", "fused2"):
            x_nhwc = fused_stem_stage1(
                x_nhwc, _hwio(self.conv1_1), self.conv1_1.bias,
                _hwio(self.conv1_2), self.conv1_2.bias, out_dtype=dtype,
            )
            start_stage = 1
        if self.stem == "fused2":
            x_nhwc = fused_conv_stage(
                x_nhwc, _hwio(self.conv2_1), self.conv2_1.bias,
                _hwio(self.conv2_2), self.conv2_2.bias, out_dtype=dtype,
            )
            start_stage = 2
        x = x_nhwc.permute(0, 3, 1, 2)  # NCHW view; a kernel's result is channels_last
        sources = []
        for si, (n, _) in enumerate(_STAGES):
            if si < start_stage:
                continue
            for ci in range(n):
                x = F.relu(getattr(self, f"conv{si + 1}_{ci + 1}")(x))
            if si in (3, 4):  # conv4_3 / conv5_3 outputs (pre-pool)
                sources.append(x)
            if si < 4:
                x = F.max_pool2d(x, 2, 2)
        x = F.max_pool2d(x, 2, 2)  # pool5, stride 2
        x = F.relu(self.conv6(x))
        x = F.relu(self.conv7(x))
        sources.append(x)
        x = F.relu(self.conv6_1(x))
        x = F.relu(self.conv6_2(x))
        sources.append(x)
        return sources
