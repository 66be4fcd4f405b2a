"""VGG-16 (reduced-fc) backbone (the port of ``tdrn_tpu/models/vgg.py``), NCHW.

The VGG-16 conv stack with fc6/fc7 replaced by the dilated conv6 (dilation 3)
and 1x1 conv7, plus conv6_1/conv6_2, emitting the four ARM source maps:
conv4_3 (size/8), conv5_3 (size/16), conv7 (size/32, after the stride-2
pool5) and conv6_2 (size/64).

Stage 1 (conv1_1 + relu + conv1_2 + relu + pool1) has six forms:

  conv    plain convolutions.
  s2d     space-to-depth: the input is folded 2x2 into 4x the channels, in
          (py, px, c) order, and stage 1 runs at half resolution with no
          pool1. conv1_1 takes 4x the input channels, so s2d has a param
          tree of its own (not weight-compatible with conv).
  poly    W-polyphase: the W axis is split into its two stride-2 phases
          (x[b, h, 2j+px, c] read as xs[b, h, j, px*C + c], a free reshape
          in NHWC), and each 3x3 conv becomes, per output phase, a (3, 2)
          conv over the 2C phase channels whose kernel is a fixed
          rearrangement of the original, with W padding (1, 0) for phase 0
          and (0, 1) for phase 1. Exact, and the same parameters as conv.
  poly2   W-polyphase with both output phases from one symmetric (3, 3)
          conv over phase space (18 of 36 taps nonzero). Same parameters.
  fused   the K3 wrapper (ops/stem.py) on the same conv1_1/conv1_2
          parameters, so a conv checkpoint serves it unchanged.
  fused2  K3, then stage 2 (conv2_1, conv2_2, pool2) as the K4 wrapper on
          K3's NHWC output.

The convolutions compute in the dtype of the backbone's parameters. The
int8 serving profile (utils/quantize.py) turns every conv of the chain into
a QConv (models/layers.py); it takes the conv and s2d stems only, since the
other stems rearrange or fuse conv1_1's float kernel.
``in_channels`` is the model's input channel count: 3, 4 under the
fold-mean transform (rgb + ones; conv and s2d stems) and the padded count
under pad-stem (conv stem only; utils/precision.py).
"""

from __future__ import annotations

import functools
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch.models.layers import QConv, Segment, conv1x1, conv3x3, to_compute_dtype
from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1

# (num_convs, channels) per VGG stage.
_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
STEMS = ("conv", "s2d", "poly", "poly2", "fused", "fused2")
QUANT_STEMS = ("conv", "s2d")  # the stems an int8 (QConv) backbone takes
# By stem: (the first stage left to run after it, its radius and stride in
# input rows). K3 reads 2 rows either side; K3 then K4 reads 2 + 2 * 2.
_STEM_SEGMENT = {"conv": (0, 0, 1), "s2d": (0, 0, 2), "poly": (1, 2, 2), "poly2": (1, 2, 2),
                 "fused": (1, 2, 2), "fused2": (2, 6, 4)}


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0).contiguous()


def _oihw(k: torch.Tensor) -> torch.Tensor:
    return k.permute(3, 2, 0, 1).contiguous()


def space_to_depth(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channels in (py, px, c) order."""
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def wpoly_kernels(k: torch.Tensor):
    """(3, 3, C, N) HWIO kernel of a SAME 3x3 conv -> the two (3, 2, 2C, N)
    kernels of its W-polyphase form (output phase 0, output phase 1)."""
    z = torch.zeros_like(k[:, 0])  # (3, C, N)
    k_p0 = torch.stack([torch.cat([z, k[:, 0]], 1),  # xs col j-1: px1 = k0
                        torch.cat([k[:, 1], k[:, 2]], 1)], 1)  # xs col j
    k_p1 = torch.stack([torch.cat([k[:, 0], k[:, 1]], 1),  # xs col j
                        torch.cat([k[:, 2], z], 1)], 1)  # xs col j+1: px0 = k2
    return k_p0, k_p1


def wpoly2_kernel(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, N) HWIO -> the (3, 3, 2C, 2N) kernel that gives both output
    phases (px-major output channels) from one conv over phase space."""
    z = torch.zeros_like(k[:, 0])  # (3, C, N)
    # Rows: the (px0, px1) input blocks; columns: the (phase 0, phase 1) outputs.
    col0 = torch.cat([torch.cat([z, z], 2), torch.cat([k[:, 0], z], 2)], 1)
    col1 = torch.cat([torch.cat([k[:, 1], k[:, 0]], 2), torch.cat([k[:, 2], k[:, 1]], 2)], 1)
    col2 = torch.cat([torch.cat([z, k[:, 2]], 2), torch.cat([z, z], 2)], 1)
    return torch.stack([col0, col1, col2], 1)


def _wpoly_conv(xp: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Phase-space SAME 3x3 conv, NCHW: (B, 2C, H, W/2) -> (B, 2N, H, W/2)."""
    k_p0, k_p1 = wpoly_kernels(_hwio(conv))
    y0 = F.conv2d(F.pad(xp, (1, 0, 1, 1)), _oihw(k_p0), conv.bias)
    y1 = F.conv2d(F.pad(xp, (0, 1, 1, 1)), _oihw(k_p1), conv.bias)
    return torch.cat([y0, y1], dim=1)  # px-major, the phase-space channel order


def _wpoly2_conv(xp: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    bias = torch.cat([conv.bias, conv.bias])
    return F.conv2d(xp, _oihw(wpoly2_kernel(_hwio(conv))), bias, padding=1)


def wpoly_stage1(x_nhwc: torch.Tensor, conv1_1: nn.Conv2d, conv1_2: nn.Conv2d,
                 two_phase_conv: bool = False) -> torch.Tensor:
    """conv1_1 + relu + conv1_2 + relu + pool1 in W-phase space:
    (B, H, W, C) NHWC -> (B, N, H/2, W/2) NCHW."""
    conv = _wpoly2_conv if two_phase_conv else _wpoly_conv
    b, h, w, c = x_nhwc.shape
    xp = x_nhwc.reshape(b, h, w // 2, 2 * c).permute(0, 3, 1, 2)  # free in NHWC
    yp = F.relu(conv(F.relu(conv(xp, conv1_1)), conv1_2))
    n = yp.shape[1] // 2
    y = yp.unflatten(1, (2, n)).amax(dim=1)  # pool over the phase pair
    return y.unflatten(2, (h // 2, 2)).amax(dim=3)  # and over row pairs


class VGG16Reduced(nn.Module):
    """VGG-16 with reduced-fc surgery; returns the 4 ARM source feature maps.

    ``width_mult`` scales every channel count as ``max(8, int(c * width_mult))``.
    """

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0, stem: str = "conv"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r} (one of {STEMS})")
        self.stem = stem
        w = lambda c: max(8, int(c * width_mult))
        cin = 4 * in_channels if stem == "s2d" else in_channels
        for si, (n, ch) in enumerate(_STAGES):
            for ci in range(n):
                setattr(self, f"conv{si + 1}_{ci + 1}", conv3x3(cin, w(ch)))
                cin = w(ch)
        self.conv6 = conv3x3(cin, w(1024), dilation=3)
        self.conv7 = conv1x1(w(1024), w(1024))
        self.conv6_1 = conv1x1(w(1024), w(256))
        self.conv6_2 = conv3x3(w(256), w(512), stride=2)
        self.out_channels = (w(512), w(512), w(1024), w(512))

    def forward(self, x_nhwc: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, in_channels) preprocessed frames, NHWC; returns NCHW maps."""
        if self.quant and self.stem not in QUANT_STEMS:
            raise ValueError(f"an int8 vgg16 backbone takes the {QUANT_STEMS} stems only")
        sources, x = [], x_nhwc
        for seg in self.segments():
            x = seg.fn(x)
            if seg.source:
                sources.append(x)
        return sources

    def segments(self) -> List[Segment]:
        """The forward as a chain: the stem (NHWC in, NCHW out), the stages
        it leaves (conv4_3, pre-pool, is the first source), then pool4 and
        stage 5 (conv5_3), pool5 + conv6 + conv7 and conv6_1 + conv6_2."""
        start, radius, stride = _STEM_SEGMENT[self.stem]
        segs = [Segment(self._stem_map, radius, stride)]
        for si in range(start, 4):
            pool = si < 3 and not (si == 0 and self.stem == "s2d")  # s2d: no pool1
            segs.append(Segment(functools.partial(self._stage, si, pool), _STAGES[si][0],
                                2 if pool else 1, si == 3))
        segs.append(Segment(self._stage5, 2 * 3, 2, True))
        segs.append(Segment(self._fc, 2 * 3, 2, True))  # conv6's dilation of 3
        segs.append(Segment(self._extra, 1, 2, True))
        return segs

    def _stem_map(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self._stem(to_compute_dtype(x_nhwc, self.conv1_1))[0]

    def _stage(self, si: int, pool: bool, x: torch.Tensor) -> torch.Tensor:
        for ci in range(_STAGES[si][0]):
            x = F.relu(getattr(self, f"conv{si + 1}_{ci + 1}")(x))
        return F.max_pool2d(x, 2, 2) if pool else x

    def _stage5(self, x: torch.Tensor) -> torch.Tensor:
        return self._stage(4, False, F.max_pool2d(x, 2, 2))  # pool4, then conv5_x

    def _fc(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(x, 2, 2)  # pool5, stride 2
        x = F.relu(self.conv6(x))
        return F.relu(self.conv7(x))

    def _extra(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv6_1(x))
        return F.relu(self.conv6_2(x))

    @property
    def quant(self) -> bool:
        """Whether the convs are int8 QConvs (utils/quantize.py)."""
        return isinstance(self.conv1_1, QConv)

    def _stem(self, x_nhwc: torch.Tensor):
        """The stages the stem runs itself: (NCHW map, first stage left to run).
        A kernel's NHWC result is read as an NCHW (channels_last) view."""
        if self.stem == "s2d":
            return space_to_depth(x_nhwc).permute(0, 3, 1, 2), 0
        if self.stem in ("poly", "poly2"):
            return wpoly_stage1(x_nhwc, self.conv1_1, self.conv1_2, self.stem == "poly2"), 1
        if self.stem not in ("fused", "fused2"):
            return x_nhwc.permute(0, 3, 1, 2), 0
        dtype = x_nhwc.dtype
        x_nhwc = fused_stem_stage1(
            x_nhwc, _hwio(self.conv1_1), self.conv1_1.bias,
            _hwio(self.conv1_2), self.conv1_2.bias, out_dtype=dtype,
        )
        if self.stem == "fused":
            return x_nhwc.permute(0, 3, 1, 2), 1
        x_nhwc = fused_conv_stage(
            x_nhwc, _hwio(self.conv2_1), self.conv2_1.bias,
            _hwio(self.conv2_2), self.conv2_2.bias, out_dtype=dtype,
        )
        return x_nhwc.permute(0, 3, 1, 2), 2
