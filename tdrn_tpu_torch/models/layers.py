"""Shared model layers (the port of ``tdrn_tpu/models/layers.py``), NCHW.

L2Norm: channel-wise L2 normalization with a learned per-channel scale,
computed in fp32, applied to the conv4_3 / conv5_3 feature maps.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class L2Norm(nn.Module):
    """Channelwise L2-normalize + learned scale (init ``scale_init``), NCHW."""

    def __init__(self, channels: int, scale_init: float = 10.0, eps: float = 1e-10):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = torch.sqrt((x32 * x32).sum(dim=1, keepdim=True) + self.eps)
        return (x32 / norm * self.scale[None, :, None, None]).to(x.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """3x3 conv with SAME padding (``padding = dilation``)."""
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation, dilation=dilation)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)
