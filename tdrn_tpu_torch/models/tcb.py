"""Transfer Connection Blocks (the port of ``tdrn_tpu/models/tcb.py``), NCHW.

Each ARM source map is projected to ``channels``, fused before its ReLU with
the 2x transposed-conv upsampling of the deeper TCB output, and refined:
t3 = TCB(s3), t2 = TCB(s2, up(t3)), ..., t0 = TCB(s0, up(t1)).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch.models.layers import conv3x3


class TCB(nn.Module):
    """One transfer-connection block. The deepest block gets no deeper input
    and so has no deconv (as in the JAX module, where it is never created).
    conv3's input is the post-add ``fused`` tensor that the JAX module sows
    for the int8 calibration (utils/quantize.py reads it by a forward
    pre-hook on conv3); under ``quant_tcb`` conv1-3 are QConvs and the
    deconv stays in the compute dtype."""

    def __init__(self, cin: int, channels: int = 256, has_deconv: bool = True):
        super().__init__()
        self.conv1 = conv3x3(cin, channels)
        self.conv2 = conv3x3(channels, channels)
        self.conv3 = conv3x3(channels, channels)
        if has_deconv:
            self.deconv = nn.ConvTranspose2d(channels, channels, 2, stride=2)

    def forward(self, x: torch.Tensor, deeper: Optional[torch.Tensor] = None):
        x = F.relu(self.conv1(x))
        x = self.conv2(x)
        if deeper is not None:
            x = x + self.deconv(deeper)
        x = F.relu(x)
        return F.relu(self.conv3(x))


class TopDownPyramid(nn.Module):
    """Apply TCBs deepest-first, threading the upsampled deeper feature."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256):
        super().__init__()
        self.num_scales = len(in_channels)
        for k, c in enumerate(in_channels):
            setattr(self, f"tcb{k}", TCB(c, channels, has_deconv=k < self.num_scales - 1))

    def forward(self, sources: List[torch.Tensor]) -> List[torch.Tensor]:
        outs: List[torch.Tensor] = [None] * self.num_scales  # type: ignore[list-item]
        deeper = None
        for k in reversed(range(self.num_scales)):
            deeper = getattr(self, f"tcb{k}")(sources[k], deeper)
            outs[k] = deeper
        return outs
