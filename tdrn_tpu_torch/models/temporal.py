"""Temporal feature propagation (the port of ``tdrn_tpu/models/temporal.py``), NCHW.

Each pyramid scale owns a convolutional GRU over its ODM features:

    z, r = split(sigmoid(conv([x, h])))   (z is the first half)
    h~ = tanh(conv([x, r*h]));  h' = (1-z)*h + z*h~

The carried state is one (B, C, H_k, W_k) tensor per scale, zero at a stream
start.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tdrn_tpu_torch.models.layers import conv3x3

State = List[torch.Tensor]
CELLS = ("convgru",)


class ConvGRUCell(nn.Module):
    """Single-scale convolutional GRU."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.channels = channels
        self.gates = conv3x3(2 * channels, 2 * channels)
        self.cand = conv3x3(2 * channels, channels)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        c = self.channels
        gates = torch.sigmoid(self.gates(torch.cat([x, h], dim=1)))
        z, r = gates[:, :c], gates[:, c:]
        cand = torch.tanh(self.cand(torch.cat([x, r * h], dim=1)))
        return (1.0 - z) * h + z * cand


class TemporalPropagation(nn.Module):
    """Per-scale gated carry over the ODM feature pyramid."""

    def __init__(self, num_scales: int = 4, channels: int = 256, cell: str = "convgru"):
        super().__init__()
        if cell not in CELLS:
            raise NotImplementedError(f"temporal cell {cell!r} is not ported yet")
        for k in range(num_scales):
            setattr(self, f"gru{k}", ConvGRUCell(channels))

    def forward(
        self, feats: List[torch.Tensor], state: Optional[State]
    ) -> Tuple[List[torch.Tensor], State]:
        outs = []
        for k, x in enumerate(feats):
            h = state[k] if state is not None else torch.zeros_like(x)
            outs.append(getattr(self, f"gru{k}")(x, h))
        return outs, list(outs)


def init_state(
    batch: int, feature_maps: Sequence[int], channels: int = 256,
    dtype: torch.dtype = torch.float32, device=None,
) -> State:
    """Zero temporal state for a clip/stream start, (B, C, f, f) per scale."""
    return [
        torch.zeros((batch, channels, f, f), dtype=dtype, device=device)
        for f in feature_maps
    ]
