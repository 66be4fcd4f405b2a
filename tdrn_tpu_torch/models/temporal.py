"""Temporal feature propagation (the port of ``tdrn_tpu/models/temporal.py``), NCHW.

Each pyramid scale owns a gated cell over its ODM features. ``convgru`` is
the full convolutional GRU:

    z, r = split(sigmoid(conv3x3([x, h])))   (z is the first half)
    h~ = tanh(conv3x3([x, r*h]));  h' = (1-z)*h + z*h~

``light`` is the bandwidth-lean cell: a 1x1 gate, a depthwise 3x3 over
[x, h] and a 1x1 candidate,

    z = sigmoid(conv1x1([x, h]));  h~ = tanh(conv1x1(dw3x3([x, h])))
    h' = (1-z)*h + z*h~

and ``hybrid`` runs the light cell on scale 0 (the largest map) and the full
cell on the others. The carried state is one (B, C, H_k, W_k) tensor per
scale, zero at a stream start.

Both cells start near the identity on their input (the pass-through init of
the JAX package): the update gate's bias is 2.0, so z = sigmoid(2) ~ 0.88,
and the candidate conv is a center-tap identity on the x half of its input
plus 0.1 x xavier noise, so an untrained cell gives h' ~ tanh(x) at frame 0.
The draw comes from an explicit ``torch.Generator``.

Under ``quant_gru`` (utils/quantize.py) the ConvGRU's ``gates`` and ``cand``
and the light cell's ``gate`` and ``cand`` are int8 QConvs; the depthwise
``dw`` stays in the compute dtype. The int8 calibration reads their inputs
(``xh``, ``xrh``) by forward pre-hooks and the ``dw`` output by a hook.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tdrn_tpu_torch.models.layers import conv1x1, conv3x3

State = List[torch.Tensor]
CELLS = ("convgru", "light", "hybrid")

PASSTHROUGH_Z_BIAS = 2.0
PASSTHROUGH_NOISE = 0.1


def _xavier(conv: nn.Conv2d, generator: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    with torch.no_grad():
        nn.init.xavier_uniform_(conv.weight, generator=generator)
        conv.weight.mul_(scale)
        conv.bias.zero_()
    return conv.weight


def cell_kind(cell: str, scale: int) -> str:
    """Which cell ("convgru" or "light") runs at a pyramid scale."""
    if cell == "hybrid":
        return "light" if scale == 0 else "convgru"
    return cell


class ConvGRUCell(nn.Module):
    """Single-scale convolutional GRU."""

    def __init__(self, channels: int = 256, passthrough_init: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = channels
        self.gates = conv3x3(2 * channels, 2 * channels)
        self.cand = conv3x3(2 * channels, channels)
        self.reset_parameters(passthrough_init, generator)

    def reset_parameters(self, passthrough: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        """xavier kernels and zero biases; with ``passthrough``, the z half of
        the gate bias at 2.0 and the candidate kernel at 0.1 x xavier plus a
        center-tap identity on x."""
        c = self.channels
        _xavier(self.gates, generator)
        w = _xavier(self.cand, generator, PASSTHROUGH_NOISE if passthrough else 1.0)
        if passthrough:
            with torch.no_grad():
                self.gates.bias[:c] = PASSTHROUGH_Z_BIAS
                w[:, :c, 1, 1] += torch.eye(c, dtype=w.dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        c = self.channels
        gates = torch.sigmoid(self.gates(torch.cat([x, h], dim=1)))
        z, r = gates[:, :c], gates[:, c:]
        cand = torch.tanh(self.cand(torch.cat([x, r * h], dim=1)))
        return (1.0 - z) * h + z * cand


class LightGRUCell(nn.Module):
    """Bandwidth-lean gated carry: 1x1 gate, depthwise 3x3 and 1x1 candidate."""

    def __init__(self, channels: int = 256, passthrough_init: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = channels
        self.gate = conv1x1(2 * channels, channels)
        self.dw = nn.Conv2d(2 * channels, 2 * channels, 3, padding=1, groups=2 * channels)
        self.cand = conv1x1(2 * channels, channels)
        self.reset_parameters(passthrough_init, generator)

    def reset_parameters(self, passthrough: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        """xavier kernels and zero biases; with ``passthrough``, the gate bias
        at 2.0, the depthwise kernel at 0.1 x xavier plus 1 on each channel's
        center tap, the candidate kernel at 0.1 x xavier plus an identity on x."""
        c = self.channels
        noise = PASSTHROUGH_NOISE if passthrough else 1.0
        _xavier(self.gate, generator)
        dw = _xavier(self.dw, generator, noise)
        cand = _xavier(self.cand, generator, noise)
        if passthrough:
            with torch.no_grad():
                self.gate.bias.fill_(PASSTHROUGH_Z_BIAS)
                dw[:, 0, 1, 1] += 1.0
                cand[:, :c, 0, 0] += torch.eye(c, dtype=cand.dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xh = torch.cat([x, h], dim=1)
        z = torch.sigmoid(self.gate(xh))
        cand = torch.tanh(self.cand(self.dw(xh)))
        return (1.0 - z) * h + z * cand


class TemporalPropagation(nn.Module):
    """Per-scale gated carry over the ODM feature pyramid."""

    def __init__(self, num_scales: int = 4, channels: int = 256, cell: str = "convgru",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cell not in CELLS:
            raise ValueError(f"unknown temporal cell {cell!r} (one of {CELLS})")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for k in range(num_scales):
            cls = LightGRUCell if cell_kind(cell, k) == "light" else ConvGRUCell
            setattr(self, f"gru{k}", cls(channels, generator=generator))

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
