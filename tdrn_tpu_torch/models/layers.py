"""Shared model layers (the port of ``tdrn_tpu/models/layers.py``), NCHW.

L2Norm: channel-wise L2 normalization with a learned per-channel scale,
computed in fp32, applied to the conv4_3 / conv5_3 feature maps.

QConv: the int8 conv of the int8 serving profile (utils/quantize.py), on the
K5 wrapper (ops/qconv.py).

Segment: one link of a backbone's forward chain with its receptive radius
and stride along H (parallel/spatial.py splits the chain along H).

FQConv: its train-time twin for quantization-aware fine-tuning
(utils/quantize.apply_qat): a plain conv whose input and kernel are snapped
to QConv's int8 grids, with straight-through gradients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn as nn

from tdrn_tpu_torch.ops.qconv import act_scale, dequant_factor, pack_weight, qconv


class Segment(NamedTuple):
    """One link of a backbone's forward, ``fn(x) -> y``. Output row ``o``
    reads input rows ``[o*stride - radius, (o+1)*stride + radius)`` (zero
    padding outside the image); ``source`` marks a source map of the
    detector. A backbone's ``forward`` is its ``segments()`` run in order."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    radius: int
    stride: int
    source: bool = False


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


def fake_quant_act(x: torch.Tensor, xscale: float) -> torch.Tensor:
    """Straight-through fake-quant of activations to QConv's int8 grid.

    Forward: dequantize(quantize(x)) with the static calibrated scale
    ``xscale`` (max|input|), in fp32, cast back to x's dtype; backward: the
    identity, through ``x + (q - x).detach()``."""
    x32 = x.float()
    q = torch.clamp(torch.round(x32 * (127.0 / xscale)), -127.0, 127.0) * (xscale / 127.0)
    return (x32 + (q - x32).detach()).to(x.dtype)


def fake_quant_kernel(w: torch.Tensor) -> torch.Tensor:
    """Straight-through fake-quant of an OIHW conv kernel, symmetric per output
    channel: step max|w| / 127 over each output channel's taps (axes 1-3,
    the JAX package's HWIO axes 0-2), in fp32, cast back to w's dtype. The
    step sits inside the detached part, so the backward is the identity."""
    w32 = w.float()
    ws = torch.clamp(w32.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / ws), -127.0, 127.0) * ws
    return (w32 + (q - w32).detach()).to(w.dtype)


class FQConv(nn.Conv2d):
    """Fake-quantized conv for QAT fine-tuning (the train-time twin of QConv).

    Its parameters are an ``nn.Conv2d``'s (``weight``, ``bias``), so a QAT
    checkpoint is a plain checkpoint that the int8 serving path quantizes
    with the same scales file. The forward snaps the input to the static
    ``xscale`` int8 grid and the kernel to the per-output-channel grid in
    fp32 elementwise math (straight-through gradients), then convolves in
    the kernel's dtype and adds the bias in it, as the JAX FQConv does.
    ``xscale`` is a Python float, not a parameter or buffer.
    """

    def __init__(self, *args, xscale: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.xscale = float(xscale)

    @classmethod
    def like(cls, conv: nn.Conv2d, xscale: float) -> "FQConv":
        """An FQConv of ``conv``'s geometry, dtype and device (SAME padding,
        square kernel) holding a copy of its weight and bias."""
        k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
        if conv.kernel_size != (k, k) or conv.padding != (d * (k - 1) // 2,) * 2 or conv.groups != 1:
            raise ValueError(f"FQConv takes square SAME convs, got {conv}")
        out = cls(conv.in_channels, conv.out_channels, k, stride=s, padding=conv.padding,
                  dilation=d, xscale=xscale)
        out = out.to(device=conv.weight.device, dtype=conv.weight.dtype)
        out.load_state_dict(conv.state_dict())
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.weight.dtype
        xq = fake_quant_act(x, self.xscale).to(dtype)
        y = self._conv_forward(xq, fake_quant_kernel(self.weight), None)
        return y + self.bias.to(dtype)[:, None, None]

    def extra_repr(self) -> str:
        return super().extra_repr() + f", xscale={self.xscale}"


class QConv(nn.Module):
    """int8-quantized conv (serving only), the port of the JAX package's QConv.

    Buffers, the leaves of the JAX param tree: ``weight`` int8 (Cout, KH, KW,
    Cin), symmetric per output channel (the JAX ``kernel``, HWIO, transposed
    so that k is contiguous); ``wscale`` fp32 (Cout), its step max|w| / 127;
    ``xscale`` fp32 (), the calibrated max|input|; ``bias`` fp32 (Cout). The
    forward is one K5 launch: it quantizes the input to int8 with the static
    ``xscale``, runs the s8 x s8 -> s32 conv and returns ``float(acc) *
    (wscale * (xscale / 127)) + bias`` in ``dtype``, an NCHW (channels_last)
    view of the kernel's NHWC output. SAME padding ``dilation * (k - 1) //
    2``; the zero point is 0, so the zero padding stays exact.

    Derived once, not per forward (non-persistent buffers, remade by
    :meth:`refresh` whenever the buffers above are loaded): ``s = 127 /
    xscale``, ``fac = wscale * (xscale / 127)`` (the JAX package's fp32
    operations) and ``wpack``, the weights packed for K5 (ops/qconv.py
    ``pack_weight``).

    A cast of the module (``module.to(dtype)``, ``.bfloat16()``) leaves every
    buffer's dtype as it is and moves only the device: the scales and bias
    stay fp32, as in the JAX package.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_channels, self.out_channels = cin, cout
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.dtype = dtype
        k = kernel_size
        self.register_buffer("weight", torch.zeros((cout, k, k, cin), dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(cout))
        self.register_buffer("xscale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(cout))
        for name in ("s", "fac", "wpack"):
            self.register_buffer(name, None, persistent=False)
        self.refresh()

    @classmethod
    def like(cls, conv: nn.Conv2d, dtype: torch.dtype) -> "QConv":
        """A QConv of ``conv``'s geometry (square kernel, SAME padding) on its
        device, holding the placeholder values (zero weights, unit scales)."""
        k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
        if conv.kernel_size != (k, k) or conv.padding != (d * (k - 1) // 2,) * 2 or conv.groups != 1:
            raise ValueError(f"QConv takes square SAME convs, got {conv}")
        out = cls(conv.in_channels, conv.out_channels, k, s, d, dtype)
        return out.to(conv.weight.device)

    @torch.no_grad()
    def refresh(self) -> None:
        """Remake ``s``, ``fac`` and ``wpack`` from the loaded buffers."""
        self.s = act_scale(self.xscale)
        self.fac = dequant_factor(self.wscale, self.xscale)
        self.wpack = pack_weight(self.weight)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.refresh()

    def _apply(self, fn, recurse=True):
        def same_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)
        return super()._apply(same_dtype, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = qconv(x, self.weight, self.s, self.fac, self.bias, stride=self.stride,
                  dilation=self.dilation, out_dtype=self.dtype, wpack=self.wpack)
        return y.permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, dilation={self.dilation}, dtype={self.dtype}")


def to_compute_dtype(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """x in the dtype ``conv`` computes in; a QConv or an FQConv quantizes its
    input from fp32 itself, so it takes x as it is (as the JAX package's do)."""
    return x if isinstance(conv, (QConv, FQConv)) else x.to(conv.weight.dtype)
