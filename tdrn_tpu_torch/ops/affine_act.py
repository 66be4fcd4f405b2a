"""K6 wrapper: a conv output's bias, FrozenBN, residual add and ReLU in one pass, and its plain version.

The JAX package has no kernel for it: XLA fuses the ResNet bottleneck's
elementwise tail on its own. In the port PyTorch runs it as separate passes
(cuDNN's bias add, FrozenBN's multiply and add, the residual add, the
ReLU). A CUDA tensor goes to the hand-written kernel (csrc/affine_act.cu),
which writes the result over the conv output; a CPU tensor to
:func:`affine_act_plain`, those very PyTorch ops. The two are bit-equal: the
kernel computes each op in fp32 from bf16 operands and rounds to bf16 after
each, as PyTorch's bf16 ops do.

On the card the kernel takes a bf16 channels_last (N, C, H, W) map with
C % 8 == 0, bf16 (C,) vectors and a shortcut of the map's layout, each
16-byte aligned, with no operand needing a gradient; it raises on anything
else. models/resnet.py decides where it runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from tdrn_tpu_torch import _build

Tensor = torch.Tensor


class Proj(NamedTuple):
    """A projection shortcut before its own bias and FrozenBN: ``out``, the
    proj conv's output without its bias, then ``conv_bias`` (or None),
    ``scale`` and ``bias``."""

    out: Tensor
    conv_bias: Optional[Tensor]
    scale: Tensor
    bias: Tensor


Shortcut = Union[None, Tensor, Proj]


def _channel(v: Tensor) -> Tensor:
    return v[:, None, None]


def _affine(c: Tensor, conv_bias: Optional[Tensor], scale: Tensor, bias: Tensor) -> Tensor:
    t = c if conv_bias is None else c + _channel(conv_bias)
    return t * _channel(scale) + _channel(bias)


def affine_act_plain(c: Tensor, conv_bias: Optional[Tensor], scale: Tensor, bias: Tensor,
                     shortcut: Shortcut = None) -> Tensor:
    """``relu((c + conv_bias) * scale + bias + shortcut)``, one PyTorch op
    each, so that bf16 rounds after every one; a :class:`Proj` shortcut goes
    through the same chain first, without a ReLU."""
    t = _affine(c, conv_bias, scale, bias)
    if isinstance(shortcut, Proj):
        shortcut = _affine(*shortcut)
    if shortcut is not None:
        t = t + shortcut
    return F.relu(t)


def _require_map(t: Tensor, name: str, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: the affine_act kernel takes a channels_last map")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the affine_act kernel needs 16-byte aligned data")


def _require_vector(v: Tensor, name: str, c: int) -> None:
    _build.require(v, name, (c,), torch.bfloat16)
    if v.data_ptr() % 16:
        raise ValueError(f"{name}: the affine_act kernel needs 16-byte aligned data")


def affine_act(c: Tensor, conv_bias: Optional[Tensor], scale: Tensor, bias: Tensor,
               shortcut: Shortcut = None) -> Tensor:
    """:func:`affine_act_plain`'s result: on the card written over ``c`` by
    K6 (the caller gives ``c`` up), on the CPU computed by the plain version
    into a new tensor."""
    proj = shortcut if isinstance(shortcut, Proj) else None
    res = proj.out if proj is not None else shortcut
    operands = [t for t in (c, conv_bias, scale, bias) + (tuple(proj) if proj else (res,))
                if t is not None]
    if _build.route(*operands) == "cpu":
        return affine_act_plain(c, conv_bias, scale, bias, shortcut)
    if c.dim() != 4:
        raise ValueError(f"c: expected (N, C, H, W), got shape {tuple(c.shape)}")
    n, ch, h, w = c.shape
    if ch % 8:
        raise ValueError(f"c: the affine_act kernel takes C % 8 == 0, got C = {ch}")
    if c.numel() // 8 >= 2**31:
        raise ValueError("c: the affine_act kernel indexes 16-byte vectors with 32 bits")
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError("the affine_act kernel writes in place and has no backward")
    _require_map(c, "c", c.shape)
    if res is not None:
        _require_map(res, "shortcut", c.shape)
    for name, v in (("conv_bias", conv_bias), ("scale", scale), ("bias", bias)):
        if v is not None:
            _require_vector(v, name, ch)
    if proj is not None:
        if (proj.conv_bias is None) != (conv_bias is None):
            raise ValueError("the proj shortcut has a conv bias exactly where the conv has one")
        for name, v in zip(("conv_bias", "scale", "bias"), proj[1:]):
            if v is not None:
                _require_vector(v, f"shortcut.{name}", ch)
    if c.numel() == 0:
        return c
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(c.device):
        err = _build.entry("affine_act")(
            ptr(c), ptr(conv_bias), ptr(scale), ptr(bias), ptr(res),
            *((ptr(proj.conv_bias), ptr(proj.scale), ptr(proj.bias)) if proj else (None,) * 3),
            n * h * w, ch, 0 if res is None else (2 if proj else 1), _build.stream_of(c),
        )
    _build.check("affine_act", err)
    affine_act.launches += 1
    return c


affine_act.launches = 0
