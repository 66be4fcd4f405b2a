"""Inference precision: resident-bf16 weights with fp32 heads and detect.

The port of ``tdrn_tpu/utils/precision.py``. The resident-bf16 serving
profile converts the backbone, TCB and temporal weights to bf16 once, at
load, and computes the feature pyramid and the temporal carry in bf16, while
the ARM/ODM heads, the L2Norm scales and the whole detect path stay fp32: the
heads read the bf16 features upcast (models/heads.py) and emit fp32 logits.
uint8 pixels minus the integer pixel means are exact in bf16, so the bf16
preprocess is lossless. Training is unaffected; this is an inference-only
transform of a copy of the model.

The mean-fold and stem-padding transforms (below) rewrite conv1_1 of a copy
of the model, as the JAX package's do.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch

# Top-level modules kept in fp32: the prediction heads (their logits feed
# detect directly) and the L2Norm scales (tiny; L2Norm computes in fp32).
FP32_SUBTREES: Tuple[str, ...] = ("arm", "odm", "l2norm0", "l2norm1")


def cast_params_bf16(model: torch.nn.Module, keep_fp32: Tuple[str, ...] = FP32_SUBTREES):
    """A copy of ``model`` whose top-level modules hold bf16 parameters, except
    ``keep_fp32``, which hold fp32. ``model`` itself is left untouched."""
    out = copy.deepcopy(model)
    for name, module in out.named_children():
        module.to(torch.float32 if name in keep_fp32 else torch.bfloat16)
    return out


def bf16_inference_model(model):
    """A copy of a detector for resident-bf16 inference: bf16 parameters,
    compute and carry, fp32 heads."""
    out = cast_params_bf16(model)
    out.dtype, out.head_dtype = torch.bfloat16, torch.float32
    return out


def apply_inference_precision(model, precision: str):
    """('fp32' | 'bf16') -> the model, or its transformed copy."""
    if precision in (None, "fp32", "float32"):
        return model
    if precision in ("bf16", "bfloat16"):
        return bf16_inference_model(model)
    raise ValueError(f"unknown inference precision {precision!r}")


# --- Mean-fold and stem padding: rewrites of conv1_1 ----------------------
#
# Mean-fold feeds raw pixels plus a constant ones channel and gives conv1_1 a
# fourth input channel whose taps are -sum_c k[:, c] * mean[c]:
# conv(x - m) = conv(x) - conv(m), and the ones channel is zero-padded at the
# borders exactly like x, so border cells see the partial-tap sum as well.
# Under the s2d stem the space-to-depth fold interleaves the ones channel
# with each spatial position ((py, px, c) channel order), so the (3, 3, 4*3,
# N) kernel maps position by position into (3, 3, 4*4, N).
# Pad-stem zero-pads conv1_1's input channels (the model feeds zeros there).
# Both are inference-only and keep the kernel's dtype; fold-mean takes the
# conv and s2d stems, pad-stem the conv stem only.

_CONV1_1 = "backbone.conv1_1.weight"


def _require_vgg16(model) -> None:
    from tdrn_tpu_torch.models.vgg import VGG16Reduced

    if not isinstance(model.backbone, VGG16Reduced):
        raise ValueError("fold_mean and pad_stem support the vgg16 backbone only")


def fold_mean_params(state_dict: Dict[str, torch.Tensor], cfg, stem: str = "conv"):
    """A copy of ``state_dict`` whose conv1_1 weight takes rgb + ones input:
    (O, 3, 3, 3) -> (O, 4, 3, 3) under the conv stem, and (O, 12, 3, 3) ->
    (O, 16, 3, 3) under s2d, where input position p's channels 3p..3p+2 move
    to 4p..4p+2 and channel 4p+3 takes -sum_c k[3p+c] * mean[c]. The new
    channels are computed in fp32 as the JAX package computes them (the same
    einsum on the HWIO kernel), then cast back to the weight's dtype."""
    w = state_dict[_CONV1_1]
    k = w.detach().cpu().float().numpy().transpose(2, 3, 1, 0)  # HWIO
    mean = np.asarray(cfg.pixel_means, np.float32)
    kh, kw, cin, cout = k.shape
    if stem == "s2d":
        if cin % 3:
            raise ValueError(f"conv1_1 takes {cin} input channels, expected a multiple of 3")
        k4 = np.zeros((kh, kw, cin // 3 * 4, cout), np.float32)
        for p in range(cin // 3):
            k4[:, :, 4 * p:4 * p + 3] = k[:, :, 3 * p:3 * p + 3]
            k4[:, :, 4 * p + 3] = -np.einsum("hwcn,c->hwn", k[:, :, 3 * p:3 * p + 3], mean)
    else:
        if cin != 3:
            raise ValueError(f"conv1_1 takes {cin} input channels, expected 3")
        k4 = np.concatenate([k, -np.einsum("hwcn,c->hwn", k, mean)[:, :, None, :]], axis=2)
    out = dict(state_dict)
    out[_CONV1_1] = torch.from_numpy(k4.transpose(3, 2, 0, 1).copy()).to(w.dtype)
    return out


def pad_stem_params(state_dict: Dict[str, torch.Tensor], pad_to: int):
    """A copy of ``state_dict`` whose conv1_1 weight is zero-padded to
    ``pad_to`` input channels (exact: the new channels are zero)."""
    w = state_dict[_CONV1_1]
    cout, cin, kh, kw = w.shape
    if cin >= pad_to:
        raise ValueError(f"pad_stem needs more than conv1_1's {cin} input channels, got {pad_to}")
    out = dict(state_dict)
    out[_CONV1_1] = torch.cat([w, w.new_zeros((cout, pad_to - cin, kh, kw))], dim=1)
    return out


def _with_conv1_1(model, in_channels: int, state_dict, **settings):
    """A deep copy of ``model`` with conv1_1 rebuilt for ``in_channels``, the
    given state loaded and the settings (fold_mean, pad_stem) set."""
    from tdrn_tpu_torch.models.layers import conv3x3

    out = copy.deepcopy(model)
    old = out.backbone.conv1_1
    out.backbone.conv1_1 = conv3x3(in_channels, old.out_channels).to(
        device=old.weight.device, dtype=old.weight.dtype
    )
    out.load_state_dict(state_dict, strict=True)
    for key, value in settings.items():
        setattr(out, key, value)
    return out


def apply_pad_stem(model, pad_to: int = 8):
    """A copy of the model that zero-pads the stem input to ``pad_to``
    channels, with conv1_1's weight padded to match (exact). vgg16 conv stem
    only."""
    _require_vgg16(model)
    if model.backbone.stem != "conv":
        raise ValueError("pad_stem supports the vgg16 conv stem only")
    sd = pad_stem_params(model.state_dict(), pad_to)
    return _with_conv1_1(model, pad_to, sd, pad_stem=int(pad_to))


def apply_fold_mean(model):
    """A copy of the model for raw-pixel (rgb + ones) input, with conv1_1
    folded. vgg16 only, and not with a fused stem; composes with
    ``apply_inference_precision(..., "bf16")`` in either order."""
    _require_vgg16(model)
    stem = model.backbone.stem
    if stem in ("fused", "fused2"):
        raise ValueError("fold_mean + fused stem not supported")
    sd = fold_mean_params(model.state_dict(), model.cfg, stem)
    return _with_conv1_1(model, sd["backbone.conv1_1.weight"].shape[1], sd, fold_mean=True)
