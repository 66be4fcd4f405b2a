"""Inference precision: resident-bf16 weights with fp32 heads and detect.

The port of ``tdrn_tpu/utils/precision.py``. The resident-bf16 serving
profile converts the backbone, TCB and temporal weights to bf16 once, at
load, and computes the feature pyramid and the temporal carry in bf16, while
the ARM/ODM heads, the L2Norm scales and the whole detect path stay fp32: the
heads read the bf16 features upcast (models/heads.py) and emit fp32 logits.
uint8 pixels minus the integer pixel means are exact in bf16, so the bf16
preprocess is lossless. Training is unaffected; this is an inference-only
transform of a copy of the model.
"""

from __future__ import annotations

import copy
from typing import Tuple

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


def apply_fold_mean(model):
    """The mean-fold transform of the JAX package; not ported."""
    raise NotImplementedError("fold_mean is not ported yet (ROADMAP.md, queue 1 item 6)")


def apply_pad_stem(model, pad_to: int = 8):
    """The stem channel-padding transform of the JAX package; not ported."""
    raise NotImplementedError("pad_stem is not ported yet (ROADMAP.md, queue 1 item 6)")
