"""Post-training int8 quantization of the backbone, TCB and temporal convs
(serving only): the port of ``tdrn_tpu/utils/quantize.py``.

  * weights: symmetric per output channel, step ``wscale = max|w| / 127``,
    computed with the JAX package's numpy fp32 operations, so the int8
    weights and their steps are bit-equal to its;
  * activations: symmetric per tensor with a STATIC scale calibrated from
    sample frames (the max, or a percentile, of each conv's input), so the
    in-graph quantization needs no runtime reduction.

Covered: VGG-16 (every conv of ``VGG_CONV_CHAIN``, conv and s2d stems) and
ResNet-101 (stem, every bottleneck's conv1/conv2/conv3/proj, extra1/extra2;
the norms stay in the compute dtype); ``tcb=True`` adds the TCB convs
(``tcb{k}/conv{1,2,3}``), ``gru=True`` the temporal-cell convs
(``gru{k}/gates|gate|cand``). The transform returns a quantized copy of the
model whose convs are QConvs (models/layers.py) on the K5 kernel::

    model = apply_inference_precision(model, "bf16")
    model = apply_int8_backbone(model, calib_frames, tcb=True, gru=True)

:func:`apply_qat` is its train-time twin: the same convs become FQConvs,
fake-quantized on the same grids with straight-through gradients.

Calibration reads the same tensors as the JAX package's captured
intermediates, by forward hooks: each conv's output before its ReLU (a
VGG conv's before the pool that follows), the ResNet norms' and blocks'
outputs, the L2Norm outputs (signed), TCB's post-add ``fused`` tensor (conv3's
input) and the cells' concatenated inputs (signed, floored at 1.0). It copies
to the host, so it runs once, before serving, and never inside the step.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tdrn_tpu_torch.models.layers import FQConv, QConv
from tdrn_tpu_torch.models.resnet import DEPTHS, resnet_conv_chain
from tdrn_tpu_torch.models.temporal import cell_kind
from tdrn_tpu_torch.models.vgg import QUANT_STEMS

# Backbone conv chain in dataflow order: each conv's input is relu(previous
# conv's output) (max-pools between them do not change the max), except
# conv1_1's, which is the preprocessed frame.
VGG_CONV_CHAIN: Sequence[str] = (
    "conv1_1", "conv1_2",
    "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
    "conv6", "conv7", "conv6_1", "conv6_2",
)

_TCB_KEY = r"tcb\d+/conv[123]"
_GRU_KEY = r"gru\d+/(gates|gate|cand)"


def _is_tcb_key(name: str) -> bool:
    return re.fullmatch(_TCB_KEY, name) is not None


def _is_gru_key(name: str) -> bool:
    return re.fullmatch(_GRU_KEY, name) is not None


def module_path(key: str) -> str:
    """A scale key -> the module's path in the port's TDRN."""
    if _is_tcb_key(key):
        return "tcb." + key.replace("/", ".")
    if _is_gru_key(key):
        return "temporal." + key.replace("/", ".")
    return "backbone." + key.replace("/", ".")


def _backbone(model) -> str:
    return getattr(model, "backbone_name", "vgg16")


def _stat_fn(percentile: Optional[float]):
    """The JAX package's statistic: max(relu(x)) or max|x| (signed), or that
    percentile of relu(x) or |x|; never below 0."""
    def stat(t: torch.Tensor, signed: bool = False) -> float:
        if percentile is None:
            # max(relu(x)) == max(x.max(), 0); an exact reduction on the tensor's device.
            m = float((t.abs() if signed else t).max().float()) if t.numel() else 0.0
            return max(m, 0.0)
        x = t.detach().float().cpu().numpy()
        x = np.abs(x) if signed else np.maximum(x, 0.0)
        return max(float(np.percentile(x, percentile)), 0.0)
    return stat


def calibrate_act_scales(
    model, frames: Any, headroom: float = 1.0, percentile: Optional[float] = None,
    tcb: bool = False, gru: bool = False,
) -> Dict[str, float]:
    """Per-conv input scale from a calibration forward pass of ``model``.

    ``frames``: (B, H, W, 3) PREPROCESSED frames (the in-graph preprocess
    output, in the model's dtype), a tensor on the model's device or an
    array; the first 8 are used. ``percentile`` (e.g. 99.9) takes that
    percentile of each input's values instead of their max. ``tcb`` and
    ``gru`` add the TCB and temporal-cell convs; the cells' scales floor at
    1.0, since the hidden half of their input is tanh-bounded. A chunked
    model is calibrated at chunk 1 (the same parameters). Returns {key:
    max(scale, 1e-6) * headroom}, in the JAX package's key order.
    """
    if gru and not model.temporal_enabled:
        raise ValueError("gru=True needs a temporal model")
    name = _backbone(model)
    if name not in ("vgg16", "resnet101"):
        raise ValueError(f"int8 calibration: unknown backbone {name}")
    if getattr(model, "chunk", 1) > 1:
        model = model.clone(chunk=1)
    dev = next(model.parameters()).device
    frames = torch.as_tensor(frames)[:8].to(dev)
    stat = _stat_fn(percentile)
    got: Dict[str, float] = {}
    mods = dict(model.named_modules())
    handles = []

    def on_output(path, signed=False):
        def hook(_mod, _inp, out):
            got[path] = stat(out, signed)
        handles.append(mods[path].register_forward_hook(hook))

    def on_input(path, key):
        def hook(_mod, inp):
            got[key] = stat(inp[0], True)
        handles.append(mods[path].register_forward_pre_hook(hook))

    if name == "vgg16":
        for conv in VGG_CONV_CHAIN:
            on_output(f"backbone.{conv}")
    else:
        on_output("backbone.stem_bn")
        for si, n in enumerate(DEPTHS[101], start=1):
            for bi in range(n):
                blk = f"backbone.stage{si}_{bi}"
                for sub in ("", ".bn1", ".bn2"):
                    on_output(blk + sub)
        for conv in ("extra1", "extra2"):
            on_output(f"backbone.{conv}")
    n_scales = len(model.cfg.feature_maps)
    if tcb:
        for k in range(2):
            on_output(f"l2norm{k}", signed=True)
        for k in range(n_scales):
            on_output(f"tcb.tcb{k}.conv1")
            on_input(f"tcb.tcb{k}.conv3", f"tcb{k}.fused")
    kinds = [cell_kind(model.temporal_cell, k) for k in range(n_scales)] if gru else []
    for k, kind in enumerate(kinds):
        cell = f"temporal.gru{k}"
        if kind == "convgru":
            on_input(f"{cell}.gates", f"gru{k}.xh")
            on_input(f"{cell}.cand", f"gru{k}.xrh")
        else:
            on_input(f"{cell}.gate", f"gru{k}.xh")
            on_output(f"{cell}.dw", signed=True)
    try:
        state = model.zero_state(frames.shape[0]) if model.temporal_enabled else None
        with torch.inference_mode():
            model(frames, state)
    finally:
        for h in handles:
            h.remove()

    scales: Dict[str, float] = {}
    frame_stat = stat(frames, True)
    if name == "vgg16":
        prev = None
        for conv in VGG_CONV_CHAIN:
            scales[conv] = frame_stat if prev is None else got[f"backbone.{prev}"]
            prev = conv
        deep_src = (got["backbone.conv7"], got["backbone.conv6_2"])
    else:
        scales["stem"] = frame_stat
        prev = got["backbone.stem_bn"]
        for si, n in enumerate(DEPTHS[101], start=1):
            for bi in range(n):
                blk = f"stage{si}_{bi}"
                scales[f"{blk}/conv1"] = prev
                if bi == 0:
                    scales[f"{blk}/proj"] = prev
                scales[f"{blk}/conv2"] = got[f"backbone.{blk}.bn1"]
                scales[f"{blk}/conv3"] = got[f"backbone.{blk}.bn2"]
                prev = got[f"backbone.{blk}"]
        scales["extra1"] = prev
        scales["extra2"] = got["backbone.extra1"]
        deep_src = (scales["extra1"], got["backbone.extra2"])
    if tcb:
        for k in range(n_scales):
            scales[f"tcb{k}/conv1"] = got[f"l2norm{k}"] if k < 2 else deep_src[k - 2]
            scales[f"tcb{k}/conv2"] = got[f"tcb.tcb{k}.conv1"]
            scales[f"tcb{k}/conv3"] = got[f"tcb{k}.fused"]
    for k, kind in enumerate(kinds):
        xh = got[f"gru{k}.xh"]
        if kind == "convgru":
            scales[f"gru{k}/gates"] = max(xh, 1.0)
            scales[f"gru{k}/cand"] = max(got[f"gru{k}.xrh"], 1.0)
        else:
            scales[f"gru{k}/gate"] = max(xh, 1.0)
            scales[f"gru{k}/cand"] = max(got[f"temporal.gru{k}.dw"], 1.0)
    return {k: max(v, 1e-6) * headroom for k, v in scales.items()}


def _quantize_conv(weight: torch.Tensor, bias: torch.Tensor, xscale: float) -> Dict[str, torch.Tensor]:
    """One conv's float (OIHW) weight and bias -> QConv's buffers: int8 weight
    (Cout, KH, KW, Cin), fp32 wscale, xscale and bias. The JAX package's numpy
    fp32 operations on the HWIO kernel, so the results are bit-equal."""
    k = weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
    ws = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0) / 127.0
    ws = np.maximum(ws, 1e-12)
    kq = np.clip(np.round(k / ws), -127, 127).astype(np.int8)
    return {
        "weight": torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 0, 1, 2))),
        "wscale": torch.from_numpy(np.asarray(ws, np.float32)),
        "xscale": torch.from_numpy(np.asarray(np.float32(xscale))),
        "bias": torch.from_numpy(np.asarray(bias.detach().float().cpu().numpy(), np.float32)),
    }


def quantize_backbone_params(state_dict: Dict[str, torch.Tensor],
                             act_scales: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """A copy of the port's ``state_dict`` in which every conv named by a key
    of ``act_scales`` (backbone ``conv3_1`` / ``stage2_0/conv1`` / ``stem``,
    ``tcb{k}/conv{i}``, ``gru{k}/<conv>``) holds QConv's buffers: int8
    ``weight`` (Cout, KH, KW, Cin), fp32 ``wscale``, ``xscale`` and ``bias``."""
    out = dict(state_dict)
    for key, xscale in act_scales.items():
        path = module_path(key)
        q = _quantize_conv(state_dict[f"{path}.weight"], state_dict[f"{path}.bias"], xscale)
        for leaf, v in q.items():
            out[f"{path}.{leaf}"] = v
    return out


def _validate_gru_keys(model, act_scales: Dict[str, float]) -> None:
    """The gru scale keys must match the model's cell kind at each scale:
    ``gru{k}/gates`` + ``gru{k}/cand`` for a ConvGRU, ``gru{k}/gate`` +
    ``gru{k}/cand`` for a light cell."""
    if not model.temporal_enabled:
        return  # apply_int8_backbone raises its own error for this
    by_scale: Dict[int, set] = {}
    for key in act_scales:
        if _is_gru_key(key):
            k = int(key[len("gru"):key.index("/")])
            by_scale.setdefault(k, set()).add(key.split("/", 1)[1])
    for k, have in sorted(by_scale.items()):
        kind = cell_kind(model.temporal_cell, k)
        want = {"gates", "cand"} if kind == "convgru" else {"gate", "cand"}
        if have != want:
            raise ValueError(
                f"gru scale keys for scale {k} are gru{k}/{sorted(have)} but the model's cell "
                f"there is {kind!r} (temporal_cell={model.temporal_cell!r}), which needs "
                f"gru{k}/{sorted(want)}: the scales were calibrated on another cell kind"
            )


def expected_conv_keys(model) -> Sequence[str]:
    """The backbone conv-scale keys this model's int8 profile requires."""
    if _backbone(model) == "vgg16":
        return VGG_CONV_CHAIN
    return tuple(resnet_conv_chain(101))


def apply_int8_backbone(model, calib_frames: Any = None, headroom: float = 1.0,
                        act_scales: Optional[Dict[str, float]] = None,
                        tcb: bool = False, gru: bool = False):
    """Calibrate and quantize: a deep copy of ``model`` whose quantized convs
    are QConvs computing in the model's dtype, with ``quant``, ``quant_tcb``
    and ``quant_gru`` set.

    ``calib_frames`` are preprocessed like serving inputs (ops/preprocess.py,
    in the model's dtype). Or pass ``act_scales`` (e.g. from
    :func:`load_act_scales`); their keys then decide tcb and gru. Compose
    after the bf16 profile: the weight steps are derived from whatever weight
    dtype the model holds. ``model`` itself is left untouched.
    """
    name = _backbone(model)
    if name == "vgg16":
        if model.backbone.stem not in QUANT_STEMS:
            raise ValueError("int8 vgg16 backbone supports the conv/s2d stems only")
    elif name != "resnet101":
        raise ValueError(f"int8 backbone: unsupported {name!r}")
    if getattr(model, "fold_mean", False):
        # The folded mean taps are ~100x the rgb taps: a per-output-channel
        # weight step would crush the rgb taps to a few int8 steps.
        raise ValueError("int8 backbone is incompatible with fold_mean")
    if act_scales is None:
        if calib_frames is None:
            raise ValueError("need calib_frames or act_scales")
        act_scales = calibrate_act_scales(model, calib_frames, headroom, tcb=tcb, gru=gru)
    else:
        tcb = any(_is_tcb_key(k) for k in act_scales)
        gru = any(_is_gru_key(k) for k in act_scales)
        missing = sorted(set(expected_conv_keys(model)) - set(act_scales))
        if missing:
            shown = missing[:5] + (["..."] if len(missing) > 5 else [])
            raise ValueError(f"act_scales missing convs for backbone {name!r}: {shown}")
        if gru:
            _validate_gru_keys(model, act_scales)
    if gru and not model.temporal_enabled:
        raise ValueError("gru int8 scales need a temporal model")
    bad = {k: v for k, v in act_scales.items() if not float(v) > 0}
    if bad:
        raise ValueError(f"int8 backbone: non-positive activation scales {bad}")
    out = copy.deepcopy(model)
    for key in act_scales:
        parent, _, leaf = module_path(key).rpartition(".")
        owner = out.get_submodule(parent)
        setattr(owner, leaf, QConv.like(getattr(owner, leaf), model.dtype))
    out.load_state_dict(quantize_backbone_params(model.state_dict(), act_scales), strict=True)
    out.quant, out.quant_tcb, out.quant_gru = True, bool(tcb), bool(gru)
    return out


def apply_qat(model, act_scales: Dict[str, float]):
    """A copy of ``model`` for QAT fine-tuning on calibrated scales.

    The train-time twin of :func:`apply_int8_backbone`: every conv the int8
    serving profile would quantize becomes an FQConv (models/layers.py) on
    the same grids (per-output-channel weight steps from the float weights,
    the static activation scale from ``act_scales``), with straight-through
    gradients. Which subsystems fake-quantize follows the keys present
    (tcb, gru), as in the scales-file serving path. Parameter names and
    shapes are unchanged, so the trainer runs the copy on the masters of
    ``model`` (train/trainer.py) and checkpoints stay plain; serve the result
    with ``--precision int8 --int8_scales <the same file>``. Refuses what the
    JAX package's ``apply_qat`` refuses: a stem other than conv or s2d, an
    unknown backbone, missing backbone keys, gru keys on a non-temporal
    model or of the wrong cell kind, non-positive scales, and an int8 model.
    """
    name = _backbone(model)
    if name == "vgg16":
        if model.backbone.stem not in QUANT_STEMS:
            raise ValueError("qat supports the conv/s2d stems only")
    elif name != "resnet101":
        raise ValueError(f"qat: unsupported backbone {name!r}")
    if getattr(model, "quant", False):
        raise ValueError("qat_scales and quant are mutually exclusive")
    missing = sorted(set(expected_conv_keys(model)) - set(act_scales))
    if missing:
        shown = missing[:5] + (["..."] if len(missing) > 5 else [])
        raise ValueError(f"qat scales missing convs for backbone {name!r}: {shown}")
    if any(_is_gru_key(k) for k in act_scales) and not model.temporal_enabled:
        raise ValueError("gru qat scales need a temporal model")
    _validate_gru_keys(model, act_scales)
    bad = {k: v for k, v in act_scales.items() if not float(v) > 0}
    if bad:
        raise ValueError(f"qat: non-positive activation scales {bad}")
    out = copy.deepcopy(model)
    for key, xscale in act_scales.items():
        parent, _, leaf = module_path(key).rpartition(".")
        owner = out.get_submodule(parent)
        setattr(owner, leaf, FQConv.like(getattr(owner, leaf), float(xscale)))
    out.qat_scales = tuple(sorted((k, float(v)) for k, v in act_scales.items()))
    return out


def save_act_scales(path: str, scales: Dict[str, float]) -> None:
    """Write calibrated activation scales as json, for offline serving."""
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in scales.items()}, f, indent=1)


def load_act_scales(path: str) -> Dict[str, float]:
    """Read a scales file (this module's or the JAX package's): its keys must
    be convs of one backbone family, and every scale positive."""
    with open(path) as f:
        scales = json.load(f)
    if "stem" in scales:  # resnet family (completeness checked in apply_int8_backbone)
        pat = r"stem|extra[12]|stage\d+_\d+/(conv[123]|proj)|" + _TCB_KEY + "|" + _GRU_KEY
        known = set()
    else:  # vgg family: the whole chain is static, checked here
        pat = _TCB_KEY + "|" + _GRU_KEY
        known = set(VGG_CONV_CHAIN)
    missing = known - set(scales)
    extra = {k for k in set(scales) - known if not re.fullmatch(pat, k)}
    if missing or extra:
        raise ValueError(
            f"scales file {path}: missing convs {sorted(missing)}, unknown convs {sorted(extra)}"
        )
    bad = {k: v for k, v in scales.items() if not float(v) > 0}
    if bad:
        # A zero or NaN scale would quantize with 127/0 = inf, silently.
        raise ValueError(f"scales file {path}: non-positive scales {bad}")
    return {k: float(v) for k, v in scales.items()}
