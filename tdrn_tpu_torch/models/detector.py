"""The dual-refinement video detector (the port of ``tdrn_tpu/models/detector.py``).

VGG-16 or ResNet-101 backbone -> L2Norm on the two shallow scales -> ARM
heads -> TCB top-down pyramid -> ARM-guided re-sampling -> temporal carry
(ConvGRU, light or hybrid cells) -> ODM heads. The forward returns the raw
predictions and the new temporal state; post-processing (ops/detection.py)
is composed by the callers.

Module attribute names follow the flax module names, so ``state_dict`` keys
are the flax parameter paths joined with "." (weights.py converts layouts).

``dtype`` is the compute dtype of the backbone, TCB, re-sampling and temporal
carry, and ``head_dtype`` that of the ARM/ODM heads; each module's parameters
are held in its compute dtype, the L2Norm scales in fp32, and the raw
predictions are returned in fp32 whatever the heads computed in.

Six inference-only settings mirror the flax fields of the same names:
``chunk`` (frame-major micro-batching, set by ``clone``), ``fold_mean`` and
``pad_stem`` (set by the transforms of utils/precision.py, which also rewrite
conv1_1), and ``quant``, ``quant_tcb`` and ``quant_gru`` (set by
utils/quantize.apply_int8_backbone, which turns the backbone's, the TCB's
and the temporal cells' convs into int8 QConvs). ``qat_scales`` is set by
utils/quantize.apply_qat, whose copy runs those convs as FQConvs for
quantization-aware training (:func:`split_qat_scales` groups its keys).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.models.heads import MultiBoxHead
from tdrn_tpu_torch.models.layers import L2Norm
from tdrn_tpu_torch.models.offset import apply_arm_guided_sampling
from tdrn_tpu_torch.models.resnet import ResNetBackbone
from tdrn_tpu_torch.models.tcb import TopDownPyramid
from tdrn_tpu_torch.models.temporal import State, TemporalPropagation, init_state
from tdrn_tpu_torch.models.vgg import VGG16Reduced
from tdrn_tpu_torch.ops.detection import RawPredictions

DTYPES = (torch.float32, torch.bfloat16)
BACKBONES = ("vgg16", "resnet101")


def build_backbone(name: str, in_channels: int = 3, width_mult: float = 1.0,
                   stem: str = "conv", norm: str = "frozen") -> nn.Module:
    """The backbone module; its ``out_channels`` are the four source widths.
    ``stem`` applies to vgg16 and ``norm`` to resnet101 only, as in the JAX
    package."""
    if name == "vgg16":
        return VGG16Reduced(in_channels, width_mult=width_mult, stem=stem)
    if name == "resnet101":
        return ResNetBackbone(101, in_channels, width_mult=width_mult, norm=norm)
    raise ValueError(f"unknown backbone {name!r} (one of {BACKBONES})")


def split_qat_scales(qat_scales):
    """Split ((key, xscale), ...) into (backbone, tcb, gru) groups by the
    utils/quantize.py key convention ("tcb{k}/..." and "gru{k}/..." prefixes;
    everything else is a backbone conv)."""
    backbone, tcb, gru = [], [], []
    for k, v in qat_scales:
        blk = k.split("/", 1)[0]
        if blk.startswith("tcb") and blk[3:].isdigit():
            tcb.append((k, v))
        elif blk.startswith("gru") and blk[3:].isdigit():
            gru.append((k, v))
        else:
            backbone.append((k, v))
    return tuple(backbone), tuple(tcb), tuple(gru)


class TDRN(nn.Module):
    """Dual-refinement detector with optional temporal propagation."""

    def __init__(
        self,
        cfg: DetectorConfig,
        backbone: str = "vgg16",
        temporal: bool = True,
        arm_guided_sampling: bool = True,
        tcb_channels: int = 256,
        width_mult: float = 1.0,
        stem: str = "conv",
        temporal_cell: str = "convgru",
        backbone_norm: str = "frozen",
        dtype: torch.dtype = torch.float32,
        head_dtype: Optional[torch.dtype] = None,
        chunk: int = 1,
        fold_mean: bool = False,
        pad_stem: int = 0,
    ):
        """chunk: frames per stream in one forward. x is then (chunk*B, ...)
        FRAME-MAJOR (frame 0's B streams, then frame 1's, ...) and the state
        stays (B, ...): the backbone, TCB and heads run over all chunk*B
        frames at once, the temporal cell steps chunk times.
        fold_mean: the model takes raw-pixel rgb + ones input (4 channels);
        vgg16, not with a fused stem.
        pad_stem: the input is zero-padded to this many channels (0 = off);
        vgg16 with the conv stem.
        """
        super().__init__()
        if (fold_mean or pad_stem) and backbone != "vgg16":
            raise ValueError("fold_mean and pad_stem support the vgg16 backbone only")
        if fold_mean and stem in ("fused", "fused2"):
            raise ValueError("fold_mean + fused stem not supported")
        if pad_stem and stem != "conv":
            raise ValueError("pad_stem is conv-stem only")
        self.cfg = cfg
        self.backbone_name = backbone
        self.temporal_cell = temporal_cell
        self.quant = self.quant_tcb = self.quant_gru = False
        self.qat_scales = None  # set by utils/quantize.apply_qat
        self.chunk = int(chunk)
        self.fold_mean = bool(fold_mean)
        self.pad_stem = int(pad_stem)
        self.dtype = dtype
        self.head_dtype = head_dtype or dtype
        self.temporal_enabled = temporal
        self.arm_guided_sampling = arm_guided_sampling
        self.tcb_channels = tcb_channels
        in_channels = self.pad_stem or (4 if self.fold_mean else 3)
        self.backbone = build_backbone(backbone, in_channels, width_mult, stem, backbone_norm)
        src_channels = self.backbone.out_channels
        self.l2norm0 = L2Norm(src_channels[0], 10.0)
        self.l2norm1 = L2Norm(src_channels[1], 8.0)
        self.arm = MultiBoxHead(2, cfg.anchors_per_cell, src_channels)
        self.tcb = TopDownPyramid(src_channels, tcb_channels)
        if temporal:
            self.temporal = TemporalPropagation(len(src_channels), tcb_channels, temporal_cell)
        self.odm = MultiBoxHead(
            cfg.num_classes, cfg.anchors_per_cell, (tcb_channels,) * len(src_channels)
        )
        for name, module in self.named_children():
            if name in ("arm", "odm"):
                module.to(self.head_dtype)
            elif not name.startswith("l2norm"):
                module.to(dtype)

    def forward(
        self, x: torch.Tensor, state: Optional[State] = None
    ) -> Tuple[RawPredictions, Optional[State]]:
        """x: (chunk*B, size, size, 3) preprocessed frames (NHWC,
        mean-subtracted; 4 channels, raw rgb + ones, under fold_mean);
        state: per-scale (B, C, f, f) tensors or None (zeros)."""
        return self.forward_sources(self.backbone(self.stem_input(x)), state)

    def stem_input(self, x: torch.Tensor) -> torch.Tensor:
        """The backbone's input: x zero-padded in channels under pad_stem."""
        if self.pad_stem and x.shape[-1] < self.pad_stem:
            x = F.pad(x, (0, self.pad_stem - x.shape[-1]))
        return x

    def forward_sources(
        self, sources, state: Optional[State] = None
    ) -> Tuple[RawPredictions, Optional[State]]:
        """The forward after the backbone, from its four source maps (NCHW):
        L2Norm, ARM, TCB, re-sampling, the temporal cell and ODM."""
        sources = list(sources)
        sources[0] = self.l2norm0(sources[0])
        sources[1] = self.l2norm1(sources[1])
        arm_loc, arm_conf = self.arm(sources)
        feats = self.tcb(sources)
        if self.arm_guided_sampling:
            feats = apply_arm_guided_sampling(feats, arm_loc, self.cfg)
        new_state = None
        if self.temporal_enabled:
            if self.chunk > 1:
                feats, new_state = self._temporal_chunk(feats, state)
            else:
                feats, new_state = self.temporal(feats, state)
        odm_loc, odm_conf = self.odm(feats)
        preds = RawPredictions(arm_loc, arm_conf, odm_loc, odm_conf)
        return RawPredictions(*(t.float() for t in preds)), new_state

    def _temporal_chunk(self, feats, state):
        """Split the frame-major (chunk*B) features into chunk frames, step the
        cell over them in order, and stack the outputs back frame-major."""
        f = self.chunk
        per_frame = [ft.unflatten(0, (f, -1)).unbind(0) for ft in feats]  # scale -> frames
        outs = []
        for i in range(f):
            out_i, state = self.temporal([frames[i] for frames in per_frame], state)
            outs.append(out_i)
        stacked = [torch.stack(scale).flatten(0, 1) for scale in zip(*outs)]
        return stacked, state

    def clone(self, *, chunk: int) -> "TDRN":
        """A copy that shares every parameter and runs ``chunk`` frames a
        stream in one forward, as flax's ``Module.clone(chunk=...)`` does."""
        out = copy.copy(self)  # a new __dict__; the submodules are shared
        # Dicts of its own, so that registering on the copy leaves self as it is.
        out._modules = self._modules.copy()
        out._parameters = self._parameters.copy()
        out._buffers = self._buffers.copy()
        out.chunk = int(chunk)
        return out

    def zero_state(self, batch: int) -> State:
        return init_state(
            batch, self.cfg.feature_maps, self.tcb_channels, self.dtype,
            next(self.parameters()).device,
        )


def build_detector(
    cfg: DetectorConfig,
    backbone: str = "vgg16",
    temporal: bool = True,
    dtype: torch.dtype = torch.float32,
    tcb_channels: int = 256,
    width_mult: float = 1.0,
    arm_guided_sampling: bool = True,
    stem: str = "conv",
    temporal_cell: str = "convgru",
    backbone_norm: str = "frozen",
    head_dtype: Optional[torch.dtype] = None,
    device=None,
) -> TDRN:
    """Build an eval-mode detector on ``device`` (CUDA unless "cpu" is given).

    backbone: vgg16 or resnet101; stem (vgg16): conv, s2d, poly, poly2, fused
    or fused2; backbone_norm (resnet101): frozen or group; temporal_cell:
    convgru, light or hybrid; dtype and head_dtype: fp32 or bf16 (fp16 is not
    ported and raises NotImplementedError).
    """
    dev = _build.resolve_device(device)
    for dt in (dtype, head_dtype or dtype):
        if dt not in DTYPES:
            raise NotImplementedError(f"dtype {dt} is not ported (ported: {DTYPES})")
    model = TDRN(
        cfg, backbone=backbone, temporal=temporal, arm_guided_sampling=arm_guided_sampling,
        tcb_channels=tcb_channels, width_mult=width_mult, stem=stem,
        temporal_cell=temporal_cell, backbone_norm=backbone_norm, dtype=dtype,
        head_dtype=head_dtype,
    )
    return model.to(dev).eval()
