"""The dual-refinement video detector (the port of ``tdrn_tpu/models/detector.py``).

VGG-16 backbone -> L2Norm on the two shallow scales -> ARM heads -> TCB
top-down pyramid -> ARM-guided re-sampling -> ConvGRU temporal carry -> ODM
heads. The forward returns the raw predictions and the new temporal state;
post-processing (ops/detection.py) is composed by the callers.

Module attribute names follow the flax module names, so ``state_dict`` keys
are the flax parameter paths joined with "." (weights.py converts layouts).

``dtype`` is the compute dtype of the backbone, TCB, re-sampling and temporal
carry, and ``head_dtype`` that of the ARM/ODM heads; each module's parameters
are held in its compute dtype, the L2Norm scales in fp32, and the raw
predictions are returned in fp32 whatever the heads computed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.models.heads import MultiBoxHead
from tdrn_tpu_torch.models.layers import L2Norm
from tdrn_tpu_torch.models.offset import apply_arm_guided_sampling
from tdrn_tpu_torch.models.tcb import TopDownPyramid
from tdrn_tpu_torch.models.temporal import State, TemporalPropagation, init_state
from tdrn_tpu_torch.models.vgg import VGG16Reduced
from tdrn_tpu_torch.ops.detection import RawPredictions

DTYPES = (torch.float32, torch.bfloat16)


class TDRN(nn.Module):
    """Dual-refinement detector with optional temporal propagation."""

    def __init__(
        self,
        cfg: DetectorConfig,
        temporal: bool = True,
        arm_guided_sampling: bool = True,
        tcb_channels: int = 256,
        width_mult: float = 1.0,
        stem: str = "conv",
        temporal_cell: str = "convgru",
        dtype: torch.dtype = torch.float32,
        head_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.head_dtype = head_dtype or dtype
        self.temporal_enabled = temporal
        self.arm_guided_sampling = arm_guided_sampling
        self.tcb_channels = tcb_channels
        w = lambda c: max(8, int(c * width_mult))
        src_channels = (w(512), w(512), w(1024), w(512))
        self.backbone = VGG16Reduced(width_mult=width_mult, stem=stem)
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
        """x: (B, size, size, 3) preprocessed frames (NHWC, mean-subtracted);
        state: per-scale (B, C, f, f) tensors or None (zeros)."""
        sources = self.backbone(x)
        sources[0] = self.l2norm0(sources[0])
        sources[1] = self.l2norm1(sources[1])
        arm_loc, arm_conf = self.arm(sources)
        feats = self.tcb(sources)
        if self.arm_guided_sampling:
            feats = apply_arm_guided_sampling(feats, arm_loc, self.cfg)
        new_state = None
        if self.temporal_enabled:
            feats, new_state = self.temporal(feats, state)
        odm_loc, odm_conf = self.odm(feats)
        preds = RawPredictions(arm_loc, arm_conf, odm_loc, odm_conf)
        return RawPredictions(*(t.float() for t in preds)), new_state

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
    head_dtype: Optional[torch.dtype] = None,
    device=None,
) -> TDRN:
    """Build an eval-mode detector on ``device`` (CUDA unless "cpu" is given).

    Ported: the VGG-16 backbone, the conv, fused and fused2 stems, the ConvGRU
    cell, fp32 and bf16 for ``dtype`` and ``head_dtype``. Everything else
    raises NotImplementedError.
    """
    dev = _build.resolve_device(device)
    if backbone != "vgg16":
        raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
    for dt in (dtype, head_dtype or dtype):
        if dt not in DTYPES:
            raise NotImplementedError(f"dtype {dt} is not ported (ported: {DTYPES})")
    model = TDRN(
        cfg, temporal=temporal, arm_guided_sampling=arm_guided_sampling,
        tcb_channels=tcb_channels, width_mult=width_mult, stem=stem,
        temporal_cell=temporal_cell, dtype=dtype, head_dtype=head_dtype,
    )
    return model.to(dev).eval()
