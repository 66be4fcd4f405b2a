"""Plain single-stage SSD detector (the port of ``tdrn_tpu/models/ssd.py``).

The baseline with no refinement cascade: multibox heads straight on the
backbone's four sources (the two shallow ones L2-normalized), then a
one-stage decode and the per-class NMS, whose suppression sweep is the K2
wrapper (ops/nms_suppress.py). It shares the backbone, L2Norm, heads, priors
and post-processing with the dual-refinement detector. The heads are named
``multibox``, as in the JAX param tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.models.detector import DTYPES, build_backbone
from tdrn_tpu_torch.models.heads import MultiBoxHead
from tdrn_tpu_torch.models.layers import L2Norm
from tdrn_tpu_torch.ops import boxes as B
from tdrn_tpu_torch.ops import nms as N


class SSD(nn.Module):
    """Single-stage multibox detector; forward returns fp32 (loc, conf) logits."""

    def __init__(self, cfg: DetectorConfig, backbone: str = "vgg16", width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = build_backbone(backbone, width_mult=width_mult)
        src = self.backbone.out_channels
        self.l2norm0 = L2Norm(src[0], 10.0)
        self.l2norm1 = L2Norm(src[1], 8.0)
        self.multibox = MultiBoxHead(cfg.num_classes, cfg.anchors_per_cell, src)
        self.backbone.to(dtype)
        self.multibox.to(dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, size, size, 3) preprocessed frames, NHWC."""
        sources = self.backbone(x)
        sources[0] = self.l2norm0(sources[0])
        sources[1] = self.l2norm1(sources[1])
        loc, conf = self.multibox(sources)
        return loc.float(), conf.float()


def ssd_detect(loc: torch.Tensor, conf: torch.Tensor, priors: torch.Tensor,
               cfg: DetectorConfig) -> torch.Tensor:
    """Softmax, decode and per-class NMS: (B, P, 4), (B, P, C) -> (B, C, top_k, 5)
    rows [score, x1, y1, x2, y2]."""
    boxes = B.decode(loc, priors, cfg.variance)
    scores = torch.softmax(conf, dim=-1)
    return N.class_aware_nms(
        boxes, scores, cfg.nms_thresh, cfg.top_k, cfg.conf_thresh, cfg.approx_topk
    )


def ssd_detect_topk(loc, conf, priors, cfg: DetectorConfig,
                    top_k: Optional[int] = None) -> N.TopDetections:
    """The overall top-k (boxes, scores, classes) of each image."""
    det = ssd_detect(loc, conf, priors, cfg)
    return N.flatten_detections(det, top_k or cfg.top_k, cfg.approx_topk)


def build_ssd(cfg: DetectorConfig, backbone: str = "vgg16", dtype: torch.dtype = torch.float32,
              width_mult: float = 1.0, device=None) -> SSD:
    """An eval-mode SSD on ``device`` (CUDA unless "cpu" is given)."""
    dev = _build.resolve_device(device)
    if dtype not in DTYPES:
        raise NotImplementedError(f"dtype {dtype} is not ported (ported: {DTYPES})")
    return SSD(cfg, backbone, width_mult, dtype).to(dev).eval()
