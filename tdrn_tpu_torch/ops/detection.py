"""Two-stage (ARM -> ODM) detection post-processing (the port of ``tdrn_tpu/ops/detection.py``).

Softmax confidences, two-stage box decode (ARM offsets refine the priors, ODM
offsets decode against the refined anchors), the ARM negative-anchor filter,
then per-class threshold + top-k + greedy NMS, and the overall top-k. With
``cfg.fused_cascade`` the decode is the K1 wrapper (ops/cascade.py), which
emits class-major scores; the suppression is always the K2 wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.ops import boxes as B
from tdrn_tpu_torch.ops import nms as N
from tdrn_tpu_torch.ops.cascade import fused_refine_cascade

Tensor = torch.Tensor


class RawPredictions(NamedTuple):
    """Network outputs for one batch."""

    arm_loc: Tensor  # (B, P, 4)
    arm_conf: Tensor  # (B, P, 2) objectness logits
    odm_loc: Tensor  # (B, P, 4)
    odm_conf: Tensor  # (B, P, C) class logits


def decode_two_stage(preds: RawPredictions, priors: Tensor, cfg: DetectorConfig):
    """Decode ODM boxes against ARM-refined anchors.

    Returns (boxes (B,P,4) xyxy, class_scores (B,P,C) softmax with ARM-filtered
    anchors zeroed).
    """
    var = cfg.variance
    refined = B.decode(preds.arm_loc, priors, var)  # (B, P, 4) xyxy
    boxes = B.decode(preds.odm_loc, B.center_size(refined), var)
    scores = torch.softmax(preds.odm_conf, dim=-1)
    arm_bg = torch.softmax(preds.arm_conf, dim=-1)[..., 0]
    filtered = (arm_bg > cfg.arm_filter_thresh)[..., None]
    scores = torch.where(filtered, torch.zeros_like(scores), scores)
    return boxes, scores


def _prefilter_select(per_anchor: Tensor, cfg: DetectorConfig) -> Tensor:
    """Indices (B, M) of the prefilter's exact top-M anchors."""
    if cfg.prefilter_recall < 1.0:
        raise NotImplementedError("prefilter_recall < 1 is not ported yet")
    _, idx = N._top_k(per_anchor, cfg.prefilter_anchors, cfg.approx_topk)
    return idx


def _prefilter(boxes: Tensor, scores: Tensor, cfg: DetectorConfig):
    """Keep the top-M anchors image-wide by max non-background class score.
    Exact vs the unfiltered path whenever fewer than M anchors clear
    conf_thresh."""
    m = cfg.prefilter_anchors
    if not m or m >= boxes.shape[1]:
        return boxes, scores
    idx = _prefilter_select(scores[..., 1:].amax(dim=-1), cfg)  # (B, M)
    take = lambda x: torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return take(boxes), take(scores)


def _prefilter_on(cfg: DetectorConfig, num_anchors: int) -> bool:
    return bool(cfg.prefilter_anchors) and cfg.prefilter_anchors < num_anchors


def _detect(
    preds: RawPredictions, priors: Tensor, cfg: DetectorConfig
) -> Tuple[Tensor, Optional[Tensor]]:
    """(B, C, top_k, 5) detections, and the (B, P) max non-background score per
    anchor when the prefilter is on (else None)."""
    per_anchor = None
    if cfg.fused_cascade:
        if _prefilter_on(cfg, preds.arm_loc.shape[1]):
            per_anchor = preds.odm_conf.new_empty(preds.odm_conf.shape[:2])  # (B, P)
        # K1 writes each anchor's max over class rows (row 0 is zero) into
        # per_anchor as it stores them.
        boxes, scores_cm = fused_refine_cascade(preds, priors, cfg, per_anchor)
        if per_anchor is not None:
            # Gather anchors on the last axis, no transpose.
            idx = _prefilter_select(per_anchor, cfg)
            boxes = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
            scores_cm = torch.gather(
                scores_cm, 2, idx[:, None, :].expand(-1, scores_cm.shape[1], -1)
            )
        det = N.class_aware_nms_cm(
            boxes, scores_cm, cfg.nms_thresh, cfg.top_k, cfg.conf_thresh, cfg.approx_topk
        )
        return det, per_anchor
    boxes, scores = decode_two_stage(preds, priors, cfg)
    if _prefilter_on(cfg, boxes.shape[1]):
        per_anchor = scores[..., 1:].amax(dim=-1)
    boxes, scores = _prefilter(boxes, scores, cfg)
    det = N.class_aware_nms(
        boxes, scores, cfg.nms_thresh, cfg.top_k, cfg.conf_thresh, cfg.approx_topk
    )
    return det, per_anchor


def detect(preds: RawPredictions, priors: Tensor, cfg: DetectorConfig) -> Tensor:
    """Full Detect: (B, C, top_k, 5) rows [score, x1, y1, x2, y2]."""
    return _detect(preds, priors, cfg)[0]


def _overflow(per_anchor: Tensor, cfg: DetectorConfig) -> Tensor:
    return (per_anchor > cfg.conf_thresh).sum(dim=-1) >= cfg.prefilter_anchors


def prefilter_overflow(
    preds: RawPredictions, priors: Tensor, cfg: DetectorConfig
) -> Tensor:
    """(B,) bool: True where at least cfg.prefilter_anchors anchors clear
    conf_thresh, i.e. the prefilter's exactness precondition failed."""
    _, scores = decode_two_stage(preds, priors, cfg)
    return _overflow(scores[..., 1:].amax(dim=-1), cfg)


def detect_topk(
    preds: RawPredictions, priors: Tensor, cfg: DetectorConfig,
    top_k: Optional[int] = None,
) -> N.TopDetections:
    """Per-frame detect API: overall top-k (boxes, scores, classes) per image,
    plus ``prefilter_overflow`` when the prefilter is on. The flag reuses the
    scores the detect pass already computed (K1's on the fused branch)."""
    k = top_k or cfg.top_k
    det, per_anchor = _detect(preds, priors, cfg)
    out = N.flatten_detections(det, k, cfg.approx_topk)
    if per_anchor is not None:
        out = out._replace(prefilter_overflow=_overflow(per_anchor, cfg))
    return out
