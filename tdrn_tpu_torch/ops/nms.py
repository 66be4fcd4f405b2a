"""Fixed-shape greedy NMS (the port of ``tdrn_tpu/ops/nms.py``).

Candidate selection is a stable descending sort, so equal scores rank lowest
index first as ``lax.top_k`` does (score fields are full of ties at 0).
``approx_topk`` selects by the same sort: the JAX package's
``lax.approx_max_k(recall_target=1.0)`` promises top_k's values, and the
exact, tie-ordered selection meets that with top_k's indices as well (on
the CPU the JAX call falls back to the exact top-k, ties lowest index
first). The
suppression step is the K2 wrapper (ops/nms_suppress.py), launched once for
every (image, class) row of a batch. Every function takes any number of
leading batch dimensions where the JAX one takes a single image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted

Tensor = torch.Tensor


class NMSResult(NamedTuple):
    scores: Tensor  # (..., K) kept scores, 0 where suppressed/padded
    boxes: Tensor  # (..., K, 4) kept boxes (xyxy), 0 where suppressed/padded
    keep: Tensor  # (..., K) bool keep mask over the top-K candidates


class TopDetections(NamedTuple):
    boxes: Tensor  # (..., K, 4)
    scores: Tensor  # (..., K)
    classes: Tensor  # (..., K) int32; 0 where padded
    # (B,) bool when cfg.prefilter_anchors > 0: True where at least that many
    # anchors cleared conf_thresh, i.e. the prefilter may have changed this
    # frame's detections. None on exact paths.
    prefilter_overflow: Optional[Tensor] = None


def _top_k(scores: Tensor, k: int, approx: bool = False):
    """(values, indices) of the k largest along the last axis, ties lowest
    index first. ``approx`` takes the same exact selection (module doc)."""
    del approx
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed(
    boxes: Tensor,
    scores: Tensor,
    iou_thresh: float = 0.45,
    top_k: int = 200,
    score_thresh: float = 0.0,
    approx_topk: bool = False,
) -> NMSResult:
    """Greedy NMS over (..., P, 4) boxes / (..., P) scores, static output (..., top_k)."""
    if score_thresh > 0.0:
        scores = torch.where(scores >= score_thresh, scores, torch.zeros_like(scores))
    k = min(top_k, scores.shape[-1])
    vals, idx = _top_k(scores, k, approx_topk)
    lead = vals.shape[:-1]
    boxes = boxes.expand(*lead, *boxes.shape[-2:])
    cand = torch.gather(boxes, -2, idx.unsqueeze(-1).expand(*lead, k, 4))
    kept = suppress_sorted(
        cand.reshape(-1, k, 4), vals.reshape(-1, k).contiguous(), iou_thresh
    ).reshape(vals.shape)
    keep = kept > 0.0
    out_boxes = torch.where(keep[..., None], cand, torch.zeros_like(cand))
    if k < top_k:  # pad to the static contract
        pad = top_k - k
        kept = torch.nn.functional.pad(kept, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
    return NMSResult(kept, out_boxes, keep)


def class_aware_nms_cm(
    boxes: Tensor,
    scores_cm: Tensor,
    iou_thresh: float = 0.45,
    top_k: int = 200,
    score_thresh: float = 0.01,
    approx_topk: bool = False,
) -> Tensor:
    """Per-class NMS of CLASS-MAJOR scores: boxes (..., P, 4), scores_cm (..., C, P)
    with the background row zeroed. Returns (..., C, top_k, 5) rows
    [score, x1, y1, x2, y2], zero-padded."""
    r = nms_fixed(
        boxes.unsqueeze(-3), scores_cm, iou_thresh, top_k, score_thresh, approx_topk
    )
    return torch.cat([r.scores.unsqueeze(-1), r.boxes], dim=-1)


def class_aware_nms(
    boxes: Tensor,
    class_scores: Tensor,
    iou_thresh: float = 0.45,
    top_k: int = 200,
    score_thresh: float = 0.01,
    approx_topk: bool = False,
) -> Tensor:
    """Per-class NMS of (..., P, C) softmax scores (class 0 = background, its
    output rows stay empty). Returns (..., C, top_k, 5)."""
    num_classes = class_scores.shape[-1]
    cls_mask = torch.arange(num_classes, device=class_scores.device) > 0
    scores = torch.where(cls_mask, class_scores, torch.zeros_like(class_scores))
    return class_aware_nms_cm(
        boxes, scores.transpose(-1, -2), iou_thresh, top_k, score_thresh, approx_topk
    )


def flatten_detections(
    det: Tensor, top_k: int = 200, approx_topk: bool = False
) -> TopDetections:
    """(..., C, K, 5) per-class detections -> overall top-k (boxes, scores, classes)."""
    c, k = det.shape[-3], det.shape[-2]
    lead = det.shape[:-3]
    scores = det[..., 0].reshape(*lead, c * k)
    boxes = det[..., 1:].reshape(*lead, c * k, 4)
    classes = torch.arange(c, dtype=torch.int32, device=det.device).repeat_interleave(k)
    vals, idx = _top_k(scores, top_k, approx_topk)
    top_boxes = torch.gather(boxes, -2, idx.unsqueeze(-1).expand(*idx.shape, 4))
    top_classes = torch.where(vals > 0, classes[idx], torch.zeros_like(idx, dtype=torch.int32))
    return TopDetections(top_boxes, vals, top_classes)
