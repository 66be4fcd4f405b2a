"""The plain reference of the detect tail: two-stage decode, ARM filter,
image-wide anchor prefilter, per-class greedy NMS and the overall top-k.

Float32 tensor operations only; the NMS is the sequential greedy sweep
written as a fixpoint (``keep <- candidate & ~(keep @ S)``), which any
greedy order reaches. Imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def priors(cfg, device) -> Tensor:
    """(P, 4) anchors in centre form, row-major cells, [s, s] then each aspect
    ratio's pair, clipped to [0, 1]."""
    out = []
    for k, f in enumerate(cfg["feature_maps"]):
        step, s = cfg["steps"][k], cfg["min_sizes"][k] / cfg["size"]
        ij = torch.arange(f, dtype=torch.float32)
        cy, cx = torch.meshgrid(ij, ij, indexing="ij")
        centers = torch.stack([(cx + 0.5) * step / cfg["size"],
                               (cy + 0.5) * step / cfg["size"]], -1).reshape(-1, 2)
        whs = [(s, s)]
        for r in cfg["aspect_ratios"][k]:
            rt = float(r) ** 0.5
            whs += [(s * rt, s / rt), (s / rt, s * rt)]
        whs = torch.tensor(whs, dtype=torch.float32)
        a = len(whs)
        out.append(torch.cat([centers.repeat_interleave(a, 0), whs.repeat(f * f, 1)], -1))
    return torch.cat(out).clamp(0.0, 1.0).to(device)


def decode(cfg, preds, anchors: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Raw predictions -> (boxes (B, P, 4) xyxy, scores (B, P, C), the same
    scores unfiltered): ODM offsets decoded against the ARM-refined anchors;
    softmax class scores with the background column set to 0 and, in the
    first, the anchors the ARM calls background (probability above
    ``arm_filter_thresh``) too."""
    arm_loc, arm_conf, odm_loc, odm_conf = preds
    v0, v1 = cfg["variance"]
    cxy = anchors[..., :2] + arm_loc[..., :2] * v0 * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(arm_loc[..., 2:] * v1)
    cxy = cxy + odm_loc[..., :2] * v0 * wh
    wh = wh * torch.exp(odm_loc[..., 2:] * v1)
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1)
    unfiltered = torch.softmax(odm_conf, -1)
    unfiltered[..., 0] = 0.0
    background = torch.softmax(arm_conf, -1)[..., 0] > cfg["arm_filter_thresh"]
    return boxes, torch.where(background[..., None], 0.0, unfiltered), unfiltered


def _iou(a: Tensor, b: Tensor) -> Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[..., 2] - x[..., 0]).clamp(min=0) * (x[..., 3] - x[..., 1]).clamp(min=0)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def greedy_nms(boxes: Tensor, scores: Tensor, thresh: float) -> Tensor:
    """boxes (..., K, 4) and scores (..., K) sorted by descending score (0 =
    empty) -> the scores with suppressed entries set to 0."""
    k = scores.shape[-1]
    rank = torch.arange(k, device=scores.device)
    sup = ((_iou(boxes, boxes) > thresh) & (rank[:, None] < rank[None, :])).float()
    cand = scores > 0
    keep = cand
    for _ in range(k + 1):
        new = cand & ~((keep.float().unsqueeze(-2) @ sup).squeeze(-2) > 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.where(keep, scores, 0.0)


def detect(cfg, boxes: Tensor, scores: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(B, P, 4) boxes and (B, P, C) scores -> the top-k detections of each
    frame: boxes (B, K, 4), scores (B, K), classes (B, K) (0 where empty)
    and the anchor each came from (B, K) (-1 where empty)."""
    m, top_k = int(cfg["prefilter_anchors"]), int(cfg["top_k"])
    anchor = torch.arange(boxes.shape[1], device=boxes.device).expand(boxes.shape[:2])
    if 0 < m < boxes.shape[1]:  # keep the M anchors with the highest class score
        idx = torch.sort(scores.amax(-1), dim=-1, descending=True, stable=True)[1][:, :m]
        boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(scores, 1, idx[..., None].expand(-1, -1, scores.shape[-1]))
        anchor = idx
    scores_cm = scores.transpose(1, 2)  # (B, C, P)
    scores_cm = torch.where(scores_cm >= cfg["conf_thresh"], scores_cm, 0.0)
    k = min(top_k, scores_cm.shape[-1])
    vals, idx = torch.sort(scores_cm, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    cand = torch.gather(boxes[:, None].expand(-1, scores_cm.shape[1], -1, -1), 2,
                        idx[..., None].expand(*idx.shape, 4))
    kept = greedy_nms(cand, vals, cfg["nms_thresh"])  # (B, C, k)
    b, c = kept.shape[:2]
    flat = kept.reshape(b, c * k)
    top, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, order = top[:, :top_k], order[:, :top_k]
    out_boxes = torch.gather(cand.reshape(b, c * k, 4), 1, order[..., None].expand(-1, -1, 4))
    classes = torch.where(top > 0, order // k, 0)
    cand_anchor = torch.gather(anchor[:, None].expand(-1, c, -1), 2, idx).reshape(b, c * k)
    anchors = torch.where(top > 0, torch.gather(cand_anchor, 1, order), -1)
    return out_boxes, top, classes, anchors
