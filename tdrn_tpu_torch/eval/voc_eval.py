"""VOC-protocol mAP evaluation (the port's copy of ``tdrn_tpu/eval/voc_eval.py``).

Per-class PR curves from score-ranked detections, greedy one-to-one GT
matching at IoU 0.5, difficult-box exclusion, and both AP metrics: the VOC07
11-point interpolation and the continuous (area-under-PR) variant. Pure
numpy on the host, a post-pass over detections already computed on the
device. ``write_voc_results_files`` writes the per-class text files of the
reference's tooling.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

# Ground truth for one image: boxes (N,4) pixel xyxy, labels (N,), difficult (N,)
GtDict = Mapping[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
# Detections for one class: image_id -> (boxes (M,4), scores (M,))
DetDict = Mapping[str, Tuple[np.ndarray, np.ndarray]]


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = True) -> float:
    """AP from a PR curve. 07 metric: mean precision at 11 recall points."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    # continuous: envelope + area under curve
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-12)


def eval_class(
    gt_by_image: Dict[str, Tuple[np.ndarray, np.ndarray]],
    detections: DetDict,
    iou_thresh: float = 0.5,
    use_07_metric: bool = True,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """AP for one class.

    gt_by_image: image_id -> (boxes (N,4), difficult (N,) bool) for this class.
    detections: image_id -> (boxes, scores).
    """
    npos = sum(int((~d).sum()) for _, d in gt_by_image.values())
    matched = {k: np.zeros(len(b), bool) for k, (b, _) in gt_by_image.items()}

    # Flatten detections, rank by score descending.
    recs: List[Tuple[str, float, np.ndarray]] = []
    for img_id, (boxes, scores) in detections.items():
        for i in range(len(scores)):
            recs.append((img_id, float(scores[i]), boxes[i]))
    recs.sort(key=lambda r: -r[1])

    tp = np.zeros(len(recs))
    fp = np.zeros(len(recs))
    for i, (img_id, _, box) in enumerate(recs):
        gts = gt_by_image.get(img_id)
        if gts is None or len(gts[0]) == 0:
            fp[i] = 1.0
            continue
        gboxes, difficult = gts
        ious = _iou_one_to_many(box, gboxes)
        j = int(ious.argmax())
        if ious[j] > iou_thresh:
            if difficult[j]:
                continue  # difficult GT: detection ignored
            if not matched[img_id][j]:
                matched[img_id][j] = True
                tp[i] = 1.0
            else:
                fp[i] = 1.0  # duplicate detection of a matched GT
        else:
            fp[i] = 1.0

    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / max(npos, 1)
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    return voc_ap(recall, precision, use_07_metric), recall, precision


def evaluate_detections(
    all_gt: GtDict,
    all_dets: Mapping[int, DetDict],
    class_names: Sequence[str],
    iou_thresh: float = 0.5,
    use_07_metric: bool = True,
    skip_empty_classes: bool = False,
) -> Dict[str, float]:
    """Full mAP. all_dets: class_index (0-based object class) -> DetDict.

    skip_empty_classes: average mAP only over classes with at least one
    non-difficult GT box (classes with none get ``AP = nan``). Used by the
    VID motion-speed breakdown, where a bin may contain no instances of some
    classes — the protocol averages over the populated ones.
    """
    aps = {}
    for ci, cname in enumerate(class_names):
        gt_c = {}
        npos = 0
        for img_id, (boxes, labels, difficult) in all_gt.items():
            sel = labels == ci
            gt_c[img_id] = (boxes[sel], difficult[sel])
            npos += int((~difficult[sel]).sum())
        if skip_empty_classes and npos == 0:
            aps[cname] = float("nan")
            continue
        ap, _, _ = eval_class(gt_c, all_dets.get(ci, {}), iou_thresh, use_07_metric)
        aps[cname] = ap
    vals = [aps[c] for c in class_names if not np.isnan(aps[c])]
    aps["mAP"] = float(np.mean(vals)) if vals else float("nan")
    return aps


def write_voc_results_files(
    out_dir: str, all_dets: Mapping[int, DetDict], class_names: Sequence[str]
):
    """Reference-compatible per-class results files (comp_det_test_<cls>.txt)."""
    os.makedirs(out_dir, exist_ok=True)
    for ci, cname in enumerate(class_names):
        path = os.path.join(out_dir, f"comp4_det_test_{cname}.txt")
        with open(path, "w") as f:
            for img_id, (boxes, scores) in all_dets.get(ci, {}).items():
                for i in range(len(scores)):
                    x1, y1, x2, y2 = boxes[i]
                    # VOC results format is 1-based pixel coords
                    f.write(
                        f"{img_id} {scores[i]:.6f} {x1 + 1:.1f} {y1 + 1:.1f} "
                        f"{x2 + 1:.1f} {y2 + 1:.1f}\n"
                    )
