"""Motion-speed breakdown for ImageNet VID evaluation (the port of
``tdrn_tpu/eval/motion.py``).

An object's *motion IoU* is the mean IoU between its box in the current
frame and the same track's boxes in nearby frames (a +/-10 window); objects
are **slow** (IoU > 0.9), **medium** (0.7-0.9) or **fast** (< 0.7).
Per-category mAP re-runs the evaluator with out-of-category GT marked
"difficult" (matched detections are neither TP nor FP, and the GT does not
count toward recall). A host-side computation on the annotations only.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tdrn_tpu_torch.data.vid import parse_vid_xml

MOTION_CATEGORIES = ("slow", "medium", "fast")


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / max(ua, 1e-12))


def motion_categories_for_snippet(
    frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    window: int = 10,
    slow_thr: float = 0.9,
    fast_thr: float = 0.7,
) -> List[np.ndarray]:
    """Per-object motion categories for one snippet.

    frames: ordered (boxes (N,4), track_ids (N,)) per frame.
    Returns one int8 array per frame, aligned with that frame's box order:
    0 = slow, 1 = medium, 2 = fast. An object whose track appears in no
    other frame of the window has no motion evidence and is binned slow.
    """
    track_boxes: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    for fi, (boxes, tracks) in enumerate(frames):
        for b, t in zip(boxes, tracks):
            track_boxes[int(t)][fi] = b

    out: List[np.ndarray] = []
    for fi, (boxes, tracks) in enumerate(frames):
        cats = np.zeros(len(boxes), np.int8)
        for oi, (b, t) in enumerate(zip(boxes, tracks)):
            tb = track_boxes[int(t)]
            ious = [
                _iou(b, tb[nf])
                for nf in range(fi - window, fi + window + 1)
                if nf != fi and nf in tb
            ]
            m = float(np.mean(ious)) if ious else 1.0
            cats[oi] = 0 if m > slow_thr else (2 if m < fast_thr else 1)
        out.append(cats)
    return out


def vid_motion_categories(
    root: str,
    split: str,
    snippets: Sequence[Tuple[str, Sequence[str]]],
    frame_ids: Optional[Iterable[str]] = None,
    window: int = 10,
) -> Dict[str, np.ndarray]:
    """Motion categories for every evaluated frame of a VID split.

    snippets: ``VIDDetection.snippets`` — (snippet-relative dir, [stems]).
    frame_ids: optional set of evaluated ``"{rel}/{stem}"`` ids; snippets
    with none of their frames evaluated are skipped (``--max_images`` runs).
    Box order per frame matches ``parse_vid_xml`` (= the eval GT order).
    """
    wanted = None if frame_ids is None else set(frame_ids)
    out: Dict[str, np.ndarray] = {}
    for rel, stems in snippets:
        if wanted is not None and not any(f"{rel}/{s}" in wanted for s in stems):
            continue
        per_frame = []
        for stem in stems:
            ann = os.path.join(root, "Annotations", "VID", split, rel, stem + ".xml")
            if os.path.exists(ann):
                boxes, _labels, tracks = parse_vid_xml(ann)
            else:
                boxes = np.zeros((0, 4), np.float32)
                tracks = np.zeros((0,), np.int32)
            per_frame.append((boxes, tracks))
        cats = motion_categories_for_snippet(per_frame, window=window)
        for stem, c in zip(stems, cats):
            img_id = f"{rel}/{stem}"
            if wanted is None or img_id in wanted:
                out[img_id] = c
    return out


def motion_gt_views(all_gt, categories: Dict[str, np.ndarray]):
    """Split eval GT into the three per-category views.

    all_gt: ``{img_id: (boxes, labels, difficult)}`` as fed to
    ``evaluate_detections``. Yields (category_name, gt_view) where the view
    marks every out-of-category object difficult (ignored), preserving the
    original difficult flags.
    """
    for ci, cname in enumerate(MOTION_CATEGORIES):
        view = {}
        for img_id, (boxes, labels, difficult) in all_gt.items():
            cats = categories.get(img_id)
            if cats is None or len(cats) != len(labels):
                cats = np.zeros(len(labels), np.int8)
            view[img_id] = (boxes, labels, difficult | (cats != ci))
        yield cname, view
