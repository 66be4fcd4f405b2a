"""Detection-collection runners for evaluation (the port of ``tdrn_tpu/eval/runner.py``).

Two runners produce the per-class detection dicts that ``voc_eval`` reads:

  * :func:`run_batched`: a batched single-image forward (VOC / VID-frame eval).
  * :func:`run_streaming`: temporal eval. Snippets are scheduled onto the S
    stream lanes of one StreamingDetector (one graph replay a step on the
    card); each lane carries its state on the device, resets at a snippet
    boundary and picks up the next snippet as soon as one finishes, so frame
    order within a snippet is kept.

The forward and the detector keep their weights, so no params argument is
passed as in the JAX runners.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

Array = np.ndarray
# per-class detections: class_idx -> img_id -> (boxes list, scores list)
DetAccum = Dict[int, Dict[str, Tuple[list, list]]]


def new_accum() -> DetAccum:
    return defaultdict(lambda: defaultdict(lambda: ([], [])))


def record(
    accum: DetAccum,
    img_id: str,
    hw: Tuple[int, int],
    boxes01: Array,
    scores: Array,
    classes: Array,
    score_thresh: float,
):
    h, w = hw
    keep = scores >= score_thresh
    b = boxes01[keep] * np.asarray([w, h, w, h], np.float32)
    s = scores[keep]
    c = classes[keep] - 1  # 0-based object classes
    for ci in np.unique(c):
        sel = c == ci
        bl, sl = accum[int(ci)][img_id]
        bl.extend(b[sel])
        sl.extend(s[sel])


def finalize(accum: DetAccum):
    return {
        ci: {k: (np.asarray(v[0], np.float32).reshape(-1, 4), np.asarray(v[1], np.float32))
             for k, v in d.items()}
        for ci, d in accum.items()
    }


def _host(det):
    """(boxes, scores, classes) of a TopDetections as numpy arrays."""
    return tuple(t.cpu().numpy() for t in (det.boxes, det.scores, det.classes))


def run_batched(
    forward: Callable,
    items: Sequence[Tuple[str, Tuple[int, int], Array]],
    batch_size: int,
    score_thresh: float = 0.01,
    progress_every: int = 20,
    device=None,
) -> DetAccum:
    """items: sequence of (img_id, (h, w), resized uint8 frame).
    forward: (B, H, W, 3) uint8 tensor -> TopDetections, e.g.
    ``make_single_image_forward(model)``; the batches go to ``device``
    (CUDA unless "cpu")."""
    from tdrn_tpu_torch import _build

    dev = _build.resolve_device(device)
    accum = new_accum()
    n = len(items)
    overflow = 0
    for start in range(0, n, batch_size):
        chunk = items[start : start + batch_size]
        batch = np.stack([f for _, _, f in chunk]).astype(np.uint8)
        if len(batch) < batch_size:
            pad = np.zeros((batch_size - len(batch),) + batch.shape[1:], np.uint8)
            batch = np.concatenate([batch, pad])
        det = forward(torch.from_numpy(batch).to(dev))
        boxes, scores, classes = _host(det)
        if det.prefilter_overflow is not None:
            overflow += int(det.prefilter_overflow[: len(chunk)].sum())
        for bi, (img_id, hw, _) in enumerate(chunk):
            record(accum, img_id, hw, boxes[bi], scores[bi], classes[bi], score_thresh)
        if progress_every and (start // batch_size) % progress_every == 0:
            print(f"{min(start + batch_size, n)}/{n} images", flush=True)
    if overflow:
        # On these frames the anchor prefilter's exactness precondition
        # failed (ops/detection.prefilter_overflow), so APs may deviate from
        # the exact path.
        print(f"prefilter overflow on {overflow}/{n} images", flush=True)
    return accum


def run_streaming(
    detector,
    snippets: Sequence[Sequence[Tuple[str, Tuple[int, int], Array]]],
    score_thresh: float = 0.01,
    progress_every: int = 200,
) -> DetAccum:
    """Temporal eval with continuous batching.

    detector: a StreamingDetector with S lanes.
    snippets: list of snippets; each is an ordered list of
        (img_id, (h, w), resized uint8 frame).
    """
    s_lanes = detector.num_streams
    size = detector.cfg.size
    accum = new_accum()
    todo = list(range(len(snippets)))
    lane_snip: List[int] = [-1] * s_lanes  # snippet index per lane
    lane_pos: List[int] = [0] * s_lanes
    frames = np.zeros((s_lanes, size, size, 3), np.uint8)
    done_frames = 0

    def assign(lane: int) -> bool:
        if not todo:
            lane_snip[lane] = -1
            return False
        lane_snip[lane] = todo.pop(0)
        lane_pos[lane] = 0
        detector.reset([lane])
        return True

    for lane in range(s_lanes):
        assign(lane)

    while any(s >= 0 for s in lane_snip):
        active = []
        active_mask = np.zeros((s_lanes,), np.float32)
        for lane in range(s_lanes):
            si = lane_snip[lane]
            if si < 0:
                continue
            img_id, hw, frame = snippets[si][lane_pos[lane]]
            frames[lane] = frame
            active.append((lane, img_id, hw))
            active_mask[lane] = 1.0
        # Drained lanes are masked inactive so their temporal state freezes
        # instead of advancing on stale frames (their outputs are ignored).
        boxes, scores, classes = _host(detector.detect(frames, active=active_mask))
        for lane, img_id, hw in active:
            record(accum, img_id, hw, boxes[lane], scores[lane], classes[lane], score_thresh)
            done_frames += 1
            lane_pos[lane] += 1
            if lane_pos[lane] >= len(snippets[lane_snip[lane]]):
                assign(lane)  # snippet finished: slot in the next one
        if progress_every and done_frames % progress_every < s_lanes:
            print(f"{done_frames} frames", flush=True)
    return accum
