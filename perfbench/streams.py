"""Video streams and the check of their detections against the reference.

A stream (a recorded video on a lane of a clip run) plays frames
0, 1, 2, ... of its own; frame i of stream l is ``pool[i % per_lane, l]``.
Its temporal state starts from zero at frame 0 and at every snippet start:
frame i starts a snippet where ``(i + offset(l)) % snippet == 0``, the
offsets staggered over the streams when the traffic asks for it.

The check: after the window, for every stream, the latest snippet whose
frames all came back (or, in a short run, the one in progress) is replayed
by the reference from its first frame. A few streams drawn from the seed
are replayed to the snippet's end and checked at its first frames, its last
and positions drawn from the seed; the others are replayed and checked at
their first ``shallow_depth`` frames. Three numbers are taken, each the
largest over the checked frames; a cell's limits file names those it
compares. Each served detection (score > 0) is first put to its anchor:
the reference's anchor in that frame at the least distance, the larger of
the box's largest coordinate error and the score's error against the
reference's softmax score of that anchor in that class (before the ARM's
background filter, whose threshold rounding may cross), over the frame's
largest such score. A frame served nothing where the reference keeps
detections reads 1 in each.

``frame_gap``, the frame's answer to the model (preprocess, backbone, TCB,
  carry, heads, decode): the mean of those distances. The largest single
  detection's swings with rounding far more than the mean (PERF.md).
``selection_miss``, the detect tail's choice as a whole (prefilter,
  per-class NMS, top-k): one minus the share of the (class, anchor) pairs
  the reference's own detect tail keeps that were served, over the larger
  of the two counts; a pair served twice counts as a miss.
``nms_overlap``, the suppression: the share of the served detections that
  the reference's greedy NMS, run over them class by class in score order,
  would suppress (an overlap over the threshold by more than the rounding
  of an IoU). A sound run reads 0; so does the control, whose suppression
  is the reference's own.

Near-ties swap a share of the detections in sound runs (at the top-k's cut,
the suppression's threshold and the prefilter's cut); PERF.md gives each
limit with the readings of sound runs and of the control it sits between,
and why ``selection_miss`` is not compared where the two lie too close.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import detect as ref_detect
from perfbench.reference import reference

Result = Tuple[np.ndarray, np.ndarray, np.ndarray]  # boxes (K, 4), scores (K,), classes (K,)
# Two detections the program's suppression kept may overlap by up to this
# much over the threshold: the same IoU computed in another order.
NMS_ROUNDING = 1e-4


class Streams:
    """The traffic's streams: which frame each plays, and where it resets."""

    def __init__(self, pool: np.ndarray, snippet: int, stagger: bool):
        self.pool = pool
        self.per_lane, self.lanes = pool.shape[:2]
        self.snippet = int(snippet)
        self.offsets = [(l * self.snippet) // self.lanes if stagger else 0
                        for l in range(self.lanes)]

    def frame(self, lane: int, i: int) -> np.ndarray:
        return self.pool[i % self.per_lane, lane]

    def starts_snippet(self, lane: int, i: int) -> bool:
        return i == 0 or (i + self.offsets[lane]) % self.snippet == 0

    def snippet_start(self, lane: int, i: int) -> int:
        return max(0, i - (i + self.offsets[lane]) % self.snippet)


class Ring:
    """The last ``keep`` results of each stream, by frame index, in arrays
    allocated once: keeping a result allocates no object."""

    def __init__(self, lanes: int, keep: int, top_k: int):
        self.keep = keep
        self.index = np.full((lanes, keep), -1, np.int64)
        self.arrays = (np.zeros((lanes, keep, top_k, 4), np.float32),
                       np.zeros((lanes, keep, top_k), np.float32),
                       np.zeros((lanes, keep, top_k), np.int32))
        self.last = [-1] * lanes

    def put(self, lane: int, i: int, result) -> None:
        slot = i % self.keep
        if result is not None:
            for buf, a in zip(self.arrays, result):
                buf[lane, slot] = a
        self.index[lane, slot] = i
        self.last[lane] = max(self.last[lane], i)

    def has(self, lane: int, i: int) -> bool:
        return bool(self.index[lane, i % self.keep] == i)

    def get(self, lane: int, i: int) -> Result:
        if not self.has(lane, i):
            raise KeyError((lane, i))
        return tuple(buf[lane, i % self.keep] for buf in self.arrays)


def checked_snippets(streams: Streams, ring: Ring) -> List[Tuple[int, int, int]]:
    """(lane, first frame, frames) of the snippet checked on each stream."""
    out = []
    for lane in range(streams.lanes):
        n = ring.last[lane]
        if n < 0:
            raise RuntimeError(f"stream {lane} returned no frame in the window")
        cur = streams.snippet_start(lane, n)
        start, end = cur, n
        if cur > 0:
            prev = streams.snippet_start(lane, cur - 1)
            if all(ring.has(lane, i) for i in range(prev, cur)):
                start, end = prev, cur - 1
        out.append((lane, start, end - start + 1))
    return out


def plan(streams: Streams, ring: Ring, traffic: dict, seed: int):
    """The replay: lanes ordered deep first, the depth each is replayed to,
    and the positions checked on each."""
    rng = np.random.default_rng(int(seed) + 7)
    snippets = checked_snippets(streams, ring)
    deep = set(rng.choice(streams.lanes, size=min(int(traffic["deep_lanes"]), streams.lanes),
                          replace=False).tolist())
    order = sorted(snippets, key=lambda s: (s[0] not in deep, s[0]))
    shallow = int(traffic["shallow_depth"])
    lanes = []
    for lane, start, length in order:
        if lane in deep:
            depth = length
            extra = rng.choice(length, size=min(int(traffic["deep_checks"]), length), replace=False)
            checks = sorted(set(extra.tolist()) | {0, 1, length - 1} & set(range(length)))
        else:
            depth = min(shallow, length)
            checks = list(range(depth))
        lanes.append((lane, start, depth, checks))
    return sorted(lanes, key=lambda t: -t[2])  # deepest first: replay() drops lanes from the end


@torch.no_grad()
def replay(cfg: dict, weights, streams: Streams, lanes, device, lowp=None,
           batch: int = 16) -> Dict[Tuple[int, int], dict]:
    """The reference over each lane's checked snippet. Returns, by (lane,
    frame index), the reference's anchors (boxes, scores) and detections at
    each checked position."""
    ref_model = reference(cfg)
    anchors = ref_detect.priors(cfg, device)
    out = {}
    for g in range(0, len(lanes), batch):
        group = lanes[g:g + batch]
        state = ref_model.zero_state(cfg, len(group), device)
        for pos in range(max(depth for _, _, depth, _ in group)):
            live = [k for k, (_, _, depth, _) in enumerate(group) if depth > pos]
            if len(live) < len(state[0]):  # lanes sorted by depth within a group
                state = [s[:len(live)] for s in state]
            frames = np.stack([streams.frame(group[k][0], group[k][1] + pos) for k in live])
            x = ref_model.preprocess(cfg, torch.from_numpy(frames).to(device))
            preds, state = ref_model.forward(cfg, weights, x, state, lowp)
            want = [k for k in live if pos in group[k][3]]
            if not want:
                continue
            boxes, scores, unfiltered = ref_detect.decode(cfg, [t[want] for t in preds], anchors)
            top = ref_detect.detect(cfg, boxes, scores)
            for j, k in enumerate(want):
                lane, start = group[k][0], group[k][1]
                out[(lane, start + pos)] = dict(boxes=boxes[j], scores=unfiltered[j],
                                               top=tuple(t[j] for t in top),
                                               nms_thresh=cfg["nms_thresh"])
    return out


NUMBERS = ("frame_gap", "selection_miss", "nms_overlap")


def frame_numbers(served: Result, ref: dict) -> Dict[str, float]:
    """The numbers of one frame (module doc)."""
    boxes, scores, classes = (torch.as_tensor(np.asarray(a)) for a in served)
    dev = ref["scores"].device
    boxes, scores, classes = boxes.to(dev).float(), scores.to(dev).float(), classes.to(dev).long()
    live = scores > 0
    ref_classes, ref_anchors = ref["top"][2], ref["top"][3]
    ref_live = ref["top"][1] > 0
    n = max(int(live.sum()), int(ref_live.sum()))
    if not bool(live.any()):
        return dict.fromkeys(NUMBERS, float(n > 0))
    smax = ref["scores"].max().clamp(min=1e-12)
    b, s, c = boxes[live], scores[live], classes[live]
    box_err = (b[:, None, :] - ref["boxes"][None, :, :]).abs().amax(-1)  # (n, P)
    score_err = (s[:, None] - ref["scores"][:, c].T).abs() / smax
    err, anchor = torch.maximum(box_err, score_err).min(-1)
    p = ref["boxes"].shape[0]
    mine = torch.unique(c * p + anchor)
    theirs = ref_classes[ref_live].long() * p + ref_anchors[ref_live]
    # The reference's suppression over the served detections, classes set
    # apart so that boxes of two classes never overlap.
    kept = ref_detect.greedy_nms(b + (4 * c).float()[:, None], s,
                                 float(ref["nms_thresh"]) + NMS_ROUNDING)
    return {
        "frame_gap": float(err.mean()),
        "selection_miss": 1.0 - int(torch.isin(mine, theirs).sum()) / n,
        "nms_overlap": float((kept == 0).sum()) / n,
    }


def compare(results: Dict[Tuple[int, int], Result], refs: Dict[Tuple[int, int], dict]) -> dict:
    """The numbers over every checked frame: the largest of each."""
    missing = [k for k in refs if k not in results]
    if missing:
        raise RuntimeError(f"{len(missing)} checked frames never came back, e.g. {missing[:3]}")
    frames = [frame_numbers(results[key], ref) for key, ref in refs.items()]
    out = {k: max(f[k] for f in frames) for k in NUMBERS}
    out["frames_checked"] = len(frames)
    return out


def reference_results(refs: Dict[Tuple[int, int], dict]) -> Dict[Tuple[int, int], Result]:
    """The reference's own detections, in the served form (the control)."""
    return {k: tuple(t.cpu().numpy() for t in v["top"][:3]) for k, v in refs.items()}


def check(cfg, weights, streams: Streams, ring: Ring, traffic: dict, seed: int, device,
          lowp=None) -> dict:
    """Replay and compare: the numbers of the output check."""
    t0 = time.perf_counter()
    lanes = plan(streams, ring, traffic, seed)
    refs = replay(cfg, weights, streams, lanes, device)
    if lowp is None:
        results = {key: ring.get(*key) for key in refs if ring.has(*key)}
    else:  # the control: the reference at lower precision in the program's place
        results = reference_results(replay(cfg, weights, streams, lanes, device, lowp))
    out = compare(results, refs)
    out["check_s"] = time.perf_counter() - t0
    return out


def served_form(top) -> List[Result]:
    """A step's detections on the host, (boxes, scores, classes) a lane."""
    boxes, scores, classes = (np.asarray(t) for t in top[:3])
    return [(boxes[l], scores[l], classes[l]) for l in range(boxes.shape[0])]
