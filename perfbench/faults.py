"""Faults planted in the timed path, and the readings they give.

    python3 perfbench/faults.py --workload <name> --seeds 1 2 3 --seconds 3

Each fault breaks the program underneath a run (perfbench/run.py), which
is otherwise driven as the benchmark drives it; the run's output check has
to come out not correct. One JSON line a fault and seed, with the numbers
compared; ``sound`` is the run with no fault planted.

- ``state_unchanged``: the carried state is never written back;
- ``half_batch``: half of the streams' answers left out (zeroed);
- ``answer_altered``: one stream's boxes moved where they are produced;
- ``nms_off``: the per-class suppression (K2) keeps every candidate;
- ``prefilter_off``: the detect tail takes every anchor, not the
  prefilter's top-M (it changes no answer where the prefilter is exact).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _altered(alter):
    from tdrn_tpu_torch.inference import StreamingDetector

    detect = StreamingDetector.detect

    def broken(self, *args, **kwargs):
        out = detect(self, *args, **kwargs)
        return out._replace(**alter(out))

    return _patched(StreamingDetector, "detect", broken)


def state_unchanged():
    from tdrn_tpu_torch.inference import StreamingDetector

    return _patched(StreamingDetector, "_commit", lambda self, new_state: None)


def half_batch():
    import torch

    def alter(out):
        keep = (torch.arange(out.scores.shape[0]) < out.scores.shape[0] // 2).to(out.scores.device)
        return {"scores": out.scores * keep[:, None], "boxes": out.boxes * keep[:, None, None]}

    return _altered(alter)


def answer_altered():
    def alter(out):
        boxes = out.boxes.clone()
        boxes[0] += 0.1
        return {"boxes": boxes}

    return _altered(alter)


def nms_off():
    from tdrn_tpu_torch.ops import nms

    return _patched(nms, "suppress_sorted", lambda boxes, scores, iou_thresh=0.45: scores.clone())


def prefilter_off():
    from tdrn_tpu_torch.ops import detection

    return _patched(detection, "_prefilter_on", lambda cfg, num_anchors: False)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, nms_off,
                                  prefilter_off)}


def reading(cell, fault, seed: int, seconds: float, device="cuda") -> dict:
    """One run of ``cell`` with ``fault`` (a name of FAULTS, or ``sound``)
    planted: the numbers compared and whether the run came out correct."""
    from perfbench import run

    with (FAULTS[fault]() if fault != "sound" else contextlib.nullcontext()):
        res = run.run_cell(cell, seed, seconds, False, device=device)
    return {"fault": fault, "seed": seed, "correct": res["correct"], "checked": res["checked"]}


def main(argv=None) -> int:
    import torch

    from perfbench import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="+", default=["sound", *FAULTS])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench faults: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    for seed in args.seeds:
        for fault in args.faults:
            t0 = time.perf_counter()
            out = reading(cell, fault, seed, args.seconds)
            print(json.dumps({"workload": args.workload, **out,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
