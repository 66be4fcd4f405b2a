#!/usr/bin/env python3
"""Time the port's streaming paths and its server from two checkouts, in turns
on one card: A, B, B, A, each run in a fresh process.

    python3 chip_compare.py DIR_A DIR_B
    python3 chip_compare.py --int8 DIR_A DIR_B

DIR_A and DIR_B are checkouts of this repository, for example this one and a
`git archive` of its parent unpacked under build/. Each run builds that
checkout's kernels and measures it with this checkout's chip_smoke.py helpers,
the same seeded random weights and the same frames:
- the fp32 step (fused stem, S=16, 480x640 frames, cuDNN TF32 on) and the bf16
  serving step (fused2, bf16, prefilter 512, 320x320 frames) with
  chip_smoke.time_streaming: the median step time over 20 steps, each ending
  in a synchronize, and the median host time of the detect() call alone,
  before that synchronize (the enqueue);
- InferenceServer with 16 concurrent clients x 16 frames: frames/s, frames a
  step, p50/p99 request latency;
- K1 and K2 alone at the main path's shapes (B=16; 496 rows of 200), on the
  same seeded inputs in every run, with this checkout's chip_smoke.time_ms,
  so that a kernel of either checkout is timed the same way.
With --int8 each run times the int8 serving profile instead: VID_320 with
the conv stem, fused cascade and ConvGRU, resident bf16 then int8 with tcb
and gru (chip_smoke.int8_model: calibrated on 8 seeded frames, 37 QConvs),
S=16, prefilter 512, 320x320 frames: the graphed step and its host time, and
the same model's bf16 step beside it.
It prints the card line, one JSON line a run, and last the medians of each
checkout's two runs. It checks nothing: chip_smoke.py does.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This checkout's chip_smoke.py, loaded under another name so that the
    checkout under test keeps its own."""
    spec = importlib.util.spec_from_file_location("smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(torch, smoke) -> dict:
    """Median device ms of K1 and K2 of the checkout under test."""
    import numpy as np

    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
    from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
    from tdrn_tpu_torch.ops.priors import prior_boxes

    cfg = VID_320
    rng = np.random.default_rng(smoke.SEED)
    preds = smoke._cascade_inputs(torch, rng, smoke.B, cfg.num_priors, cfg.num_classes)
    priors = prior_boxes(cfg, torch.device("cuda"))
    boxes, scores = smoke._nms_rows(rng, smoke.B * cfg.num_classes, cfg.top_k)
    boxes, scores = torch.tensor(boxes, device="cuda"), torch.tensor(scores, device="cuda")
    return dict(
        k1_ms=smoke.time_ms(torch, lambda: fused_refine_cascade(preds, priors, cfg)),
        k2_ms=smoke.time_ms(torch, lambda: suppress_sorted(boxes, scores, cfg.nms_thresh)),
    )


def int8_times(torch, smoke) -> dict:
    """The VID_320 int8 step and its bf16 twin of the checkout under test."""
    from tdrn_tpu_torch.config import VID_320

    bf16, model8, _ = smoke.int8_model(torch, dataclasses.replace(VID_320, fused_cascade=True))
    out = {}
    _, _, out["int8_step_ms"], out["int8_host_ms"] = smoke.time_streaming(
        torch, model8, hw=(320, 320), prefilter=512)
    _, _, out["bf16_twin_step_ms"], out["bf16_twin_host_ms"] = smoke.time_streaming(
        torch, bf16, hw=(320, 320), prefilter=512)
    return out


def worker(root: str, int8: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import tdrn_tpu_torch
    from tdrn_tpu_torch import _build
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.models.detector import build_detector

    if not os.path.abspath(tdrn_tpu_torch.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"tdrn_tpu_torch did not come from {root}")
    smoke = _smoke()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    _build.build_all()
    if int8:
        return {"root": root, **int8_times(torch, smoke)}
    out = {"root": root, **kernel_times(torch, smoke)}
    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    fp32 = smoke.random_params(build_detector(cfg, stem="fused"), smoke.SEED)
    _, _, out["fp32_step_ms"], out["fp32_host_ms"] = smoke.time_streaming(torch, fp32)
    del fp32
    model16 = smoke.serving_model(torch)
    _, _, out["bf16_step_ms"], out["bf16_host_ms"] = smoke.time_streaming(
        torch, model16, hw=(320, 320), prefilter=512)
    fps, steps, lat = smoke.time_server(torch, model16)
    out.update(server_fps=fps, server_frames_a_step=16 * 16 / steps,
               server_p50_ms=lat["p50_ms"], server_p99_ms=lat["p99_ms"])
    return out


def main() -> int:
    args = sys.argv[1:]
    int8 = "--int8" in args
    args = [a for a in args if a != "--int8"]
    if args[:1] == ["--worker"]:
        print(json.dumps(worker(args[1], int8)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(args) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    a, b = args
    print(_smoke().card_line(), flush=True)
    runs = []
    for root in (a, b, b, a):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root] + (["--int8"] if int8 else [])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in runs[0] if k != "root"]
    print(json.dumps({root: {k: statistics.median(r[k] for r in runs if r["root"] == root)
                             for k in keys} for root in (a, b)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
