"""Profiling entry point (CLI) of the PyTorch / CUDA port: the counterpart of ``profile_trace.py``.

Times the streaming step (wall clock, each window fenced on the card) and
captures a ``torch.profiler`` trace of it: ``<out>/trace.json`` (Perfetto or
chrome://tracing) and ``<out>/kernels.txt``, the device time by kernel.
The weights are a seeded random draw (weights.load_random_params).

Example:
    python profile_trace_torch.py --out chiprun_out/tdrn_trace --frames 20
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tdrn_tpu_torch import weights
from tdrn_tpu_torch.config import get_config
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.utils.logging import TRACE_FILE, Timer, profile_trace
from tdrn_tpu_torch.utils.precision import apply_inference_precision
from tdrn_tpu_torch.utils.quantize import apply_int8_backbone

KERNELS_FILE = "kernels.txt"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Capture a profiler trace of streaming inference "
                                             "(PyTorch / CUDA port)")
    ap.add_argument("--config", default="vid_320")
    ap.add_argument("--backbone", default="vgg16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stem", default="conv", choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"])
    ap.add_argument("--cell", default="convgru", choices=["convgru", "light", "hybrid"])
    ap.add_argument("--prefilter", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 PTQ backbone (random-frame calibration — "
                         "timing-representative, not serving-representative)")
    ap.add_argument("--int8_tcb", action="store_true")
    ap.add_argument("--int8_gru", action="store_true")
    ap.add_argument("--bf16_weights", action="store_true",
                    help="resident-bf16 serving profile (utils/precision.py)")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/tdrn_trace")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)
    if (args.int8_tcb or args.int8_gru) and not args.int8:
        # Silently ignoring the sub-flags would mislabel the trace.
        ap.error("--int8_tcb/--int8_gru require --int8")
    return args


def main(argv=None):
    """Returns the Timer's stage times (seconds)."""
    args = parse_args(argv)
    cfg = get_config(args.config)
    model = build_detector(cfg, backbone=args.backbone, temporal=True, stem=args.stem,
                           temporal_cell=args.cell, device=args.device)
    weights.load_random_params(model, 0)
    device = next(model.parameters()).device
    if args.bf16_weights:
        model = apply_inference_precision(model, "bf16")
    if args.int8:
        calib = torch.from_numpy(np.random.RandomState(1).randint(
            0, 255, (min(args.batch, 8), cfg.size, cfg.size, 3), dtype=np.uint8)).to(device)
        model = apply_int8_backbone(
            model, preprocess_batch(calib, cfg, model.dtype, model.fold_mean),
            tcb=args.int8_tcb, gru=args.int8_gru,
        )
    det = StreamingDetector(model, num_streams=args.batch, prefilter=args.prefilter or None,
                            chunk=args.chunk, device=device)
    shape = (args.batch, cfg.size, cfg.size, 3)
    if args.chunk > 1:
        shape = (args.chunk,) + shape
    frames = torch.from_numpy(
        np.random.RandomState(0).randint(0, 255, shape, dtype=np.uint8)
    ).to(device)

    timer = Timer()
    with timer.time("first_step", fence=device):  # kernel builds, graph capture
        det.detect(frames)
    with timer.time("warm_steps", fence=device):
        for _ in range(args.frames):
            det.detect(frames)
    per = timer.times["warm_steps"] / args.frames
    print(f"first step (build + capture): {timer.times['first_step'] * 1e3:.1f} ms")
    print(f"steady-state: {per * 1e3:.2f} ms/step ({args.batch * args.chunk / per:.0f} frames/s) "
          f"on {device}")

    with profile_trace(args.out) as prof, timer.time("traced_steps", fence=device):
        for _ in range(args.frames):
            det.detect(frames)
    sort = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=sort, row_limit=40)
    with open(os.path.join(args.out, KERNELS_FILE), "w") as f:
        f.write(table + "\n")
    print(f"trace written to {os.path.join(args.out, TRACE_FILE)} "
          f"({args.frames} steps; table in {KERNELS_FILE})")
    print("stage times: " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timer.times.items()))
    return timer.times


if __name__ == "__main__":
    main()
