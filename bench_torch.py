"""Benchmark of the PyTorch / CUDA port: streaming TDRN per-frame inference
on one NVIDIA GPU (the port's counterpart of ``bench.py``): VGG-16 or
ResNet-101, at 320 (vid_320) or 512 (vid_512).

    python3 bench_torch.py                        # vid_320, 16 streams, bf16 weights
    python3 bench_torch.py --stem fused2 --frames 200
    python3 bench_torch.py --backbone resnet101 --config vid_512 --fused_cascade
    python3 bench_torch.py --device cpu --config tiny_64 --frames 2   # CPU smoke only

Prints ONE JSON line with bench.py's fields: {"metric", "value", "unit",
"vs_baseline", "p50_roundtrip_latency_ms", "step_ms", "batch", "dtype",
"bf16_weights", "int8", "backbone", "stem", "cell", "prefilter", "device"}.
``device`` is the card's name and power limit as nvidia-smi reports them.

  * throughput: ``--frames`` streaming steps, each a replay of the step's
    CUDA graph (StreamingDetector), timed by CUDA events around the whole
    loop; the carried state chains the steps, so step_ms is the card's time
    a step including any wait for the host.
  * latency: a separate loop of full round trips, each step's detections
    copied to the host, on the host clock.

The frames are one seeded uint8 batch of the config's size already on the
card, and the weights a seeded random draw (weights.load_random_params).
Metric: frames/s for streaming video at the config's size (320x320 for
vid_320, 512x512 for vid_512); vs_baseline = frames/s / 20, the reference
TDRN's real-time claim on a 1080Ti-class GPU. ``--approx_topk`` and
``--prefilter_recall`` set the detect tail's selection options, which the
port meets with its exact selection. On ``--device cpu`` the same loops run
eagerly on the host clock; those numbers are the CPU's, not a card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from tdrn_tpu_torch import weights
from tdrn_tpu_torch.config import get_config
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.utils.precision import apply_inference_precision

BASELINE_FPS = 20.0  # reference TDRN real-time claim

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16, help="concurrent streams")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--config", default="vid_320", help="detector config name")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--stem", default="conv",
                    choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"])
    ap.add_argument("--cell", default="convgru", choices=["convgru", "light", "hybrid"])
    ap.add_argument("--prefilter", type=int, default=512,
                    help="anchor cap before the per-class NMS (0 = exact Detect)")
    ap.add_argument("--fused_cascade", action="store_true",
                    help="the K1 ARM->ODM cascade kernel (ops/cascade.py)")
    add_selection_args(ap)
    ap.add_argument("--bf16_weights", action=argparse.BooleanOptionalAction, default=True,
                    help="resident-bf16 feature-pyramid weights and carry, fp32 heads "
                         "and detect (utils/precision.py); --no-bf16_weights: fp32")
    ap.add_argument("--int8", action="store_true", help="not ported (ROADMAP.md)")
    ap.add_argument("--int8_tcb", action="store_true", help="not ported (ROADMAP.md)")
    ap.add_argument("--int8_gru", action="store_true", help="not ported (ROADMAP.md)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the plain versions eagerly, for tests only")
    args = ap.parse_args(argv)
    refuse_unported(ap, args)
    return args


def add_selection_args(ap):
    """The detect tail's selection options (config.py)."""
    ap.add_argument("--approx_topk", action=argparse.BooleanOptionalAction, default=None,
                    help="cfg.approx_topk (the port selects exactly either way)")
    ap.add_argument("--prefilter_recall", type=float, default=None,
                    help="cfg.prefilter_recall of the prefilter's selection (exact in the port)")


def refuse_unported(ap, args):
    """Exit with an error naming ROADMAP.md on an option the port lacks."""
    if args.int8 or args.int8_tcb or args.int8_gru:
        ap.error("--int8, --int8_tcb and --int8_gru are not ported yet (ROADMAP.md, queue 1)")


def selected_config(args):
    """The config named by --config with the detect-tail flags applied."""
    cfg = dataclasses.replace(get_config(args.config), fused_cascade=args.fused_cascade,
                              prefilter_anchors=args.prefilter)
    if args.approx_topk is not None:
        cfg = dataclasses.replace(cfg, approx_topk=args.approx_topk)
    if args.prefilter_recall is not None:
        cfg = dataclasses.replace(cfg, prefilter_recall=args.prefilter_recall)
    return cfg


def build_model(args, device, temporal=True):
    """The detector the flags name, with the seeded random weights."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_detector(selected_config(args), backbone=args.backbone, temporal=temporal,
                           dtype=dtype, stem=args.stem, temporal_cell=args.cell, device=device)
    return weights.load_random_params(model, 0)


def main(argv=None):
    args = parse_args(argv)
    model = build_model(args, args.device)
    cfg = model.cfg
    if args.bf16_weights:
        model = apply_inference_precision(model, "bf16")
    det = StreamingDetector(model, num_streams=args.batch, device=args.device)
    dev = det.device
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (args.batch, cfg.size, cfg.size, 3), dtype=np.uint8)).to(dev)

    def fetch(out):
        return [t.cpu().numpy() for t in (out.boxes, out.scores, out.classes)]

    for _ in range(args.warmup):
        out = det.detect(frames)
    fetch(out)

    # Throughput: the carried state chains the steps; the events bracket all
    # of them on the card's stream.
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.frames):
            out = det.detect(frames)
        end.record()
        end.synchronize()
        total_ms = start.elapsed_time(end)
        device = card_line()
    else:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            out = det.detect(frames)
        fetch(out)
        total_ms = (time.perf_counter() - t0) * 1e3
        device = "cpu"
    fps = args.frames * args.batch / (total_ms / 1e3)

    # Latency: a full round trip a step, detections on the host.
    lat = []
    for _ in range(max(args.frames // 4, 10)):
        s = time.perf_counter()
        fetch(det.detect(frames))
        lat.append(time.perf_counter() - s)

    result = {
        "metric": f"streaming_{args.config}_frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "p50_roundtrip_latency_ms": round(float(np.percentile(lat, 50) * 1e3), 3),
        "step_ms": round(total_ms / args.frames, 3),
        "batch": args.batch,
        "dtype": args.dtype,
        "bf16_weights": args.bf16_weights,
        "int8": args.int8,
        "backbone": args.backbone,
        "stem": args.stem,
        "cell": args.cell,
        "prefilter": args.prefilter,
        "device": device,
        "graph_replays": det.replays,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
