"""Benchmark of the PyTorch / CUDA port: streaming TDRN-VGG16 @320 per-frame
inference on one NVIDIA GPU (the port's counterpart of ``bench.py``).

    python3 bench_torch.py                        # vid_320, 16 streams, bf16 weights
    python3 bench_torch.py --stem fused2 --frames 200
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

The frames are one seeded uint8 batch already on the card, and the weights a
seeded random draw (weights.load_random_params). Metric: frames/s for
streaming 320x320 video; vs_baseline = frames/s / 20, the reference TDRN's
real-time claim on a 1080Ti-class GPU. On ``--device cpu`` the same loops
run eagerly on the host clock; those numbers are the CPU's, not a card's.
"""

from __future__ import annotations

import argparse
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

# Options of bench.py and tools/device_bench.py that the port does not have
# yet (ROADMAP.md, queue 1).
_UNPORTED = {
    "backbone": ("resnet101",),
    "cell": ("light", "hybrid"),
    "stem": ("poly", "poly2", "s2d"),
}


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


def refuse_unported(ap, args):
    """Exit with an error naming ROADMAP.md on an option the port lacks."""
    for flag, values in _UNPORTED.items():
        if getattr(args, flag) in values:
            ap.error(f"--{flag} {getattr(args, flag)} is not ported yet (ROADMAP.md, queue 1)")
    if args.int8 or args.int8_tcb or args.int8_gru:
        ap.error("--int8, --int8_tcb and --int8_gru are not ported yet (ROADMAP.md, queue 1 item 9)")


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.config)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_detector(cfg, temporal=True, dtype=dtype, stem=args.stem,
                           temporal_cell=args.cell, device=args.device)
    model = weights.load_random_params(model, 0)
    if args.bf16_weights:
        model = apply_inference_precision(model, "bf16")
    det = StreamingDetector(model, num_streams=args.batch,
                            prefilter=args.prefilter or None, device=args.device)
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
