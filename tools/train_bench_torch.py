"""Training-step throughput of the PyTorch port (the counterpart of
tools/train_bench.py).

N train steps run back to back, each taking the previous step's state, on
one batch uploaded to the device beforehand, so the input pipeline is not
timed; the clock stops after a synchronize. The weights are a seeded draw
(weights.init_weights), the batch seeded uniform frames with two fixed
boxes an image, as train_bench.py's.

    python tools/train_bench_torch.py                    # voc_320 frame mode, b32
    python tools/train_bench_torch.py --clip --batch 4   # vid_320 TBPTT, T=8 clips
    python tools/train_bench_torch.py --clip --bf16 --remat --profile out.txt

Prints one JSON line with steps/s, images/s, ms/step and the peak device
memory; ``device`` is the card's name and power limit as nvidia-smi gives
them. ``--profile PATH`` also writes torch.profiler tables of three steps
(``--steps`` if fewer)
and a breakdown of a step's device time (by part of the step: the kernels
under the trainer's and the loss's ``record_function`` ranges; by kernel
kind; and its idle share against the timed step) to PATH.
``--device cpu`` runs on the CPU (a smoke run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# The record_function ranges of train/trainer.py and train/loss.py, by the
# part of the step they time.
PARTS = ("tdrn::forward", "tdrn::match", "tdrn::mine", "tdrn::loss", "tdrn::backward",
         "tdrn::optimizer")
# Device kernels by kind, from their names (first match wins).
KINDS = (
    ("optimizer (foreach)", ("foreach",)),
    ("sort", ("sort", "radix")),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop")),
    ("gemm", ("gemm", "cutlass")),
    ("elementwise / reduce / copy", ("elementwise", "vectorized", "reduce", "unrolled", "index",
                                     "scatter", "gather", "cat", "copy", "fill")),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, help="default: voc_320 (frame) / vid_320 (--clip)")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--stem", default="conv", choices=["conv", "poly", "poly2", "s2d"])
    ap.add_argument("--cell", default="convgru", choices=["convgru", "light"])
    ap.add_argument("--clip", action="store_true",
                    help="TBPTT clip mode (temporal model, T frames a step)")
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None, help="default: 32 frame mode / 4 clip mode")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision train step: bf16 feature-pyramid compute, "
                         "fp32 masters/heads/loss")
    ap.add_argument("--remat", action="store_true", help="checkpoint per-frame forwards in clip mode")
    ap.add_argument("--width_mult", type=float, default=1.0, help=argparse.SUPPRESS)
    ap.add_argument("--tcb_channels", type=int, default=256, help=argparse.SUPPRESS)
    ap.add_argument("--profile", default=None, help="write a profile of three steps to this file")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def batch_of(cfg, clip: bool, t: int, batch: int, dev):
    """train_bench.py's batch: uniform frames, 8 GT slots with 2 valid boxes."""
    from tdrn_tpu_torch.train import Targets

    rng = np.random.RandomState(0)
    g = 8
    lead = (t, batch) if clip else (batch,)
    frames = torch.from_numpy(rng.rand(*lead, cfg.size, cfg.size, 3).astype(np.float32)).to(dev)
    boxes = torch.tensor([0.2, 0.2, 0.7, 0.7], device=dev).expand(*lead, g, 4).contiguous()
    labels = torch.ones(*lead, g, dtype=torch.int32, device=dev)
    valid = (torch.arange(g, device=dev) < 2).expand(*lead, g).contiguous()
    return frames, Targets(boxes, labels, valid)


def profile_breakdown(step, ts, frames, targets, path: str, steps: int = 3):
    """torch.profiler over ``steps`` steps, a step's device time: in all
    (``device_busy``, the kernels alone), by kernel kind (KINDS), and under
    each PARTS range (the kernels its host thread launched inside it; the
    backward runs on autograd's own threads, so ``backward and the rest``
    is the busy time the other parts leave). The ops' table goes to
    ``path``. Returns (those times, ts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if frames.is_cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            ts, _ = step(ts, frames, targets)
        if frames.is_cuda:
            torch.cuda.synchronize()
    dev_self = lambda e: e.self_device_time_total
    dev_total = lambda e: e.device_time_total
    ms = lambda us: us / 1e3 / steps
    parts = {name: 0.0 for name in PARTS}
    for e in prof.events():  # the host-side ranges, with the kernels launched under them
        if e.device_type == DeviceType.CPU and e.name in parts:
            parts[e.name] += ms(dev_total(e))
    ev = prof.key_averages()
    # Kernels only: the ranges also appear on the device's timeline.
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA and not e.key.startswith("tdrn::")]
    parts["device_busy"] = ms(sum(dev_self(e) for e in kernels))
    parts["backward and the rest"] = parts["device_busy"] - sum(
        parts[p] for p in ("tdrn::forward", "tdrn::loss", "tdrn::optimizer"))
    kinds = {kind: 0.0 for kind, _ in KINDS}
    kinds["other"] = 0.0
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, words in KINDS if any(w in name for w in words)), "other")
        kinds[kind] += ms(dev_self(e))
    parts["kernels_by_kind"] = kinds
    parts["kernels_a_step"] = sum(e.count for e in kernels) / steps
    sort_by = "self_device_time_total" if frames.is_cuda else "self_cpu_time_total"
    with open(path, "w") as f:
        f.write(json.dumps({"ms_a_step": parts}) + "\n\n")
        f.write(ev.table(sort_by=sort_by, row_limit=60, max_name_column_width=90))
    return parts, ts


def main(argv=None):
    args = parse_args(argv)
    from bench_torch import card_line
    from tdrn_tpu_torch import _build, weights
    from tdrn_tpu_torch.config import get_config
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    dev = _build.resolve_device(args.device)
    cfg = get_config(args.config or ("vid_320" if args.clip else "voc_320"))
    batch = args.batch or (4 if args.clip else 32)
    model = build_detector(cfg, backbone=args.backbone, temporal=args.clip, stem=args.stem,
                           temporal_cell=args.cell, width_mult=args.width_mult,
                           tcb_channels=args.tcb_channels, device="cpu")
    weights.init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    opt = make_optimizer(base_lr=1e-3, warmup_steps=10)
    ts = init_train_state(model, opt)
    step = make_train_step(model, opt, clip_mode=args.clip, remat=args.remat,
                           compute_dtype=torch.bfloat16 if args.bf16 else None)
    frames, targets = batch_of(cfg, args.clip, args.seq_len, batch, dev)
    per_step_images = (args.seq_len if args.clip else 1) * batch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    for _ in range(args.warmup):
        ts, metrics = step(ts, frames, targets)
    float(metrics["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ts, metrics = step(ts, frames, targets)
    sync()
    dt = time.perf_counter() - t0
    loss = float(metrics["loss"])
    ms = dt / args.steps * 1e3
    out = {
        "metric": "train_clip_images_per_sec" if args.clip else "train_images_per_sec",
        "value": per_step_images / (dt / args.steps),
        "unit": "images/s",
        "ms_per_step": ms,
        "steps_per_sec": 1e3 / ms,
        "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if dev.type == "cuda" else None),
        "config": cfg.name,
        "backbone": args.backbone,
        "stem": args.stem,
        "cell": args.cell,
        "clip": args.clip,
        "seq_len": args.seq_len if args.clip else None,
        "batch": batch,
        "remat": args.remat,
        "bf16": args.bf16,
        "loss": loss,
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    if args.profile:
        out["profile_ms_a_step"], ts = profile_breakdown(step, ts, frames, targets, args.profile,
                                                         steps=min(3, args.steps))
        out["profile_ms_a_step"]["idle_share"] = 1.0 - out["profile_ms_a_step"]["device_busy"] / ms
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
