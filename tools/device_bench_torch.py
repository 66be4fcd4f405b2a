"""Device-side micro-benchmark of the PyTorch / CUDA port on one NVIDIA GPU
(the port's counterpart of ``tools/device_bench.py``).

By default it times the step that is served: ``StreamingDetector.detect``
(uint8 -> preprocess -> model -> decode -> NMS -> top-k, the temporal state
carried in place), one CUDA graph replay a call, each call on a distinct
frame batch already on the card. ``--no_detect`` times the model alone
(preprocess and forward, the state carried in place) as a graph of its own.
N steps are timed by CUDA events around the whole run; the best of
``--repeats`` runs gives the card's time a frame.

    python3 tools/device_bench_torch.py --batch 1 --frames 100
    python3 tools/device_bench_torch.py --batch 16 --stem fused2 --bf16_weights \
        --fused_cascade --prefilter 512 --chunk 2
    python3 tools/device_bench_torch.py --batch 1 --no_detect   # model-only ablation
    python3 tools/device_bench_torch.py --batch 16 --backbone resnet101 --config vid_512 \
        --bf16_weights --fused_cascade --prefilter 512
    python3 tools/device_bench_torch.py --batch 16 --bf16_weights --int8 --int8_tcb \
        --int8_gru --fused_cascade --prefilter 512        # int8 serving profile

Prints one JSON line; ``device`` is the card's name and power limit as
nvidia-smi reports them. The weights are a seeded random draw
(weights.load_random_params).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from bench_torch import (
    add_int8_args, add_selection_args, apply_int8, build_model, card_line, check_int8_args,
)
from tdrn_tpu_torch.inference import StreamingDetector, capture
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.utils.precision import (
    apply_fold_mean, apply_inference_precision, apply_pad_stem,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--config", default="vid_320")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--stem", default="conv",
                    choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"])
    ap.add_argument("--cell", default="convgru", choices=["convgru", "light", "hybrid"])
    ap.add_argument("--no_detect", action="store_true",
                    help="skip decode/NMS/top-k (model-only ablation)")
    ap.add_argument("--no_temporal", action="store_true")
    ap.add_argument("--fused_cascade", action="store_true",
                    help="the K1 ARM->ODM cascade kernel (ops/cascade.py)")
    ap.add_argument("--prefilter", type=int, default=0,
                    help="image-wide anchor cap before per-class NMS (0=off)")
    ap.add_argument("--bf16_weights", action="store_true",
                    help="resident-bf16 inference profile (utils/precision.py)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per stream per step (TDRN.chunk micro-batching)")
    ap.add_argument("--fold_mean", action="store_true",
                    help="fold the preprocess mean-subtract into conv1_1 (conv stem)")
    ap.add_argument("--pad_stem", type=int, default=0,
                    help="zero-pad the stem input and kernel to N channels (conv stem)")
    add_selection_args(ap)
    add_int8_args(ap)
    args = ap.parse_args(argv)
    check_int8_args(ap, args)
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    return args


def model_only(model, frames, chunk):
    """--no_detect: preprocess and the model forward, the state carried in
    place, captured as one graph. Returns a callable that runs step i."""
    if chunk > 1:
        model = model.clone(chunk=chunk)
    state = model.zero_state(frames.shape[-4]) if model.temporal_enabled else None
    static = frames[0].clone()

    @torch.inference_mode()
    def step():
        x = preprocess_batch(static.flatten(0, 1) if chunk > 1 else static, model.cfg,
                             model.dtype, model.fold_mean)
        return model(x, state)

    def commit(out):
        if state is not None:
            with torch.inference_mode():
                for s, ns in zip(state, out[1]):
                    s.copy_(ns)

    graph, _ = capture(step, frames.device, after=commit)

    def run(i):
        static.copy_(frames[i])
        graph.replay()

    return run


def main(argv=None):
    args = parse_args(argv)
    dev = torch.device("cuda")
    model = build_model(args, dev, temporal=not args.no_temporal)
    cfg = model.cfg
    if args.fold_mean:
        model = apply_fold_mean(model)
    if args.pad_stem:
        model = apply_pad_stem(model, args.pad_stem)
    if args.bf16_weights:
        model = apply_inference_precision(model, "bf16")
    b, ch = args.batch, args.chunk
    model = apply_int8(args, model, frames=min(ch * b, 8))

    # A distinct frame batch a step, (B, H, W, 3) or (chunk, B, H, W, 3), on the card.
    steps = max(args.frames // ch, 1)
    lead = (b,) if ch == 1 else (ch, b)
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (steps, *lead, cfg.size, cfg.size, 3), dtype=np.uint8)).to(dev)
    if args.no_detect:
        run, det = model_only(model, frames, ch), None
    else:
        det = StreamingDetector(model, num_streams=b, chunk=ch, device=dev)
        run = lambda i: det.detect(frames[i])

    times = []
    for _ in range(args.repeats + 1):  # the first run captures and warms the replays up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            run(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    best = min(times[1:])
    per = best / (steps * ch)
    result = {
        "ms_per_frame": per,
        "frames_per_sec_per_chip": b / per * 1e3,
        "ms_per_step": best / steps,
        "batch": b,
        "dtype": args.dtype,
        "bf16_weights": args.bf16_weights,
        "int8": args.int8,
        "int8_tcb": args.int8_tcb,
        "int8_gru": args.int8_gru,
        "fold_mean": args.fold_mean,
        "pad_stem": args.pad_stem,
        "chunk": ch,
        "stem": args.stem,
        "cell": args.cell,
        "backbone": args.backbone,
        "config": args.config,
        "detect": not args.no_detect,
        "fused_cascade": args.fused_cascade,
        "prefilter": args.prefilter,
        "approx_topk": cfg.approx_topk,
        "prefilter_recall": cfg.prefilter_recall,
        "temporal": not args.no_temporal,
        "frames": args.frames,
        "timed": "model forward" if det is None else "StreamingDetector.detect",
        "cuda_graph_replays": steps * (args.repeats + 1) if det is None else det.replays,
        "device": card_line(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
