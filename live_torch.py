"""Live / streaming video demo (CLI) of the PyTorch / CUDA port: the counterpart of ``live.py``.

Reads frames from a camera or a video file, runs the streaming per-frame
detector (the temporal state carried on the card, one graph replay a
frame), draws boxes and an FPS overlay, and optionally writes the annotated
video. Video capture, writing and drawing use OpenCV (``cv2``), the one
entry point of the port that needs it; the resize is data/image.py's.

Example:
    python live_torch.py --checkpoint weights_torch/ --source video.mp4 --out annotated.mp4
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tdrn_tpu_torch.data import VID_CLASSES, VOC_CLASSES, image
from tdrn_tpu_torch.inference import StreamingDetector, load_inference_model
from tdrn_tpu_torch.utils.precision import apply_pad_stem


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Streaming video detection demo (PyTorch / CUDA port)")
    ap.add_argument("--dataset", default=None,
                    help="config name; defaults to the checkpoint's meta (else vid_320)")
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--stem", default=None, choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"],
                    help="override the checkpoint's stem (fused/fused2 = the K3/K4 kernels)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--source", default="0", help="camera index or video path")
    ap.add_argument("--out", default=None, help="write annotated video here")
    ap.add_argument("--score_thresh", type=float, default=0.4)
    ap.add_argument("--max_frames", type=int, default=0)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "int8"],
                    help="bf16 = resident-bf16 feature pyramid, fp32 "
                         "heads/detect (utils/precision.py)")
    ap.add_argument("--int8_scales", default=None,
                    help="activation-scales json for --precision int8 "
                         "(from eval_torch.py --precision int8 --save_scales)")
    ap.add_argument("--backbone_norm", default=None, choices=["frozen", "group"],
                    help="resnet norm override (identical param trees restore "
                         "silently into the wrong norm)")
    ap.add_argument("--pad_stem", type=int, default=0,
                    help="zero-pad the stem input+kernel to N channels (exact; "
                         "vgg conv stem only)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(
            "live_torch.py needs OpenCV (cv2) for video capture, writing and "
            "drawing; it is not installed"
        ) from e
    return cv2


def main(argv=None):
    """Returns the number of frames processed."""
    args = parse_args(argv)
    cv2 = _cv2()
    try:
        model, cfg, _, _ = load_inference_model(
            args.checkpoint, dataset=args.dataset, backbone=args.backbone,
            stem=args.stem, temporal=True, dataset_fallback="vid_320",
            precision=args.precision, backbone_norm=args.backbone_norm,
            int8_scales=args.int8_scales, device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    if args.pad_stem:
        model = apply_pad_stem(model, args.pad_stem)
    class_names = VID_CLASSES if cfg.name.startswith("vid") else VOC_CLASSES

    src = int(args.source) if args.source.isdigit() else args.source
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise SystemExit(f"cannot open source {args.source}")

    det = StreamingDetector(model, num_streams=1, device=args.device)
    writer = None
    n, fps, t0 = 0, 0.0, time.perf_counter()
    while True:
        ok, frame_bgr = cap.read()
        if not ok or (args.max_frames and n >= args.max_frames):
            break
        rgb = image.resize(np.ascontiguousarray(frame_bgr[..., ::-1]), cfg.size)
        out = det.detect(rgb[None])
        boxes, scores, classes = (t[0].cpu().numpy() for t in (out.boxes, out.scores, out.classes))
        h, w = frame_bgr.shape[:2]
        for b, s, c in zip(boxes, scores, classes):
            if s < args.score_thresh:
                continue
            x1, y1, x2, y2 = (b * [w, h, w, h]).astype(int)
            cv2.rectangle(frame_bgr, (x1, y1), (x2, y2), (0, 220, 0), 2)
            label = f"{class_names[int(c) - 1]} {s:.2f}"
            cv2.putText(frame_bgr, label, (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 220, 0), 1)
        n += 1
        fps = n / (time.perf_counter() - t0)
        cv2.putText(frame_bgr, f"{fps:.1f} FPS", (8, 24),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 255), 2)
        if args.out:
            if writer is None:
                writer = cv2.VideoWriter(
                    args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                    cap.get(cv2.CAP_PROP_FPS) or 25.0, (w, h),
                )
            writer.write(frame_bgr)
    cap.release()
    if writer is not None:
        writer.release()
    print(f"processed {n} frames at {fps:.1f} FPS")
    return n


if __name__ == "__main__":
    main()
