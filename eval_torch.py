"""Evaluation entry point (CLI) of the PyTorch / CUDA port: the counterpart of ``eval.py``.

Runs the detector over the VOC test / VID val split, collects per-class
detections and computes 07-metric (or continuous) AP and mAP. Temporal VID
evaluation (``--temporal``) streams each snippet's frames in order through
the state carried on the card, snippets continuously batched onto S stream
lanes (tdrn_tpu_torch/eval/runner.py).

Examples:
    python eval_torch.py --dataset voc_320 --data_root /data/VOCdevkit --checkpoint weights_torch/
    python eval_torch.py --dataset vid_320 --data_root /data/ILSVRC --checkpoint weights_torch/ \
        --temporal --batch_size 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tdrn_tpu_torch.data import VID_CLASSES, VOC_CLASSES, VIDDetection, VOCDetection, image
from tdrn_tpu_torch.eval import evaluate_detections, write_voc_results_files
from tdrn_tpu_torch.eval.motion import motion_gt_views, vid_motion_categories
from tdrn_tpu_torch.eval.runner import finalize, run_batched, run_streaming
from tdrn_tpu_torch.inference import (
    StreamingDetector,
    load_inference_model,
    make_single_image_forward,
)
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.utils.quantize import (
    apply_int8_backbone,
    calibrate_act_scales,
    load_act_scales,
    save_act_scales,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate a TDRN detector (PyTorch / CUDA port)")
    ap.add_argument("--dataset", default=None,
                    help="config name; defaults to the checkpoint's meta (else voc_320)")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--backbone", default=None, choices=["vgg16", "resnet101"],
                    help="defaults to the checkpoint's meta")
    ap.add_argument("--stem", default=None, choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"],
                    help="override the checkpoint's stem (fused/fused2 = the K3/K4 kernels)")
    ap.add_argument("--checkpoint", required=True, help="checkpoint directory")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--temporal", action="store_true", help="VID temporal (snippet-streaming) eval")
    ap.add_argument("--motion_breakdown", action="store_true",
                    help="VID only: also report mAP over slow/medium/fast-"
                         "moving GT (mean track IoU over a +/-10-frame "
                         "window; tdrn_tpu_torch/eval/motion.py)")
    ap.add_argument("--split", default=None, help="VID split (default val) / VOC year:split")
    ap.add_argument("--score_thresh", type=float, default=0.01)
    ap.add_argument("--use_07_metric", action=argparse.BooleanOptionalAction, default=True,
                    help="11-point 07 AP (default) / --no-use_07_metric = continuous AP")
    ap.add_argument("--results_dir", default=None, help="write VOC-format det files")
    ap.add_argument("--max_images", type=int, default=0, help="0 = all")
    ap.add_argument("--prefilter_recall", type=float, default=None,
                    help="with --prefilter: the anchor selection's recall "
                         "target (the port's selection is exact at any target)")
    ap.add_argument("--prefilter", type=int, default=0,
                    help="anchor-prefilter cap (0 = exact reference-parity "
                         "Detect, the default; >0 = the streaming fast path)")
    ap.add_argument("--int8_tcb", action="store_true",
                    help="with --precision int8: also quantize the TCB pyramid convs")
    ap.add_argument("--int8_gru", action="store_true",
                    help="with --precision int8 --temporal: also quantize "
                         "the temporal-cell convs")
    ap.add_argument("--calib_percentile", type=float, default=None,
                    help="with --precision int8: calibrate activation scales "
                         "at this |x| percentile (e.g. 99.9) instead of the max")
    ap.add_argument("--int8_scales", default=None,
                    help="with --precision int8: LOAD activation scales from "
                         "this json instead of calibrating on the eval set")
    ap.add_argument("--save_scales", default=None,
                    help="with --precision int8: write the calibrated "
                         "activation scales (json) for offline serving "
                         "(serve_torch/live_torch/test_torch --int8_scales)")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "int8"],
                    help="bf16 = resident-bf16 feature pyramid, fp32 "
                         "heads/detect (utils/precision.py)")
    ap.add_argument("--backbone_norm", default=None, choices=["frozen", "group"],
                    help="resnet norm override when the checkpoint meta lacks "
                         "it (FrozenBN/GroupNorm param trees are identical, "
                         "so a wrong norm restores silently)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the APs by class name and "mAP" (and "mAP(slow)" etc. with
    --motion_breakdown) and the detections by class."""
    args = parse_args(argv)
    # Model geometry and flags come from the checkpoint's meta; the CLI
    # overrides. --temporal selects the eval mode (a clip-trained checkpoint
    # restores into either mode).
    try:
        # int8 = the bf16 profile + the quantized backbone (calibrated below
        # on the eval set's own first frames).
        base_precision = "bf16" if args.precision == "int8" else args.precision
        model, cfg, step, meta = load_inference_model(
            args.checkpoint, dataset=args.dataset, backbone=args.backbone,
            stem=args.stem, temporal=args.temporal, precision=base_precision,
            backbone_norm=args.backbone_norm, device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    device = next(model.parameters()).device

    def maybe_quantize(model, frames_u8):
        """--precision int8: quantize the backbone, its static activation
        scales calibrated on this eval's own first frames (or loaded)."""
        if args.precision != "int8":
            return model
        if args.calib_percentile is not None and not (50.0 < args.calib_percentile <= 100.0):
            # 0.999-style fractions would calibrate near-zero scales and
            # silently produce garbage mAP.
            raise SystemExit(
                f"--calib_percentile {args.calib_percentile}: expected a "
                "percent in (50, 100], e.g. 99.9"
            )
        if args.int8_gru and not args.temporal:
            raise SystemExit("--int8_gru needs --temporal (the frame-mode "
                             "eval model has no temporal cell)")
        if args.int8_scales:
            scales = load_act_scales(args.int8_scales)
            src = args.int8_scales
        else:
            calib = torch.from_numpy(np.stack(frames_u8[:8])).to(device)
            calib = preprocess_batch(calib, cfg, model.dtype)
            scales = calibrate_act_scales(model, calib, percentile=args.calib_percentile,
                                          tcb=args.int8_tcb, gru=args.int8_gru)
            src = f"{min(len(frames_u8), 8)} eval frames"
        if args.save_scales:
            save_act_scales(args.save_scales, scales)
            print(f"int8 activation scales -> {args.save_scales}")
        print(f"int8 backbone: scales from {src}")
        return apply_int8_backbone(model, act_scales=scales)

    is_vid = cfg.name.startswith("vid")
    class_names = VID_CLASSES if is_vid else VOC_CLASSES
    print(f"restored step {step}")

    all_gt = {}

    def prep(img):
        return image.resize(img, cfg.size)

    if is_vid:
        split = args.split or "val"
        dataset = VIDDetection(args.data_root, split)
        if args.temporal:
            # snippet-ordered items for streaming eval
            snippets = []
            count = 0
            for rel, stems in dataset.snippets:
                snip = []
                for stem in stems:
                    img, boxes, labels = dataset._load_frame(rel, stem)
                    img_id = f"{rel}/{stem}"
                    all_gt[img_id] = (boxes, labels, np.zeros(len(labels), bool))
                    snip.append((img_id, img.shape[:2], prep(img)))
                    count += 1
                    if args.max_images and count >= args.max_images:
                        break
                snippets.append(snip)
                if args.max_images and count >= args.max_images:
                    break
            model = maybe_quantize(model, [f for snip in snippets for (_, _, f) in snip])
            det = StreamingDetector(model, num_streams=args.batch_size,
                                    prefilter=args.prefilter or None,
                                    prefilter_recall=args.prefilter_recall, device=device)
            accum = run_streaming(det, snippets, args.score_thresh)
        else:
            items = []
            n = len(dataset.frames) if not args.max_images else min(
                args.max_images, len(dataset.frames)
            )
            for i in range(n):
                rel, stem = dataset.frames[i]
                img, boxes, labels = dataset._load_frame(rel, stem)
                img_id = f"{rel}/{stem}"
                all_gt[img_id] = (boxes, labels, np.zeros(len(labels), bool))
                items.append((img_id, img.shape[:2], prep(img)))
            model = maybe_quantize(model, [f for _, _, f in items])
            forward = make_single_image_forward(model, prefilter=args.prefilter or None,
                                                prefilter_recall=args.prefilter_recall)
            accum = run_batched(forward, items, args.batch_size, args.score_thresh,
                                device=device)
    else:
        if args.split:
            year, split = args.split.split(":")
            sets = ((year, split),)
        else:
            sets = (("2007", "test"),)
        dataset = VOCDetection(args.data_root, image_sets=sets, keep_difficult=True)
        n = len(dataset) if not args.max_images else min(args.max_images, len(dataset))
        items = []
        for i in range(n):
            img, boxes, labels, difficult, img_id = dataset.raw_item(i)
            if len(difficult) != len(labels):
                difficult = np.zeros(len(labels), bool)
            all_gt[img_id] = (boxes, labels, difficult)
            items.append((img_id, img.shape[:2], prep(img)))
        model = maybe_quantize(model, [f for _, _, f in items])
        forward = make_single_image_forward(model, prefilter=args.prefilter or None,
                                            prefilter_recall=args.prefilter_recall)
        accum = run_batched(forward, items, args.batch_size, args.score_thresh, device=device)

    dets_np = finalize(accum)
    aps = evaluate_detections(all_gt, dets_np, class_names, use_07_metric=args.use_07_metric)
    for name in class_names:
        print(f"AP {name}: {aps[name]:.4f}")
    print(f"mAP: {aps['mAP']:.4f}")
    if args.motion_breakdown:
        if not is_vid:
            raise SystemExit("--motion_breakdown needs a VID dataset "
                             "(motion IoU is defined over track ids)")
        cats = vid_motion_categories(
            args.data_root, split, dataset.snippets, frame_ids=set(all_gt)
        )
        for cname, gt_view in motion_gt_views(all_gt, cats):
            aps_c = evaluate_detections(
                gt_view, dets_np, class_names,
                use_07_metric=args.use_07_metric, skip_empty_classes=True,
            )
            aps[f"mAP({cname})"] = aps_c["mAP"]
            print(f"mAP({cname}): {aps_c['mAP']:.4f}")
    if args.results_dir:
        write_voc_results_files(args.results_dir, dets_np, class_names)
    return aps, dets_np


if __name__ == "__main__":
    main()
