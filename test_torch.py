"""Batch-inference script (CLI) of the PyTorch / CUDA port: the counterpart of ``test.py``.

Runs the detector over a VOC test split or a folder of images and writes one
results block per image (class name, score, pixel box):

    GROUND TRUTH FOR: <image id>
    PREDICTION: label: <class> score: <s> box: <x1> <y1> <x2> <y2>

Example:
    python test_torch.py --dataset voc_320 --data_root /data/VOCdevkit \
        --checkpoint weights_torch/ --out_file eval/test1.txt
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tdrn_tpu_torch.data import VID_CLASSES, VOC_CLASSES, VOCDetection, image
from tdrn_tpu_torch.inference import load_inference_model, make_single_image_forward


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Batch inference -> text file (PyTorch / CUDA port)")
    ap.add_argument("--dataset", default=None,
                    help="config name; defaults to the checkpoint's meta (else voc_320)")
    ap.add_argument("--data_root", default=None, help="VOCdevkit root")
    ap.add_argument("--image_dir", default=None, help="or: a folder of images")
    ap.add_argument("--backbone", default=None, choices=["vgg16", "resnet101"],
                    help="defaults to the checkpoint's meta")
    ap.add_argument("--stem", default=None, choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"],
                    help="override the checkpoint's stem (fused/fused2 = the K3/K4 kernels)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out_file", default="eval/test1.txt")
    ap.add_argument("--visual_thresh", type=float, default=0.6)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_images", type=int, default=0)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "int8"],
                    help="bf16 = resident-bf16 feature pyramid, fp32 "
                         "heads/detect (utils/precision.py)")
    ap.add_argument("--int8_scales", default=None,
                    help="activation-scales json for --precision int8 "
                         "(from eval_torch.py --precision int8 --save_scales)")
    ap.add_argument("--backbone_norm", default=None, choices=["frozen", "group"],
                    help="resnet norm override (identical param trees restore "
                         "silently into the wrong norm)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    try:
        model, cfg, _, _ = load_inference_model(
            args.checkpoint, dataset=args.dataset, backbone=args.backbone,
            stem=args.stem, temporal=False, precision=args.precision,
            int8_scales=args.int8_scales,
            backbone_norm=args.backbone_norm, device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    class_names = VID_CLASSES if cfg.name.startswith("vid") else VOC_CLASSES

    if args.image_dir:
        paths = sorted(
            os.path.join(args.image_dir, f)
            for f in os.listdir(args.image_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        items = [(os.path.splitext(os.path.basename(p))[0], p) for p in paths]
    else:
        if not args.data_root:
            raise SystemExit("need --data_root or --image_dir")
        ds = VOCDetection(args.data_root, image_sets=(("2007", "test"),))
        items = [(ds.ids[i][1], ds.image_path(i)) for i in range(len(ds))]
    if args.max_images:
        items = items[: args.max_images]

    forward = make_single_image_forward(model)
    device = next(model.parameters()).device
    os.makedirs(os.path.dirname(args.out_file) or ".", exist_ok=True)
    bs = args.batch_size
    with open(args.out_file, "w") as f:
        for start in range(0, len(items), bs):
            chunk = items[start : start + bs]
            frames, metas = [], []
            for img_id, path in chunk:
                img = image.imread(path)
                h, w, _ = img.shape
                frames.append(image.resize(img, cfg.size))
                metas.append((img_id, (h, w)))
            batch = np.stack(frames).astype(np.uint8)
            if len(batch) < bs:
                batch = np.concatenate(
                    [batch, np.zeros((bs - len(batch),) + batch.shape[1:], np.uint8)]
                )
            det = forward(torch.from_numpy(batch).to(device))
            boxes, scores, classes = (t.cpu().numpy() for t in (det.boxes, det.scores, det.classes))
            for bi, (img_id, (h, w)) in enumerate(metas):
                f.write(f"GROUND TRUTH FOR: {img_id}\n")
                keep = scores[bi] >= args.visual_thresh
                for b, s, c in zip(boxes[bi][keep], scores[bi][keep], classes[bi][keep]):
                    x1, y1, x2, y2 = b * [w, h, w, h]
                    f.write(
                        f"PREDICTION: label: {class_names[int(c) - 1]} "
                        f"score: {s:.4f} box: {x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}\n"
                    )
            print(f"{min(start + bs, len(items))}/{len(items)}", flush=True)
    print(f"wrote {args.out_file}")


if __name__ == "__main__":
    main()
