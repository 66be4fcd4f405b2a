"""Training entry point of the PyTorch port (the counterpart of train.py).

The same flags as train.py, on ``tdrn_tpu_torch``'s train step: VOC
single-image training and VID clip (temporal, truncated-BPTT) training, on
the card unless ``--device cpu`` is given.

    python train_torch.py --dataset voc_320 --data_root /data/VOCdevkit \
        --batch_size 32 --max_iter 120000 --save_folder weights/
    python train_torch.py --dataset vid_320 --data_root /data/ILSVRC --clip \
        --batch_size 4 --seq_len 8 --bf16

Checkpoints go to ``--save_folder`` in the layout of
tdrn_tpu_torch/train/checkpoint.py (``model_meta.json``,
``<step>/params.pt`` and ``<step>/train_state.pt``); ``--resume`` continues
from the newest exactly, and the inference CLIs read the directory as it is.
The augmentation needs ``cv2``. ``--loader processes`` (or train.py's
``grain``) fetches and augments in worker processes instead of threads,
with the same batches for a seed. ``--width_mult`` and ``--tcb_channels``
build a narrower model (smoke runs); both are written to the meta file.

Data-parallel training (``--multihost``, as train.py has it) runs one
process a card, launched by torchrun:

    torchrun --nproc_per_node 4 train_torch.py --dataset voc_320 \
        --data_root /data/VOCdevkit --batch_size 8 --multihost

or on each host with RANK and WORLD_SIZE set and ``--coordinator
host0:1234``. ``--batch_size`` is the batch of one process, as in train.py:
the global batch is ``batch_size * world``. Each rank trains on
``cuda:LOCAL_RANK``; the step divides by the global batch's positive
counts and sums the gradients over the ranks (train/trainer.py). The
weights are drawn, grafted, or restored from the un-offset ``--seed`` and
broadcast from rank 0; only the input seeds differ by rank: the thread
loader, its dataset and augmentation and the ``--mixed_frames`` loader take
``seed + rank``, while the worker-process loader takes the global batch
(``batch_size * world``) from the common seed and keeps rank r's rows of
it. Only rank 0 writes the meta file, checkpoints, the metrics log and
TensorBoard.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a TDRN detector (PyTorch port)")
    ap.add_argument("--dataset", default="voc_320", help="config name (see tdrn_tpu_torch.config)")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--backbone_norm", default="frozen", choices=["frozen", "group"],
                    help="resnet norm: frozen (pretrained BN fold) or group "
                         "(GroupNorm, trainable from scratch)")
    ap.add_argument("--pretrained", default=None,
                    help="torch checkpoint to graft into the backbone: "
                         "vgg16_reducedfc.pth / torchvision vgg16 (vgg16) or "
                         "a torchvision resnet101 state dict (resnet101)")
    ap.add_argument("--init_from", default=None,
                    help="init params from another run's checkpoint dir "
                         "(subtree-tolerant graft; e.g. clip fine-tuning from a "
                         "frame-trained detector: the fresh temporal subtree "
                         "keeps its init)")
    ap.add_argument("--clip", action="store_true", help="VID clip (temporal) training")
    ap.add_argument("--image_sets", default="2007:trainval,2012:trainval",
                    help="VOC splits as year:split[,year:split...]")
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--milestones", type=int, nargs="+", default=[80000, 100000])
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--grad_clip", type=float, default=10.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--no_photometric", action="store_true",
                    help="disable photometric distortion (color-sensitive data)")
    ap.add_argument("--max_iter", type=int, default=120000)
    ap.add_argument("--save_folder", default="weights/")
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--resume", action="store_true", help="resume from latest ckpt")
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--loader", default="threads", choices=["threads", "processes", "grain"],
                    help="input pipeline: a thread pool (data/loader.py) or worker "
                         "processes (data/process_loader.py; 'grain' is train.py's "
                         "name for it); the same batches for a seed either way")
    ap.add_argument("--temporal_cell", default="convgru", choices=["convgru", "light", "hybrid"])
    ap.add_argument("--stem", default="conv", choices=["conv", "poly", "poly2", "s2d"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multihost", action="store_true",
                    help="data-parallel over torch.distributed processes (torchrun, or "
                         "RANK/WORLD_SIZE and --coordinator); --batch_size is per process")
    ap.add_argument("--coordinator", default=None, help="host:port for multihost")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write the logged metrics as TensorBoard events under "
                         "<save_folder>/tb")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed-precision training: bf16 feature-pyramid compute "
                         "and carry (params cast once a step, outside the frame "
                         "loop), fp32 masters/heads/loss")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint per-frame forwards in clip mode (less memory)")
    ap.add_argument("--qat", action="store_true",
                    help="quantization-aware fine-tuning on the calibrated grids "
                         "of --int8_scales (straight-through gradients, fp32 "
                         "masters and checkpoints); serve the result with "
                         "--precision int8 and the SAME scales file")
    ap.add_argument("--int8_scales", default=None,
                    help="activation-scales json from `eval_torch.py --precision "
                         "int8 --save_scales` (or eval.py's)")
    ap.add_argument("--mixed_frames", type=int, default=0,
                    help="clip mode: interleave one frame-objective optimizer step "
                         "per iteration on this many independent frames (T=1 "
                         "clips through the same train step); --max_iter bounds "
                         "the total optimizer steps")
    ap.add_argument("--width_mult", type=float, default=1.0, help=argparse.SUPPRESS)
    ap.add_argument("--tcb_channels", type=int, default=256, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback to the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns (final TrainState, last logged metrics)."""
    args = parse_args(argv)
    if args.mixed_frames and not args.clip:
        raise SystemExit("--mixed_frames requires --clip")
    if args.qat and not args.int8_scales:
        raise SystemExit("--qat requires --int8_scales (calibrate offline: "
                         "eval_torch.py --precision int8 --save_scales <path>)")
    import torch

    from tdrn_tpu_torch import _build, weights
    from tdrn_tpu_torch.config import get_config
    from tdrn_tpu_torch.data import (VID_CLASSES, VOC_CLASSES, SSDAugmentation, VIDDetection,
                                     VOCDetection)
    from tdrn_tpu_torch.data.loader import make_loader
    from tdrn_tpu_torch.data.process_loader import make_process_loader
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.parallel import replicate_tree
    from tdrn_tpu_torch.train import (Targets, init_train_state, make_optimizer,
                                      make_train_step)
    from tdrn_tpu_torch.train.checkpoint import CheckpointManager, restore_params
    from tdrn_tpu_torch.utils.logging import MetricsLogger

    dev = _build.resolve_device(args.device)
    mesh = None
    rank, world = 0, 1
    if args.multihost:
        from tdrn_tpu_torch.parallel import init_distributed, local_device, make_mesh

        init_distributed(args.coordinator, device=args.device)
        dev = local_device(args.device)
        mesh = make_mesh(dev)
        rank, world = mesh.rank, mesh.world
        print(f"process {rank}/{world} on {dev}")
    lead = rank == 0  # the one rank that writes
    # The input seed: the worker-process loader shards one global batch
    # stream, the thread loader decorrelates ranks by seed (train.py).
    data_seed = args.seed + (rank if args.loader == "threads" else 0)
    cfg = get_config(args.dataset)
    # The masters (and checkpoints) are always fp32; --bf16 selects the
    # mixed-precision compute path inside the train step.
    model = build_detector(
        cfg, backbone=args.backbone, temporal=args.clip, stem=args.stem,
        temporal_cell=args.temporal_cell, backbone_norm=args.backbone_norm,
        width_mult=args.width_mult, tcb_channels=args.tcb_channels, device="cpu",
    )
    weights.init_weights(model, torch.Generator().manual_seed(args.seed))

    aug = SSDAugmentation(cfg.size, cfg.pixel_means, seed=data_seed,
                          photometric=not args.no_photometric)
    if args.clip:
        dataset = VIDDetection(args.data_root, "train", mode="clip", seq_len=args.seq_len,
                               transform=aug, seed=data_seed)
    elif args.dataset.startswith("vid"):
        dataset = VIDDetection(args.data_root, "train", mode="frame", transform=aug,
                               seed=data_seed)
    else:
        sets = tuple(tuple(p.split(":")) for p in args.image_sets.split(","))
        try:
            dataset = VOCDetection(args.data_root, image_sets=sets, transform=aug, seed=data_seed)
        except FileNotFoundError as e:
            raise SystemExit(f"dataset split not found under {args.data_root} "
                             f"(--image_sets {args.image_sets}): {e}")
    n_fg = len(VID_CLASSES) if isinstance(dataset, VIDDetection) else len(VOC_CLASSES)
    if cfg.num_classes < n_fg + 1:
        # An out-of-range label would index past the logits in the loss.
        raise SystemExit(
            f"config {cfg.name} has num_classes={cfg.num_classes} (incl. background) "
            f"but the dataset has {n_fg} foreground classes")
    print(f"dataset: {len(dataset)} samples; priors: {cfg.num_priors}")

    # The weights come from rank 0 (replicate_tree below): the other ranks
    # neither graft nor restore.
    if args.pretrained and lead:
        if args.backbone == "resnet101":
            if args.backbone_norm != "frozen":
                raise SystemExit("--pretrained resnet weights need --backbone_norm frozen")
            _, loaded, _ = weights.load_resnet_backbone(model, args.pretrained)
        else:
            _, loaded, skipped = weights.load_vgg_backbone(model, args.pretrained)
            if skipped:
                print(f"pretrained: skipped {skipped}")
        print(f"pretrained: grafted {len(loaded)} tensors from {args.pretrained}")
    if args.init_from and lead:
        out = restore_params(args.init_from, model.state_dict())
        if out is None:
            raise SystemExit(f"--init_from: no checkpoint in {args.init_from}")
        params, missing, extra = out
        model.load_state_dict(params, strict=True)
        print(f"init_from {args.init_from}: {len(missing)} fresh subtree(s) {missing[:3]}, "
              f"{len(extra)} unused {extra[:3]}")
    model = model.to(dev)

    opt = make_optimizer(args.lr, args.momentum, args.weight_decay, args.warmup,
                         args.milestones, args.gamma, grad_clip_norm=args.grad_clip)
    ts = init_train_state(model, opt)
    ckpt = CheckpointManager(args.save_folder, save_every=args.save_every) if lead else None
    if lead:
        # Construction flags beside the checkpoints, so the inference CLIs
        # rebuild the exact model without the train-time flags.
        ckpt.save_meta({
            "dataset": args.dataset,
            "backbone": args.backbone,
            "temporal": bool(args.clip),
            "stem": args.stem,
            "temporal_cell": args.temporal_cell,
            "backbone_norm": args.backbone_norm,
            "tcb_channels": args.tcb_channels,
            "width_mult": args.width_mult,
            "bf16": bool(args.bf16),
            "qat": bool(args.qat),
            "optimizer": {
                "lr": args.lr, "momentum": args.momentum,
                "weight_decay": args.weight_decay, "warmup": args.warmup,
                "milestones": list(args.milestones), "gamma": args.gamma,
                "grad_clip": args.grad_clip,
            },
        })
    if args.resume and lead:  # the other ranks take rank 0's state below
        restored = ckpt.restore_latest(ts)
        if restored is not None:
            ts = restored
            print(f"resumed at step {ts.step}")
    if mesh is not None:
        ts = replicate_tree(ts, mesh)

    qat_scales = None
    if args.qat:
        from tdrn_tpu_torch.utils.quantize import load_act_scales

        qat_scales = load_act_scales(args.int8_scales)
        print(f"qat: fake-quantizing {len(qat_scales)} convs on {args.int8_scales}")
    step_fn = make_train_step(model, opt, clip_mode=args.clip, remat=args.remat,
                              compute_dtype=torch.bfloat16 if args.bf16 else None,
                              qat_scales=qat_scales, mesh=mesh)
    logger = (MetricsLogger(args.save_folder, tensorboard=args.tensorboard,
                            echo_every=args.log_every) if lead else None)
    pin = dev.type == "cuda"

    def make(ds, batch_size, num_workers, seed, clip_mode=False):
        if args.loader == "threads":
            return make_loader(ds, batch_size=batch_size, num_workers=num_workers,
                               clip_mode=clip_mode, seed=seed, pin_memory=pin)
        # One global batch of batch_size * world a step; rank r keeps its rows.
        return make_process_loader(ds, batch_size=batch_size * world, num_workers=num_workers,
                                   clip_mode=clip_mode, seed=seed, pin_memory=pin, rank=rank,
                                   world=world)

    loader = make(dataset, args.batch_size, args.num_workers, data_seed, clip_mode=args.clip)
    frame_loader = None
    if args.mixed_frames:
        frame_ds = VIDDetection(args.data_root, "train", mode="frame", transform=aug,
                                seed=data_seed + 7919)
        frame_loader = make(frame_ds, args.mixed_frames, 2, data_seed + 7919)

    def on_device(images, boxes, labels, valid):
        return images.to(dev, non_blocking=True), Targets(
            *(t.to(dev, non_blocking=True) for t in (boxes, labels, valid)))

    t_last = time.perf_counter()
    steps_done = steps_logged = ts.step  # optimizer steps, bounded by --max_iter
    logged = {}
    try:
        for images, boxes, labels, valid in loader:
            if steps_done >= args.max_iter:
                break
            ts, metrics = step_fn(ts, *on_device(images, boxes, labels, valid))
            steps_done += 1
            if lead:
                ckpt.maybe_save(ts, step=steps_done)
            if frame_loader is not None and steps_done < args.max_iter:
                # Independent frames as a T=1 clip through the same train step.
                ts, fmetrics = step_fn(ts, *on_device(*(t[None] for t in next(frame_loader))))
                metrics = dict(metrics, frame_loss=fmetrics["loss"])
                steps_done += 1
                if lead:
                    ckpt.maybe_save(ts, step=steps_done)
            if steps_done - steps_logged >= args.log_every:
                logged = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                logged["steps_per_sec"] = (steps_done - steps_logged) / (now - t_last)
                t_last, steps_logged = now, steps_done
                if lead:
                    logger.log(steps_done, logged)
        if lead:
            ckpt.maybe_save(ts, force=True)
            ckpt.wait()
    finally:
        loader.close()
        if frame_loader is not None:
            frame_loader.close()
        if logger is not None:
            logger.close()
    print("training complete")
    return ts, logged


if __name__ == "__main__":
    main()
