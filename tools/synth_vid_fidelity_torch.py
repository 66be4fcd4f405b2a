"""Temporal fidelity harness of the PyTorch / CUDA port: the counterpart of
tools/synth_vid_fidelity.py, driving train_torch.py and eval_torch.py.

The data is the reference harness's synthetic ImageNet-VID-format video,
made by its own ``generate`` (imported: the same snippets for a seed):
colored rectangles (color == class) moving over textured noise, each hidden
for a few frames now and then by a background-colored band while its ground
truth persists. A single-frame detector cannot score the hidden frames; the
ConvGRU's state can carry an object through them, so the temporal model must
beat the frame model (``temporal_advantage`` > 0, the pass bar).

Staged training, as the reference's: a frame model (vid_320, batch 16), then
a clip model (``--clip``, T=8, batch 4) fine-tuned from it with
``--init_from``; ``--no-staged`` trains the clip model from scratch. Both
are evaluated on the val split with eval_torch.py (``--temporal`` for the
clip model) with ``--motion_breakdown``; ``--precision_check`` also serves
the clip model in bf16, int8, int8 with the TCB and int8 with the TCB and
the GRU (``--int8_gru``). On the card unless ``--device cpu``; ``--loader``
is train_torch.py's (worker processes by default); ``--n_train``,
``--n_val`` and ``--frames`` size the data (the reference's 60, 10 and 24
by default). The data and weights go under ``--out``, by default
``build/synth_vid`` in the checkout.

    python tools/synth_vid_fidelity_torch.py --steps 1500 --precision_check
    # prints one JSON line: {"temporal_mAP": ..., "frame_mAP": ...,
    #   "temporal_advantage": ..., "card": ..., "loader": ..., ...}
"""

from __future__ import annotations

import argparse
import os
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, TOOLS)

from synth_fidelity_torch import card_line, mean_ap, parse_aps, record, run, train_losses  # noqa: E402
from synth_vid_fidelity import CLASSES, generate  # noqa: E402


def parse_motion(stdout: str) -> dict:
    """The mAP(slow)/mAP(medium)/mAP(fast) lines of eval_torch.py
    --motion_breakdown."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("mAP(") and "):" in line:
            cat = line[len("mAP("):line.index(")")]
            out[cat] = float(line.split(":")[1])
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "synth_vid"))
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--frame_batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_train", type=int, default=60, help="train snippets")
    ap.add_argument("--n_val", type=int, default=10, help="val snippets")
    ap.add_argument("--frames", type=int, default=24, help="frames a snippet")
    ap.add_argument("--gen_only", action="store_true")
    ap.add_argument("--skip_gen", action="store_true")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--staged", action=argparse.BooleanOptionalAction, default=True,
                    help="staged training: the frame model first, the clip model "
                         "fine-tunes from it (--init_from)")
    ap.add_argument("--mixed_frames", type=int, default=0,
                    help="pass --mixed_frames N to the clip training")
    ap.add_argument("--extra_train_args", default="",
                    help="extra flags appended to BOTH train commands (e.g. '--stem s2d "
                         "--temporal_cell light'; eval reads the variant from "
                         "model_meta.json)")
    ap.add_argument("--precision_check", action="store_true",
                    help="also eval the temporal model with --precision bf16 and int8 "
                         "(+tcb, +tcb+gru) and report each mAP delta against fp32")
    ap.add_argument("--device", default="cuda",
                    help="passed to train_torch.py and eval_torch.py (cuda, or cpu)")
    ap.add_argument("--loader", default="processes", choices=["threads", "processes"],
                    help="train_torch.py's input pipeline")
    ap.add_argument("--record", default=None, help="also write the result JSON to this file")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    data_root = os.path.join(args.out, "data")
    w_clip = os.path.join(args.out, "weights_clip")
    w_frame = os.path.join(args.out, "weights_frame")
    if not args.skip_gen:
        generate(data_root, n_train=args.n_train, n_val=args.n_val, frames=args.frames,
                 seed=args.seed)
    if args.gen_only:
        return {}

    dev = ["--device", args.device]
    common = [
        "--dataset", "vid_320", "--data_root", data_root,
        "--lr", str(args.lr), "--warmup", "150",
        "--milestones", str(int(args.steps * 0.75)),
        "--no_photometric", "--log_every", "50", "--seed", str(args.seed),
        "--grad_clip", "10", "--loader", args.loader, *dev,
    ] + args.extra_train_args.split()
    train = [sys.executable, os.path.join(REPO, "train_torch.py")]
    result = {}
    if not args.skip_train:
        _, result["frame_train_s"] = run(
            train + ["--batch_size", str(args.frame_batch_size), "--max_iter", str(args.steps),
                     "--save_folder", w_frame, "--save_every", str(args.steps)] + common)
        staged = ["--init_from", w_frame] if args.staged else []
        mixed = ["--mixed_frames", str(args.mixed_frames)] if args.mixed_frames else []
        _, result["clip_train_s"] = run(
            train + ["--clip", "--seq_len", str(args.seq_len),
                     "--batch_size", str(args.batch_size), "--max_iter", str(args.steps),
                     "--save_folder", w_clip, "--save_every", str(args.steps)]
            + staged + mixed + common)
    eval_s = []

    def run_eval(more):
        stdout, secs = run([sys.executable, os.path.join(REPO, "eval_torch.py"),
                            "--dataset", "vid_320", "--data_root", data_root, "--split", "val",
                            "--batch_size", "8", *dev, *more], capture=True)
        sys.stderr.write(stdout[-4000:])
        eval_s.append(secs)
        return stdout

    out_t = run_eval(["--checkpoint", w_clip, "--temporal", "--motion_breakdown"])
    out_f = run_eval(["--checkpoint", w_frame, "--motion_breakdown"])
    aps_t, aps_f = parse_aps(out_t, CLASSES), parse_aps(out_f, CLASSES)
    result.update({
        "temporal_mAP": mean_ap(aps_t, CLASSES),
        "frame_mAP": mean_ap(aps_f, CLASSES),
        "temporal_per_class": aps_t,
        "frame_per_class": aps_f,
        "steps": args.steps,
    })
    if result["temporal_mAP"] is not None and result["frame_mAP"] is not None:
        result["temporal_advantage"] = round(result["temporal_mAP"] - result["frame_mAP"], 4)
    result["pass"] = result.get("temporal_advantage", 0) > 0
    result["staged"] = bool(args.staged)
    result["mixed_frames"] = args.mixed_frames
    result["extra_train_args"] = args.extra_train_args
    # On this data the temporal advantage should sit in the occlusion-heavy
    # frames; the motion-speed split (eval/motion.py) shows where it lies.
    result["temporal_motion_mAP"] = parse_motion(out_t)
    result["frame_motion_mAP"] = parse_motion(out_f)
    result["train_loss_first_last"] = {"frame": train_losses(w_frame),
                                       "clip": train_losses(w_clip)}
    if args.precision_check:
        for prec, flags in (
            ("bf16", ["--precision", "bf16"]),
            ("int8", ["--precision", "int8"]),
            ("int8_tcb", ["--precision", "int8", "--int8_tcb"]),
            # the whole pyramid int8, the recurrent cell included: the gate
            # for quantizing the state carried through occlusions
            ("int8_full", ["--precision", "int8", "--int8_tcb", "--int8_gru"]),
        ):
            aps_p = parse_aps(run_eval(["--checkpoint", w_clip, "--temporal"] + flags), CLASSES)
            result[f"temporal_mAP_{prec}"] = mean_ap(aps_p, CLASSES)
            if result[f"temporal_mAP_{prec}"] is not None and result["temporal_mAP"] is not None:
                result[f"{prec}_delta"] = round(
                    result[f"temporal_mAP_{prec}"] - result["temporal_mAP"], 4)
    result.update(eval_s=eval_s, card=card_line(args.device), loader=args.loader)
    record(result, args.record)
    return result


if __name__ == "__main__":
    main()
