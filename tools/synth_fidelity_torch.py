"""Synthetic fidelity harness of the PyTorch / CUDA port: the counterpart of
tools/synth_fidelity.py, driving train_torch.py and eval_torch.py.

No VOC data is in the repository, so the port's training is judged end to
end on the reference harness's synthetic detection tasks, generated by that
harness's own ``generate`` (imported, not copied: the same data for a seed):

* the easy profile: solid-color rectangles on gray noise, color <-> class (4
  classes), non-overlapping; a correct pipeline reaches mAP ~1.0, and the
  pass bar is 0.9;
* ``--hard``: 10 classes keyed by (color, texture), overlapping and nested
  boxes, scales 0.05-0.6, unannotated distractors; the pass bar is 0.45.

It trains voc_320 with train_torch.py (the reference's schedule, photometric
distortion off: color is the class) and evaluates the held-out split with
eval_torch.py, each in a subprocess, on the card unless ``--device cpu``.
The options are the reference's: ``--prefilter_check`` (eval again with
``--prefilter 512``), ``--precision_check`` (bf16, int8, int8 with the TCB),
``--qat_check`` (calibrate and save scales, PTQ on them, a QAT fine-tune with
``--qat --int8_scales --init_from``, the QAT model served int8 on the same
scales), ``--skip_gen``/``--skip_train``/``--gen_only`` and
``--extra_train_args``; besides, ``--device``, ``--loader`` (train_torch.py's;
worker processes by default) and ``--record`` (also write the result to a
file). The data and weights go under ``--out``, by default
``build/synth_fidelity`` in the checkout (a directory of its own, never the
reference harness's).

    python tools/synth_fidelity_torch.py --steps 3000
    python tools/synth_fidelity_torch.py --hard --steps 6000 --prefilter_check \
        --out build/synth_hard
    # prints one JSON line: {"mAP": ..., "per_class": {...}, "pass": ...,
    #   "card": <nvidia-smi name, power limit>, "loader": ..., ...}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, TOOLS)

from synth_fidelity import CLASSES, HARD_CLASSES, generate  # noqa: E402


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def child_env():
    """The environment with the repository root prepended to PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run(cmd, capture=False):
    """Run a CLI of the repository; returns (its stdout or None, seconds)."""
    print("+", " ".join(cmd), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, check=True, cwd=REPO, env=child_env(),
                         capture_output=capture, text=True)
    return out.stdout, time.perf_counter() - t0


def parse_aps(stdout: str, classes) -> dict:
    """The "AP <class>: <v>" lines of eval_torch.py for the task's classes."""
    aps = {}
    for line in stdout.splitlines():
        toks = line.replace(":", " ").split()
        if len(toks) >= 3 and toks[0] == "AP" and toks[1] in classes:
            aps[toks[1]] = float(toks[2])
    return aps


def mean_ap(aps: dict, classes):
    """The mean over the task's classes (eval_torch.py's own mAP averages all
    of the dataset's names), or None if one is missing."""
    return float(np.mean([aps[c] for c in classes])) if len(aps) == len(classes) else None


def train_losses(save_folder: str):
    """(first, last) loss train_torch.py logged to <save_folder>/metrics.jsonl,
    or None where it logged none."""
    path = os.path.join(save_folder, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    return [losses[0], losses[-1]] if losses else None


def record(result: dict, path) -> None:
    print(json.dumps(result), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "synth_fidelity"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gen_only", action="store_true")
    ap.add_argument("--skip_gen", action="store_true")
    ap.add_argument("--threshold", type=float, default=None,
                    help="pass bar on mAP (default 0.9 easy / 0.45 hard)")
    ap.add_argument("--hard", action="store_true",
                    help="discriminative profile: 10 confusable (color, texture) classes, "
                         "overlap/nesting, scales 0.05-0.6, unannotated distractors")
    ap.add_argument("--n_train", type=int, default=None,
                    help="train images (default 240 easy / 360 hard)")
    ap.add_argument("--prefilter_check", action="store_true",
                    help="also eval with --prefilter 512 and report per-class AP deltas "
                         "against the exact path")
    ap.add_argument("--precision_check", action="store_true",
                    help="also eval with the bf16 / int8 / int8+tcb serving profiles and "
                         "report mAP deltas against fp32")
    ap.add_argument("--qat_check", action="store_true",
                    help="calibrate int8 scales (eval_torch.py --save_scales), PTQ on them, "
                         "fine-tune with train_torch.py --qat --init_from, then eval the "
                         "result int8 on the SAME scales; reports mAP_int8_qat against PTQ")
    ap.add_argument("--qat_steps", type=int, default=None,
                    help="QAT fine-tune steps (default steps/4, at least 200)")
    ap.add_argument("--skip_train", action="store_true",
                    help="re-eval an existing --out/weights checkpoint")
    ap.add_argument("--extra_train_args", default="",
                    help="extra train_torch.py flags, e.g. '--stem s2d'")
    ap.add_argument("--device", default="cuda",
                    help="passed to train_torch.py and eval_torch.py (cuda, or cpu)")
    ap.add_argument("--loader", default="processes", choices=["threads", "processes"],
                    help="train_torch.py's input pipeline")
    ap.add_argument("--record", default=None, help="also write the result JSON to this file")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    classes = HARD_CLASSES if args.hard else CLASSES
    threshold = args.threshold if args.threshold is not None else (0.45 if args.hard else 0.9)

    data_root = os.path.join(args.out, "data")
    weights = os.path.join(args.out, "weights")
    if not args.skip_gen:
        n_train = args.n_train or (360 if args.hard else 240)
        n_test = 36 if args.hard else 24
        generate(data_root, n_train=n_train, n_test=n_test, seed=args.seed, hard=args.hard)
    if args.gen_only:
        return {}

    extra = args.extra_train_args.split()
    dev = ["--device", args.device]

    def train_cmd(save_folder, steps, lr, warmup, more=()):
        # Color IS the class signal: photometric distortion off (NOTES.md).
        return [
            sys.executable, os.path.join(REPO, "train_torch.py"),
            "--dataset", "voc_320", "--data_root", data_root,
            "--image_sets", "2007:trainval", "--batch_size", str(args.batch_size),
            "--max_iter", str(steps), "--lr", str(lr),
            "--warmup", str(warmup), "--milestones", str(int(steps * 0.75)),
            "--save_folder", save_folder, "--save_every", str(steps),
            "--no_photometric", "--log_every", "50", "--seed", str(args.seed),
            "--loader", args.loader, *dev, *more,
        ] + extra

    result = {"profile": "hard" if args.hard else "easy"}
    if not args.skip_train:
        _, result["train_s"] = run(train_cmd(weights, args.steps, args.lr, 200))
    eval_s = []

    def run_eval(more=(), ckpt=None):
        stdout, secs = run([
            sys.executable, os.path.join(REPO, "eval_torch.py"),
            "--dataset", "voc_320", "--data_root", data_root,
            "--checkpoint", ckpt or weights, "--split", "2007:test",
            "--batch_size", "8", *dev, *more,
        ], capture=True)
        sys.stderr.write(stdout[-4000:])
        eval_s.append(secs)
        aps = parse_aps(stdout, classes)
        return mean_ap(aps, classes), aps

    map_exact, aps = run_eval()
    result.update({
        "mAP": map_exact,
        "per_class": aps,
        "threshold": threshold,
        "steps": args.steps,
        "pass": map_exact is not None and map_exact >= threshold,
        "train_loss_first_last": train_losses(weights),
    })
    delta = lambda a, b: None if a is None or b is None else round(a - b, 6)
    if args.prefilter_check:
        map_pf, aps_pf = run_eval(("--prefilter", "512"))
        result["prefilter_mAP"] = map_pf
        result["prefilter_delta"] = delta(map_pf, map_exact)
        result["prefilter_per_class_delta"] = {
            c: round(aps_pf[c] - aps[c], 6) for c in aps if c in aps_pf}
    if args.precision_check:
        for prec, more in (("bf16", ("--precision", "bf16")),
                           ("int8", ("--precision", "int8")),
                           ("int8_tcb", ("--precision", "int8", "--int8_tcb"))):
            map_p, _ = run_eval(more)
            result[f"mAP_{prec}"] = map_p
            result[f"{prec}_delta"] = delta(map_p, map_exact)
    if args.qat_check:
        # 1. Calibrate once, offline (backbone + TCB keys: QAT covers both).
        scales = os.path.join(args.out, "int8_scales.json")
        run_eval(("--precision", "int8", "--int8_tcb", "--save_scales", scales))
        # 2. The PTQ baseline on those exact scales (what QAT must beat).
        map_ptq, _ = run_eval(("--precision", "int8", "--int8_scales", scales))
        # 3. Fine-tune with fake quantization on the same grids.
        weights_qat = os.path.join(args.out, "weights_qat")
        qat_steps = args.qat_steps or max(200, args.steps // 4)
        _, result["qat_train_s"] = run(train_cmd(
            weights_qat, qat_steps, args.lr * 0.1, 50,
            ("--qat", "--int8_scales", scales, "--init_from", weights)))
        # 4. Serve the QAT checkpoint int8 on the SAME scales.
        map_qat, _ = run_eval(("--precision", "int8", "--int8_scales", scales),
                              ckpt=weights_qat)
        result["mAP_int8_ptq"] = map_ptq
        result["mAP_int8_qat"] = map_qat
        result["qat_steps"] = qat_steps
        result["qat_vs_ptq_delta"] = delta(map_qat, map_ptq)
        result["qat_vs_fp32_delta"] = delta(map_qat, map_exact)
    result.update(eval_s=eval_s, card=card_line(args.device), loader=args.loader,
                  extra_train_args=args.extra_train_args)
    record(result, args.record)
    return result


if __name__ == "__main__":
    main()
