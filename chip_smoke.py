#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (tdrn_tpu_torch) on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # build, check every kernel, drive the main path
    python3 chip_smoke.py --profile  # also write a torch.profiler breakdown of three
                                     # streaming steps (cuDNN TF32 on) to
                                     # chiprun_out/profile.txt

1. Prints the card (nvidia-smi name and power limit) and the torch / CUDA versions.
2. Builds the three kernels from tdrn_tpu_torch/csrc/*.cu with nvcc for sm_90a,
   one nvcc per source, all at once, into build/tdrn_tpu_torch/.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (B=16, vid_320), and times both with CUDA events
   (median of 30 launches after warm-up, L2 flushed by a read before each).
4. Drives the main path: StreamingDetector at full-width vid_320 (fused stem,
   fused cascade, fp32), random weights from a seeded numpy draw loaded
   through weights.py, 4 streams x 8 steps of 480x640 uint8 frames with a
   reset and an inactive lane. Checks shapes, finiteness, that each kernel
   launched once per step, the reset lane against a fresh run, and one frame
   against the plain versions on the CPU. Then times the steady-state step
   at 16 streams (host clock, median of 20 steps, each ending in a synchronize).
5. Prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failed check raises; there is no fallback to the CPU. It imports nothing
of JAX or of the JAX package tdrn_tpu. TF32 is off for every check, so the
fp32 model and the plain versions compute in fp32; the streaming step is
timed with TF32 off and again with cuDNN's default (TF32 on).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 and fp32 (non-tensor) FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12

SEED = 0
B = 16  # frames per streaming step at the timed shapes
K1_ATOL, K1_RTOL = 1e-5, 1e-4
K3_REL_TOL = 1e-3  # max |kernel - plain| / max |plain|, bf16 (tests/test_torch_port_kernels.py)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=30, warmup=5):
    """Median device time of one call of fn, with the L2 cache flushed before
    each by reading a buffer twice its size (a read leaves no dirty lines
    for the timed call to write back)."""
    flush = torch.ones(100 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.max()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --- kernel phases ---------------------------------------------------------


def phase_cascade(torch, rng):
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.ops.cascade import cascade_plain, fused_refine_cascade
    from tdrn_tpu_torch.ops.detection import RawPredictions
    from tdrn_tpu_torch.ops.priors import prior_boxes

    cfg = VID_320
    p, c = cfg.num_priors, cfg.num_classes
    dev = torch.device("cuda")
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    preds = RawPredictions(
        t(rng.normal(size=(B, p, 4)) * 0.5), t(rng.normal(size=(B, p, 2)) * 2),
        t(rng.normal(size=(B, p, 4)) * 0.5), t(rng.normal(size=(B, p, c)) * 2),
    )
    priors = prior_boxes(cfg, dev)
    plain = lambda: cascade_plain(*preds, priors, *cfg.variance, cfg.arm_filter_thresh)
    kern = lambda: fused_refine_cascade(preds, priors, cfg)
    (kb, ks), (pb, ps) = kern(), plain()
    torch.cuda.synchronize()
    err = max((kb - pb).abs().max().item(), (ks - ps).abs().max().item())
    check(torch.allclose(kb, pb, atol=K1_ATOL, rtol=K1_RTOL), f"K1 boxes differ ({err})")
    check(torch.allclose(ks, ps, atol=K1_ATOL, rtol=K1_RTOL), f"K1 scores differ ({err})")
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    nbytes = 4 * (B * p * (4 + 2 + 4 + c) + p * 4 + B * p * 4 + B * c * p)
    ops = B * p * (6 * c + 40)  # softmax ~6 flops a class, decode + ARM filter ~40
    bms, by = bound(nbytes, ops, PEAK_FP32)
    return dict(name="cascade", wrapper="fused_refine_cascade", source="tdrn_tpu_torch/csrc/cascade.cu",
                replaces="tdrn_tpu/ops/cascade_pallas.py:73", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def _nms_rows(rng, n, k):
    """n score-sorted rows of k candidates: random boxes, pairs placed at an
    IoU within a few ulps of 0.45, degenerate boxes, ties and empty slots."""
    cxy = rng.uniform(0.15, 0.85, (n, k, 2))
    wh = rng.uniform(0.0, 0.3, (n, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    # Equal squares of side s shifted by d have IoU (s - d) / (s + d).
    s = rng.uniform(0.05, 0.3, (n, k // 4))
    d = s * 0.55 / 1.45 * (1 + rng.normal(0, 2e-7, s.shape))
    i = np.arange(k // 4) * 2
    boxes[:, i, 2:] = boxes[:, i, :2] + s[..., None]
    boxes[:, i + 1, :2] = boxes[:, i, :2] + np.stack([d, np.zeros_like(d)], -1)
    boxes[:, i + 1, 2:] = boxes[:, i + 1, :2] + s[..., None]
    deg = rng.random((n, k)) < 0.05  # zero-area and inverted boxes
    boxes[deg, 2] = boxes[deg, 0] - rng.choice([0.0, 0.05], deg.sum())
    scores = np.sort(rng.choice(np.linspace(0.0, 1.0, 50), (n, k)), -1)[:, ::-1]
    return boxes.astype(np.float32), np.ascontiguousarray(scores, dtype=np.float32)


def phase_nms(torch, rng):
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.ops.nms_suppress import suppress_plain, suppress_sorted

    k, thresh = VID_320.top_k, VID_320.nms_thresh
    boxes_np, scores_np = _nms_rows(rng, 2048, k)
    boxes, scores = torch.tensor(boxes_np, device="cuda"), torch.tensor(scores_np, device="cuda")
    got = suppress_sorted(boxes, scores, thresh)
    ref = suppress_plain(boxes, scores, thresh)
    ref_cpu = suppress_sorted(torch.tensor(boxes_np), torch.tensor(scores_np), thresh)
    torch.cuda.synchronize()
    check(torch.equal(got > 0, ref > 0), "K2 keep mask differs from the plain version")
    check(torch.equal(got.cpu() > 0, ref_cpu > 0), "K2 keep mask differs from the CPU plain version")
    err = (got - ref).abs().max().item()
    log(f"  K2 rows=2048 kept={int((got > 0).sum())} of {int((scores > 0).sum())} candidates")
    # Timed at the main path's shape: one row per (frame, class).
    n = B * VID_320.num_classes
    tb, ts = boxes[:n].contiguous(), scores[:n].contiguous()
    ms = time_ms(torch, lambda: suppress_sorted(tb, ts, thresh))
    plain_ms = time_ms(torch, lambda: suppress_plain(tb, ts, thresh))
    nbytes = n * k * (16 + 4 + 4)
    ops = n * (k * (k - 1) / 2 * 14 + 5 * k)  # ~14 flops an IoU pair
    bms, by = bound(nbytes, ops, PEAK_FP32)
    return dict(name="nms_suppress", wrapper="suppress_sorted", source="tdrn_tpu_torch/csrc/nms_suppress.cu",
                replaces="tdrn_tpu/ops/nms_pallas.py:78", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_stem(torch, rng):
    from tdrn_tpu_torch.ops.stem import fused_stem_stage1, stem_plain

    h = w = 320
    cin, n = 3, 64
    t = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    x = t(rng.uniform(0, 255, (B, h, w, cin)) - 117.0)
    k1 = t(rng.uniform(-1, 1, (3, 3, cin, n)) * np.sqrt(6 / (9 * (cin + n))))
    k2 = t(rng.uniform(-1, 1, (3, 3, n, n)) * np.sqrt(6 / (9 * 2 * n)))
    b1, b2 = t(rng.normal(0, 0.1, n)), t(rng.normal(0, 0.1, n))
    kern = lambda: fused_stem_stage1(x, k1, b1, k2, b2)
    plain = lambda: stem_plain(x, k1, b1, k2, b2, torch.bfloat16, torch.float32)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    check(got.shape == (B, h // 2, w // 2, n), f"K3 shape {tuple(got.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"  K3 max|err|={err:.6g} max|ref|={scale:.6g} rel={err / scale:.3g}")
    check(err / scale < K3_REL_TOL, f"K3 differs: {err / scale} of max|ref|")
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    nbytes = 4 * (B * h * w * cin + 9 * cin * n + 9 * n * n + 2 * n + B * h * w // 4 * n)
    ops = 2 * B * h * w * n * 9 * (cin + n)
    bms, by = bound(nbytes, ops, PEAK_BF16)
    return dict(name="stem", wrapper="fused_stem_stage1", source="tdrn_tpu_torch/csrc/stem.cu",
                replaces="tdrn_tpu/ops/stem_pallas.py:189", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


# --- main path --------------------------------------------------------------


def random_params(model, seed):
    """A seeded numpy draw in the JAX layout, loaded through weights.py:
    xavier-uniform kernels, small normal biases, the L2Norm scales as built."""
    from tdrn_tpu_torch import weights

    rng = np.random.default_rng(seed)
    tree = weights.params_to_jax(model.state_dict())

    def fill(node):
        for key, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif key == "kernel":
                kh, kw, ci, co = v.shape
                lim = np.sqrt(6.0 / (kh * kw * (ci + co)))
                node[key] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            elif key == "bias":
                node[key] = rng.normal(0.0, 0.01, v.shape).astype(np.float32)

    fill(tree["params"])
    return weights.load_jax_params(model, tree)


def main_path(torch, counters):
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.inference import StreamingDetector, make_single_image_forward
    from tdrn_tpu_torch.models.detector import build_detector

    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    model = random_params(build_detector(cfg, stem="fused"), SEED)
    s, steps, reset_at, inactive_at = 4, 8, 4, 6
    rng = np.random.default_rng(SEED + 1)
    frames = rng.integers(0, 256, (steps, s, 480, 640, 3), dtype=np.uint8)
    active = lambda i: np.array([1, 1, 0 if i == inactive_at else 1, 1], np.float32)

    det = StreamingDetector(model, num_streams=s)
    for c in counters:
        c.launches = 0
    outs = []
    for i in range(steps):
        if i == reset_at:
            det.reset([1])
        outs.append(det.detect(frames[i], active=active(i)))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"  main path launches over {steps} steps: {launches}")
    for name, n in launches.items():
        check(n == steps, f"{name} launched {n} times in {steps} steps")
    for o in outs:
        check(o.boxes.shape == (s, cfg.top_k, 4) and o.scores.shape == (s, cfg.top_k)
              and o.classes.shape == (s, cfg.top_k) and o.classes.dtype == torch.int32,
              "detection shapes")
        check(bool(torch.isfinite(o.boxes).all() and torch.isfinite(o.scores).all()),
              "non-finite detections")
    check(all(bool(torch.isfinite(t).all()) for t in det.state), "non-finite state")
    n_kept = int((outs[-1].scores > 0).sum())
    log(f"  last step: {n_kept} detections kept over {s} streams, "
        f"top score {outs[-1].scores.max().item():.4f}")

    fresh = StreamingDetector(model, num_streams=s)
    for i in range(reset_at, steps):
        fresh.detect(frames[i], active=active(i))
    diff = max((a[1] - b[1]).abs().max().item() for a, b in zip(det.state, fresh.state))
    log(f"  reset lane vs fresh run: max|diff| = {diff:.3g}")
    check(diff <= 1e-5, f"reset lane state differs from a fresh run by {diff}")

    # One frame against the plain versions on the CPU.
    cpu_model = build_detector(cfg, stem="fused", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    img = torch.tensor(frames[0, :1])
    g = make_single_image_forward(model)(img.cuda())
    r = make_single_image_forward(cpu_model)(img)
    same = (g.boxes.cpu() - r.boxes).abs().amax(-1) < 1e-2
    score_err = (g.scores.cpu() - r.scores).abs().max().item()
    box_err = (g.boxes.cpu() - r.boxes)[same].abs().max().item()
    log(f"  one frame vs CPU plain path: max|score diff|={score_err:.3g}, "
        f"same candidate {same.float().mean().item():.3f}, max|box diff|={box_err:.3g}")
    check(score_err < 1e-3 and same.float().mean().item() > 0.9 and box_err < 1e-4,
          "GPU main path disagrees with the CPU plain path")
    return model, launches


def time_streaming(torch, model, streams=16, steps=20):
    from tdrn_tpu_torch.inference import StreamingDetector

    rng = np.random.default_rng(SEED + 2)
    frames = torch.tensor(rng.integers(0, 256, (streams, 480, 640, 3), dtype=np.uint8))
    det = StreamingDetector(model, num_streams=streams)
    for _ in range(3):
        det.detect(frames)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        det.detect(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return det, frames, statistics.median(times) * 1e3


def profile_step(torch, det, frames, steps=3):
    """Device time by kernel over a few streaming steps, busy and idle share.

    Sums the kernel-level (device) events only, so an aten op and the kernels
    it launches are not counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            det.detect(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [(e.self_device_time_total / 1e3 / steps, e.count // steps, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lines = [f"profiled {steps} steps: wall {wall_ms:.3f} ms/step, device busy "
             f"{busy:.3f} ms/step, idle share {1 - busy / wall_ms:.3f}",
             "ms/step  share  launches/step  kernel"]
    lines += [f"{ms:8.4f} {ms / busy:6.3f} {n:6d}  {key[:110]}" for ms, n, key in rows]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("\n".join(lines[:25]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tdrn_tpu_torch
    from tdrn_tpu_torch import _build
    from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
    from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
    from tdrn_tpu_torch.ops.stem import fused_stem_stage1

    if os.path.dirname(os.path.abspath(tdrn_tpu_torch.__file__)) != os.path.join(HERE, "tdrn_tpu_torch"):
        raise RuntimeError("tdrn_tpu_torch must come from this checkout")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: nvcc sm_90a, {len(logs)} sources compiled in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    results = []
    for label, phase in (("K1 cascade", phase_cascade), ("K2 nms_suppress", phase_nms),
                         ("K3 stem", phase_stem)):
        r = phase(torch, rng)
        log(f"{label}: max_abs_err={r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results.append(r)

    counters = [fused_refine_cascade, suppress_sorted, fused_stem_stage1]
    model, launches = main_path(torch, counters)

    _, _, step_ms = time_streaming(torch, model)
    log(f"streaming vid_320 fp32 S=16 480x640, TF32 off: step {step_ms:.3f} ms, "
        f"{16 / step_ms * 1e3:.1f} frames/s on {card}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    det, frames, tf32_ms = time_streaming(torch, model)
    log(f"streaming vid_320 fp32 S=16 480x640, cuDNN TF32 on: step {tf32_ms:.3f} ms, "
        f"{16 / tf32_ms * 1e3:.1f} frames/s on {card}")
    if "--profile" in sys.argv[1:]:
        profile_step(torch, det, frames)

    kernels = [dict(name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
                    launches=launches[r["wrapper"]], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None) for r in results]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
