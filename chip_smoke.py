#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (tdrn_tpu_torch) on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # build, check every kernel, drive both paths
    python3 chip_smoke.py --profile  # also write torch.profiler breakdowns of three
                                     # streaming steps (cuDNN TF32 on) of the fp32
                                     # path to chiprun_out/profile.txt and of the
                                     # bf16 serving path to chiprun_out/profile_bf16.txt

1. Prints the card (nvidia-smi name and power limit) and the torch / CUDA versions.
2. Builds the four kernels from tdrn_tpu_torch/csrc/*.cu with nvcc for sm_90a,
   one nvcc per source, all at once, into build/tdrn_tpu_torch/.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (B=16, vid_320), and times both with CUDA events
   (median of 30 launches after warm-up, L2 flushed by a read before each,
   then the card held busy for about 0.1 ms so the events time the card
   and not the host's launch).
   K1 also at B=3, P=1000, C=21 and C=2 with its logits starting 0-3 floats
   off a 16-byte boundary and with NaN logits, its per-anchor max bit-equal
   to scores_cm.amax(1), NaN included. K2 also at K in 1, 63, 64, 65, 200, 256, 1024 with one
   row and with 496, thresholds 0 and 0.45, empty rows and rows whose
   positive scores end early or hold zeros, bit-equal to its plain version
   on the card and on the CPU. For K1 and K2 the time warm and three more
   flushed medians are logged beside the flushed one, and K2's time on rows
   that end at 16 of 200.
   K3 and K4 run on fp32 and on bf16 input, and at a ragged shape (B=2,
   44x52: the last tile partial in both axes); K3 on bf16 input must equal
   K3 on the same values in fp32 bit for bit, and K3's fp32-compute route
   (CUDA cores) is held to fp32 convs at 1e-4 of max|ref|. K3 and K4 also
   log TFLOP/s, and the time of the same stage as a cuDNN chain in bf16
   channels_last (conv, ReLU, conv, ReLU, max_pool2d) as a yardstick
   (cudnn_chain_ms); the port never calls that chain.
4. Drives the fp32 path: StreamingDetector at full-width vid_320 (fused stem,
   fused cascade, fp32), random weights from a seeded numpy draw loaded
   through weights.py, 4 streams x 8 steps of 480x640 uint8 frames with a
   reset and an inactive lane. Checks shapes, finiteness, that each kernel
   launched once per step, the reset lane against a fresh run, and one frame
   against the plain versions on the CPU (its raw predictions' error logged).
5. Drives the serving path: the resident-bf16 profile (fused2 stem, fused
   cascade, apply_inference_precision "bf16", prefilter 512) behind
   InferenceServer, 16 client threads each submitting 8 320x320 frames of
   its own stream, one stream reset partway. Checks that K1-K4 each launched
   once per server step, each stream's detections against the same frames
   through a plain StreamingDetector with only that lane active (scores
   within 1e-5), finiteness, the bf16 carry, and one frame's raw predictions
   against the port's CPU plain path in bf16 (5e-2 of max|ref|).
6. Times, before any profiling (a profiler session leaves host overhead
   behind): the fp32 step and the bf16 step at 16 streams (host clock,
   median of 20 steps, each ending in a synchronize, with the host's time
   of the detect() call alone beside it), and frames/s through the server
   with 16 concurrent clients, with its p50/p99 request latency.
7. Prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

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
K3_FP32_REL_TOL = 1e-4  # the same for fp32 compute: fp32 sums in another order
K4_REL_TOL = 1e-3  # the same bound for K4 (tests/test_torch_port_stage.py)
SERVE_SCORE_ATOL = 1e-5  # server against sequential detector (tests/test_serving.py)
BF16_REL_TOL = 5e-2  # bf16 raw predictions, card against CPU (tests/test_precision.py)
STREAMS = 16  # serving lanes and concurrent clients


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(out: str):
    """One line a kernel from nvcc's -Xptxas -v output: its (demangled) name,
    registers, spills and static shared memory."""
    import re
    import shutil

    filt = shutil.which("c++filt")
    name, spill, lines = None, "", []
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            if filt:
                name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip()
            name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]  # drop the argument list
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


SPIN_CYCLES = 200_000  # about 0.1 ms of the card's clock


def time_ms(torch, fn, reps=30, warmup=5, flush_l2=True):
    """Median device time of one call of fn, with the L2 cache flushed before
    each by reading a buffer twice its size (a read leaves no dirty lines
    for the timed call to write back); flush_l2=False times it warm, each
    call after the last with nothing between. The card then spins for
    SPIN_CYCLES before the start event, so the host has enqueued fn's
    launches before the card reaches them and the events time the card
    alone, not the gap in which it waits for a launch."""
    flush = torch.ones(100 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if flush_l2:
            flush.max()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_spread(torch, fn):
    """The flushed median, the warm median and three more flushed medians,
    each of 30 launches, in this order."""
    ms = time_ms(torch, fn)
    warm = time_ms(torch, fn, flush_l2=False)
    return dict(ms=ms, ms_warm=warm, ms_repeats=[time_ms(torch, fn) for _ in range(3)])


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --- kernel phases ---------------------------------------------------------


def _cascade_inputs(torch, rng, b, p, c, lead=0):
    """Seeded K1 inputs on the card. odm_conf and arm_conf are contiguous
    views that start `lead` floats into a buffer of their own, so their rows
    (and the blocks' logit tiles) can start off a 16-byte boundary."""
    from tdrn_tpu_torch.ops.detection import RawPredictions

    def t(a, lead=0):
        a = a.astype(np.float32)
        flat = torch.empty(lead + a.size, device="cuda")
        flat[lead:] = torch.tensor(a.ravel(), device="cuda")
        return flat[lead:].view(a.shape)

    return RawPredictions(
        t(rng.normal(size=(b, p, 4)) * 0.5), t(rng.normal(size=(b, p, 2)) * 2, lead),
        t(rng.normal(size=(b, p, 4)) * 0.5), t(rng.normal(size=(b, p, c)) * 2, lead),
    )


def _same(a, b):
    """Bit-equal, NaN in the same places counting as equal."""
    return a.isnan().equal(b.isnan()) and a.nan_to_num().equal(b.nan_to_num())


def _check_cascade(torch, preds, priors, cfg, what):
    """K1 against its plain version (NaN where it has NaN), and its
    per-anchor output bit-equal to scores_cm.amax(dim=1); returns
    max|kernel - plain| over the values that are not NaN, and the number of
    NaN per-anchor values."""
    from tdrn_tpu_torch.ops.cascade import cascade_plain, fused_refine_cascade

    b, p = preds.arm_loc.shape[:2]
    top = torch.full((b, p), -1.0, device="cuda")
    kb, ks = fused_refine_cascade(preds, priors, cfg, top)
    nb, ns = fused_refine_cascade(preds, priors, cfg)
    pb, ps = cascade_plain(*preds, priors, *cfg.variance, cfg.arm_filter_thresh)
    torch.cuda.synchronize()
    err = max((kb - pb).nan_to_num().abs().max().item(), (ks - ps).nan_to_num().abs().max().item())
    close = lambda x, y: torch.allclose(x, y, atol=K1_ATOL, rtol=K1_RTOL, equal_nan=True)
    check(close(kb, pb), f"K1 {what}: boxes differ ({err})")
    check(close(ks, ps), f"K1 {what}: scores differ ({err})")
    check(_same(top, ks.amax(dim=1)), f"K1 {what}: per-anchor max differs from scores_cm.amax(1)")
    check(_same(nb, kb) and _same(ns, ks), f"K1 {what}: the per-anchor output changed boxes or scores")
    return err, int(top.isnan().sum())


def phase_cascade(torch, rng):
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.ops.cascade import cascade_plain, fused_refine_cascade
    from tdrn_tpu_torch.ops.priors import prior_boxes

    cfg = VID_320
    p, c = cfg.num_priors, cfg.num_classes
    dev = torch.device("cuda")
    # Main shape: P * C = 197,625 floats an image, so image b's logits start
    # b floats off a 16-byte boundary (mod 4): every lead is reached.
    preds = _cascade_inputs(torch, rng, B, p, c)
    priors = prior_boxes(cfg, dev)
    err, _ = _check_cascade(torch, preds, priors, cfg, f"B={B} P={p} C={c}")
    # Ragged: the last tile partial; C=2 is even; the logits start 0-3 floats
    # off a 16-byte boundary.
    rpri = torch.tensor(rng.uniform(0.05, 0.95, (1000, 4)).astype(np.float32), device=dev)
    for rc in (21, 2):
        for lead in range(4):
            _check_cascade(torch, _cascade_inputs(torch, rng, 3, 1000, rc, lead), rpri, cfg,
                           f"B=3 P=1000 C={rc} lead={lead}")
    # A NaN logit makes its anchor's scores NaN, and its per-anchor max NaN
    # as amax gives it.
    nan_preds = _cascade_inputs(torch, rng, 3, 1000, 21, 1)
    nan_preds.odm_conf[:, ::37, 5] = float("nan")
    _, n_nan = _check_cascade(torch, nan_preds, rpri, cfg, "B=3 P=1000 C=21 with NaN logits")
    check(n_nan > 0, "K1 with NaN logits: no per-anchor NaN (every NaN anchor filtered?)")
    log(f"  K1 holds at B={B} P={p} C={c} and at B=3 P=1000 C=21 and C=2, leads 0-3, and with "
        f"NaN logits ({n_nan} NaN anchors); per-anchor max bit-equal to scores_cm.amax(1)")
    plain = lambda: cascade_plain(*preds, priors, *cfg.variance, cfg.arm_filter_thresh)
    kern = lambda: fused_refine_cascade(preds, priors, cfg)
    top = torch.empty((B, p), device=dev)
    times = time_spread(torch, kern)
    plain_ms = time_ms(torch, plain)
    ms_per_anchor = time_ms(torch, lambda: fused_refine_cascade(preds, priors, cfg, top))
    scores_cm = kern()[1]
    amax_ms = time_ms(torch, lambda: scores_cm.amax(dim=1))
    log(f"  K1 flushed {times['ms']:.4f} ms, warm {times['ms_warm']:.4f} ms, flushed repeats "
        f"{', '.join(f'{t:.4f}' for t in times['ms_repeats'])} ms; with the per-anchor max "
        f"{ms_per_anchor:.4f} ms; the amax pass it replaces {amax_ms:.4f} ms")
    nbytes = 4 * (B * p * (4 + 2 + 4 + c) + p * 4 + B * p * 4 + B * c * p)
    ops = B * p * (6 * c + 40)  # softmax ~6 flops a class, decode + ARM filter ~40
    bms, by = bound(nbytes, ops, PEAK_FP32)
    return dict(name="cascade", wrapper="fused_refine_cascade", source="tdrn_tpu_torch/csrc/cascade.cu",
                replaces="tdrn_tpu/ops/cascade_pallas.py:73", max_abs_err=err,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, ms_per_anchor=ms_per_anchor,
                amax_ms=amax_ms, **times)


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


def _sparse_rows(scores, k):
    """Every fourth row all empty; others whose positive scores end at 16 (or
    k // 2), some with zeros inside as well."""
    scores[1::4] = 0.0
    scores[2::4, min(16, k):] = 0.0
    scores[3::4, 1::7] = 0.0
    scores[3::4, max(1, k // 2):] = 0.0
    return scores


def _suppress_plain_rows(torch, boxes, scores, thresh, rows=64):
    """suppress_plain a block of rows at a time (its K x K temporaries)."""
    from tdrn_tpu_torch.ops.nms_suppress import suppress_plain

    return torch.cat([suppress_plain(boxes[i:i + rows], scores[i:i + rows], thresh)
                      for i in range(0, scores.shape[0], rows)])


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
    # Both specialisations (warp a row up to K=256, block a row above), one
    # row and a step's 496, thresholds 0 and 0.45, sparse rows among full ones.
    n = B * VID_320.num_classes
    t0 = time.perf_counter()
    for rk in (1, 63, 64, 65, 200, 256, 1024):
        for rn in (1, n):
            bx, sc = _nms_rows(rng, rn, rk)
            if rn > 1:
                sc = _sparse_rows(sc, rk)
            bg, sg = torch.tensor(bx, device="cuda"), torch.tensor(sc, device="cuda")
            for th in (0.0, thresh):
                g = suppress_sorted(bg, sg, th)
                want = _suppress_plain_rows(torch, bg, sg, th)
                want_cpu = _suppress_plain_rows(torch, torch.tensor(bx), torch.tensor(sc), th)
                torch.cuda.synchronize()
                check(torch.equal(g, want), f"K2 N={rn} K={rk} thresh={th}: differs from the plain version")
                check(torch.equal(g.cpu(), want_cpu), f"K2 N={rn} K={rk} thresh={th}: differs from the CPU")
    log(f"  K2 bit-equal to the plain version on the card and on the CPU at K in 1, 63, 64, 65, "
        f"200, 256, 1024, N in 1, {n}, thresholds 0 and {thresh} ({time.perf_counter() - t0:.1f} s)")
    # Timed at the main path's shape: one row per (frame, class).
    tb, ts = boxes[:n].contiguous(), scores[:n].contiguous()
    times = time_spread(torch, lambda: suppress_sorted(tb, ts, thresh))
    plain_ms = time_ms(torch, lambda: suppress_plain(tb, ts, thresh))
    early = ts.clone()
    early[:, 16:] = 0.0  # positive scores end at 16 of 200
    ms_early = time_ms(torch, lambda: suppress_sorted(tb, early, thresh))
    bx, sc = _nms_rows(rng, n, 1024)
    b1k, s1k = torch.tensor(bx, device="cuda"), torch.tensor(sc, device="cuda")
    ms_k1024 = time_ms(torch, lambda: suppress_sorted(b1k, s1k, thresh))
    log(f"  K2 flushed {times['ms']:.4f} ms, warm {times['ms_warm']:.4f} ms, flushed repeats "
        f"{', '.join(f'{t:.4f}' for t in times['ms_repeats'])} ms; rows ending at 16 of 200 "
        f"{ms_early:.4f} ms; {n} rows of K=1024 (block a row) {ms_k1024:.4f} ms")
    nbytes = n * k * (16 + 4 + 4)
    ops = n * (k * (k - 1) / 2 * 14 + 5 * k)  # ~14 flops an IoU pair
    bms, by = bound(nbytes, ops, PEAK_FP32)
    return dict(name="nms_suppress", wrapper="suppress_sorted", source="tdrn_tpu_torch/csrc/nms_suppress.cu",
                replaces="tdrn_tpu/ops/nms_pallas.py:78", max_abs_err=err,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, ms_early=ms_early,
                ms_k1024=ms_k1024, **times)


def _stage_inputs(torch, rng, b, h, w, cin, cmid, cout, x_scale):
    """Seeded fp32 inputs of a fused stage, on the card: x scaled by x_scale
    (a callable of the draw), xavier-uniform kernels, small normal biases."""
    t = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    x = t(x_scale(rng, (b, h, w, cin)))
    k1 = t(rng.uniform(-1, 1, (3, 3, cin, cmid)) * np.sqrt(6 / (9 * (cin + cmid))))
    k2 = t(rng.uniform(-1, 1, (3, 3, cmid, cout)) * np.sqrt(6 / (9 * (cmid + cout))))
    return x, k1, t(rng.normal(0, 0.1, cmid)), k2, t(rng.normal(0, 0.1, cout))


def _bf16(args):
    """x, k1, k2 in bf16; the biases stay fp32."""
    x, k1, b1, k2, b2 = args
    return x.bfloat16(), k1.bfloat16(), b1, k2.bfloat16(), b2


def _rel_err(torch, got, ref, what, tol):
    """max |got - ref| / max |ref|, logged and held to tol; returns max |got - ref|."""
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)}, expected {tuple(ref.shape)}")
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    log(f"  {what}: max|err|={err:.6g} max|ref|={scale:.6g} rel={err / scale:.3g} (bound {tol:g})")
    check(err / scale < tol, f"{what} differs: {err / scale} of max|ref|")
    return err


def cudnn_chain(torch, args):
    """The same stage as one chain of PyTorch calls in bf16 channels_last
    (cuDNN conv, ReLU, conv, ReLU, max_pool2d): a yardstick of speed only,
    which the port never calls. Returns a callable over the given inputs."""
    import torch.nn.functional as F

    x, k1, b1, k2, b2 = args
    cl = torch.channels_last
    xc = x.bfloat16().permute(0, 3, 1, 2).contiguous(memory_format=cl)
    w1 = k1.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=cl)
    w2 = k2.bfloat16().permute(3, 2, 0, 1).contiguous(memory_format=cl)
    c1, c2 = b1.bfloat16(), b2.bfloat16()
    return lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(F.conv2d(xc, w1, c1, padding=1)),
                                                w2, c2, padding=1)), 2, 2)


# Ragged shape of the K3 and K4 checks: the last 16x16 tile is partial in both axes.
RAGGED = (2, 44, 52)


def phase_stem(torch, rng):
    from tdrn_tpu_torch.ops.stem import fused_stem_stage1, stem_plain

    h = w = 320
    cin, n = 3, 64
    pixels = lambda r, shape: r.uniform(0, 255, shape) - 117.0
    a32 = _stage_inputs(torch, rng, B, h, w, cin, n, n, pixels)
    a16 = _bf16(a32)
    f32, b16 = torch.float32, torch.bfloat16
    # bf16 compute (the tensor-core kernel), fp32 input, at the main shape
    # and at a ragged one.
    err = _rel_err(torch, fused_stem_stage1(*a32), stem_plain(*a32, b16, f32),
                   "K3 bf16 compute, fp32 input", K3_REL_TOL)
    rag = _stage_inputs(torch, rng, *RAGGED, cin, n, n, pixels)
    _rel_err(torch, fused_stem_stage1(*rag), stem_plain(*rag, b16, f32),
             f"K3 ragged {RAGGED}", K3_REL_TOL)
    # bf16 input, as the resident-bf16 profile feeds it: the kernel rounds x,
    # k1 and k2 to bf16 first, so it must equal K3 on the same values in fp32.
    got16 = fused_stem_stage1(*a16, out_dtype=f32)
    same = fused_stem_stage1(a16[0].float(), a16[1].float(), a16[2], a16[3].float(), a16[4])
    torch.cuda.synchronize()
    check(torch.equal(got16, same), "K3 on bf16 input differs from K3 on the same values in fp32")
    log("  K3 bf16 input: bit-equal to fp32 input of the same values")
    # fp32 compute: the CUDA-core kernel, against fp32 convs (TF32 off).
    fp32_route = lambda: fused_stem_stage1(*a32, compute_dtype=f32)
    _rel_err(torch, fp32_route(), stem_plain(*a32, f32, f32), "K3 fp32 compute", K3_FP32_REL_TOL)

    kern = lambda: fused_stem_stage1(*a16)  # bf16 in and out, as served
    plain = lambda: stem_plain(*a16, b16, b16)
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    ms_fp32_input = time_ms(torch, lambda: fused_stem_stage1(*a32))
    ms_fp32_compute = time_ms(torch, fp32_route)
    chain_ms = time_ms(torch, cudnn_chain(torch, a16))
    nbytes = 2 * (B * h * w * cin + 9 * cin * n + 9 * n * n + B * h * w // 4 * n) + 4 * 2 * n
    ops = 2 * B * h * w * n * 9 * (cin + n)
    bms, by = bound(nbytes, ops, PEAK_BF16)
    log(f"  K3 bf16 in and out {ms:.4f} ms = {ops / ms / 1e9:.1f} TFLOP/s; fp32 in and out "
        f"{ms_fp32_input:.4f} ms; fp32 compute (CUDA cores) {ms_fp32_compute:.4f} ms; "
        f"cuDNN bf16 chain {chain_ms:.4f} ms")
    return dict(name="stem", wrapper="fused_stem_stage1", source="tdrn_tpu_torch/csrc/stem.cu",
                replaces="tdrn_tpu/ops/stem_pallas.py:189", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, tflops=ops / ms / 1e9,
                cudnn_chain_ms=chain_ms, ms_fp32_input=ms_fp32_input,
                ms_fp32_compute=ms_fp32_compute)


def phase_conv_stage(torch, rng):
    from tdrn_tpu_torch.ops.stem import fused_conv_stage, stem_plain

    h = w = 160
    cin, cmid, cout = 64, 128, 128
    post_relu = lambda r, shape: np.maximum(r.normal(size=shape), 0.0) * 3  # as K3 gives
    a32 = _stage_inputs(torch, rng, B, h, w, cin, cmid, cout, post_relu)
    a16 = _bf16(a32)
    f32, b16 = torch.float32, torch.bfloat16
    err = 0.0
    for name, a in (("fp32", a32), ("bf16", a16)):
        err = max(err, _rel_err(torch, fused_conv_stage(*a, out_dtype=f32),
                                stem_plain(*a, b16, f32), f"K4 {name} input", K4_REL_TOL))
    rag = _bf16(_stage_inputs(torch, rng, *RAGGED, cin, cmid, cout, post_relu))
    _rel_err(torch, fused_conv_stage(*rag, out_dtype=f32), stem_plain(*rag, b16, f32),
             f"K4 ragged {RAGGED}", K4_REL_TOL)
    kern = lambda: fused_conv_stage(*a16)  # bf16 in and out, as served
    plain = lambda: stem_plain(*a16, b16, b16)
    ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
    ms_fp32 = time_ms(torch, lambda: fused_conv_stage(*a32))
    chain_ms = time_ms(torch, cudnn_chain(torch, a16))
    nbytes = 2 * (B * h * w * cin + 9 * cin * cmid + 9 * cmid * cout + B * h * w // 4 * cout)
    ops = 2 * B * h * w * 9 * (cin * cmid + cmid * cout)
    bms, by = bound(nbytes + 4 * (cmid + cout), ops, PEAK_BF16)
    log(f"  K4 bf16 in and out {ms:.4f} ms = {ops / ms / 1e9:.1f} TFLOP/s; fp32 in and out "
        f"{ms_fp32:.4f} ms; cuDNN bf16 chain {chain_ms:.4f} ms")
    return dict(name="conv_stage", wrapper="fused_conv_stage",
                source="tdrn_tpu_torch/csrc/conv_stage.cu",
                replaces="tdrn_tpu/ops/stem_pallas.py:134", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, tflops=ops / ms / 1e9,
                cudnn_chain_ms=chain_ms, ms_fp32_input=ms_fp32)


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
        f"same candidate {same.float().mean().item():.3f}, max|box diff|={box_err:.3g}, "
        f"raw predictions max rel err {raw_rel_err(torch, model, cpu_model, img):.3g} of max|ref|")
    check(score_err < 1e-3 and same.float().mean().item() > 0.9 and box_err < 1e-4,
          "GPU main path disagrees with the CPU plain path")
    return model, launches


def raw_rel_err(torch, model, cpu_model, img):
    """One frame's raw predictions (the four head outputs) on the card against
    the same weights on the CPU: max over the heads of max|diff| / max|ref|."""
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    def raw(m, dev):
        x = preprocess_batch(img.to(dev), m.cfg, m.dtype)
        with torch.inference_mode():
            return m(x, m.zero_state(1))[0]

    g, r = raw(model, "cuda"), raw(cpu_model, "cpu")
    return max(((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(g, r))


def time_streaming(torch, model, streams=16, steps=20, hw=(480, 640), prefilter=None):
    from tdrn_tpu_torch.inference import StreamingDetector

    rng = np.random.default_rng(SEED + 2)
    frames = torch.tensor(rng.integers(0, 256, (streams, *hw, 3), dtype=np.uint8))
    det = StreamingDetector(model, num_streams=streams, prefilter=prefilter)
    for _ in range(3):
        det.detect(frames)
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        det.detect(frames)
        host.append(time.perf_counter() - t0)  # the host's enqueue, before the synchronize
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return det, frames, statistics.median(times) * 1e3, statistics.median(host) * 1e3


def profile_step(torch, det, frames, out_name, steps=3):
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
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("\n".join(lines[:25]))


# --- serving path: resident bf16 behind InferenceServer ----------------------


def serving_model(torch):
    """Full-width vid_320 in the serving profile: fused2 stem, fused cascade,
    the seeded random weights, then the resident-bf16 transform."""
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    return apply_inference_precision(random_params(build_detector(cfg, stem="fused2"), SEED), "bf16")


def serve_clients(server, frames, reset=None):
    """One client thread a stream: thread s submits frames[:, s] in order as
    stream "s<s>"; reset = (s, i) resets stream s before its frame i.
    Returns {s: [(boxes, scores, classes), ...]}."""
    import threading

    results = {s: [] for s in range(frames.shape[1])}
    errors = []

    def client(s):
        try:
            for i in range(frames.shape[0]):
                if reset == (s, i):
                    server.reset_stream(f"s{s}")
                results[s].append(server.submit(f"s{s}", frames[i, s]))
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in results]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    check(all(len(r) == frames.shape[0] for r in results.values()), "a client did not finish")
    return results


def serving_path(torch, counters):
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.serving import InferenceServer
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    model = serving_model(torch)
    cfg = model.cfg
    steps, reset = 8, (5, 4)
    rng = np.random.default_rng(SEED + 3)
    frames = rng.integers(0, 256, (steps, STREAMS, cfg.size, cfg.size, 3), dtype=np.uint8)
    det = StreamingDetector(model, num_streams=STREAMS, prefilter=512)
    server = InferenceServer(det, window_ms=3.0, dispatch_thread=True)  # its warm-up step runs here
    try:
        for c in counters:
            c.launches = 0
        results = serve_clients(server, frames, reset)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        server.close()
    log(f"  serving: {server.frames} frames in {server.steps} server steps, "
        f"launches {launches}, prefilter overflow frames {server.overflow_frames}")
    check(server.frames == steps * STREAMS, f"server ran {server.frames} frames")
    for name, n in launches.items():
        check(n == server.steps, f"{name} launched {n} times in {server.steps} server steps")
    check(all(s.dtype == torch.bfloat16 for s in det.state), "the carried state is not bf16")
    check(all(bool(torch.isfinite(s).all()) for s in det.state), "non-finite state")
    check(all(np.isfinite(r[0]).all() and np.isfinite(r[1]).all()
              for rs in results.values() for r in rs), "non-finite detections")

    # Each stream against the same frames through a plain StreamingDetector
    # with only that stream's lane active (the same batch shape as the server's).
    worst = 0.0
    for s, got in results.items():
        lane = server._lane_of[f"s{s}"]
        ref = StreamingDetector(model, num_streams=STREAMS, prefilter=512)
        buf = np.zeros((STREAMS, cfg.size, cfg.size, 3), np.uint8)
        active = np.zeros((STREAMS,), np.float32)
        active[lane] = 1.0
        for i in range(steps):
            if reset == (s, i):
                ref.reset([lane])
            buf[lane] = frames[i, s]
            want = ref.detect(buf, active=active).scores[lane].cpu().numpy()
            worst = max(worst, float(np.abs(got[i][1] - want).max()))
    log(f"  serving vs sequential detector: max|score diff| = {worst:.3g} over {STREAMS} streams")
    check(worst <= SERVE_SCORE_ATOL, f"server scores differ from the sequential detector by {worst}")

    # One frame's raw predictions against the port's CPU plain path in bf16.
    cpu_model = apply_inference_precision(build_detector(cfg, stem="fused2", device="cpu"), "bf16")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    rel = raw_rel_err(torch, model, cpu_model, torch.tensor(frames[0, :1]))
    log(f"  one frame vs CPU plain path, bf16 raw predictions: max rel err {rel:.3g} "
        f"of max|ref| ({time.perf_counter() - t0:.1f} s)")
    check(rel < BF16_REL_TOL, f"bf16 card predictions differ from the CPU by {rel} of max|ref|")
    return model, launches


def time_server(torch, model, per_client=16):
    """frames/s through InferenceServer with one client thread a stream, and
    the server's request latency percentiles."""
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.serving import InferenceServer, LatencyStats

    size = model.cfg.size
    rng = np.random.default_rng(SEED + 4)
    frames = rng.integers(0, 256, (per_client, STREAMS, size, size, 3), dtype=np.uint8)
    server = InferenceServer(StreamingDetector(model, num_streams=STREAMS, prefilter=512))
    try:
        serve_clients(server, frames[:2])  # warm the lanes
        server.latency, steps0 = LatencyStats(), server.steps
        t0 = time.perf_counter()
        serve_clients(server, frames)
        wall = time.perf_counter() - t0
    finally:
        server.close()
    return per_client * STREAMS / wall, server.steps - steps0, server.latency.snapshot()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tdrn_tpu_torch
    from tdrn_tpu_torch import _build
    from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
    from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
    from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1

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
        for line in ptxas_summary(out):
            log(f"  {name}: {line}")

    rng = np.random.default_rng(SEED)
    results = []
    for label, phase in (("K1 cascade", phase_cascade), ("K2 nms_suppress", phase_nms),
                         ("K3 stem", phase_stem), ("K4 conv_stage", phase_conv_stage)):
        r = phase(torch, rng)
        log(f"{label}: max_abs_err={r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        results.append(r)

    counters = [fused_refine_cascade, suppress_sorted, fused_stem_stage1]
    log("fp32 path (fused stem):")
    model, fp32_launches = main_path(torch, counters)
    log("serving path (resident bf16, fused2 stem, prefilter 512, InferenceServer):")
    model16, launches = serving_path(torch, counters + [fused_conv_stage])

    # Every timing runs before any profiling: a profiler session leaves host
    # overhead behind, and the bf16 step is bound by the host.
    _, _, step_ms, _ = time_streaming(torch, model)
    log(f"streaming vid_320 fp32 S=16 480x640, TF32 off: step {step_ms:.3f} ms, "
        f"{16 / step_ms * 1e3:.1f} frames/s on {card}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    det, frames, tf32_ms, host_ms = time_streaming(torch, model)
    log(f"streaming vid_320 fp32 S=16 480x640, cuDNN TF32 on: step {tf32_ms:.3f} ms "
        f"(host enqueue {host_ms:.3f} ms), {16 / tf32_ms * 1e3:.1f} frames/s on {card}")
    # The serving profile with cuDNN's default TF32 (its fp32 heads).
    det16, frames16, bf16_ms, host_ms = time_streaming(torch, model16, hw=(320, 320), prefilter=512)
    log(f"streaming vid_320 bf16 fused2 S=16 320x320 prefilter 512: step {bf16_ms:.3f} ms "
        f"(host enqueue {host_ms:.3f} ms), {16 / bf16_ms * 1e3:.1f} frames/s on {card}")
    fps, server_steps, lat = time_server(torch, model16)
    log(f"InferenceServer bf16, 16 concurrent clients x 16 frames: {fps:.1f} frames/s in "
        f"{server_steps} steps ({16 * 16 / server_steps:.2f} frames a step), "
        f"request latency {json.dumps(lat)} on {card}")
    if "--profile" in sys.argv[1:]:
        profile_step(torch, det, frames, "profile.txt")
        profile_step(torch, det16, frames16, "profile_bf16.txt")

    extra = ("tflops", "cudnn_chain_ms", "ms_fp32_input", "ms_fp32_compute", "ms_warm",
             "ms_repeats", "ms_per_anchor", "amax_ms", "ms_early", "ms_k1024")
    kernels = [dict(name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
                    launches=launches[r["wrapper"]], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    launches_by_path={"fp32_fused": fp32_launches.get(r["wrapper"], 0),
                                      "bf16_serving": launches[r["wrapper"]]},
                    **{k: r[k] for k in extra if k in r}) for r in results]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
