#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (tdrn_tpu_torch) on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # build, check every kernel, drive both paths
    python3 chip_smoke.py --profile  # also write torch.profiler breakdowns of three
                                     # graphed streaming steps (cuDNN TF32 on) of the
                                     # ResNet-101 vid_512 path to
                                     # chiprun_out/profile_resnet101_512.txt, of the
                                     # fp32 path to chiprun_out/profile.txt, of the
                                     # bf16 serving path to chiprun_out/profile_bf16.txt,
                                     # of three eager bf16 steps to
                                     # chiprun_out/profile_bf16_eager.txt, and of the
                                     # int8 paths to chiprun_out/profile_int8.txt
                                     # (VID_320) and profile_int8_resnet101_512.txt

1. Prints the card (nvidia-smi name and power limit) and the torch / CUDA versions.
2. Builds the five kernels from tdrn_tpu_torch/csrc/*.cu with nvcc for sm_90a,
   one nvcc per source, all at once, into build/tdrn_tpu_torch/.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (B=16, vid_320) and at a chunk-2 step's (B=32; K2 at
   992 rows), and times both at B=16 with CUDA events
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
3b. Holds K1-K4 at the 512 geometry's shapes, each timed as above with its
   bound: K1 at B=16, P=16320, C=31 (per-anchor max bit-equal); K2 on the
   rows the vid_512 path sorts (K1's output through the 512-anchor
   prefilter and the per-class top-200, 16 x 31 rows of 200), bit-equal on
   the card and on the CPU; K3 at B=16, 512x512 and K4 at B=16, 256x256 x 64,
   bf16 as served, within 1e-3 of max|ref|.
4. Drives the fp32 path: StreamingDetector at full-width vid_320 (fused stem,
   fused cascade, fp32), random weights from a seeded numpy draw loaded
   through weights.py, 4 streams x 6 steps of 480x640 uint8 frames with a
   reset and an inactive lane. On the card every detect() replays the
   step's CUDA graph, so a wrapper's launch counter counts only where the
   step runs eagerly: in its warm-up and its capture. Checks shapes,
   finiteness, each kernel launched once in the warm-up step before each
   capture and once in the capture, one replay a step, the graphed detect() against the eager step
   (StreamingDetector._step called directly on clones of the same state,
   frames and masks: bit-equal expected, scores, boxes and state held at
   1e-5; which one held is logged), the reset lane against a fresh run, and
   one frame against the plain versions on the CPU (its raw predictions'
   error logged).
5. Drives the serving path: the resident-bf16 profile (fused2 stem, fused
   cascade, apply_inference_precision "bf16", prefilter 512) behind
   InferenceServer, whose warm-up step captures the graph, 16 client threads
   each submitting 8 320x320 frames of its own stream, one stream reset
   partway. Checks the launch counts as above, one replay a server step,
   each stream's detections against the same frames through a second
   detector with only that lane active (scores within 1e-5), the graphed
   step against the eager one over 4 steps of all lanes with a reset and
   an inactive lane (the bf16 state must be equal), finiteness, the bf16
   carry, and one frame's raw predictions against the port's CPU plain path
   in bf16 (5e-2 of max|ref|).
6. Drives both profiles at chunk=2 (16 streams x 4 frames of 320x320 in two
   steps, a reset at the chunk boundary) against four chunk-1 steps: launch
   counts; the carried state within 1e-5 (fp32) or 5e-2 of max|ref| (bf16);
   the sorted scores within 1e-3 (fp32) or 5e-2 (bf16) of max|ref|; at
   least 95 % of each frame's detections matched (same class, score within
   the same share of max|ref|, box within 1e-4 or 1e-2), since at batch 32
   the convolutions sum in another order than at 16 and a last-bit change
   can flip an NMS or top-k decision; and, so that the rule can fail, at
   most 95 % of a frame's detections matched by the other frame of its
   chunk. The raw predictions of one batch-32 forward against two of 16 are
   logged.
6b. Drives the ResNet-101 vid_512 path at full width: FrozenBN, fused
   cascade, the seeded random weights, the resident-bf16 profile,
   StreamingDetector(num_streams=16, prefilter=512), 4 steps of 512x512
   frames with a reset and an inactive lane. Checks K1 and K2 launched once
   in the warm-up and once in the capture (K3 and K4 never), one replay a
   step, shapes, finiteness and a bf16 carry, the graphed detect() against
   the eager step (bit-equal expected), and one frame's raw predictions
   against the port's CPU plain path in bf16 (5e-2 of max|ref|) and in fp32
   with TF32 off (1e-3 of max|ref|); logs max|source| per scale. Then the
   group-norm ResNet-101 at S=4: graphed against eager over 4 steps with a
   reset and an inactive lane.
6c. Drives the plain SSD baseline at full width on VOC_320 (fp32, TF32 off):
   ssd_detect_topk at B=1 and B=8, K2 launched once a call and no other
   kernel, the detections equal to the same function with K2's plain
   version on the card, one image's raw predictions against the CPU (1e-3 of
   max|ref|), and the eager forward + detect timed at both batches.
7. Times, before any profiling (a profiler session leaves host overhead
   behind): the fp32 step and the bf16 step at 16 streams, graphed, with the
   eager step (the frames copied from pageable memory, then _step, as
   detect() ran before the graph) beside each (host clock, median of 20
   steps, each ending in a synchronize, with the host's time of the call
   alone beside it); the bf16 step at chunk 2; and frames/s through the
   server with 16 concurrent clients, with its p50/p99 request latency, for
   the bf16 serving path and for the fp32 model at 320x320; and the
   ResNet-101 vid_512 step, graphed and eager.
8. Under torch.profiler from a detector's construction on (warm-up, capture
   and three replays), for both paths at chunk 1 and at chunk 2: each
   kernel's device events by name, which must show it once in the warm-up
   and once in every replayed step; the same for K1 and K2 on the ResNet-101
   path. Then each other VGG stem (s2d, poly, poly2) and temporal cell
   (light, hybrid) at vid_320 in the resident-bf16 profile, S=4: 4 graphed
   steps against eager with a reset and an inactive lane, the launch
   counts, and K1 and K2 once a replayed step.
8b. The int8 serving profile (utils/quantize.py, QConv on K5), each model
   the seeded random one in the resident-bf16 profile, calibrated with tcb
   and gru on 8 seeded frames (RandomState(1)) and quantized:
   - the int8 profile's main path, VID_320 VGG-16 (conv stem, fused cascade,
     ConvGRU; 37 QConvs) behind InferenceServer with 16 clients x 8 frames,
     with serving path 5's checks; K5 launched once a QConv in each warm-up
     and capture, K3/K4 never;
   - ResNet-101 at vid_512 (126 QConvs), S=16, and s2d + light and hybrid at
     vid_320, S=4: graphed against eager over 4 steps with a reset and an
     inactive lane, the launch counts;
   - on each: one frame's raw predictions against a copy of the model on the
     CPU (the plain versions) within 5e-2 of max|ref|, and the PTQ deviation
     against the same model's bf16 profile (logged); K1, K2 and K5 counted
     a replayed step by the profiler (K5 once a QConv: it quantizes its own
     input, and no PyTorch rounding kernel may run in the step);
   - K5 (the whole QConv: quantize-on-load, s8 wgmma, epilogue) against its
     plain version, bit-equal in bf16 and fp32 input and output, on
     channels_last and NCHW input, on every distinct conv shape of those
     paths, on ragged shapes (B=2, 44x52, Cin 3, 12 and 64, Cout 24) and on
     all +-127 weights with inputs past +-xscale; every shape whose plan
     splits K also launched twice in a CUDA graph replayed twice (the split
     tickets reset); each distinct shape timed with its bound at 1,979
     TOP/s int8 or 3.35 TB/s (bf16 activations read once), TOP/s, the plain
     version's time, torch._int_mm on the same operands quantized for 1x1
     stride-1 shapes (library_ms; its int32 accumulators must equal the
     plain version's) and cuDNN's bf16 conv for the others (a yardstick);
     the sum over each path's step;
   - timed: the VID_320 int8 step and the same model's bf16 step (graphed
     and eager), the ResNet-101 vid_512 int8 step, and the server on the
     VID_320 int8 model.
8c. The entry points (run after the SSD phase, before the timings; their
   profiler counts with the others), VID_320 at full width, S=16:
   - a port checkpoint (train/checkpoint.py) of VID_320 with the conv stem,
     ConvGRU and 256 TCB channels, the seeded random weights, written in
     the call under build/entry_points/;
   - load_inference_model(stem="fused2", precision="bf16") bit-equal in raw
     predictions to the model built directly from the same state_dict;
     4 graphed steps against eager; K2, K3 and K4 once a step (K1 never: no
     CLI sets fused_cascade, prefilter off);
   - a scales file calibrated (tcb, gru) on 8 seeded frames;
     load_inference_model(precision="int8", int8_scales=...) bit-equal to
     apply_int8_backbone on the same scales; graphed against eager; K2 and
     K5 (37 QConvs) counted, K3/K4 never;
   - serve_torch.py's server in this process on 127.0.0.1:0 (threaded, 16
     lanes) on each model: 4 streams x 8 JPEG frames of 480x640 from
     concurrent clients, a reset, each stream against a sequential
     detector on the same decoded and resized frames (1e-5); the launches
     of its warm-up and capture; frames/s and p50/p99 over HTTP with 16
     clients x 8 frames; data/image.py's resize and PIL's decode timed on
     the host, cv2.resize beside them where cv2 exists;
   - eval_torch.py's main on a 16-image mini-VOC (a VOC_320 checkpoint) and
     a 2-snippet mini-VID (--temporal --motion_breakdown), written in the
     call: finite mAP; the --temporal detections against run_streaming on
     the same frames (1e-5); each sub-step's seconds logged.
8d. Training (train/, data/, train_torch.py, tools/train_bench_torch.py),
   after the K5 phase; no kernel of the port runs in a train step:
   - card against host: one VID_320 clip step at full width (VGG-16, conv
     stem, ConvGRU; B=2, T=2, fp32, TF32 off) on the card and on its host
     CPU from the same seeded params (weights.init_weights) and batch: loss
     within 1e-4 relative, num_pos_arm equal, the gradient's global
     relative difference within 1e-3; num_pos_odm and the mined negatives
     of frame 0 logged;
   - train_torch.py in this process on a mini VID (clip mode, T=8, B=2) and
     a mini VOC (batch 8) written in the call: 3 steps and a save, the
     restored train state bit-equal to the saved one, a --resume ("resumed
     at step 3"); a --bf16 --remat clip run; the trained checkpoint read by
     load_inference_model bit-equal in raw predictions to the in-memory
     params; a --qat run on scales calibrated (tcb, gru) on 8 seeded frames,
     served with --precision int8 on the same scales: 37 QConvs, K5 37 times
     and K2 once a replayed step by the profiler's kernel events;
   - 20 bf16 clip steps on one fixed VID_320 batch: the loss must fall below
     0.9 of the first;
   - times (cuDNN TF32 on): tools/train_bench_torch.py at voc_320 b32 fp32
     and bf16 and vid_320 clip T=8 b4 with and without --remat (ms/step,
     images/s, peak memory), a torch.profiler breakdown of the clip step by
     part and kernel kind (chiprun_out/profile_train_vid320_clip.txt) and
     train_torch.py's images/s at voc_320 b32 fp32 with --loader threads and
     --loader processes (8 workers each, steps 21-40 of 40); the numbers also
     go to chiprun_out/training.json.
8e. After training, four phases, each timed:
   - top-k ties (tools/tpu_checks.py::check_topk_equivalence): ops/nms.py's
     _top_k on the card equal to its CPU result in values and index order,
     most scores zeroed and every other trial quantized, at (6375,),
     (16320,), (31, 512) and (21, 6375) with k 200, 512, 200, 200, twice
     each;
   - the input pipeline: data/process_loader.py bit-equal to data/loader.py
     batch for batch over an epoch boundary at 0 and 8 workers, on a
     generated mini-VOC (frames, pinned) and mini-VID (clips, (T, B, ...));
     then images/s at voc_320 b32 with the full SSDAugmentation in steady
     state, 8 threads against 2, 4, 8 and 16 worker processes (at most
     os.cpu_count()), pinned, and 8 of each unpinned; one image's
     augmentation on one thread, the host's cores and /dev/shm logged;
   - native decode: data/native.py's probe of csrc/libtdrn_io.so and its
     reason; where it loads, decode_resize (with and without the mean) and
     decode_resize_batch within 1.0 of PIL's decode and data/image.py's
     resize, and images/s beside theirs; a library that does not load on
     this host is logged, not failed (nothing on the card path uses it);
   - fidelity smoke: tools/synth_fidelity_torch.py's easy profile at full
     width with the worker-process loader, cut in depth to
     FIDELITY_SMOKE_STEPS (300) of the harness's 3000 steps: an AP for each
     of its 4 classes, the training loss falling (the first logged at step
     10 against the last), and eval_torch.py run again in this process on
     its checkpoint: fp32 with K2 launched and the same APs, int8 with K2
     and K5 launched; the mAP logged (chiprun_out/fidelity_smoke.json).
9. Prints {"kernels": [...]} (K5's entry holds the VID_320 int8 step's sum
   and each path's; its per-shape rows go to chiprun_out/k5_shapes.json)
   and, last, {"ok": true, "device": {...}}.

Any failed check raises; there is no fallback to the CPU. It imports nothing
of JAX or of the JAX package tdrn_tpu. TF32 is off for every check, so the
fp32 model and the plain versions compute in fp32; the streaming step is
timed with TF32 off and again with cuDNN's default (TF32 on).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 FLOP/s, int8 OP/s and
# fp32 (non-tensor) FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12

SEED = 0
B = 16  # frames per streaming step at the timed shapes
K1_ATOL, K1_RTOL = 1e-5, 1e-4
K3_REL_TOL = 1e-3  # max |kernel - plain| / max |plain|, bf16 (tests/test_torch_port_kernels.py)
K3_FP32_REL_TOL = 1e-4  # the same for fp32 compute: fp32 sums in another order
K4_REL_TOL = 1e-3  # the same bound for K4 (tests/test_torch_port_stage.py)
SERVE_SCORE_ATOL = 1e-5  # server against sequential detector (tests/test_serving.py)
BF16_REL_TOL = 5e-2  # bf16 raw predictions, card against CPU (tests/test_precision.py)
GRAPH_ATOL = 1e-5  # graphed detect() against the eager step: scores, boxes, fp32 state
# chunk 2 against chunk 1: the fp32 state (tests/test_chunk_streaming.py),
# and the share of detections that match (tests/test_torch_port_serving.py).
CHUNK_STATE_ATOL = 1e-5
CHUNK_MATCH_SHARE = 0.95
# By profile: the sorted scores' max|diff|, and a matched detection's score
# difference, as a share of the frame's max score (PR 5's readings on the
# H100: fp32 2.49e-4, bf16 1.15e-2); a matched box's max|diff|.
CHUNK_SCORE_REL = {"fp32": 1e-3, "bf16": 5e-2}
CHUNK_BOX_ATOL = {"fp32": 1e-4, "bf16": 1e-2}
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
    # A chunk-2 step's batch.
    err = max(err, _check_cascade(torch, _cascade_inputs(torch, rng, 2 * B, p, c), priors, cfg,
                                  f"B={2 * B} P={p} C={c}")[0])
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
    log(f"  K1 holds at B={B} and {2 * B}, P={p} C={c}, and at B=3 P=1000 C=21 and C=2, leads 0-3, and with "
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
    # row and a step's 496 (at the path's K, also a chunk-2 step's 992),
    # thresholds 0 and 0.45, sparse rows among full ones.
    n = B * VID_320.num_classes
    t0 = time.perf_counter()
    for rk in (1, 63, 64, 65, 200, 256, 1024):
        for rn in ((1, n, 2 * n) if rk == k else (1, n)):
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
        f"200, 256, 1024, N in 1, {n} (and {2 * n} at K={k}), thresholds 0 and {thresh} "
        f"({time.perf_counter() - t0:.1f} s)")
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
    # A chunk-2 step's batch, on fp32 input (the fp32 path) and bf16 (serving).
    big = _stage_inputs(torch, rng, 2 * B, h, w, cin, n, n, pixels)
    for name, a in (("fp32", big), ("bf16", _bf16(big))):
        err = max(err, _rel_err(torch, fused_stem_stage1(*a, out_dtype=f32), stem_plain(*a, b16, f32),
                                f"K3 B={2 * B} {name} input", K3_REL_TOL))
    del big

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
    big = _stage_inputs(torch, rng, 2 * B, h, w, cin, cmid, cout, post_relu)  # a chunk-2 step
    for name, a in (("fp32", big), ("bf16", _bf16(big))):
        err = max(err, _rel_err(torch, fused_conv_stage(*a, out_dtype=f32), stem_plain(*a, b16, f32),
                                f"K4 B={2 * B} {name} input", K4_REL_TOL))
    del big
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
    xavier-uniform kernels, small normal biases, the L2Norm and norm scales
    as built but a ResNet block's last (bn3), uniform in [0.1, 0.3). The same draw as weights.load_random_params, kept here because
    chip_compare.py runs these helpers on checkouts that predate it."""
    from tdrn_tpu_torch import weights

    rng = np.random.default_rng(seed)
    tree = weights.params_to_jax(model.state_dict())

    def fill(node, name=""):
        for key, v in node.items():
            if isinstance(v, dict):
                fill(v, key)
            elif key == "kernel":
                kh, kw, ci, co = v.shape
                lim = np.sqrt(6.0 / (kh * kw * (ci + co)))
                node[key] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            elif key == "bias":
                node[key] = rng.normal(0.0, 0.01, v.shape).astype(np.float32)
            elif key == "scale" and name == "bn3":  # a ResNet block's last norm
                node[key] = rng.uniform(0.1, 0.3, v.shape).astype(np.float32)

    fill(tree["params"])
    return weights.load_jax_params(model, tree)


# Device kernel names of each wrapper's kernels, as torch.profiler reports them.
KERNEL_NAMES = {
    "fused_refine_cascade": ("cascade_kernel",),
    "suppress_sorted": ("nms_rows_kernel", "nms_block_kernel"),
    "fused_stem_stage1": ("stem_tc_kernel", "stem_kernel"),
    "fused_conv_stage": ("conv_stage_kernel",),
    "qconv": ("qconv_kernel",),
}


def read_launches(counters, det, what, per_step=None):
    """The wrappers' counts since they were set to 0. A wrapper counts where it
    launches its kernel, which on the card happens in the eager warm-up step
    before each capture and in the capture; a replay calls no wrapper. So
    each kernel of the path must count twice a capture, times its launches a
    step: per_step[name], 1 where not given (K5 runs once a QConv)."""
    launches = {c.__name__: c.launches for c in counters}
    log(f"  {what}: launches {launches}; {det.captures} captures (each after one warm-up "
        f"step), {det.replays} replays")
    check(det.captures >= 1, f"{what}: no capture")
    for name, n in launches.items():
        want = 2 * det.captures * (per_step or {}).get(name, 1)
        check(n == want, f"{what}: {name} launched {n} times, expected {want}: its launches "
                         f"a step in each warm-up and in each capture")
    return launches


def run_graphed(torch, det, frames, reset, inactive):
    """Steps through detect() (graph replays). reset = (step, lane) queues a
    reset before that step; inactive = (step, lane) masks that lane out of it,
    the mask given as a tensor on the card. Returns the detections and a
    snapshot of the state after each step."""
    outs, states = [], []
    for i in range(frames.shape[0]):
        if i == reset[0]:
            det.reset([reset[1]])
        active = torch.from_numpy(step_active(det, i, inactive)).to(det.device)  # on the card
        outs.append(det.detect(frames[i], active=active))
        states.append([s.clone() for s in det.state])
    return outs, states


def step_active(det, i, inactive):
    active = np.ones((det.num_streams,), np.float32)
    if i == inactive[0]:
        active[inactive[1]] = 0.0
    return active


def graphed_vs_eager(torch, det, frames, outs, states, state0, reset, inactive, what):
    """The eager step (StreamingDetector._step, called directly) on clones of
    the same state and the same frames, masks and resets, against the
    graphed detect(): bit-equal expected; the detections' scores and boxes
    held at 1e-5 and the state at 1e-5 (a bf16 state: equal)."""
    dev = det.device
    state = [s.clone() for s in state0]
    bit_equal, score_err, box_err, state_err = True, 0.0, 0.0, 0.0
    for i in range(frames.shape[0]):
        r = torch.zeros(det.num_streams, device=dev)
        if i == reset[0]:
            r[reset[1]] = 1.0
        a = torch.tensor(step_active(det, i, inactive), device=dev)
        state, ref = det._step(state, torch.from_numpy(frames[i]).to(dev), r, a)
        got = outs[i]
        bit_equal &= all(torch.equal(x, y) for x, y in zip(got, ref) if x is not None)
        bit_equal &= all(torch.equal(x, y) for x, y in zip(states[i], state))
        score_err = max(score_err, (got.scores - ref.scores).abs().max().item())
        box_err = max(box_err, (got.boxes - ref.boxes).abs().max().item())
        state_err = max(state_err, max((x.float() - y.float()).abs().max().item()
                                       for x, y in zip(states[i], state)))
    bf16 = state[0].dtype == torch.bfloat16
    held = "bit-equal" if bit_equal else "within tolerance, not bit-equal"
    log(f"  {what}: graphed detect() vs eager _step over {frames.shape[0]} steps: {held}; "
        f"max|score diff| {score_err:.3g}, max|box diff| {box_err:.3g}, max|state diff| "
        f"{state_err:.3g} ({'bf16 state: must be equal' if bf16 else 'bound 1e-5'})")
    check(score_err <= GRAPH_ATOL and box_err <= GRAPH_ATOL, f"{what}: graphed detections differ")
    check(state_err == 0.0 if bf16 else state_err <= GRAPH_ATOL, f"{what}: graphed state differs")
    return held


def main_path(torch, counters):
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.inference import StreamingDetector, make_single_image_forward
    from tdrn_tpu_torch.models.detector import build_detector

    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    model = random_params(build_detector(cfg, stem="fused"), SEED)
    s, steps, reset, inactive = 4, 6, (3, 1), (4, 2)
    rng = np.random.default_rng(SEED + 1)
    frames = rng.integers(0, 256, (steps, s, 480, 640, 3), dtype=np.uint8)

    for c in counters:
        c.launches = 0
    det = StreamingDetector(model, num_streams=s)
    state0 = [t.clone() for t in det.state]
    outs, states = run_graphed(torch, det, frames, reset, inactive)
    torch.cuda.synchronize()
    launches = read_launches(counters, det, f"fp32 path, {steps} steps")
    check(det.replays == steps, f"{det.replays} replays in {steps} steps")
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
    held = graphed_vs_eager(torch, det, frames, outs, states, state0, reset, inactive, "fp32 path")

    fresh = StreamingDetector(model, num_streams=s)
    for i in range(reset[0], steps):
        fresh.detect(frames[i], active=step_active(fresh, i, inactive))
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
    return model, launches, held


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


def time_streaming(torch, model, streams=16, steps=20, hw=(480, 640), prefilter=None, chunk=1):
    """Median step time (host clock, each step ending in a synchronize) and
    median host time of the detect() call alone, over `steps` steps after 3
    warm-up steps. With chunk > 1 a step takes chunk frames a stream."""
    from tdrn_tpu_torch.inference import StreamingDetector

    rng = np.random.default_rng(SEED + 2)
    lead = (streams,) if chunk == 1 else (chunk, streams)
    frames = torch.tensor(rng.integers(0, 256, (*lead, *hw, 3), dtype=np.uint8))
    det = StreamingDetector(model, num_streams=streams, prefilter=prefilter, chunk=chunk)
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


def eager_step(torch, det, frames):
    """A callable that runs one eager step as detect() ran before the graph:
    the frames copied to the card from pageable memory, then
    StreamingDetector._step on a state chain of its own."""
    dev = det.device
    state = [[s.clone() for s in det.state]]
    reset = torch.zeros(det.num_streams, device=dev)
    active = torch.ones(det.num_streams, device=dev)

    def step():
        state[0], out = det._step(state[0], frames.to(dev), reset, active)
        return out

    return step


def time_eager(torch, det, frames, steps=20):
    """time_streaming's medians for the eager step."""
    step = eager_step(torch, det, frames)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3, statistics.median(host) * 1e3


def profile_step(torch, step, out_name, steps=3):
    """Device time by kernel over a few calls of step(), busy and idle share.

    Sums the kernel-level (device) events only, so an aten op and the kernels
    it launches are not counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [(e.self_device_time_total / 1e3 / steps, e.count // steps, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lines = [f"profiled {steps} steps: wall {wall_ms:.3f} ms/step, device busy "
             f"{busy:.3f} ms/step, idle share {1 - busy / wall_ms:.3f}, "
             f"{sum(r[1] for r in rows)} device kernels and copies a step",
             "ms/step  share  launches/step  kernel"]
    lines += [f"{ms:8.4f} {ms / busy:6.3f} {n:6d}  {key[:110]}" for ms, n, key in rows]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    log("\n".join(lines[:25]))


def replayed_kernel_counts(torch, make_det, frames, wrappers, what, steps=3, per_step=None,
                           banned=()):
    """From a detector's construction on, under torch.profiler: its warm-up,
    its capture and `steps` replays. Counts each wrapper's device kernel
    events by name and checks that each kernel ran per_step[name] times (1
    where not given) in the warm-up and in every replayed step (a capture
    runs nothing), and that no device kernel's name holds one of `banned`.
    Returns the kernel runs a replayed step, by wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det = make_det()
        for _ in range(steps):
            det.detect(frames)
        torch.cuda.synchronize()
    counts = {w: 0 for w in wrappers}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for w in wrappers:
            if any(name in e.key for name in KERNEL_NAMES[w]):
                counts[w] += e.count
    hits = {e.key[:90]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and any(b in e.key for b in banned)}
    check(not hits, f"{what}: kernels that must not run: {hits}")
    runs = {w: n / (det.captures + det.replays) for w, n in counts.items()}
    log(f"  {what}: kernel events over {det.captures} warm-up and {det.replays} replayed steps "
        f"{counts}; a replayed step runs {runs}")
    for w, n in counts.items():
        want = (det.captures + det.replays) * (per_step or {}).get(w, 1)
        check(n == want, f"{what}: {w}'s kernel ran {n} times, expected {want}: its runs a "
                         f"step in the warm-up and in each replayed step")
    return runs


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


def serving_path(torch, counters, model, what="bf16 serving path", per_step=None):
    """model behind InferenceServer (16 clients x 8 frames, a reset): launch
    counts (read_launches with per_step), each stream against a sequential
    detector, graphed against eager, finiteness, a bf16 carry, and one
    frame's raw predictions against a copy of the model on the CPU (its
    plain versions) within BF16_REL_TOL of max|ref|."""
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.serving import InferenceServer

    cfg = model.cfg
    steps, reset = 8, (5, 4)
    rng = np.random.default_rng(SEED + 3)
    frames = rng.integers(0, 256, (steps, STREAMS, cfg.size, cfg.size, 3), dtype=np.uint8)
    for c in counters:
        c.launches = 0
    det = StreamingDetector(model, num_streams=STREAMS, prefilter=512)
    server = InferenceServer(det, window_ms=3.0, dispatch_thread=True)  # its warm-up step captures
    try:
        results = serve_clients(server, frames, reset)
        torch.cuda.synchronize()
    finally:
        server.close()
    launches = read_launches(counters, det, f"{what}, {server.steps} server steps", per_step)
    log(f"  serving: {server.frames} frames in {server.steps} server steps, "
        f"prefilter overflow frames {server.overflow_frames}")
    check(server.frames == steps * STREAMS, f"server ran {server.frames} frames")
    check(det.replays == server.steps + 1, f"{det.replays} replays in {server.steps} server "
                                           f"steps and the warm-up step")
    check(all(s.dtype == torch.bfloat16 for s in det.state), "the carried state is not bf16")
    check(all(bool(torch.isfinite(s).all()) for s in det.state), "non-finite state")
    check(all(np.isfinite(r[0]).all() and np.isfinite(r[1]).all()
              for rs in results.values() for r in rs), "non-finite detections")

    # Each stream against the same frames through a second StreamingDetector
    # with only that stream's lane active (the same batch shape as the
    # server's), its state zeroed before each stream.
    ref = StreamingDetector(model, num_streams=STREAMS, prefilter=512)
    worst = 0.0
    for s, got in results.items():
        lane = server._lane_of[f"s{s}"]
        for t in ref.state:
            t.zero_()
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

    # The graphed step against the eager one, all lanes, a reset and an inactive lane.
    for t in ref.state:
        t.zero_()
    state0 = [t.clone() for t in ref.state]
    g_reset, g_inactive = (1, 5), (2, 3)
    outs, states = run_graphed(torch, ref, frames[:4], g_reset, g_inactive)
    held = graphed_vs_eager(torch, ref, frames[:4], outs, states, state0, g_reset, g_inactive,
                            what)
    rel = cpu_rel_err(torch, model, torch.tensor(frames[0, :1]), what)
    return launches, held, rel


def cpu_rel_err(torch, model, img, what):
    """One frame's raw predictions on the card against a copy of the same
    model on the CPU (its plain versions), held at BF16_REL_TOL of max|ref|."""
    t0 = time.perf_counter()
    rel = raw_rel_err(torch, model, copy.deepcopy(model).cpu(), img)
    log(f"  {what}: one frame vs CPU plain path, bf16 raw predictions: max rel err {rel:.3g} "
        f"of max|ref| (bound {BF16_REL_TOL}; {time.perf_counter() - t0:.1f} s)")
    check(rel < BF16_REL_TOL, f"{what}: card predictions differ from the CPU by {rel} of max|ref|")
    return rel


def matched_share(got, ref, score_tol, box_tol):
    """The share of got's detections (score > 0) that ref's list for the same
    frame and lane holds with the same class, the box within box_tol and the
    score within score_tol (tests/test_torch_port_serving.py's rule)."""
    same = ((got.classes[..., :, None] == ref.classes[..., None, :])
            & ((got.boxes[..., :, None, :] - ref.boxes[..., None, :, :]).abs() < box_tol).all(-1)
            & ((got.scores[..., :, None] - ref.scores[..., None, :]).abs() < score_tol)).any(-1)
    live = got.scores > 0
    return (same & live).sum().item() / max(live.sum().item(), 1)


def chunk_path(torch, counters, model, state_tol, what):
    """A profile at chunk=2: 16 streams x 4 frames of 320x320 in two steps,
    lane 5 reset at the chunk boundary, against four chunk-1 steps. The
    carried state is continuous in the inputs and is held at state_tol
    (max|diff|, relative to max|ref| in bf16). The detections pass through
    thresholds, NMS and top-k, where a last-bit change of a box can flip a
    decision: their sorted scores are held at CHUNK_SCORE_REL of the frame's
    max score, and at least CHUNK_MATCH_SHARE of each frame's detections must
    match. So that the match can fail, the other frame of the same chunk
    must match less than that share."""
    from tdrn_tpu_torch.inference import StreamingDetector

    size = model.cfg.size
    frames = np.random.default_rng(SEED + 5).integers(
        0, 256, (4, STREAMS, size, size, 3), dtype=np.uint8)
    bf16 = model.dtype == torch.bfloat16
    score_rel = CHUNK_SCORE_REL["bf16" if bf16 else "fp32"]
    box_tol = CHUNK_BOX_ATOL["bf16" if bf16 else "fp32"]
    prefilter = 512 if bf16 else None
    for c in counters:
        c.launches = 0
    det = StreamingDetector(model, num_streams=STREAMS, prefilter=prefilter, chunk=2)
    out_a = det.detect(frames[0:2])
    det.reset([5])
    out_b = det.detect(frames[2:4])
    torch.cuda.synchronize()
    launches = read_launches(counters, det, f"{what} at chunk 2, 2 steps")
    check(det.replays == 2, f"{det.replays} replays in 2 steps")
    check(out_a.scores.shape == (2, STREAMS, model.cfg.top_k), "chunk-2 detection shape")
    ref = StreamingDetector(model, num_streams=STREAMS, prefilter=prefilter)
    wants, gots = [], []
    for t in range(4):
        if t == 2:
            ref.reset([5])
        wants.append(ref.detect(frames[t]))
        gots.append(type(wants[t])(*(None if f is None else f[t % 2] for f in (out_a, out_b)[t // 2])))
    gap, share, control = 0.0, 1.0, 0.0
    for t, (got, want) in enumerate(zip(gots, wants)):
        scale = want.scores.abs().max().item()
        share = min(share, matched_share(got, want, score_rel * scale, box_tol))
        # The other frame of the same chunk (0 with 1, 2 with 3).
        control = max(control, matched_share(got, wants[t ^ 1], score_rel * scale, box_tol))
        w, g = want.scores.sort(dim=-1).values, got.scores.sort(dim=-1).values
        gap = max(gap, (g - w).abs().max().item() / scale)
    state_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(det.state, ref.state))
    if bf16:
        state_err /= max(b.float().abs().max().item() for b in ref.state)
    log(f"  {what}, chunk 2 vs two chunk-1 steps a chunk: state max|diff| {state_err:.3g} "
        f"{'of max|ref| ' if bf16 else ''}(bound {state_tol:g}); sorted scores max|diff| / "
        f"max|ref| {gap:.3g} (bound {score_rel:g}); matching detections (score within "
        f"{score_rel:g} of max|ref|, box within {box_tol:g}), least share a frame {share:.4f} "
        f"(bound {CHUNK_MATCH_SHARE}); the other frame of the chunk matches at most "
        f"{control:.4f} (bound: below {CHUNK_MATCH_SHARE})")
    check(state_err <= state_tol, f"{what}: chunk-2 state differs from chunk 1 by {state_err}")
    check(gap <= score_rel, f"{what}: chunk-2 sorted scores differ by {gap} of max|ref|")
    check(share >= CHUNK_MATCH_SHARE, f"{what}: only {share} of the chunk-2 detections match")
    check(control < CHUNK_MATCH_SHARE,
          f"{what}: the match rule cannot tell frames apart ({control} match the other frame)")
    return launches


def batch_rel_err(torch, model, frames):
    """One forward of 32 frames against two forwards of 16 (zero state): max
    over the heads of max|diff| / max|ref|. Nonzero where the convolutions
    sum in another order at batch 32, which is what chunk 2 runs at."""
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    with torch.inference_mode():
        x = preprocess_batch(torch.from_numpy(frames).cuda(), model.cfg, model.dtype)
        p32, _ = model(x, model.zero_state(32))
        halves = [model(h, model.zero_state(16))[0] for h in (x[:16], x[16:])]
    return max(((a - torch.cat(b)).abs().max() / torch.cat(b).abs().max()).item()
               for a, b in zip(p32, zip(*halves)))


def time_server(torch, model, per_client=16, prefilter=512):
    """frames/s through InferenceServer with one client thread a stream, and
    the server's request latency percentiles."""
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.serving import InferenceServer, LatencyStats

    size = model.cfg.size
    rng = np.random.default_rng(SEED + 4)
    frames = rng.integers(0, 256, (per_client, STREAMS, size, size, 3), dtype=np.uint8)
    server = InferenceServer(StreamingDetector(model, num_streams=STREAMS, prefilter=prefilter))
    try:
        serve_clients(server, frames[:2])  # warm the lanes
        server.latency, steps0 = LatencyStats(), server.steps
        t0 = time.perf_counter()
        serve_clients(server, frames)
        wall = time.perf_counter() - t0
    finally:
        server.close()
    return per_client * STREAMS / wall, server.steps - steps0, server.latency.snapshot()


def log_times(what, card, graphed, eager, frames_a_step=16):
    (g_ms, g_host), (e_ms, e_host) = graphed, eager
    log(f"{what}: graphed step {g_ms:.3f} ms (host {g_host:.3f} ms), "
        f"{frames_a_step / g_ms * 1e3:.1f} frames/s; eager step {e_ms:.3f} ms "
        f"(host {e_host:.3f} ms), {frames_a_step / e_ms * 1e3:.1f} frames/s on {card}")


def log_server(what, card, res):
    fps, server_steps, lat = res
    log(f"InferenceServer {what}, 16 concurrent clients x 16 frames: {fps:.1f} frames/s in "
        f"{server_steps} steps ({16 * 16 / server_steps:.2f} frames a step), "
        f"request latency {json.dumps(lat)} on {card}")


# --- the 512 geometry: K1-K4 at its shapes ----------------------------------


@contextlib.contextmanager
def k2_replaced(fn):
    """ops/nms.py's K2 wrapper replaced by fn(real_wrapper) while the block
    runs: a recorder of its calls, or K2's plain version."""
    from tdrn_tpu_torch.ops import nms as nms_mod

    real = nms_mod.suppress_sorted
    nms_mod.suppress_sorted = fn(real)
    try:
        yield
    finally:
        nms_mod.suppress_sorted = real


def kernels_512(torch, rng, results, card):
    """K1-K4 at the 512 geometry's shapes: K1 at B=16, P=16320, C=31 (per-anchor
    max bit-equal); K2 bit-equal on the rows the vid_512 path sorts (K1's
    output through the 512-anchor prefilter and the per-class top-200: 16
    streams x 31 classes); K3 at B=16, 512x512 and K4 on its output's shape
    (B=16, 256x256, 64 channels), bf16 as served, within 1e-3 of max|ref|.
    Each timed as at 320 (flushed median of 30) with its bound; the figures
    go into each kernel's entry under "at_512"."""
    from tdrn_tpu_torch.config import VID_512
    from tdrn_tpu_torch.ops.cascade import cascade_plain, fused_refine_cascade
    from tdrn_tpu_torch.ops.detection import detect_topk
    from tdrn_tpu_torch.ops.nms_suppress import suppress_plain, suppress_sorted
    from tdrn_tpu_torch.ops.priors import prior_boxes
    from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1, stem_plain

    cfg = dataclasses.replace(VID_512, fused_cascade=True, prefilter_anchors=512)
    p, c = cfg.num_priors, cfg.num_classes
    by = {r["name"]: r for r in results}
    preds = _cascade_inputs(torch, rng, B, p, c)
    priors = prior_boxes(cfg, torch.device("cuda"))
    err, _ = _check_cascade(torch, preds, priors, cfg, f"B={B} P={p} C={c}")
    ms = time_ms(torch, lambda: fused_refine_cascade(preds, priors, cfg))
    plain_ms = time_ms(torch, lambda: cascade_plain(*preds, priors, *cfg.variance,
                                                    cfg.arm_filter_thresh))
    nbytes = 4 * (B * p * (4 + 2 + 4 + c) + p * 4 + B * p * 4 + B * c * p)
    bms, bb = bound(nbytes, B * p * (6 * c + 40), PEAK_FP32)
    by["cascade"]["at_512"] = dict(shape=[B, p, c], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bms, bound_by=bb)
    log(f"  K1 at B={B} P={p} C={c}: max|err| {err:.3g}, per-anchor max bit-equal; "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({bb}) on {card}")

    calls = []

    def recorder(real):
        def record(boxes, scores, thresh):
            calls.append((boxes.clone(), scores.clone(), thresh))
            return real(boxes, scores, thresh)
        return record

    with k2_replaced(recorder):
        detect_topk(preds, priors, cfg)
    check(len(calls) == 1, f"the vid_512 detect tail called K2 {len(calls)} times, expected once")
    boxes, scores, thresh = calls[0]
    n, k = scores.shape
    check((n, k) == (B * c, cfg.top_k), f"K2 rows of the vid_512 path {tuple(scores.shape)}")
    got, ref = suppress_sorted(boxes, scores, thresh), suppress_plain(boxes, scores, thresh)
    ref_cpu = suppress_plain(boxes.cpu(), scores.cpu(), thresh)
    torch.cuda.synchronize()
    check(torch.equal(got, ref) and torch.equal(got.cpu(), ref_cpu),
          "K2 differs from its plain version on the vid_512 path's rows")
    ms = time_ms(torch, lambda: suppress_sorted(boxes, scores, thresh))
    plain_ms = time_ms(torch, lambda: suppress_plain(boxes, scores, thresh))
    bms, bb = bound(n * k * 24, n * (k * (k - 1) / 2 * 14 + 5 * k), PEAK_FP32)
    by["nms_suppress"]["at_512"] = dict(shape=[n, k], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bms, bound_by=bb)
    log(f"  K2 on the vid_512 path's {n} rows of {k} ({int((scores > 0).sum())} candidates, "
        f"{int((got > 0).sum())} kept): bit-equal on the card and on the CPU; {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({bb}) on {card}")
    del preds, boxes, scores

    f32, b16 = torch.float32, torch.bfloat16
    pixels = lambda r, shape: r.uniform(0, 255, shape) - 117.0
    post_relu = lambda r, shape: np.maximum(r.normal(size=shape), 0.0) * 3
    for name, fn, h, cin, cmid, cout, scale in (
            ("stem", fused_stem_stage1, 512, 3, 64, 64, pixels),
            ("conv_stage", fused_conv_stage, 256, 64, 128, 128, post_relu)):
        a16 = _bf16(_stage_inputs(torch, rng, B, h, h, cin, cmid, cout, scale))
        what = f"{'K3' if name == 'stem' else 'K4'} B={B} {h}x{h}"
        err = _rel_err(torch, fn(*a16, out_dtype=f32), stem_plain(*a16, b16, f32), what,
                       K3_REL_TOL if name == "stem" else K4_REL_TOL)
        ms = time_ms(torch, lambda: fn(*a16))
        plain_ms = time_ms(torch, lambda: stem_plain(*a16, b16, b16))
        nbytes = 2 * (B * h * h * cin + 9 * cin * cmid + 9 * cmid * cout + B * h * h // 4 * cout)
        ops = 2 * B * h * h * 9 * (cin * cmid + cmid * cout)
        bms, bb = bound(nbytes + 4 * (cmid + cout), ops, PEAK_BF16)
        by[name]["at_512"] = dict(shape=[B, h, h, cin], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bms, bound_by=bb, tflops=ops / ms / 1e9)
        log(f"  {what}: {ms:.4f} ms = {ops / ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({bb}) on {card}")
        del a16


# --- ResNet-101 at vid_512, the new stems and cells, and SSD -----------------

K12 = ("fused_refine_cascade", "suppress_sorted")


def check_path_launches(counters, det, what, per_step=None):
    """K1 and K2 launched once a step in each warm-up and each capture, the
    other wrappers as per_step says, and never where it does not name them
    (no path here runs a fused stem)."""
    per = {c.__name__: int(c.__name__ in K12) for c in counters}
    return read_launches(counters, det, what, {**per, **(per_step or {})})


def check_stream(torch, det, outs, what):
    cfg, s = det.cfg, det.num_streams
    for o in outs:
        check(o.boxes.shape == (s, cfg.top_k, 4) and o.classes.dtype == torch.int32,
              f"{what}: detection shapes")
        check(bool(torch.isfinite(o.boxes).all() and torch.isfinite(o.scores).all()),
              f"{what}: non-finite detections")
    check(all(t.dtype == det.model.dtype for t in det.state), f"{what}: the state's dtype")
    check(all(bool(torch.isfinite(t).all()) for t in det.state), f"{what}: non-finite state")


def drive_graphed(torch, counters, model, frames, reset, inactive, what, prefilter=512,
                  per_step=None):
    """A detector of model over frames (steps, S, H, W, 3): launch counts
    (check_path_launches), one replay a step, shapes and finiteness, graphed
    against eager."""
    from tdrn_tpu_torch.inference import StreamingDetector

    for c in counters:
        c.launches = 0
    det = StreamingDetector(model, num_streams=frames.shape[1], prefilter=prefilter)
    state0 = [t.clone() for t in det.state]
    outs, states = run_graphed(torch, det, frames, reset, inactive)
    torch.cuda.synchronize()
    launches = check_path_launches(counters, det, f"{what}, {frames.shape[0]} steps", per_step)
    check(det.replays == frames.shape[0], f"{what}: {det.replays} replays")
    check_stream(torch, det, outs, what)
    held = graphed_vs_eager(torch, det, frames, outs, states, state0, reset, inactive, what)
    return det, launches, held


def resnet_model(torch, norm="frozen", device="cuda"):
    """Full-width ResNet-101 at vid_512 with the fused cascade and the seeded
    random weights, fp32."""
    from tdrn_tpu_torch.config import VID_512
    from tdrn_tpu_torch.models.detector import build_detector

    cfg = dataclasses.replace(VID_512, fused_cascade=True)
    return random_params(build_detector(cfg, backbone="resnet101", backbone_norm=norm,
                                        device=device), SEED)


def resnet_path(torch, counters):
    """The ResNet-101 vid_512 stream in the resident-bf16 profile, 16 streams x
    4 steps of 512x512 frames, prefilter 512, a reset and an inactive lane;
    one frame against the CPU in bf16 (5e-2 of max|ref|) and in fp32 with
    TF32 off (1e-3 of max|ref|); max|source| per scale logged."""
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    fp32 = resnet_model(torch)
    model = apply_inference_precision(fp32, "bf16")
    frames = np.random.default_rng(SEED + 8).integers(0, 256, (4, STREAMS, 512, 512, 3), np.uint8)
    det, launches, held = drive_graphed(torch, counters, model, frames, (2, 5), (3, 7),
                                        "ResNet-101 vid_512 bf16")
    img = torch.tensor(frames[0, :1])
    with torch.inference_mode():
        for m, name in ((fp32, "fp32"), (model, "bf16")):
            src = m.backbone(preprocess_batch(img.cuda(), m.cfg, m.dtype))
            log(f"  max|source| per scale, {name}: "
                f"{[round(s.float().abs().max().item(), 3) for s in src]}")
    t0 = time.perf_counter()
    cpu32 = build_detector(fp32.cfg, backbone="resnet101", device="cpu")
    cpu32.load_state_dict({k: v.cpu() for k, v in fp32.state_dict().items()})
    rel32 = raw_rel_err(torch, fp32, cpu32, img)
    cpu16 = apply_inference_precision(cpu32, "bf16")
    rel16 = raw_rel_err(torch, model, cpu16, img)
    log(f"  one frame vs CPU plain path: raw predictions max rel err fp32 (TF32 off) "
        f"{rel32:.3g} of max|ref| (bound 1e-3), bf16 {rel16:.3g} (bound {BF16_REL_TOL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    check(rel32 < 1e-3, f"ResNet-101 fp32 card predictions differ from the CPU by {rel32}")
    check(rel16 < BF16_REL_TOL, f"ResNet-101 bf16 card predictions differ from the CPU by {rel16}")
    return model, launches, held, dict(rel_err_fp32=rel32, rel_err_bf16=rel16)


def resnet_group_path(torch, counters):
    """The group-norm ResNet-101 at vid_512, bf16, S=4: graphed against eager
    over 4 steps with a reset and an inactive lane."""
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    model = apply_inference_precision(resnet_model(torch, "group"), "bf16")
    frames = np.random.default_rng(SEED + 9).integers(0, 256, (4, 4, 512, 512, 3), np.uint8)
    _, launches, held = drive_graphed(torch, counters, model, frames, (1, 1), (2, 3),
                                      "ResNet-101 group norm vid_512 bf16")
    return launches, held


# The other VGG stems and the temporal cells, each at vid_320 in the
# resident-bf16 profile (fused cascade, prefilter 512).
VARIANT_PATHS = {
    "s2d_320": dict(stem="s2d"), "poly_320": dict(stem="poly"), "poly2_320": dict(stem="poly2"),
    "light_320": dict(temporal_cell="light"), "hybrid_320": dict(temporal_cell="hybrid"),
}


def variant_paths(torch, counters, names):
    """Each variant at S=4 over 4 steps of 320x320 frames: graphed against
    eager, launches, and K1/K2 once a replayed step by the profiler."""
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    frames = np.random.default_rng(SEED + 10).integers(0, 256, (4, 4, 320, 320, 3), np.uint8)
    launches, per_step, held = {}, {}, {}
    for path, kw in VARIANT_PATHS.items():
        t0 = time.perf_counter()
        model = apply_inference_precision(random_params(build_detector(cfg, **kw), SEED), "bf16")
        _, launches[path], held[path] = drive_graphed(torch, counters, model, frames, (2, 1),
                                                      (3, 2), path)
        per_step[path] = replayed_kernel_counts(
            torch, lambda: StreamingDetector(model, num_streams=4, prefilter=512),
            torch.tensor(frames[0]), names, path)
        log(f"  {path}: {time.perf_counter() - t0:.1f} s")
    return launches, per_step, held


def ssd_path(torch, counters, card):
    """The plain SSD baseline at full width on VOC_320, fp32 (TF32 off):
    ssd_detect_topk at B=1 and B=8, K2 launched once a call, the detections
    equal to the same function with K2's plain version on the card, one
    image's raw predictions against the CPU (1e-3 of max|ref|), timed."""
    from tdrn_tpu_torch.config import VOC_320
    from tdrn_tpu_torch.models.ssd import build_ssd, ssd_detect_topk
    from tdrn_tpu_torch.ops.nms_suppress import suppress_plain
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch
    from tdrn_tpu_torch.ops.priors import prior_boxes

    cfg = VOC_320
    model = random_params(build_ssd(cfg), SEED)
    priors = prior_boxes(cfg, torch.device("cuda"))
    imgs = torch.tensor(np.random.default_rng(SEED + 11).integers(0, 256, (8, 320, 320, 3), np.uint8))
    x = preprocess_batch(imgs.cuda(), cfg)

    def run(b):
        with torch.inference_mode():
            loc, conf = model(x[:b])
            return ssd_detect_topk(loc, conf, priors, cfg)

    for c in counters:
        c.launches = 0
    kept = {}
    for b in (1, 8):
        det = run(b)
        with k2_replaced(lambda real: suppress_plain):
            plain = run(b)
        torch.cuda.synchronize()
        check(det.scores.shape == (b, cfg.top_k) and bool(torch.isfinite(det.boxes).all()),
              f"SSD B={b}: shapes or finiteness")
        check(all(torch.equal(u, v) for u, v in zip(det[:3], plain[:3])),
              f"SSD B={b}: detections differ between K2 and its plain version")
        kept[b] = int((det.scores > 0).sum())
    launches = {c.__name__: c.launches for c in counters}
    log(f"  SSD VOC_320: B=1 and B=8 equal with K2 and with its plain version "
        f"({kept[1]} and {kept[8]} detections kept); launches {launches}")
    check(launches["suppress_sorted"] == 2, "SSD: K2 not launched once a call")
    check(all(n == 0 for name, n in launches.items() if name != "suppress_sorted"),
          "SSD: a kernel other than K2 launched")
    cpu = build_ssd(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        g = model(x[:1])
        r = cpu(preprocess_batch(imgs[:1], cfg))
    rel = max(((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(g, r))
    log(f"  SSD one image vs CPU plain path: raw predictions max rel err {rel:.3g} of max|ref| "
        f"(bound 1e-3)")
    check(rel < 1e-3, f"SSD card predictions differ from the CPU by {rel}")
    times = {}
    for b in (1, 8):
        for _ in range(3):
            run(b)
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            run(b)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[b] = statistics.median(ts) * 1e3
        log(f"SSD VOC_320 fp32 (TF32 off), forward + ssd_detect_topk, eager, B={b}: "
            f"{times[b]:.3f} ms, {b / times[b] * 1e3:.1f} images/s on {card}")
    return launches, dict(rel_err=rel, ms_b1=times[1], ms_b8=times[8])



# --- the int8 serving profile: K5 and the int8 paths --------------------------

K5_COUNTS = {"fused_stem_stage1": 0, "fused_conv_stage": 0}  # no fused stem on an int8 path
# PyTorch's rounding kernel: K5 quantizes its own input, so no int8 step may
# run one (ops/qconv.py quantize_act runs it on the plain route only).
QUANTIZE_PASSES = ("round_kernel",)


# --- entry points: checkpoint restore, serve_torch.py, eval_torch.py ---------

EP_LANES = 16  # serve_torch.py --lanes
EP_STREAMS, EP_FRAMES = 4, 8  # HTTP streams x frames each, 480x640 JPEG, held
EP_TIME_FRAMES = 8  # frames a stream in the timed HTTP round, EP_LANES streams
EP_META = {"dataset": "vid_320", "backbone": "vgg16", "temporal": True, "stem": "conv",
           "temporal_cell": "convgru", "tcb_channels": 256, "backbone_norm": "frozen"}
# The entry points' paths: no fused cascade (no CLI sets it), prefilter off.
EP_FUSED2 = {"fused_refine_cascade": 0, "fused_stem_stage1": 1, "fused_conv_stage": 1, "qconv": 0}
EP_INT8 = {"fused_refine_cascade": 0, "fused_stem_stage1": 0, "fused_conv_stage": 0}


def _write_checkpoint(directory, cfg, meta, seed):
    """A port checkpoint (train/checkpoint.py's layout) of cfg's detector with
    the seeded random weights; returns its state_dict on the CPU."""
    import shutil

    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.train import checkpoint

    shutil.rmtree(directory, ignore_errors=True)
    model = build_detector(cfg, temporal=meta["temporal"], stem=meta["stem"])
    weights.load_random_params(model, seed)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    checkpoint.save_params(directory, 1, sd)
    checkpoint.save_meta(directory, meta)
    return sd


def _raw_equal(torch, a, b, frames, what):
    """Raw predictions of two models on the same frames (zero state): bit-equal."""
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    with torch.inference_mode():
        outs = [m(preprocess_batch(frames, m.cfg, m.dtype), m.zero_state(frames.shape[0]))[0]
                for m in (a, b)]
    same = all(torch.equal(x, y) for x, y in zip(*outs))
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(*outs))
    log(f"  {what}: raw predictions {'bit-equal' if same else 'NOT bit-equal'} "
        f"(max|diff| {err:.3g}) over {frames.shape[0]} frames")
    check(same, f"{what}: the restored model differs from the directly built one")


def _http_clients(port, payloads, reset=None, query="&thresh=0"):
    """One client thread a stream: stream s posts payloads[s] in order to
    /detect?stream=e<s><query>; reset = (s, i) posts /reset before frame i.
    Returns ({s: [detections, ...]}, request seconds, wall seconds)."""
    import http.client
    import threading

    results = {s: [] for s in range(len(payloads))}
    seconds, errors = [], []

    def post(conn, path, body):
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"HTTP {resp.status} on {path}: {data[:200]!r}")
        return json.loads(data)

    def client(s):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i, body in enumerate(payloads[s]):
                if reset == (s, i):
                    post(conn, f"/reset?stream=e{s}", b"")
                t0 = time.perf_counter()
                results[s].append(post(conn, f"/detect?stream=e{s}{query}", body)["detections"])
                seconds.append(time.perf_counter() - t0)
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(s,)) for s in results]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    check(all(len(r) == len(payloads[s]) for s, r in results.items()), "an HTTP client did not finish")
    return results, seconds, wall


def http_serving(torch, counters, argv, card, what, per_step):
    """serve_torch.py's server in this process on 127.0.0.1:0 (threaded):
    EP_STREAMS streams x EP_FRAMES 480x640 frames as JPEG from concurrent
    clients (stream 1 reset before its frame 5), each stream's detections
    against a sequential StreamingDetector fed the same decoded and resized
    frames (SERVE_SCORE_ATOL), the launches of the server's warm-up and
    capture; then a timed round of EP_LANES streams x EP_TIME_FRAMES frames.
    Returns (launches, frames/s, latency percentiles)."""
    import threading

    import serve_torch
    from tdrn_tpu_torch.data import image
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.serving import LatencyStats

    rng = np.random.default_rng(SEED + 20)
    frames = rng.integers(0, 256, (EP_LANES, max(EP_FRAMES, EP_TIME_FRAMES), 480, 640, 3),
                          dtype=np.uint8)
    payloads = [[image.encode(f) for f in stream] for stream in frames]
    for c in counters:
        c.launches = 0
    args = serve_torch.parse_args(argv + ["--port", "0", "--mode", "threaded",
                                          "--lanes", str(EP_LANES)])
    t0 = time.perf_counter()
    server, names = serve_torch.build_server(args)
    httpd = serve_torch.make_httpd(args, server, names)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    log(f"  {what}: serve_torch.build_server (restore, precision, warm-up and capture) "
        f"{time.perf_counter() - t0:.1f} s")
    port = httpd.server_address[1]
    reset = (1, 5)
    try:
        results, _, _ = _http_clients(port, [p[:EP_FRAMES] for p in payloads[:EP_STREAMS]], reset)
        torch.cuda.synchronize()
        launches = read_launches(counters, server.det, f"{what}, {server.steps} server steps",
                                 per_step)
        lanes = {s: server._lane_of[f"e{s}"] for s in range(EP_STREAMS)}
        # The timed round: every lane busy, after the lanes are warm; the
        # CLI's default score threshold (0.3).
        steps0 = server.steps
        server.latency = LatencyStats()
        timed, seconds, wall = _http_clients(port, [p[:EP_TIME_FRAMES] for p in payloads],
                                             query="")
        steps = server.steps - steps0
        server_lat = server.latency.snapshot()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=10)
    check(not thread.is_alive(), "the HTTP server thread did not stop")

    model = server.det.model
    ref = StreamingDetector(model, num_streams=EP_LANES)
    worst = 0.0
    for s, got in results.items():
        lane = lanes[s]
        for t in ref.state:
            t.zero_()
        buf = np.zeros((EP_LANES, 320, 320, 3), np.uint8)
        active = np.zeros((EP_LANES,), np.float32)
        active[lane] = 1.0
        for i in range(EP_FRAMES):
            if reset == (s, i):
                ref.reset([lane])
            buf[lane] = image.resize(image.decode(payloads[s][i]), 320)
            out = ref.detect(buf, active=active)
            b, sc, c = (t[lane].cpu().numpy() for t in (out.boxes, out.scores, out.classes))
            dets = got[i]
            check(len(dets) == len(sc) and [d["class"] for d in dets] == [names[int(k) - 1] for k in c],
                  f"{what}: stream {s} frame {i}: classes differ from the sequential detector")
            worst = max(worst, float(np.abs(np.array([d["score"] for d in dets]) - sc).max()),
                        float(np.abs(np.array([d["box"] for d in dets]) - b * [640, 480, 640, 480]).max()))
    log(f"  {what}: HTTP streams vs sequential detector: max|score or pixel-box diff| "
        f"{worst:.3g} over {EP_STREAMS} streams x {EP_FRAMES} frames (bound {SERVE_SCORE_ATOL})")
    check(worst <= SERVE_SCORE_ATOL, f"{what}: HTTP detections differ from the sequential detector")
    a = np.sort(np.asarray(seconds)) * 1e3
    q = lambda p: float(a[min(len(a) - 1, int(p * len(a)))])
    fps = len(seconds) / wall
    lat = {"n": len(a), "p50_ms": round(q(0.5), 3), "p99_ms": round(q(0.99), 3),
           "max_ms": round(float(a[-1]), 3)}
    n_dets = sum(len(d) for r in timed.values() for d in r) / len(seconds)
    log(f"  {what}: HTTP {EP_LANES} clients x {EP_TIME_FRAMES} frames of 480x640 JPEG: {fps:.1f} "
        f"frames/s in {steps} server steps, request latency (client, HTTP round trip) "
        f"{json.dumps(lat)}, InferenceServer.submit {json.dumps(server_lat)}, {n_dets:.1f} "
        f"detections a response (score >= 0.3) on {card}")
    return launches, fps, lat, server_lat


def host_resize_times(card):
    """One 480x640 frame: data/image.py's resize to 320 and PIL's JPEG
    decode on this host, with cv2.resize beside them where cv2 is installed
    (bit-equality logged)."""
    from tdrn_tpu_torch.data import image

    img = np.random.default_rng(SEED + 21).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    data = image.encode(img)

    def per_call(fn, n=50):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    out = {"resize_ms": per_call(lambda: image.resize(img, 320)),
           "decode_ms": per_call(lambda: image.decode(data))}
    try:
        import cv2
    except ImportError:
        out["cv2_resize_ms"], same = None, "cv2 absent"
    else:
        out["cv2_resize_ms"] = per_call(lambda: cv2.resize(img, (320, 320)))
        same = f"bit-equal to cv2 {cv2.__version__}: " + str(
            bool(np.array_equal(image.resize(img, 320), cv2.resize(img, (320, 320)))))
    log(f"  host, one 480x640 frame: data/image.py resize to 320 {out['resize_ms']:.3f} ms, PIL "
        f"JPEG decode {out['decode_ms']:.3f} ms, cv2.resize {out['cv2_resize_ms']} ms ({same}); "
        f"{os.cpu_count()} host cores, torch threads {__import__('torch').get_num_threads()}, "
        f"on {card}")
    return out


def _mini_voc(root, n=16):
    """A VOC2007 test split of n seeded 375x500 JPEGs with 1-3 boxes each."""
    from tdrn_tpu_torch.data import VOC_CLASSES, image

    rng = np.random.default_rng(SEED + 22)
    base = os.path.join(root, "VOC2007")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = [f"{i:06d}" for i in range(n)]
    for img_id in ids:
        image.imwrite(os.path.join(base, "JPEGImages", img_id + ".jpg"),
                      rng.integers(0, 256, (375, 500, 3), dtype=np.uint8))
        objs = ""
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.integers(1, 300), rng.integers(1, 200)
            objs += (f"<object><name>{VOC_CLASSES[int(rng.integers(0, 20))]}</name>"
                     f"<difficult>0</difficult><bndbox><xmin>{x}</xmin><ymin>{y}</ymin>"
                     f"<xmax>{x + 150}</xmax><ymax>{y + 120}</ymax></bndbox></object>")
        with open(os.path.join(base, "Annotations", img_id + ".xml"), "w") as f:
            f.write(f"<annotation>{objs}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def _mini_vid(root, snippets=2, frames=8, split="val"):
    """An ILSVRC VID split (val by default) of seeded 480x640 JPEG snippets,
    one moving object (track 0) a frame."""
    from tdrn_tpu_torch.data import image
    from tdrn_tpu_torch.data.vid import VID_WNID_CLASSES

    rng = np.random.default_rng(SEED + 23)
    for s in range(snippets):
        data = os.path.join(root, "Data", "VID", split, f"snip{s}")
        ann = os.path.join(root, "Annotations", "VID", split, f"snip{s}")
        os.makedirs(data, exist_ok=True)
        os.makedirs(ann, exist_ok=True)
        for f in range(frames):
            image.imwrite(os.path.join(data, f"{f:06d}.JPEG"),
                          rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
            x = 40 + 20 * f * (s + 1)
            with open(os.path.join(ann, f"{f:06d}.xml"), "w") as fh:
                fh.write(f"<annotation><object><trackid>0</trackid><name>{VID_WNID_CLASSES[s][0]}"
                         f"</name><bndbox><xmin>{x}</xmin><ymin>60</ymin><xmax>{x + 200}</xmax>"
                         f"<ymax>300</ymax></bndbox></object></annotation>")


def entry_points(torch, counters, card):
    """The inference entry points at full width: a port checkpoint of
    VID_320 (conv stem, ConvGRU, 256 TCB channels; seeded random weights)
    written through train/checkpoint.py, restored by load_inference_model as
    fused2 bf16 and as int8 (a scales file calibrated on 8 seeded frames),
    each bit-equal to the model built directly and graphed against eager at
    S=16; serve_torch.py over HTTP on each; eval_torch.py on a synthetic
    mini-VOC and mini-VID (--temporal against run_streaming)."""
    from tdrn_tpu_torch.config import VID_320, VOC_320
    from tdrn_tpu_torch.inference import load_inference_model
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch
    from tdrn_tpu_torch.utils.precision import apply_inference_precision
    from tdrn_tpu_torch.utils.quantize import (apply_int8_backbone, calibrate_act_scales,
                                               load_act_scales, save_act_scales)

    work = os.path.join(HERE, "build", "entry_points")
    ck = os.path.join(work, "vid_320")
    times, out = {}, {}
    t0 = time.perf_counter()
    sd = _write_checkpoint(ck, VID_320, EP_META, SEED)
    times["write checkpoint"] = time.perf_counter() - t0
    frames = torch.from_numpy(np.random.default_rng(SEED + 24).integers(
        0, 256, (4, STREAMS, 320, 320, 3), dtype=np.uint8))

    t0 = time.perf_counter()
    fused2 = load_inference_model(ck, stem="fused2", precision="bf16", verbose=False)
    check(fused2.step == 1 and fused2.meta == EP_META and fused2.cfg.name == "vid_320",
          "restored step, meta or config")
    direct = build_detector(VID_320, stem="fused2")
    direct.load_state_dict(sd)
    direct = apply_inference_precision(direct, "bf16")
    _raw_equal(torch, fused2.model, direct, frames[0].cuda(), "restored fused2 bf16")
    del direct
    _, out["launches_fused2"], out["held_fused2"] = drive_graphed(
        torch, counters, fused2.model, frames.numpy(), (1, 5), (2, 3), "restored fused2 bf16",
        prefilter=None, per_step=EP_FUSED2)
    times["restore fused2 bf16, held, graphed"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bf16 = load_inference_model(ck, precision="bf16", verbose=False)
    calib = torch.from_numpy(np.random.RandomState(1).randint(
        0, 255, (8, 320, 320, 3), dtype=np.uint8)).cuda()
    scales = calibrate_act_scales(bf16.model, preprocess_batch(calib, VID_320, torch.bfloat16),
                                  tcb=True, gru=True)
    scales_path = os.path.join(work, "scales.json")
    save_act_scales(scales_path, scales)
    int8 = load_inference_model(ck, precision="int8", int8_scales=scales_path, verbose=False)
    nq = n_qconvs(int8.model)
    check(nq == 37, f"restored int8 has {nq} QConvs, expected 37")
    direct = apply_int8_backbone(bf16.model, act_scales=load_act_scales(scales_path))
    _raw_equal(torch, int8.model, direct, frames[0].cuda(), "restored int8")
    del direct, bf16
    _, out["launches_int8"], out["held_int8"] = drive_graphed(
        torch, counters, int8.model, frames.numpy(), (1, 5), (2, 3), "restored int8",
        prefilter=None, per_step={**EP_INT8, "qconv": nq})
    times["scales, restore int8, held, graphed"] = time.perf_counter() - t0

    out["host"] = host_resize_times(card)
    for name, argv, per_step in (
            ("fused2_bf16", ["--stem", "fused2", "--precision", "bf16"], EP_FUSED2),
            ("int8", ["--precision", "int8", "--int8_scales", scales_path],
             {**EP_INT8, "qconv": nq})):
        t0 = time.perf_counter()
        launches, fps, lat, server_lat = http_serving(
            torch, counters, ["--checkpoint", ck] + argv, card, f"serve_torch.py {name}", per_step)
        out[f"http_{name}"] = dict(frames_per_s=fps, latency=lat, submit_latency=server_lat)
        out[f"launches_http_{name}"] = launches
        times[f"serve_torch.py {name}"] = time.perf_counter() - t0

    import eval_torch
    from tdrn_tpu_torch.data import image
    from tdrn_tpu_torch.data.vid import VIDDetection
    from tdrn_tpu_torch.eval.runner import finalize, run_streaming
    from tdrn_tpu_torch.inference import StreamingDetector

    t0 = time.perf_counter()
    voc_ck = os.path.join(work, "voc_320")
    _write_checkpoint(voc_ck, VOC_320, {**EP_META, "dataset": "voc_320", "temporal": False},
                      SEED + 1)
    _mini_voc(os.path.join(work, "mini_voc"))
    aps, _ = eval_torch.main(["--data_root", os.path.join(work, "mini_voc"),
                              "--checkpoint", voc_ck, "--batch_size", "16"])
    check(np.isfinite(aps["mAP"]), f"eval_torch.py VOC mAP {aps['mAP']}")
    out["voc_map"] = aps["mAP"]
    times["eval_torch.py mini-VOC"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vid_root = os.path.join(work, "mini_vid")
    _mini_vid(vid_root)
    aps, dets = eval_torch.main(["--data_root", vid_root, "--checkpoint", ck, "--temporal",
                                 "--motion_breakdown", "--batch_size", "2"])
    check(np.isfinite(aps["mAP"]), f"eval_torch.py VID mAP {aps['mAP']}")
    ds = VIDDetection(vid_root, "val")
    snippets = [[(f"{rel}/{stem}", (480, 640), image.resize(ds._load_frame(rel, stem)[0], 320))
                 for stem in stems] for rel, stems in ds.snippets]
    model = load_inference_model(ck, temporal=True, verbose=False).model
    want = finalize(run_streaming(StreamingDetector(model, num_streams=2), snippets, 0.01,
                                  progress_every=0))
    check(dets.keys() == want.keys(), "eval_torch.py --temporal: other classes than run_streaming")
    worst = 0.0
    for ci in want:
        check(dets[ci].keys() == want[ci].keys(), f"class {ci}: other frames than run_streaming")
        for k, (b, sc) in want[ci].items():
            check(dets[ci][k][0].shape == b.shape, f"class {ci} frame {k}: other detections")
            worst = max(worst, float(np.abs(dets[ci][k][1] - sc).max(initial=0)),
                        float(np.abs(dets[ci][k][0] - b).max(initial=0)))
    log(f"  eval_torch.py --temporal vs run_streaming on the same frames: max|diff| {worst:.3g} "
        f"(bound {SERVE_SCORE_ATOL}); mAP {aps['mAP']:.4f}, "
        + ", ".join(f"{k} {v:.4f}" for k, v in aps.items() if k.startswith("mAP(")))
    check(worst <= SERVE_SCORE_ATOL, "eval_torch.py --temporal differs from run_streaming")
    out["vid_map"] = aps["mAP"]
    times["eval_torch.py mini-VID --temporal"] = time.perf_counter() - t0
    log("  entry points, seconds by sub-step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return fused2.model, int8.model, out



# --- training: train/, data/, train_torch.py, tools/train_bench_torch.py ------

TRAIN_LOSS_RTOL = 1e-4  # card against host, one fp32 VID_320 clip step
TRAIN_GRAD_REL = 1e-3  # |g_card - g_host| / |g_host| over every parameter
TRAIN_LEARN_STEPS = 20
TRAIN_LEARN_DROP = 0.9  # the last loss below this share of the first (tests/test_loss.py)
TRAIN_LOADER_STEPS = 40  # train_torch.py voc_320 b32 runs timed over their second half
TRAIN_BENCH = (  # tools/train_bench_torch.py cells
    ("voc_320 b32 fp32", ["--config", "voc_320", "--batch", "32"]),
    ("voc_320 b32 bf16", ["--config", "voc_320", "--batch", "32", "--bf16"]),
    ("vid_320 clip T=8 b4", ["--clip", "--batch", "4", "--seq_len", "8"]),
    ("vid_320 clip T=8 b4 remat", ["--clip", "--batch", "4", "--seq_len", "8", "--remat"]),
)


def _train_batch(torch, cfg, t, b, seed, g=8):
    """A seeded (T, B) clip batch: mean-subtracted-range frames and 1-8
    valid boxes of 0.1-0.45 a side per frame (CPU tensors)."""
    from tdrn_tpu_torch.train import Targets

    rng = np.random.default_rng(seed)
    x = rng.uniform(-120.0, 130.0, (t, b, cfg.size, cfg.size, 3)).astype(np.float32)
    xy = rng.uniform(0.05, 0.5, (t, b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(0.1, 0.45, (t, b, g, 2)), 1.0)], -1)
    labels = rng.integers(0, cfg.num_classes - 1, (t, b, g)).astype(np.int32)
    valid = rng.random((t, b, g)) < 0.5
    valid[..., 0] = True
    return torch.from_numpy(x), Targets(torch.from_numpy(boxes.astype(np.float32)),
                                        torch.from_numpy(labels), torch.from_numpy(valid))


def _on(targets, dev):
    return type(targets)(*(t.to(dev) for t in targets))


def _mined_counts(torch, model, x0, tg0, cfg):
    """Frame 0 from the zero state: the ARM and ODM negatives the loss mines
    (train/loss.py's _mine_negatives, recorded)."""
    from tdrn_tpu_torch.ops.priors import prior_boxes
    from tdrn_tpu_torch.train import loss as L

    got, orig = [], L._mine_negatives

    def record(*a):
        m = orig(*a)
        got.append(int(m.sum()))
        return m

    L._mine_negatives = record
    try:
        with torch.no_grad():
            preds, _ = model(x0, model.zero_state(x0.shape[0]))
            _, metrics = L.refine_multibox_loss(preds, prior_boxes(cfg, x0.device), tg0, cfg)
    finally:
        L._mine_negatives = orig
    return {"arm_neg": got[0], "odm_neg": got[1], "num_pos_arm": float(metrics["num_pos_arm"]),
            "num_pos_odm": float(metrics["num_pos_odm"])}


def train_card_vs_host(torch):
    """One VID_320 clip step at full width (B=2, T=2, fp32, TF32 off) on the
    card and on its host CPU (the same plain PyTorch path), from the same
    params and batch; no weight decay or clip, so the first step's momentum
    trace is the gradient."""
    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    model = build_detector(VID_320, device="cpu")
    weights.init_weights(model, torch.Generator().manual_seed(SEED))
    opt = make_optimizer(base_lr=1e-3, warmup_steps=1, weight_decay=0.0, grad_clip_norm=0.0)
    x, tg = _train_batch(torch, VID_320, 2, 2, SEED + 30)
    res = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        step = make_train_step(m, opt, clip_mode=True)
        t0 = time.perf_counter()
        ts, met = step(init_train_state(m, opt), x.to(dev), _on(tg, dev))
        grads = {k: v.cpu() for k, v in ts.opt_state.trace.items()}
        secs = time.perf_counter() - t0
        res[dev] = ({k: float(v) for k, v in met.items()}, grads, secs,
                    _mined_counts(torch, m, x[0].to(dev), _on(type(tg)(*(t[0] for t in tg)), dev),
                                  VID_320))
        del m, step, ts
    (mc, gc, sc, nc), (mh, gh, sh, nh) = res["cuda"], res["cpu"]
    rel = abs(mc["loss"] - mh["loss"]) / abs(mh["loss"])
    num = sum(float(((gc[k] - gh[k]) ** 2).sum()) for k in gh)
    den = sum(float((gh[k] ** 2).sum()) for k in gh)
    grad_rel = (num / den) ** 0.5
    log(f"  card vs host, VID_320 clip step B=2 T=2 fp32: loss {mc['loss']:.6f} / {mh['loss']:.6f} "
        f"(rel {rel:.3g}, bound {TRAIN_LOSS_RTOL}), num_pos_arm {mc['num_pos_arm']:.0f} / "
        f"{mh['num_pos_arm']:.0f}, num_pos_odm {mc['num_pos_odm']:.2f} / {mh['num_pos_odm']:.2f} "
        f"(clip means), |g_card - g_host| / |g_host| {grad_rel:.3g} (bound {TRAIN_GRAD_REL}); "
        f"frame 0 card {json.dumps(nc)}, host {json.dumps(nh)}; step {sc:.2f} s on the card "
        f"(first call), {sh:.2f} s on the host")
    check(rel <= TRAIN_LOSS_RTOL, f"train step: card loss {mc['loss']} vs host {mh['loss']}")
    check(mc["num_pos_arm"] == mh["num_pos_arm"], "train step: num_pos_arm differs card vs host")
    check(grad_rel <= TRAIN_GRAD_REL, f"train step: gradient differs card vs host by {grad_rel}")
    return dict(loss_card=mc["loss"], loss_host=mh["loss"], loss_rel=rel, grad_rel=grad_rel,
                num_pos_odm=(mc["num_pos_odm"], mh["num_pos_odm"]), mined_card=nc, mined_host=nh)


def _quiet(main, argv):
    """main(argv) with its standard output kept: (its result, the text)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def _run_train(argv):
    """train_torch.py's main in this process: (TrainState, last logged
    metrics, its stdout)."""
    import train_torch

    (ts, logged), text = _quiet(train_torch.main, argv)
    return ts, logged, text


def _same_state(torch, a, b, what):
    same = (a.step == b.step and a.opt_state.count == b.opt_state.count
            and a.params.keys() == b.params.keys()
            and all(torch.equal(a.params[k], b.params[k]) for k in a.params)
            and all(torch.equal(a.opt_state.trace[k], b.opt_state.trace[k]) for k in a.params))
    log(f"  {what}: {'bit-equal' if same else 'NOT bit-equal'} (step {b.step}, "
        f"{len(b.params)} params and momentum traces)")
    check(same, f"{what}: the restored train state differs from the saved one")


def train_entry_points(torch, names):
    """train_torch.py on the card at full width, on a mini VID (clip mode,
    T=8, B=2) and a mini VOC (batch 8) written in the call: save, an exact
    restore and a resume; a bf16 --remat clip run; the trained checkpoint
    served bit-equal; a --qat run served int8 on the same scales with K5
    and K2 counted a replayed step."""
    import shutil

    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.inference import StreamingDetector, load_inference_model
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch
    from tdrn_tpu_torch.train.checkpoint import CheckpointManager
    from tdrn_tpu_torch.utils.quantize import calibrate_act_scales, save_act_scales

    work = os.path.join(HERE, "build", "training")
    shutil.rmtree(work, ignore_errors=True)
    vid_root, voc_root = os.path.join(work, "mini_vid"), os.path.join(work, "mini_voc")
    _mini_vid(vid_root, split="train")
    _mini_voc(voc_root)
    common = ["--num_workers", "8", "--log_every", "1", "--warmup", "2"]
    vid = common + ["--dataset", "vid_320", "--data_root", vid_root, "--clip", "--batch_size", "2"]
    times, out = {}, {}

    t0 = time.perf_counter()
    ck = os.path.join(work, "vid_clip")
    argv = vid + ["--save_folder", ck, "--save_every", "3"]
    ts, logged, text = _run_train(argv + ["--max_iter", "3"])
    check(ts.step == 3 and np.isfinite(logged["loss"]), f"train_torch.py clip: {logged}")
    _same_state(torch, ts, CheckpointManager(ck).restore_latest(ts),
                "train_torch.py vid_320 --clip, step 3 saved and restored")
    ts, logged, text = _run_train(argv + ["--max_iter", "4", "--resume"])
    check("resumed at step 3" in text and ts.step == 4, "train_torch.py --resume")
    out["vid_clip_loss"] = logged["loss"]
    times["vid_320 clip 3 steps, restore, resume to 4"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    loaded = load_inference_model(ck, verbose=False)
    check(loaded.step == 4, f"load_inference_model step {loaded.step}")
    direct = build_detector(VID_320)
    direct.load_state_dict(ts.params)
    frames = torch.from_numpy(np.random.default_rng(SEED + 31).integers(
        0, 256, (4, 320, 320, 3), dtype=np.uint8)).cuda()
    _raw_equal(torch, loaded.model, direct, frames, "trained checkpoint served (fp32)")
    del loaded, direct
    times["trained checkpoint served"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, logged, _ = _run_train(common + ["--dataset", "voc_320", "--data_root", voc_root,
                                        "--image_sets", "2007:test", "--batch_size", "8",
                                        "--save_folder", os.path.join(work, "voc"),
                                        "--max_iter", "2"])
    check(np.isfinite(logged["loss"]), f"train_torch.py voc_320: {logged}")
    out["voc_loss"] = logged["loss"]
    times["voc_320 b8 2 steps"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, logged, _ = _run_train(vid + ["--bf16", "--remat", "--save_folder",
                                     os.path.join(work, "vid_bf16"), "--max_iter", "2"])
    check(np.isfinite(logged["loss"]), f"train_torch.py --bf16 --remat: {logged}")
    out["vid_bf16_remat_loss"] = logged["loss"]
    times["vid_320 clip bf16 remat 2 steps"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bf16 = load_inference_model(ck, precision="bf16", verbose=False)
    calib = torch.from_numpy(np.random.RandomState(1).randint(
        0, 255, (8, 320, 320, 3), dtype=np.uint8)).cuda()
    scales_path = os.path.join(work, "scales.json")
    save_act_scales(scales_path, calibrate_act_scales(
        bf16.model, preprocess_batch(calib, VID_320, torch.bfloat16), tcb=True, gru=True))
    del bf16
    qat_ck = os.path.join(work, "vid_qat")
    _, logged, text = _run_train(vid + ["--qat", "--int8_scales", scales_path, "--init_from", ck,
                                        "--save_folder", qat_ck, "--max_iter", "2"])
    check("qat: fake-quantizing 37 convs" in text and np.isfinite(logged["loss"]),
          f"train_torch.py --qat: {logged}")
    out["vid_qat_loss"] = logged["loss"]
    int8 = load_inference_model(qat_ck, precision="int8", int8_scales=scales_path, verbose=False)
    nq = n_qconvs(int8.model)
    check(nq == 37, f"the QAT checkpoint served int8 has {nq} QConvs, expected 37")
    frames8 = torch.from_numpy(np.random.default_rng(SEED + 32).integers(
        0, 256, (STREAMS, 320, 320, 3), dtype=np.uint8))
    out["qat_int8_runs_per_replayed_step"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(int8.model, num_streams=STREAMS), frames8, names,
        "QAT checkpoint served int8", per_step={**EP_INT8, "qconv": nq}, banned=QUANTIZE_PASSES)
    del int8
    times["scales, --qat 2 steps, served int8 and counted"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log("  train_torch.py, seconds by sub-step: "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return out, voc_root


def train_learns(torch):
    """TRAIN_LEARN_STEPS bf16 clip steps (VID_320, B=2, T=2) on one fixed
    batch from seeded init_weights: the loss must fall."""
    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    model = build_detector(VID_320, device="cpu")
    weights.init_weights(model, torch.Generator().manual_seed(SEED + 1))
    model = model.cuda()
    opt = make_optimizer(base_lr=1e-3, warmup_steps=1, milestones=(10 ** 9,))
    step = make_train_step(model, opt, clip_mode=True, compute_dtype=torch.bfloat16)
    x, tg = _train_batch(torch, VID_320, 2, 2, SEED + 33)
    x, tg = x.cuda(), _on(tg, "cuda")
    ts, losses = init_train_state(model, opt), []
    for _ in range(TRAIN_LEARN_STEPS):
        ts, met = step(ts, x, tg)
        losses.append(float(met["loss"]))
    log(f"  {TRAIN_LEARN_STEPS} bf16 clip steps on one batch: loss "
        + " ".join(f"{v:.3f}" for v in losses))
    check(bool(np.isfinite(losses).all()), "training: a non-finite loss")
    check(losses[-1] < TRAIN_LEARN_DROP * losses[0],
          f"training: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    return losses


def train_times(torch, card, voc_root):
    """tools/train_bench_torch.py on each TRAIN_BENCH cell (cuDNN TF32 on,
    PyTorch's default), a profiler breakdown of the vid_320 clip step, and
    train_torch.py's images/s at voc_320 b32 with each --loader."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import train_bench_torch

    res = {}
    quiet = lambda argv: _quiet(train_bench_torch.main, argv)[0]
    for what, argv in TRAIN_BENCH:
        r = quiet(argv + ["--steps", "10", "--warmup", "3"])
        res[what] = {k: r[k] for k in ("ms_per_step", "value", "steps_per_sec",
                                       "peak_memory_gib", "loss")}
        log(f"  train_bench_torch.py {what}: {r['ms_per_step']:.3f} ms/step, "
            f"{r['value']:.1f} images/s, peak {r['peak_memory_gib']:.2f} GiB on {r['device']}")
        torch.cuda.empty_cache()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof = quiet(["--clip", "--batch", "4", "--seq_len", "8", "--steps", "5", "--warmup", "2",
                  "--profile", os.path.join(out_dir, "profile_train_vid320_clip.txt")])
    res["profile vid_320 clip T=8 b4"] = prof["profile_ms_a_step"]
    log(f"  one vid_320 clip T=8 b4 step by part (ms, device time, torch.profiler): "
        f"{json.dumps(prof['profile_ms_a_step'])}")
    torch.cuda.empty_cache()

    for loader in ("threads", "processes"):
        # Steps 21-40: past the batches both loaders prefetch at the start.
        _, logged, _ = _run_train([
            "--dataset", "voc_320", "--data_root", voc_root, "--image_sets", "2007:test",
            "--batch_size", "32", "--num_workers", "8", "--loader", loader,
            "--log_every", str(TRAIN_LOADER_STEPS // 2), "--max_iter", str(TRAIN_LOADER_STEPS),
            "--save_folder", os.path.join(HERE, "build", "training", f"voc32_{loader}")])
        key = f"train_torch.py voc_320 b32 images/s, --loader {loader}"
        res[key] = 32 * logged["steps_per_sec"]
        log(f"  train_torch.py voc_320 b32 fp32 --loader {loader} (8 workers), steps "
            f"{TRAIN_LOADER_STEPS // 2 + 1}-{TRAIN_LOADER_STEPS}: {res[key]:.1f} images/s against "
            f"the step's {res['voc_320 b32 fp32']['value']:.1f} on {card}")
    with open(os.path.join(out_dir, "training.json"), "w") as f:
        json.dump({"card": card, **res}, f, indent=1)
    return res


def training(torch, names, card):
    """The training phase: card against host, train_torch.py end to end,
    the loss falling, train -> serve, and the times. The checks run with
    TF32 off (the timings before this phase turn it on), the times with
    cuDNN's default."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"card_vs_host": train_card_vs_host(torch)}
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["entry_points"], voc_root = train_entry_points(torch, names)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["learn"] = train_learns(torch)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    t0 = time.perf_counter()
    out["times"] = train_times(torch, card, voc_root)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out

# --- top-k ties, the input pipeline, native decode, fidelity smoke -----------

TOPK_CASES = (((6375,), 200), ((16320,), 512), ((31, 512), 200), ((21, 6375), 200))


def topk_ties(torch):
    """tools/tpu_checks.py::check_topk_equivalence on the card: ops/nms.py's
    _top_k equal to its CPU result in values and index order under heavy ties
    (most scores zeroed, and every other trial quantized to sixteenths), at
    the shapes the detect paths select from, two trials each."""
    from tdrn_tpu_torch.ops.nms import _top_k

    rng = np.random.RandomState(0)
    for t in range(2 * len(TOPK_CASES)):
        shape, k = TOPK_CASES[t % len(TOPK_CASES)]
        scores = rng.rand(*shape).astype(np.float32)
        scores[scores < 0.6] = 0.0
        if t % 2:
            scores = np.round(scores * 16) / 16
        v_ref, i_ref = _top_k(torch.from_numpy(scores), k)
        v, i = (x.cpu() for x in _top_k(torch.from_numpy(scores).cuda(), k))
        same = torch.equal(v, v_ref) and torch.equal(i, i_ref)
        log(f"  trial {t}: shape {shape} k={k}, {int((scores == 0).sum())} zeros: "
            f"values and indices {'equal' if same else 'DIFFER'}")
        check(same, f"top-k ties: trial {t} shape {shape} k={k} differs from the CPU's")
    return len(TOPK_CASES) * 2


def _shm_gib():
    st = os.statvfs("/dev/shm")
    return st.f_blocks * st.f_frsize / 2**30, st.f_bavail * st.f_frsize / 2**30


def _images_per_s(loader, batch, workers):
    """Images/s in steady state: the batches the start left in flight (two
    rounds of the workers) are taken first, then two rounds are timed."""
    rounds = max(workers, 4)
    try:
        for _ in range(2 * rounds):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(2 * rounds):
            next(loader)
        return 2 * rounds * batch / (time.perf_counter() - t0)
    finally:
        loader.close()


def loader_phase(torch, card):
    """data/process_loader.py against data/loader.py: the same batches bit for
    bit over an epoch boundary at 0 and 8 workers, on a mini-VOC (frame mode)
    and a mini-VID (clip mode, (T, B, ...)); then images/s at voc_320 b32 with
    the full augmentation, 8 threads against 2-16 worker processes, pinned,
    and 8 of each unpinned; and one image's augmentation on one thread."""
    import shutil

    from tdrn_tpu_torch.data import SSDAugmentation, VIDDetection, VOCDetection
    from tdrn_tpu_torch.data.loader import make_loader
    from tdrn_tpu_torch.data.process_loader import make_process_loader

    work = os.path.join(HERE, "build", "loader")
    shutil.rmtree(work, ignore_errors=True)
    voc_root, vid_root = os.path.join(work, "mini_voc"), os.path.join(work, "mini_vid")
    _mini_voc(voc_root)
    _mini_vid(vid_root, split="train")
    total, free = _shm_gib()
    out = {"cpu_count": os.cpu_count(), "dev_shm_gib": total, "dev_shm_free_gib": free}
    log(f"  {os.cpu_count()} host cores; /dev/shm {total:.1f} GiB ({free:.1f} free)")
    aug = SSDAugmentation(320, seed=SEED)
    voc = VOCDetection(voc_root, image_sets=(("2007", "test"),), transform=aug, seed=SEED)
    vid = VIDDetection(vid_root, "train", mode="clip", seq_len=4, transform=aug, seed=SEED)
    # 6 batches of 4 cross the 16-image epoch; 3 of 2 clips cross the 2-snippet one.
    for what, ds, batch, n, clip in (("mini-VOC frames", voc, 4, 6, False),
                                     ("mini-VID clips T=4", vid, 2, 3, True)):
        for workers in (0, 8):
            ref = make_loader(ds, batch, num_workers=8, clip_mode=clip, seed=SEED)
            got = make_process_loader(ds, batch, num_workers=workers, clip_mode=clip, seed=SEED,
                                      pin_memory=True)
            try:
                for b in range(n):
                    a, g = next(ref), next(got)
                    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, g))
                    check(same, f"process loader, {what}, {workers} workers: batch {b} differs "
                                "from the thread loader's")
                check(all(t.is_pinned() for t in g), "process loader: batch not pinned")
            finally:
                ref.close()
                got.close()
            log(f"  {what}, {workers} workers: {n} batches {tuple(g[0].shape)} bit-equal to the "
                f"thread loader's (over an epoch boundary)")
    t0 = time.perf_counter()
    for i in range(32):
        voc.sample(i % 16, 1)
    out["ms_an_image_one_thread"] = (time.perf_counter() - t0) / 32 * 1e3
    log(f"  one augmented 375x500 image on the calling thread: "
        f"{out['ms_an_image_one_thread']:.2f} ms")
    rates = {"threads 8": _images_per_s(
        make_loader(voc, 32, num_workers=8, seed=SEED, pin_memory=True), 32, 8)}
    for workers in sorted({min(w, os.cpu_count()) for w in (2, 4, 8, 16)}):
        rates[f"processes {workers}"] = _images_per_s(
            make_process_loader(voc, 32, num_workers=workers, seed=SEED, pin_memory=True), 32,
            workers)
    # Unpinned: the hand-over without the copy into page-locked memory.
    workers = min(8, os.cpu_count())
    rates["threads 8 unpinned"] = _images_per_s(
        make_loader(voc, 32, num_workers=8, seed=SEED), 32, 8)
    rates[f"processes {workers} unpinned"] = _images_per_s(
        make_process_loader(voc, 32, num_workers=workers, seed=SEED), 32, workers)
    out["images_per_s_b32"] = rates
    log("  voc_320 b32 (375x500 JPEG, full SSDAugmentation, pinned unless said), images/s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {card}")
    return out


def native_phase(card):
    """tdrn_tpu_torch/data/native.py: the probe's verdict; where the library
    loads, decode_resize (with and without the mean) and decode_resize_batch
    against PIL's decode + data/image.py's resize (atol 1.0), and images/s
    against them. A library that does not load is logged: no card path
    uses it."""
    from tdrn_tpu_torch.data import image, native

    ok, reason = native.available(), native.unavailable_reason()
    log(f"  csrc/libtdrn_io.so: {'available' if ok else 'unavailable: ' + reason}")
    out = {"available": ok, "reason": reason}
    if not ok:
        return out
    root = os.path.join(HERE, "build", "loader", "mini_voc", "VOC2007", "JPEGImages")
    paths = sorted(os.path.join(root, f) for f in os.listdir(root))
    mean = np.asarray((104.0, 117.0, 123.0), np.float32)
    ref = np.stack([image.resize(image.imread(p), 320).astype(np.float32) for p in paths])
    got = np.stack([native.decode_resize(p, 320) for p in paths])
    got_mean = native.decode_resize(paths[0], 320, mean)
    batch = native.decode_resize_batch(paths, 320, mean, num_threads=8)
    out["max_abs_err"] = err = float(max(np.abs(got - ref).max(),
                                         np.abs(got_mean - (ref[0] - mean)).max(),
                                         np.abs(batch - (ref - mean)).max()))
    check(err <= 1.0, f"native decode: max|diff| {err} from PIL + data/image.py's resize > 1.0")
    check(native.jpeg_dims(paths[0]) == image.imread(paths[0]).shape[:2],
          "native jpeg_dims differs from PIL's")

    def rate(fn, n=len(paths), reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return reps * n / (time.perf_counter() - t0)

    out["images_per_s"] = {
        "native decode_resize, 1 thread": rate(lambda: [native.decode_resize(p, 320)
                                                        for p in paths]),
        "native decode_resize_batch, 8 threads": rate(
            lambda: native.decode_resize_batch(paths, 320, mean, num_threads=8)),
        "PIL decode + data/image.py resize, 1 thread": rate(
            lambda: [image.resize(image.imread(p), 320) for p in paths]),
    }
    log(f"  against PIL + data/image.py's resize: max|diff| {err:.3g} (atol 1.0); 375x500 JPEG "
        "to 320, images/s: " + ", ".join(f"{k} {v:.1f}" for k, v in out["images_per_s"].items())
        + f" on {card}")
    return out


FIDELITY_SMOKE_STEPS = 300  # the one cut in depth: the harness's default is 3000


def fidelity_smoke(torch, card):
    """tools/synth_fidelity_torch.py's easy profile on the card at full width
    (voc_320, VGG-16, 256 TCB channels) with the worker-process loader, cut to
    FIDELITY_SMOKE_STEPS steps: its JSON line with an AP for each of the 4
    classes, the loss falling, and eval_torch.py run again in this process on
    the checkpoint: fp32 with K2 launched and the same APs, then int8 (K2
    and K5)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import eval_torch
    import synth_fidelity_torch

    from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
    from tdrn_tpu_torch.ops.qconv import qconv

    out_dir = os.path.join(HERE, "build", "fidelity_smoke")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    t0 = time.perf_counter()
    res = synth_fidelity_torch.main([
        "--out", out_dir, "--steps", str(FIDELITY_SMOKE_STEPS),
        "--extra_train_args", "--log_every 10",
        "--record", os.path.join(HERE, "chiprun_out", "fidelity_smoke.json")])
    secs = time.perf_counter() - t0
    classes = synth_fidelity_torch.CLASSES
    check(set(res["per_class"]) == set(classes) and res["mAP"] is not None,
          f"fidelity smoke: APs {res['per_class']} lack a class of {list(classes)}")
    first, last = res["train_loss_first_last"]
    check(last < first, f"fidelity smoke: the loss did not fall ({first:.4f} -> {last:.4f})")
    launches = {}
    for precision in ("fp32", "int8"):
        suppress_sorted.launches = qconv.launches = 0
        (aps, _), _ = _quiet(eval_torch.main, [
            "--dataset", "voc_320", "--data_root", os.path.join(out_dir, "data"),
            "--checkpoint", os.path.join(out_dir, "weights"), "--split", "2007:test",
            "--batch_size", "8", "--precision", precision])
        launches[precision] = {"suppress_sorted": suppress_sorted.launches,
                               "qconv": qconv.launches}
        if precision == "fp32":
            same = all(float(f"{aps[c]:.4f}") == res["per_class"][c] for c in classes)
            check(same, f"fidelity smoke: eval_torch.py in process {[aps[c] for c in classes]} "
                        f"against the harness's {res['per_class']}")
    check(launches["fp32"]["suppress_sorted"] > 0 and launches["int8"]["suppress_sorted"] > 0,
          f"fidelity smoke: an eval launched no K2 ({launches})")
    check(launches["int8"]["qconv"] > 0 and launches["fp32"]["qconv"] == 0,
          f"fidelity smoke: K5 launches {launches}: expected only in the int8 eval")
    log(f"  synth_fidelity_torch.py easy, {FIDELITY_SMOKE_STEPS} steps, --loader "
        f"{res['loader']}: mAP {res['mAP']:.4f} {json.dumps(res['per_class'])}, loss "
        f"{first:.3f} -> {last:.3f}, train {res['train_s']:.1f} s, eval {res['eval_s'][0]:.1f} s "
        f"({secs:.1f} s in all); eval_torch.py in process on its 24 test images: the same APs, "
        f"launches {json.dumps(launches)}; on {card}")
    return {"mAP": res["mAP"], "per_class": res["per_class"], "loss_first_last": [first, last],
            "train_s": res["train_s"], "eval_s": res["eval_s"], "seconds": secs,
            "eval_launches": launches}


def int8_model(torch, cfg, **build):
    """The seeded random model in the resident-bf16 profile and its int8
    copy: calibrated with tcb and gru on 8 seeded uint8 frames (RandomState(1),
    as bench.py) preprocessed into bf16, then quantized. Returns (bf16 model,
    int8 model, its scales)."""
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch
    from tdrn_tpu_torch.utils.precision import apply_inference_precision
    from tdrn_tpu_torch.utils.quantize import apply_int8_backbone, calibrate_act_scales

    bf16 = apply_inference_precision(random_params(build_detector(cfg, **build), SEED), "bf16")
    calib = torch.from_numpy(np.random.RandomState(1).randint(
        0, 255, (8, cfg.size, cfg.size, 3), dtype=np.uint8)).cuda()
    scales = calibrate_act_scales(bf16, preprocess_batch(calib, cfg, bf16.dtype), tcb=True, gru=True)
    return bf16, apply_int8_backbone(bf16, act_scales=scales), scales


def n_qconvs(model):
    from tdrn_tpu_torch.models.layers import QConv

    return sum(isinstance(m, QConv) for m in model.modules())


def qconv_calls(torch, model, frames_u8):
    """The K5 calls of one eager forward of model on frames, in call order:
    (B, H, W, Cin, Cout, k, stride, dilation) each."""
    from tdrn_tpu_torch.models.layers import QConv
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    calls, handles = [], []

    def hook(mod, inp):
        b, c, h, w = inp[0].shape
        calls.append((b, h, w, c, mod.out_channels, mod.kernel_size, mod.stride, mod.dilation))

    for m in model.modules():
        if isinstance(m, QConv):
            handles.append(m.register_forward_pre_hook(hook))
    try:
        x = preprocess_batch(frames_u8.cuda(), model.cfg, model.dtype)
        with torch.inference_mode():
            model(x, model.zero_state(x.shape[0]) if model.temporal_enabled else None)
    finally:
        for h in handles:
            h.remove()
    return calls


def ptq_deviation(torch, int8, bf16, img, what):
    """One frame's raw predictions of the int8 model against the same model's
    bf16 profile on the card: max|diff| / max|ref| over the heads, logged only."""
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    def raw(m):
        with torch.inference_mode():
            return m(preprocess_batch(img.cuda(), m.cfg, m.dtype), m.zero_state(1))[0]

    dev = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(raw(int8), raw(bf16)))
    log(f"  {what}: PTQ deviation, int8 against the bf16 profile, raw predictions max|diff| "
        f"{dev:.3g} of max|ref| (logged only)")
    return dev


def int8_vgg_path(torch, counters):
    """The int8 profile's main path: VID_320 VGG-16, conv stem, fused cascade, ConvGRU,
    resident bf16 then int8 with tcb and gru (37 QConvs), behind
    InferenceServer with 16 clients (serving_path's checks, K5 counted once a
    QConv, K3/K4 never)."""
    from tdrn_tpu_torch.config import VID_320

    bf16, model, scales = int8_model(torch, dataclasses.replace(VID_320, fused_cascade=True))
    nq = n_qconvs(model)
    log(f"  VID_320 int8: {nq} QConvs, {len(scales)} calibrated scales")
    check(nq == 37, f"VID_320 int8 has {nq} QConvs, expected 17 + 12 + 8 = 37")
    launches, held, rel = serving_path(torch, counters, model, "VID_320 int8 serving path",
                                       {**K5_COUNTS, "qconv": nq})
    frames = np.random.default_rng(SEED + 12).integers(0, 256, (B, 320, 320, 3), np.uint8)
    dev = ptq_deviation(torch, model, bf16, torch.tensor(frames[:1]), "VID_320 int8")
    calls = qconv_calls(torch, model, torch.tensor(frames))
    return bf16, model, launches, held, dict(rel_err_bf16=rel, ptq_deviation=dev), calls


def int8_resnet_path(torch, counters):
    """ResNet-101 at VID_512 (FrozenBN), resident bf16 then int8 with tcb and
    gru (106 + 12 + 8 = 126 QConvs), S=16, 4 graphed steps against eager with
    a reset and an inactive lane, one frame against the CPU."""
    from tdrn_tpu_torch.config import VID_512

    cfg = dataclasses.replace(VID_512, fused_cascade=True)
    bf16, model, _ = int8_model(torch, cfg, backbone="resnet101")
    nq = n_qconvs(model)
    check(nq == 126, f"ResNet-101 int8 has {nq} QConvs, expected 106 + 12 + 8 = 126")
    frames = np.random.default_rng(SEED + 13).integers(0, 256, (4, STREAMS, 512, 512, 3), np.uint8)
    _, launches, held = drive_graphed(torch, counters, model, frames, (2, 5), (3, 7),
                                      "ResNet-101 vid_512 int8", per_step={"qconv": nq})
    img = torch.tensor(frames[0, :1])
    rel = cpu_rel_err(torch, model, img, "ResNet-101 vid_512 int8")
    dev = ptq_deviation(torch, model, bf16, img, "ResNet-101 vid_512 int8")
    calls = qconv_calls(torch, model, torch.tensor(frames[0]))
    return bf16, model, launches, held, dict(rel_err_bf16=rel, ptq_deviation=dev), calls


INT8_VARIANTS = {"s2d_light_int8": dict(stem="s2d", temporal_cell="light"),
                 "hybrid_int8": dict(temporal_cell="hybrid")}


def int8_variant_paths(torch, counters, names):
    """s2d + light and hybrid at VID_320, int8 with tcb and gru, S=4: graphed
    against eager, launches, K1/K2/K5 a replayed step, one frame against the
    CPU."""
    from tdrn_tpu_torch.config import VID_320
    from tdrn_tpu_torch.inference import StreamingDetector

    cfg = dataclasses.replace(VID_320, fused_cascade=True)
    frames = np.random.default_rng(SEED + 14).integers(0, 256, (4, 4, 320, 320, 3), np.uint8)
    launches, runs, held, checks, calls = {}, {}, {}, {}, {}
    for path, kw in INT8_VARIANTS.items():
        t0 = time.perf_counter()
        bf16, model, _ = int8_model(torch, cfg, **kw)
        nq = n_qconvs(model)
        _, launches[path], held[path] = drive_graphed(torch, counters, model, frames, (2, 1),
                                                      (3, 2), path, per_step={"qconv": nq})
        runs[path] = replayed_kernel_counts(
            torch, lambda: StreamingDetector(model, num_streams=4, prefilter=512),
            torch.tensor(frames[0]), names, path, per_step={"qconv": nq}, banned=QUANTIZE_PASSES)
        img = torch.tensor(frames[0, :1])
        checks[path] = dict(qconvs=nq, rel_err_bf16=cpu_rel_err(torch, model, img, path),
                            ptq_deviation=ptq_deviation(torch, model, bf16, img, path))
        calls[path] = qconv_calls(torch, model, torch.tensor(frames[0]))
        log(f"  {path}: {nq} QConvs, {time.perf_counter() - t0:.1f} s")
    return launches, runs, held, checks, calls


def _qconv_inputs(torch, gen, b, h, w, cin, cout, k, extreme=False):
    """Seeded K5 inputs on the card: fp32 activations (B, C, H, W) in
    channels_last, a third of them past +-xscale (clamped to +-127), or all
    at +-3 xscale with all +-127 weights (extreme); int8 weights, the scales
    and bias as a QConv holds them (ops/qconv.py act_scale, dequant_factor)."""
    from tdrn_tpu_torch.ops.qconv import act_scale, dequant_factor

    xscale = torch.rand((), device="cuda", generator=gen) * 4 + 2
    u = torch.rand((b, cin, h, w), device="cuda", generator=gen)
    shape_w = (cout, k, k, cin)
    if extreme:
        x = torch.where(u < 0.5, 3.0, -3.0) * xscale
        wt = torch.where(torch.rand(shape_w, device="cuda", generator=gen) < 0.5, 127, -127)
    else:
        x = (u * 3.0 - 1.5) * xscale
        wt = torch.randint(-127, 128, shape_w, device="cuda", generator=gen)
    wscale = torch.rand(cout, device="cuda", generator=gen) * 4e-3 + 1e-3
    bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
    return (x.contiguous(memory_format=torch.channels_last), wt.to(torch.int8).contiguous(),
            act_scale(xscale), dequant_factor(wscale, xscale), bias)


# (input dtype, output dtype, input layout) of every K5 check.
K5_CASES = (("bfloat16", "bfloat16", "channels_last"), ("float32", "float32", "channels_last"),
            ("bfloat16", "float32", "channels_last"), ("float32", "bfloat16", "channels_last"),
            ("bfloat16", "bfloat16", "nchw"), ("float32", "float32", "nchw"))


def _k5_equal(torch, args, s, d, what, cases=K5_CASES):
    """K5 against its plain version, bit-equal: input dtype, output dtype and
    layout as each case says (the activations cast from args' fp32 values)."""
    from tdrn_tpu_torch.ops.qconv import pack_weight, qconv, qconv_plain

    x32, wt, sc, fac, bias = args
    wp = pack_weight(wt)
    for xd, od, layout in cases:
        xd, od = getattr(torch, xd), getattr(torch, od)
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        x = x32.to(xd).contiguous(memory_format=fmt)
        got = qconv(x, wt, sc, fac, bias, stride=s, dilation=d, out_dtype=od, wpack=wp)
        ref = qconv_plain(x, wt, sc, fac, bias, s, d, od)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            diff = (got.float() - ref.float()).abs()
            raise AssertionError(f"K5 {what} {xd} in, {od} out, {layout}: differs from its plain "
                                 f"version in {int((diff > 0).sum())} of {diff.numel()} outputs, "
                                 f"max {diff.max().item():.4g}")


def _k5_graph_twice(torch, args, s, d, what):
    """A split-k shape launched twice inside one CUDA graph, the graph replayed
    twice: every output bit-equal to the plain version, so the tickets and the
    workspace were reset between launches and replays."""
    from tdrn_tpu_torch.ops.qconv import pack_weight, qconv, qconv_plain

    x32, wt, sc, fac, bias = args
    x = x32.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wp = pack_weight(wt)
    ref = qconv_plain(x, wt, sc, fac, bias, s, d, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        qconv(x, wt, sc, fac, bias, stride=s, dilation=d, wpack=wp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y1 = qconv(x, wt, sc, fac, bias, stride=s, dilation=d, wpack=wp)
        y2 = qconv(x, wt, sc, fac, bias, stride=s, dilation=d, wpack=wp)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(y1, ref) and torch.equal(y2, ref),
              f"K5 {what}: a graph replay of two split-k launches differs from the plain version")


def phase_qconv(torch, calls_by_path, card):
    """K5 on every distinct conv shape of the int8 paths, bit-equal to its
    plain version in bf16 and fp32 input and output, on channels_last and
    NCHW input; on ragged shapes (B=2, 44x52, Cin 3, 12 and 64, Cout 24) and
    on all +-127 weights with inputs at +-3 xscale at the deepest K; every
    shape whose plan splits K also launched twice in a CUDA graph replayed
    twice. Each distinct shape timed (flushed median of 30, bf16 in and out)
    beside its plain version (median of 3), the PyTorch passes that
    quantized its input before K5 did (quantize_nhwc, a yardstick), its
    bound at PEAK_INT8 or
    PEAK_BYTES (bf16 activations read once, the int8 weights, the scales, the
    bf16 output written once; 2*M*Cout*K operations on the true channels)
    and, for 1x1 stride-1 shapes, torch._int_mm on the same operands
    quantized to int8 (library_ms; its int32 accumulators must equal the
    plain version's), for the others cuDNN's bf16 conv of the same shape (a
    yardstick only; the port never calls either). Returns K5's kernels-line
    entry, with the sum over each path's step; the rows of the distinct
    shapes go to chiprun_out/k5_shapes.json."""
    import torch.nn.functional as F

    from tdrn_tpu_torch.ops.qconv import (conv_out_size, pack_weight, plan, qconv, qconv_plain,
                                          quantize_nhwc)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for b, h, w, cin, cout, k, s, d in ((2, 44, 52, 3, 24, 3, 1, 1), (2, 44, 52, 12, 24, 3, 1, 1),
                                        (2, 44, 52, 3, 24, 7, 2, 1), (2, 44, 52, 12, 24, 1, 2, 1),
                                        (2, 44, 52, 12, 24, 3, 1, 3), (2, 44, 52, 64, 24, 3, 1, 1),
                                        (2, 44, 52, 64, 24, 1, 2, 1)):
        _k5_equal(torch, _qconv_inputs(torch, gen, b, h, w, cin, cout, k), s, d,
                  f"ragged {(b, h, w, cin, cout, k, s, d)}")
    log("  K5 ragged shapes (B=2, 44x52, Cin 3, 12 and 64, Cout 24; 3x3, 7x7/2, 1x1/2, 3x3 dil 3): "
        "bit-equal in bf16 and fp32 in and out, channels_last and NCHW")
    for shape in ((B, 40, 40, 512, 512, 3, 1, 1), (B, 10, 10, 1024, 1024, 1, 1, 1),
                  (B, 5, 5, 512, 512, 3, 1, 1)):
        b, h, w, cin, cout, k, s, d = shape
        _k5_equal(torch, _qconv_inputs(torch, gen, b, h, w, cin, cout, k, extreme=True), s, d,
                  f"all +-127 {shape}")
    log("  K5 all +-127 weights, inputs at +-3 xscale (|acc| up to 127^2 x 4608): bit-equal")

    rows, splits = {}, 0
    for shape in sorted({c for calls in calls_by_path.values() for c in calls}):
        b, h, w, cin, cout, k, s, d = shape
        args = _qconv_inputs(torch, gen, b, h, w, cin, cout, k)
        _k5_equal(torch, args, s, d, str(shape))
        pl = plan(*shape)
        if pl.splits > 1:
            _k5_graph_twice(torch, args, s, d, str(shape))
            splits += 1
        x = args[0].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wt, sc, fac, bias = args[1:]
        wp = pack_weight(wt)
        ho, wo = conv_out_size(h, k, s, d), conv_out_size(w, k, s, d)
        ops = 2 * b * ho * wo * cout * k * k * cin
        nbytes = 2 * x.numel() + wp.numel() + 12 * cout + 4 + 2 * b * ho * wo * cout
        bms, by = bound(nbytes, ops, PEAK_INT8)
        ms = time_ms(torch, lambda: qconv(x, wt, sc, fac, bias, stride=s, dilation=d, wpack=wp))
        plain_ms = time_ms(torch, lambda: qconv_plain(x, wt, sc, fac, bias, s, d), reps=3, warmup=1)
        # The PyTorch passes that quantized this input on the card before K5
        # quantized on load: a yardstick for the shape.
        quantize_ms = time_ms(torch, lambda: quantize_nhwc(x, sc))
        row = dict(shape=list(shape), plan=dict(bn=pl.bn, splits=pl.splits, stages=pl.stages,
                                                flat=pl.flat, grid=pl.grid),
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ops=ops, bytes=nbytes,
                   tops=ops / ms / 1e9, library_ms=None, cudnn_bf16_ms=None,
                   quantize_ms=quantize_ms)
        if k == 1 and s == 1:
            xq = quantize_nhwc(x, sc)[..., :cin]
            a2, b2 = xq.reshape(-1, cin).contiguous(), wt.view(cout, cin).t()
            acc = torch._int_mm(a2, b2)
            ref = (a2.double() @ b2.double()).to(torch.int32)
            torch.cuda.synchronize()
            check(torch.equal(acc, ref), f"K5 {shape}: torch._int_mm's int32 accumulators differ "
                                         f"from the plain version's")
            row["library_ms"] = time_ms(torch, lambda: torch._int_mm(a2, b2))
        else:
            wb = wt.permute(0, 3, 1, 2).bfloat16().contiguous(memory_format=torch.channels_last)
            pad = d * (k - 1) // 2
            row["cudnn_bf16_ms"] = time_ms(torch, lambda: F.conv2d(x, wb, None, s, pad, d))
        rows[shape] = row
        lib = (f"_int_mm {row['library_ms']:.4f} ms" if row["library_ms"] is not None
               else f"cuDNN bf16 {row['cudnn_bf16_ms']:.4f} ms")
        log(f"  K5 {shape} bn {pl.bn} splits {pl.splits}: {ms:.4f} ms = {row['tops']:.1f} TOP/s, "
            f"bound {bms:.4f} ms ({by}, share {bms / ms:.3f}), plain {plain_ms:.3f} ms, {lib}, "
            f"PyTorch quantize passes {quantize_ms:.4f} ms on {card}")
        del args, x, wt, wp
    log(f"  K5 every distinct shape ({len(rows)}): bit-equal in bf16 and fp32 in and out, "
        f"channels_last and NCHW; {splits} split-k shapes also graphed twice, replayed twice")

    steps = {}
    for path, calls in calls_by_path.items():
        tot = {key: sum(rows[c][key] for c in calls)
               for key in ("ms", "plain_ms", "bound_ms", "ops", "bytes", "quantize_ms")}
        by_ops = sum(rows[c]["bound_ms"] for c in calls if rows[c]["bound_by"] == "operations")
        tot["bound_by"] = "operations" if 2 * by_ops >= tot["bound_ms"] else "bytes"
        tot["launches_a_step"] = len(calls)
        steps[path] = tot
        log(f"  K5 over one {path} step ({len(calls)} launches, {tot['ops'] / 1e12:.3f} TOP): "
            f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (share "
            f"{tot['bound_ms'] / tot['ms']:.3f}), plain {tot['plain_ms']:.3f} ms, PyTorch "
            f"quantize passes {tot['quantize_ms']:.4f} ms on {card}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k5_shapes.json"), "w") as f:
        json.dump({"card": card, "shapes": [rows[c] for c in sorted(rows)],
                   "calls_by_path": {p: [list(c) for c in calls]
                                     for p, calls in calls_by_path.items()}}, f, indent=1)
    main = steps["int8_vid320"]
    return dict(name="qconv", wrapper="qconv", source="tdrn_tpu_torch/csrc/qconv.cu",
                replaces="tdrn_tpu/models/layers.py:182 (XLA's QConv: quantize, s8 conv, "
                         "dequantize)", max_abs_err=0.0,
                ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], timed="the sum over the VID_320 int8 step's 37 launches",
                step_totals=steps)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tdrn_tpu_torch
    from tdrn_tpu_torch import _build
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
    from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
    from tdrn_tpu_torch.ops.qconv import qconv
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
    t0 = time.perf_counter()
    log("K1-K4 at the 512 geometry's shapes:")
    kernels_512(torch, rng, results, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    counters = [fused_refine_cascade, suppress_sorted, fused_stem_stage1]
    log("fp32 path (fused stem), graphed:")
    model, fp32_launches, fp32_held = main_path(torch, counters)
    counters16 = counters + [fused_conv_stage]
    log("serving path (resident bf16, fused2 stem, prefilter 512, InferenceServer), graphed:")
    model16 = serving_model(torch)
    launches, bf16_held, _ = serving_path(torch, counters16, model16)
    counters8 = counters16 + [qconv]
    t0 = time.perf_counter()
    log("int8 serving path (VID_320, conv stem, resident bf16 + int8 with tcb and gru, "
        "prefilter 512, InferenceServer), graphed:")
    bf16_320, model8, int8_launches, int8_held, int8_checks, calls320 = int8_vgg_path(
        torch, counters8)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    log("chunk 2 (2 frames a stream a step), fp32 path and bf16 serving profile:")
    fp32_chunk_launches = chunk_path(torch, counters, model, CHUNK_STATE_ATOL, "fp32 path")
    chunk_launches = chunk_path(torch, counters16, model16, BF16_REL_TOL, "bf16 serving profile")
    frames32 = np.random.default_rng(SEED + 6).integers(0, 256, (32, 320, 320, 3), dtype=np.uint8)
    log(f"  batch 32 against 2 x 16, zero state, raw predictions max|diff| / max|ref|: "
        f"fp32 {batch_rel_err(torch, model, frames32):.3g}, "
        f"bf16 {batch_rel_err(torch, model16, frames32):.3g}")

    t0 = time.perf_counter()
    log("ResNet-101 vid_512 path (resident bf16, fused cascade, prefilter 512), graphed:")
    model_r, resnet_launches, resnet_held, resnet_checks = resnet_path(torch, counters16)
    group_launches, group_held = resnet_group_path(torch, counters16)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("ResNet-101 vid_512 int8 path (resident bf16 + int8 with tcb and gru), graphed:")
    _, model_r8, r8_launches, r8_held, r8_checks, calls512 = int8_resnet_path(torch, counters8)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("SSD baseline (VOC_320, full width, fp32):")
    ssd_launches, ssd_checks = ssd_path(torch, counters16, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("entry points at VID_320 (checkpoint restore, serve_torch.py over HTTP, eval_torch.py):")
    ep_fused2, ep_int8, ep = entry_points(torch, counters8, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")

    # Every timing runs before any profiling: a profiler session leaves host
    # overhead behind.
    _, _, step_ms, _ = time_streaming(torch, model, steps=10)
    log(f"streaming vid_320 fp32 S=16 480x640, TF32 off: graphed step {step_ms:.3f} ms, "
        f"{16 / step_ms * 1e3:.1f} frames/s on {card}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    det, frames, *fp32_graphed = time_streaming(torch, model)
    fp32_eager = time_eager(torch, det, frames)
    log_times("streaming vid_320 fp32 S=16 480x640, cuDNN TF32 on", card, fp32_graphed, fp32_eager)
    # The serving profile with cuDNN's default TF32 (its fp32 heads).
    det16, frames16, *bf16_graphed = time_streaming(torch, model16, hw=(320, 320), prefilter=512)
    bf16_eager = time_eager(torch, det16, frames16)
    log_times("streaming vid_320 bf16 fused2 S=16 320x320 prefilter 512", card, bf16_graphed,
              bf16_eager)
    _, _, chunk_ms, chunk_host = time_streaming(torch, model16, hw=(320, 320), prefilter=512,
                                                chunk=2)
    log(f"streaming vid_320 bf16 fused2 chunk 2 S=16 320x320 prefilter 512: graphed step "
        f"{chunk_ms:.3f} ms for 2 frames a stream (host {chunk_host:.3f} ms), "
        f"{32 / chunk_ms * 1e3:.1f} frames/s on {card}")
    det_r, frames_r, *resnet_graphed = time_streaming(torch, model_r, steps=10, hw=(512, 512),
                                                      prefilter=512)
    resnet_eager = time_eager(torch, det_r, frames_r, steps=10)
    log_times("streaming ResNet-101 vid_512 bf16 S=16 512x512 prefilter 512", card,
              resnet_graphed, resnet_eager)
    log_server("bf16 serving path", card, time_server(torch, model16))
    det8, frames8, *int8_graphed = time_streaming(torch, model8, hw=(320, 320), prefilter=512)
    int8_eager = time_eager(torch, det8, frames8)
    log_times("streaming vid_320 int8 (tcb, gru) conv stem S=16 320x320 prefilter 512", card,
              int8_graphed, int8_eager)
    det320, _, *conv_graphed = time_streaming(torch, bf16_320, hw=(320, 320), prefilter=512)
    conv_eager = time_eager(torch, det320, frames8)
    log_times("streaming vid_320 bf16 conv stem S=16 320x320 prefilter 512 (the same model before "
              "int8)", card, conv_graphed, conv_eager)
    del det320
    det_r8, _, *r8_graphed = time_streaming(torch, model_r8, steps=10, hw=(512, 512),
                                            prefilter=512)
    r8_eager = time_eager(torch, det_r8, frames_r, steps=10)
    log_times("streaming ResNet-101 vid_512 int8 (tcb, gru) S=16 512x512 prefilter 512", card,
              r8_graphed, r8_eager)
    log_server("VID_320 int8 serving path", card, time_server(torch, model8))
    log_server("fp32 path at 320x320, prefilter off", card,
               time_server(torch, model, prefilter=None))

    log("kernels a replayed step, by the profiler's kernel events:")
    names, names16 = [c.__name__ for c in counters], [c.__name__ for c in counters16]
    frames_c2 = torch.tensor(np.random.default_rng(SEED + 7).integers(
        0, 256, (2, STREAMS, 320, 320, 3), dtype=np.uint8))
    per_step = {
        "bf16_serving": replayed_kernel_counts(
            torch, lambda: StreamingDetector(model16, num_streams=STREAMS, prefilter=512),
            frames16, names16, "bf16 serving path"),
        "fp32_fused": replayed_kernel_counts(
            torch, lambda: StreamingDetector(model, num_streams=STREAMS), frames, names,
            "fp32 path"),
        "bf16_chunk2": replayed_kernel_counts(
            torch, lambda: StreamingDetector(model16, num_streams=STREAMS, prefilter=512, chunk=2),
            frames_c2, names16, "bf16 serving profile at chunk 2"),
        "fp32_chunk2": replayed_kernel_counts(
            torch, lambda: StreamingDetector(model, num_streams=STREAMS, chunk=2), frames_c2,
            names, "fp32 path at chunk 2"),
    }
    per_step["resnet101_512"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(model_r, num_streams=STREAMS, prefilter=512), frames_r,
        list(K12), "ResNet-101 vid_512 bf16")
    names8 = [c.__name__ for c in counters8]
    per_step["int8_vid320"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(model8, num_streams=STREAMS, prefilter=512), frames8,
        names8, "VID_320 int8", per_step={**K5_COUNTS, "qconv": len(calls320)},
        banned=QUANTIZE_PASSES)
    per_step["int8_resnet101_512"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(model_r8, num_streams=STREAMS, prefilter=512), frames_r,
        list(K12) + ["qconv"], "ResNet-101 vid_512 int8", per_step={"qconv": len(calls512)},
        banned=QUANTIZE_PASSES)
    per_step["entry_fused2_bf16"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(ep_fused2, num_streams=STREAMS), frames16, names8,
        "restored fused2 bf16 (entry points)", per_step=EP_FUSED2)
    per_step["entry_int8"] = replayed_kernel_counts(
        torch, lambda: StreamingDetector(ep_int8, num_streams=STREAMS), frames8, names8,
        "restored int8 (entry points)", per_step={**EP_INT8, "qconv": n_qconvs(ep_int8)},
        banned=QUANTIZE_PASSES)
    t0 = time.perf_counter()
    log("the other stems and cells at vid_320 (resident bf16, S=4), graphed:")
    variant_launches, variant_steps, variant_held = variant_paths(torch, counters16, list(K12))
    per_step.update(variant_steps)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("s2d + light and hybrid at vid_320, int8 with tcb and gru (S=4), graphed:")
    v8_launches, v8_steps, v8_held, v8_checks, v8_calls = int8_variant_paths(
        torch, counters8, list(K12) + ["qconv"])
    per_step.update(v8_steps)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("K5 qconv against its plain version, every distinct conv shape of the int8 paths:")
    k5 = phase_qconv(torch, {"int8_vid320": calls320, "int8_resnet101_512": calls512, **v8_calls},
                     card)
    results.append(k5)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("training (train/, data/, train_torch.py, tools/train_bench_torch.py) at VID_320 and "
        "VOC_320:")
    train = training(torch, names8, card)
    log(f"  (training {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("top-k under heavy ties (ops/nms.py::_top_k), card against CPU:")
    topk_trials = topk_ties(torch)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("input pipeline: data/process_loader.py against data/loader.py:")
    loader = loader_phase(torch, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("native decode (data/native.py over csrc/libtdrn_io.so):")
    native = native_phase(card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log("fidelity smoke (tools/synth_fidelity_torch.py, easy profile):")
    fidelity = fidelity_smoke(torch, card)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    if "--profile" in sys.argv[1:]:
        profile_step(torch, lambda: det_r.detect(frames_r), "profile_resnet101_512.txt")
        profile_step(torch, lambda: det.detect(frames), "profile.txt")
        profile_step(torch, lambda: det16.detect(frames16), "profile_bf16.txt")
        profile_step(torch, eager_step(torch, det16, frames16), "profile_bf16_eager.txt")
        profile_step(torch, lambda: det8.detect(frames8), "profile_int8.txt")
        profile_step(torch, lambda: det_r8.detect(frames_r), "profile_int8_resnet101_512.txt")

    extra = ("tflops", "cudnn_chain_ms", "ms_fp32_input", "ms_fp32_compute", "ms_warm",
             "ms_repeats", "ms_per_anchor", "amax_ms", "ms_early", "ms_k1024", "at_512",
             "timed", "step_totals")
    paths = {"resnet101_512": resnet_launches, "resnet101_group_512": group_launches,
             "ssd_320": ssd_launches, **variant_launches, "int8_vid320": int8_launches,
             "int8_resnet101_512": r8_launches, **v8_launches,
             "entry_fused2_bf16": ep["launches_fused2"], "entry_int8": ep["launches_int8"],
             "entry_http_fused2_bf16": ep["launches_http_fused2_bf16"],
             "entry_http_int8": ep["launches_http_int8"]}
    # A kernel's own main path: bf16 serving for K1-K4, the VID_320
    # int8 path for K5 (its library_ms is per shape, in chiprun_out/k5_shapes.json).
    own = lambda r: "int8_vid320" if r["wrapper"] == "qconv" else "bf16_serving"
    paths = {"fp32_fused": fp32_launches, "bf16_serving": launches,
             "fp32_chunk2": fp32_chunk_launches, "bf16_chunk2": chunk_launches, **paths}
    kernels = [dict(name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
                    launches=paths[own(r)][r["wrapper"]], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    launches_by_path={path: n.get(r["wrapper"], 0) for path, n in paths.items()},
                    runs_per_replayed_step=per_step[own(r)][r["wrapper"]],
                    runs_per_replayed_step_by_path={
                        path: counts.get(r["wrapper"], 0) for path, counts in per_step.items()},
                    **{k: r[k] for k in extra if k in r}) for r in results]
    log(f"graphed vs eager: fp32 path {fp32_held}, bf16 serving path {bf16_held}, ResNet-101 "
        f"vid_512 {resnet_held}, group norm {group_held}, "
        + ", ".join(f"{path} {h}" for path, h in {**variant_held, **v8_held}.items())
        + f", VID_320 int8 {int8_held}, ResNet-101 vid_512 int8 {r8_held}")
    log(f"checks against the CPU: ResNet-101 {json.dumps(resnet_checks)}, SSD {json.dumps(ssd_checks)}")
    log(f"int8 paths against the CPU and the bf16 profile: VID_320 {json.dumps(int8_checks)}, "
        f"ResNet-101 vid_512 {json.dumps(r8_checks)}, {json.dumps(v8_checks)}")
    log(f"entry points: {json.dumps({k: v for k, v in ep.items() if not k.startswith('launches')})}")
    log(f"training: {json.dumps(train)}")
    log(f"input pipeline: {json.dumps(dict(loader, topk_tie_trials=topk_trials, native=native))}")
    log(f"fidelity smoke: {json.dumps(fidelity)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
