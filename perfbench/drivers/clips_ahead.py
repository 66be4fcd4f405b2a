"""Recorded video re-processed one step ahead: S streams as the lanes of a
``StreamingDetector``, host frames, step t+1 dispatched before step t's
detections are read on the host.

Each step's detections are copied to pinned host buffers right behind the
step on the card's stream, and an event marks the copy; the host waits on
that event only after it has enqueued the next step, so the card always
has a step queued while the host reads the last one and stages the next
frames. Lanes reset at their snippet starts (streams.Streams).

End to end: ``clip_frames_per_s``, the frames whose detections reached the
host in the window over the window's seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import bench, streams
from perfbench.trace import Tracer, span


class Fetcher:
    """Copies of a step's detections to the host, two sets of pinned buffers
    used in turn."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.bufs = [None, None]
        self.turn = 0

    def start(self, top):
        fields = top[:3]
        if not self.cuda:
            return fields, None
        if self.bufs[self.turn] is None:
            self.bufs[self.turn] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                    for t in fields]
        bufs = self.bufs[self.turn]
        self.turn ^= 1
        for b, t in zip(bufs, fields):
            b.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return bufs, done

    @staticmethod
    def finish(handle):
        bufs, done = handle
        if done is not None:
            done.synchronize()
        return [b.numpy() for b in bufs]  # read before the buffers' next use


def run(ctx) -> dict:
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.utils.precision import apply_inference_precision

    cfg, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    lanes = int(traffic["lanes"])
    pool = bench.frame_pool(ctx.seed, lanes, int(traffic["pool_per_lane"]), cfg["size"], dev)
    weights = bench.make_weights(cfg, ctx.seed, dev)
    ctx.reset_peak()
    model = apply_inference_precision(bench.build_model(cfg, dev), cfg["precision"])
    bench.load_weights(model, weights)
    det = StreamingDetector(model, num_streams=lanes, prefilter=int(cfg["prefilter_anchors"]),
                            device=dev)
    strm = streams.Streams(pool, traffic["snippet_frames"], traffic["stagger"])
    for t in range(int(traffic["warmup_steps"])):  # the first captures the step's graph
        det.detect(pool[t % strm.per_lane])
    ctx.sync()
    det.reset()  # every lane starts at its frame 0 in the window
    fetch = Fetcher(dev)
    ring = streams.Ring(lanes, 2 * strm.snippet + 8, int(cfg["top_k"]))
    tracer = Tracer(dev.type == "cuda") if ctx.trace else None
    trace_from = ctx.seconds * float(traffic["trace_from"])
    host_s, done_at, dispatched = [], [], 0
    ctx.start_window()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    pending, t = None, 0
    while True:
        if tracer is not None and tracer.range is None and time.perf_counter() - t0 >= trace_from:
            tracer.start()
        with span(ctx.trace, "perfbench::reset"):
            if t > 0:
                due = [l for l in range(lanes) if strm.starts_snippet(l, t)]
                if due:
                    det.reset(due)
        h0 = time.perf_counter()
        with span(ctx.trace, "perfbench::detect"):
            handle = fetch.start(det.detect(pool[t % strm.per_lane]))
        host_s.append(time.perf_counter() - h0)
        dispatched += lanes
        if pending is not None:
            with span(ctx.trace, "perfbench::fetch"):
                out = Fetcher.finish(pending)
            now = time.perf_counter()
            for l, r in enumerate(streams.served_form(out)):
                ring.put(l, t - 1, r)
            if now > deadline:
                break
            done_at += [now] * lanes
            if tracer is not None and tracer.active:
                tracer.steps += 1
                if (tracer.steps >= int(traffic["trace_steps"])
                        or now - tracer.t_start >= float(traffic["trace_seconds"])):
                    tracer.stop()
        pending = handle
        t += 1
    for l, r in enumerate(streams.served_form(Fetcher.finish(handle))):
        ring.put(l, t, r)  # the step in flight at the close: checked, not counted
    ctx.sync()
    if tracer is not None and tracer.active:
        tracer.stop()
    ctx.end_window()
    del det, model
    ctx.free_program()
    checks = streams.check(cfg, weights, strm, ring, traffic, ctx.seed, dev)
    rate = len(done_at) / ctx.seconds
    return {
        "end_to_end": {"clip_frames_per_s": rate},
        "attempted": dispatched, "failed": 0, "checks": checks,
        "record": {"frames_per_s": tracer.untraced_rate(done_at, ctx.seconds) if tracer else rate,
                   "steps": t,
                   "detect_host_ms": 1e3 * float(np.mean(host_s)), "batch": lanes,
                   "profile": tracer.summary if tracer else None, "config": cfg},
    }
