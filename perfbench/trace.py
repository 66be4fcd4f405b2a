"""The traced sub-window: torch.profiler over a bounded stretch of steady
work, summed in memory (nothing is written to disk).

The profiled stretch sits inside one ``perfbench::window`` range, whose
host time span is the traced window. From the device's events inside it:
the busy time (the union of kernel and copy intervals), the time by kernel
name, the time by part of the step and kind of kernel (``part_s``), the
idle gaps, each put to the innermost named host range (``perfbench::*`` of
the harness, ``tdrn::*`` of the program) running at its midpoint, and the
kernel launches.

The parts of a step, in the order the card runs its events: ``copy``, the
memory copies and sets (the frames staged in, the detections fetched, the
state written back); ``tail``, every kernel from the detect tail's first,
the cascade (K1), to the next step's staging copy in; ``model``, the rest.
"""

from __future__ import annotations

import contextlib
import heapq
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.roofline import kernel_of

NAMED = ("perfbench::", "tdrn::")
OUTSIDE = "outside_the_named_host_ranges"


class Tracer:
    """Start and stop the profiler around a stretch of the window; on a
    host without a card it profiles the host alone."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        # The profiler's first start in a process takes seconds on the card
        # (CUPTI's set-up): it is paid here, in the set-up, on one op.
        with profile(activities=acts):
            (torch.zeros(1, device="cuda" if cuda else "cpu") + 1).sum().item()
        self.prof = profile(activities=acts)
        self.cuda = cuda
        self.range = None
        self.steps = 0
        self.summary: Optional[dict] = None
        # perf_counter: before the start, once tracing, after the summary.
        self.t_begin = self.t_start = self.t_done = None

    @property
    def active(self) -> bool:
        return self.range is not None and self.summary is None

    def start(self) -> None:
        self.t_begin = time.perf_counter()
        self.prof.__enter__()
        self.range = torch.profiler.record_function("perfbench::window")
        self.range.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof, self.steps)
        self.t_done = time.perf_counter()

    def untraced_rate(self, done_at, seconds: float) -> float:
        """Items a second of the window outside the profiler's start, trace
        and summary, from the items' completion times."""
        if self.t_done is None:
            return len(done_at) / seconds
        inside = sum(1 for t in done_at if self.t_begin <= t <= self.t_done)
        return (len(done_at) - inside) / (seconds - (self.t_done - self.t_begin))


def span(trace: bool, name: str):
    """A named host range, only in a traced run."""
    return torch.profiler.record_function(name) if trace else contextlib.nullcontext()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


# cuDNN's and cuBLAS's convolution and matrix-product kernels, by name.
CONV_WORDS = ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop", "gemm", "cutlass",
              "sm90_", "sm80_")


def kind(name: str) -> str:
    """``port`` (a kernel of the program with a file under kernels/),
    ``conv`` or ``other`` (norms, activations, residual adds, casts, copies,
    reductions, sorts)."""
    if kernel_of(name):
        return "port"
    low = name.lower()
    return "conv" if any(w in low for w in CONV_WORDS) else "other"


def short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)[:64]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def parts(device: List[Tuple[float, float, str]]) -> Dict[str, Dict[str, float]]:
    """Seconds by part of the step and kind of kernel (module doc)."""
    out: Dict[str, Dict[str, float]] = {"copy": defaultdict(float), "tail": defaultdict(float),
                                        "model": defaultdict(float)}
    in_tail = False
    for s, e, name in sorted(device):
        if is_copy(name):
            in_tail = in_tail and not name.startswith("Memcpy HtoD")
            out["copy"]["copy"] += (e - s) * 1e-6
            continue
        in_tail = in_tail or kernel_of(name) == "K1"
        out["tail" if in_tail else "model"][kind(name)] += (e - s) * 1e-6
    return {k: dict(v) for k, v in out.items()}


def summarize(prof, steps: int) -> dict:
    """busy_s, window_s, kernel time by name, the kernels' count and the
    idle gaps by host range, over the ``perfbench::window`` range."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = next(e for e in events
                  if e.device_type == DeviceType.CPU and e.name == "perfbench::window")
    w0, w1 = window.time_range.start, window.time_range.end
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(NAMED) or e.name.startswith("ProfilerStep"):
            if e.device_type == DeviceType.CPU and e.name != "perfbench::window":
                host.append((start, end, e.name))
            continue  # a range's mirror on the device's timeline is no kernel
        if e.device_type == DeviceType.CUDA and end > w0 and start < w1:
            device.append((max(start, w0), min(end, w1), e.name))
    busy = _merge([(s, e) for s, e, _ in device])
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for s, e, name in device:
        by_name[name] += (e - s) * 1e-6
        count[name] += 1
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    active: list = []  # heap of (-start, end, name): the innermost open range on top
    h = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        while h < len(host) and host[h][0] <= mid:
            heapq.heappush(active, (-host[h][0], host[h][1], host[h][2]))
            h += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        gaps[active[0][2] if active else OUTSIDE] += (g1 - g0) * 1e-6
    top = lambda d: [[short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": dict(by_name),
        "kernel_n": dict(count),
        "part_s": parts(device),
        "launches": len(device),
        "steps": steps,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }
