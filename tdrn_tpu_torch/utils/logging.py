"""Structured metrics logging and profiling helpers (the port of
``tdrn_tpu/utils/logging.py``): a JSONL metrics logger with an optional
TensorBoard writer (``torch.utils.tensorboard``), a wall-clock stage timer
that fences on the card, and a ``torch.profiler`` trace around a window."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

TRACE_FILE = "trace.json"


class MetricsLogger:
    """Append-only JSONL metrics log + console echo, TensorBoard optional."""

    def __init__(self, log_dir: str, tensorboard: bool = False, echo_every: int = 10):
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise RuntimeError(
                    "MetricsLogger(tensorboard=True) needs torch.utils.tensorboard, "
                    "which needs the tensorboard package; it is not installed"
                ) from e
            self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.echo_every = echo_every

    def log(self, step: int, metrics: Dict[str, Any]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=int(step))
        if self.echo_every and step % self.echo_every == 0:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Profile the enclosed window with torch.profiler (host and, on a CUDA
    machine, the card's kernels) and write its Chrome trace to
    ``<log_dir>/trace.json`` (Perfetto, chrome://tracing). Yields the
    profiler (``key_averages()``), or None if ``log_dir`` is None."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _fence(fence: Any) -> None:
    """Wait for the card behind ``fence``: a tensor or a device on CUDA."""
    dev = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock stage timer. ``fence`` (a tensor or a device) makes the
    stage end only when the card has finished its work, as
    ``block_until_ready`` does in the JAX package."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str, fence: Any = None):
        start = time.perf_counter()
        yield
        if fence is not None:
            _fence(fence)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - start
