"""The yardstick of the kernels and of the whole step: the H100's published
peaks, the formulas of the bounds of the program's hand-written kernels,
and the model's operations a frame.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit; a share
is stated against them with the card's power limit beside it. A kernel's
bound is the larger of its operations over the peak rate and its bytes,
each input read once and each output written once, over the memory
bandwidth (the formulas of the kernels' table in PERF.md):

  K1 cascade      bytes: B*P*(4+2+4+C)*4 read, P*4*4 priors, B*P*(4+C)*4 written
  K2 NMS          operations: 14 an IoU pair, all K*(K-1)/2 pairs of each of N rows,
                  on the float32 units
  K3 stem         operations: conv1_1 (3->64) + conv1_2 (64->64), 3x3, at H x W
  K4 VGG stage 2  operations: conv2_1 (64->128) + conv2_2 (128->128), 3x3, at H/2 x W/2
  K5 int8 conv    operations at the int8 rate, or the bf16 input read once

Each kernel is a file of its own, ``perfbench/kernels/<kernel>.py`` (the
contract in perfbench/kernels/__init__.py): the substrings of its names in
the device trace (``NAMES``) and its bound at a step's shapes
(``bound_s(cfg, batch)``, from the formulas here, or None where the
kernel is named but not counted). :func:`kernel_of` and :func:`bounds_s`
are built from that directory, in sorted order, so that a new kernel joins
with a new file.

The model's operations a frame are counted by walking the configuration's
plain reference (``perfbench.reference.reference``) on meta tensors (no
device, no data) under PyTorch's FLOP counter: every convolution and
matrix product, two operations a multiply-add.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from perfbench import kernels
from perfbench.reference import reference

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
              "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def kernel_files() -> Dict[str, ModuleType]:
    """The kernel files under perfbench/kernels/, by kernel (the file's
    stem), in sorted order."""
    return _kernel_files(tuple(kernels.__path__))


@functools.lru_cache(maxsize=1)  # trace.parts asks once for each device event
def _kernel_files(path: Tuple[str, ...]) -> Dict[str, ModuleType]:
    stems = sorted({m.name for m in pkgutil.iter_modules(list(path))})
    return {k: importlib.import_module(f"{kernels.__name__}.{k}") for k in stems}


def kernel_of(name: str) -> Optional[str]:
    """The kernel whose file's NAMES holds a substring of the trace name
    ``name``, or None; a name that two files match is an error."""
    hits = [k for k, f in kernel_files().items() if any(s in name for s in f.NAMES)]
    if len(hits) > 1:
        raise ValueError(f"trace name {name!r} matches the NAMES of kernels {hits}")
    return hits[0] if hits else None


def __getattr__(attr: str):
    if attr == "KERNELS":  # {trace-name substring: kernel}, read from the kernel files
        return {s: k for k, f in kernel_files().items() for s in f.NAMES}
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def k1_bytes(b: int, p: int, c: int) -> float:
    return b * p * (4 + 2 + 4 + c) * 4 + p * 4 * 4 + b * p * (4 + c) * 4


def k2_operations(rows: int, k: int) -> float:
    return rows * k * (k - 1) / 2 * 14


def conv_operations(b: int, h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * b * h * w * cout * k * k * cin


def k3_operations(b: int, h: int, w: int) -> float:
    return conv_operations(b, h, w, 3, 64) + conv_operations(b, h, w, 64, 64)


def k4_operations(b: int, h: int, w: int) -> float:
    """h, w: the stage's input, the stem's pooled output."""
    return conv_operations(b, h, w, 64, 128) + conv_operations(b, h, w, 128, 128)


def k5_bound_s(b: int, h: int, w: int, cin: int, cout: int, k: int, stride: int = 1) -> float:
    ho, wo = -(-h // stride), -(-w // stride)
    ops = conv_operations(b, ho, wo, cin, cout, k)
    return max(ops / PEAK_FLOPS["int8"], b * h * w * cin * 2 / PEAK_BYTES)


def anchors(cfg: dict) -> int:
    """The configuration's anchors a frame, P."""
    return sum(f * f * (1 + 2 * len(a)) for f, a in zip(cfg["feature_maps"], cfg["aspect_ratios"]))


def bounds_s(cfg: dict, batch: int) -> Dict[str, float]:
    """The bound of one launch of each kernel whose file counts it, in a
    serving step of ``batch`` frames of the configuration."""
    out = {}
    for k, f in kernel_files().items():
        bound = f.bound_s(cfg, batch)
        if bound is not None:
            out[k] = bound
    return out


def model_flops(cfg: dict) -> float:
    """Operations of one frame's forward (backbone to heads) of the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = reference(cfg)
    weights = {n: torch.empty(s, device="meta") for n, s, _ in ref.param_spec(cfg)}
    x = torch.empty((1, 3, cfg["size"], cfg["size"]), device="meta")
    state = ref.zero_state(cfg, 1, "meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(cfg, weights, x, state)
    return float(counter.get_total_flops())
