"""The yardstick of the kernels and of the whole step: the H100's published
peaks, the bound of each hand-written kernel of the program (K1-K5) at a
launch's shapes, and the model's operations a frame.

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

The model's operations a frame are counted by walking the reference's
forward on meta tensors (no device, no data) under PyTorch's FLOP counter:
every convolution and matrix product, two operations a multiply-add.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
              "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

# Kernel names (substrings of the device trace's names) -> the program's kernel.
KERNELS = {"cascade_kernel": "K1", "nms_rows_kernel": "K2", "nms_block_kernel": "K2",
           "stem_tc_kernel": "K3", "stem_kernel": "K3", "conv_stage_kernel": "K4",
           "qconv_kernel": "K5"}


def kernel_of(name: str) -> Optional[str]:
    for key, k in KERNELS.items():
        if key in name:
            return k
    return None


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


def bounds_s(cfg: dict, batch: int) -> Dict[str, float]:
    """The bound of one launch of each of K1-K4 in a serving step of ``batch``
    frames of the configuration (K3 on the bf16 tensor-core path)."""
    size, c = int(cfg["size"]), int(cfg["num_classes"])
    p = sum(f * f * (1 + 2 * len(a)) for f, a in zip(cfg["feature_maps"], cfg["aspect_ratios"]))
    k = min(int(cfg["top_k"]), int(cfg["prefilter_anchors"]) or p)
    return {
        "K1": k1_bytes(batch, p, c) / PEAK_BYTES,
        "K2": k2_operations(batch * c, k) / PEAK_FLOPS["fp32"],
        "K3": k3_operations(batch, size, size) / PEAK_FLOPS["bf16"],
        "K4": k4_operations(batch, size // 2, size // 2) / PEAK_FLOPS["bf16"],
    }


def model_flops(cfg: dict) -> float:
    """Operations of one frame's forward (backbone to heads) of the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import model as ref_model

    weights = {n: torch.empty(s, device="meta") for n, s, _ in ref_model.param_spec(cfg)}
    x = torch.empty((1, 3, cfg["size"], cfg["size"]), device="meta")
    state = ref_model.zero_state(cfg, 1, "meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref_model.forward(cfg, weights, x, state)
    return float(counter.get_total_flops())
