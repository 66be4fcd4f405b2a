"""K3 wrapper: the fused VGG stage-1 stem, and its plain version.

Port of ``tdrn_tpu/ops/stem_pallas.py::fused_stem_stage1``, same signature and
layout: x (B, H, W, Cin) NHWC, k1 (3, 3, Cin, N) and k2 (3, 3, N, N) HWIO.
A CUDA tensor goes to the hand-written kernel (csrc/stem.cu), a CPU tensor to
:func:`stem_plain`, which rounds at the same points.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdrn_tpu_torch import _build

Tensor = torch.Tensor

_COMPUTE = (torch.bfloat16, torch.float32)


def stem_plain(
    x: Tensor, k1: Tensor, b1: Tensor, k2: Tensor, b2: Tensor,
    compute_dtype: torch.dtype, out_dtype: torch.dtype,
) -> Tensor:
    """x, k1, k2 rounded to ``compute_dtype`` and back; fp32 convs, bias and
    ReLU; conv1's output rounded again; 2x2 max-pool. Returns NHWC."""
    rnd = lambda t: t.to(compute_dtype).to(torch.float32)
    xc = rnd(x).permute(0, 3, 1, 2)
    w1 = rnd(k1).permute(3, 2, 0, 1)
    w2 = rnd(k2).permute(3, 2, 0, 1)
    o1 = F.relu(F.conv2d(xc, w1, padding=1) + b1[None, :, None, None])
    # Zero padding of the second conv is the zeroed ring outside the image.
    o1 = rnd(o1)
    o2 = F.relu(F.conv2d(o1, w2, padding=1) + b2[None, :, None, None])
    y = F.max_pool2d(o2, 2, 2)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def fused_stem_stage1(
    x: Tensor, k1: Tensor, b1: Tensor, k2: Tensor, b2: Tensor, *,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """maxpool2(relu(conv3x3_SAME(relu(conv3x3_SAME(x, k1) + b1), k2) + b2)).

    x: (B, H, W, Cin) float32; k1: (3, 3, Cin, N); k2: (3, 3, N, N); b1, b2: (N,).
    Returns (B, H//2, W//2, N) in ``out_dtype`` (default x.dtype), NHWC. H and
    W must be even.
    """
    bsz, h, w, cin = x.shape
    n = k1.shape[-1]
    _build.require(x, "x", (bsz, h, w, cin))
    _build.require(k1, "k1", (3, 3, cin, n))
    _build.require(b1, "b1", (n,))
    _build.require(k2, "k2", (3, 3, n, n))
    _build.require(b2, "b2", (n,))
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _COMPUTE:
        raise ValueError(f"out_dtype must be one of {_COMPUTE}")
    if _build.route(x, k1, b1, k2, b2) == "cpu":
        return stem_plain(x, k1, b1, k2, b2, compute_dtype, out_dtype)
    if n % 64:
        raise ValueError(f"the stem kernel takes a multiple of 64 channels, got {n}")
    out = torch.empty((bsz, h // 2, w // 2, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.entry("stem")(
            x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, h, w, cin, n, n,
            int(compute_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            _build.stream_of(x),
        )
    _build.check("stem", err)
    fused_stem_stage1.launches += 1
    return out


fused_stem_stage1.launches = 0
