"""K3 and K4 wrappers: the fused VGG stages 1 and 2, and their plain version.

Ports of ``tdrn_tpu/ops/stem_pallas.py::fused_stem_stage1`` (K3, csrc/stem.cu)
and ``::fused_conv_stage`` (K4, csrc/conv_stage.cu), same signatures and
layout: x (B, H, W, Cin) NHWC, k1 (3, 3, Cin, Cmid) and k2 (3, 3, Cmid, Cout)
HWIO. x, k1 and k2 share one dtype, fp32 or bf16; the biases are that dtype
or fp32 and go to the kernels as fp32 (exact for bf16). A CUDA tensor goes to
the hand-written kernel, a CPU tensor to :func:`stem_plain`, which rounds at
the same points.
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
    o1 = F.relu(F.conv2d(xc, w1, padding=1) + b1.float()[None, :, None, None])
    # Zero padding of the second conv is the zeroed ring outside the image.
    o1 = rnd(o1)
    o2 = F.relu(F.conv2d(o1, w2, padding=1) + b2.float()[None, :, None, None])
    y = F.max_pool2d(o2, 2, 2)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def _validate(x, k1, b1, k2, b2, compute_dtype, out_dtype) -> torch.dtype:
    """Check the arguments of either stage; returns the output dtype."""
    if x.dtype not in _COMPUTE:
        raise TypeError(f"x: dtype {x.dtype}, expected one of {_COMPUTE}")
    bsz, h, w, cin = x.shape
    cmid, cout = k1.shape[-1], k2.shape[-1]
    _build.require(x, "x", (bsz, h, w, cin), x.dtype)
    _build.require(k1, "k1", (3, 3, cin, cmid), x.dtype)
    _build.require(k2, "k2", (3, 3, cmid, cout), x.dtype)
    for name, bias, n in (("b1", b1, cmid), ("b2", b2, cout)):
        _build.require(bias, name, (n,), x.dtype if bias.dtype == x.dtype else torch.float32)
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    if compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _COMPUTE:
        raise ValueError(f"out_dtype must be one of {_COMPUTE}")
    return out_dtype


def _launch(name, x, k1, b1, k2, b2, out, flags) -> None:
    bsz, h, w, cin = x.shape
    # Both kernels copy the weights in 16-byte chunks, K4 its input as well.
    chunked = {"k1": k1, "k2": k2} if name == "stem" else {"x": x, "k1": k1, "k2": k2}
    for arg, t in chunked.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{arg}: the {name} kernel needs a 16-byte aligned tensor")
    b1, b2 = b1.float(), b2.float()  # held until the launch is enqueued
    with torch.cuda.device(x.device):
        err = _build.entry(name)(
            x.data_ptr(), k1.data_ptr(), b1.data_ptr(), k2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), bsz, h, w, cin, k1.shape[-1],
            k2.shape[-1], int(x.dtype == torch.bfloat16), *flags,
            int(out.dtype == torch.bfloat16), _build.stream_of(x),
        )
    _build.check(name, err)


def fused_stem_stage1(
    x: Tensor, k1: Tensor, b1: Tensor, k2: Tensor, b2: Tensor, *,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """maxpool2(relu(conv3x3_SAME(relu(conv3x3_SAME(x, k1) + b1), k2) + b2)).

    x: (B, H, W, Cin) float32 or bfloat16; k1: (3, 3, Cin, N); k2: (3, 3, N, N);
    b1, b2: (N,). Returns (B, H//2, W//2, N) in ``out_dtype`` (default
    x.dtype), NHWC. H and W must be even.

    On the card, ``compute_dtype=torch.bfloat16`` runs the tensor-core kernel
    (Cin <= 3, N = 64: VGG's stage 1) and ``torch.float32`` the CUDA-core one
    (N a multiple of 64); the launch counter counts both.
    """
    out_dtype = _validate(x, k1, b1, k2, b2, compute_dtype, out_dtype)
    n = k1.shape[-1]
    if k2.shape[-1] != n:
        raise ValueError(f"k2 must be (3, 3, {n}, {n}), got {tuple(k2.shape)}")
    if _build.route(x, k1, b1, k2, b2) == "cpu":
        return stem_plain(x, k1, b1, k2, b2, compute_dtype, out_dtype)
    bsz, h, w, cin = x.shape
    if compute_dtype == torch.bfloat16 and (n != 64 or cin > 3):
        raise ValueError(
            f"the bf16 stem kernel takes Cin <= 3 and 64 channels, got {cin} and {n}"
        )
    if n % 64:
        raise ValueError(f"the fp32 stem kernel takes a multiple of 64 channels, got {n}")
    out = torch.empty((bsz, h // 2, w // 2, n), dtype=out_dtype, device=x.device)
    _launch("stem", x, k1, b1, k2, b2, out, [int(compute_dtype == torch.bfloat16)])
    fused_stem_stage1.launches += 1
    return out


fused_stem_stage1.launches = 0


def fused_conv_stage(
    x: Tensor, k1: Tensor, b1: Tensor, k2: Tensor, b2: Tensor, *,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """The same two-conv + pool stage for any channel counts (VGG stage 2 under
    ``stem="fused2"``): x (B, H, W, Cin), k1 (3, 3, Cin, Cmid), k2 (3, 3, Cmid,
    Cout) -> (B, H//2, W//2, Cout) in ``out_dtype`` (default x.dtype).

    The kernel computes on bf16 tensor cores, so on the card it takes
    ``compute_dtype=torch.bfloat16`` only, Cin a multiple of 16, Cmid of 64
    and Cout of 128.
    """
    out_dtype = _validate(x, k1, b1, k2, b2, compute_dtype, out_dtype)
    if _build.route(x, k1, b1, k2, b2) == "cpu":
        return stem_plain(x, k1, b1, k2, b2, compute_dtype, out_dtype)
    bsz, h, w, cin = x.shape
    cmid, cout = k1.shape[-1], k2.shape[-1]
    if compute_dtype != torch.bfloat16:
        raise ValueError("the conv-stage kernel computes in bfloat16 only")
    if cin % 16 or cmid % 64 or cout % 128:
        raise ValueError(
            f"the conv-stage kernel takes Cin % 16, Cmid % 64 and Cout % 128 == 0, "
            f"got {cin}, {cmid}, {cout}"
        )
    out = torch.empty((bsz, h // 2, w // 2, cout), dtype=out_dtype, device=x.device)
    _launch("conv_stage", x, k1, b1, k2, b2, out, [])
    fused_conv_stage.launches += 1
    return out


fused_conv_stage.launches = 0
