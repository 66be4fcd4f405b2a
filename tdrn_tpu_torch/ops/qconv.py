"""K5 wrapper: the int8 convolution of the int8 serving profile, and its plain version.

The counterpart of the s8 convolution inside ``tdrn_tpu/models/layers.py::QConv``
(XLA's ``conv_general_dilated(s8, s8, preferred_element_type=s32)`` and the
dequantizing epilogue behind it); the JAX package has no Pallas kernel for
it. A CUDA tensor goes to the hand-written kernel (csrc/qconv.cu), a CPU
tensor to :func:`qconv_plain`, which rounds at the same points, so the two
are bit-equal.

Layouts: the activations are int8 NHWC (B, H, W, Cp) with Cp a multiple of
16 (:func:`quantize_act` zero-pads the channels; the zero point is 0, so that
is exact), the weights int8 (Cout, KH, KW, Cp), both contiguous along k. The
output is (B, Ho, Wo, Cout) NHWC in bf16 or fp32 with SAME padding
``d * (k - 1) // 2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdrn_tpu_torch import _build

Tensor = torch.Tensor

CHANNEL_MULTIPLE = 16
_OUT = (torch.bfloat16, torch.float32)


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def fp32_div(a, b) -> Tensor:
    """a / b as one correctly rounded fp32 division (JAX's ``a / b``), either
    operand a Python number or a tensor on the device. PyTorch computes
    ``number / tensor`` as ``reciprocal(tensor) * number``, and on CUDA
    ``tensor / number`` as a multiply by the number's reciprocal: two
    roundings. A number is made a tensor by a fill on the device (no host copy)."""
    ref = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(ref, float(a))
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(ref, float(b))
    return torch.div(a, b)


def quantize_act(x: Tensor, xscale: Tensor) -> Tensor:
    """The JAX QConv's input quantization, ``clip(round(x * (127 / xscale)),
    -127, 127)`` in fp32, of an NCHW tensor (any memory format) into a new
    contiguous int8 NHWC tensor whose channels are zero-padded to a multiple
    of 16. ``xscale`` is the fp32 0-dim scale; 127 / xscale is one fp32
    division, as in the JAX package."""
    b, c, h, w = x.shape
    q = torch.clamp(torch.round(x.float() * fp32_div(127.0, xscale)), -127.0, 127.0)
    cp = padded_channels(c)
    out = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    out[..., :c] = q.permute(0, 2, 3, 1)  # exact: q holds integers in [-127, 127]
    if cp > c:
        out[..., c:] = 0
    return out


def conv_out_size(n: int, k: int, stride: int, dilation: int) -> int:
    pad = dilation * (k - 1) // 2
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def qconv_plain(xq: Tensor, w: Tensor, fac: Tensor, bias: Tensor, stride: int = 1,
                dilation: int = 1, out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """A float64 convolution of the int8 values (exact: |acc| < 2**53), read as
    int32, then ``float(acc) * fac + bias`` as two fp32 operations, rounded to
    ``out_dtype``. Returns (B, Ho, Wo, Cout) NHWC, contiguous."""
    kh, kw = w.shape[1], w.shape[2]
    pad = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=pad, dilation=dilation)
    acc = acc.to(torch.int32).float()
    y = acc * fac[:, None, None] + bias[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def qconv(xq: Tensor, w: Tensor, fac: Tensor, bias: Tensor, *, stride: int = 1,
          dilation: int = 1, out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """``float(conv_s32(xq, w)) * fac + bias`` rounded to ``out_dtype``.

    xq: (B, H, W, Cp) int8 NHWC, Cp a multiple of 16; w: (Cout, KH, KW, Cp)
    int8; fac = wscale * (xscale / 127) and bias: (Cout,) fp32. SAME padding
    ``dilation * (k - 1) // 2``. Returns (B, Ho, Wo, Cout) NHWC in
    ``out_dtype`` (bf16 or fp32). On the card Cout must be even and xq and w
    16-byte aligned.
    """
    if xq.dim() != 4:
        raise ValueError(f"xq: expected (B, H, W, C), got shape {tuple(xq.shape)}")
    bsz, h, wd, cp = xq.shape
    if w.dim() != 4:
        raise ValueError(f"w: expected (Cout, KH, KW, C), got shape {tuple(w.shape)}")
    cout, kh, kw = w.shape[0], w.shape[1], w.shape[2]
    _build.require(xq, "xq", (bsz, h, wd, cp), torch.int8)
    _build.require(w, "w", (cout, kh, kw, cp), torch.int8)
    _build.require(fac, "fac", (cout,))
    _build.require(bias, "bias", (cout,))
    if cp % CHANNEL_MULTIPLE:
        raise ValueError(f"the channels must be padded to a multiple of {CHANNEL_MULTIPLE}, got {cp}")
    if int(stride) < 1 or int(dilation) < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride} and {dilation}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be one of {_OUT}")
    ho, wo = conv_out_size(h, kh, stride, dilation), conv_out_size(wd, kw, stride, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output pixels for {h}x{wd} and a {kh}x{kw} kernel")
    if _build.route(xq, w, fac, bias) == "cpu":
        return qconv_plain(xq, w, fac, bias, stride, dilation, out_dtype)
    if cout % 2:
        raise ValueError(f"the qconv kernel takes an even Cout, got {cout}")
    for arg, t in (("xq", xq), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{arg}: the qconv kernel needs a 16-byte aligned tensor")
    out = torch.empty((bsz, ho, wo, cout), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _build.entry("qconv")(
            xq.data_ptr(), w.data_ptr(), fac.data_ptr(), bias.data_ptr(), out.data_ptr(),
            bsz, h, wd, cp, cout, kh, kw, int(stride), int(dilation),
            int(out_dtype == torch.bfloat16), _build.stream_of(xq),
        )
    _build.check("qconv", err)
    qconv.launches += 1
    return out


qconv.launches = 0
