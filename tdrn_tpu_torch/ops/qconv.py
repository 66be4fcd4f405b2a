"""K5 wrapper: the whole int8 QConv of the int8 serving profile, its plan and its plain version.

The counterpart of ``tdrn_tpu/models/layers.py::QConv``: XLA's fused
quantize pass, its ``conv_general_dilated(s8, s8, preferred_element_type=s32)``
and the dequantizing epilogue behind it. The JAX package has no Pallas kernel
for it. A CUDA tensor goes to the hand-written kernel (csrc/qconv.cu), which
quantizes the float activations while it loads them; a CPU tensor goes to
:func:`qconv_plain`, which is :func:`quantize_act` followed by a float64
convolution and rounds at the same points, so the two are bit-equal.

Layouts: the activations are (B, C, H, W) bf16 or fp32 in any memory format
(the kernel reads channels_last without a copy; for C % 16 != 0 it reads
any strides); the weights are the QConv's int8 (Cout, KH, KW, C), and the
kernel reads them packed once by :func:`pack_weight` into a (Cout, Kp) matrix.
The output is (B, Ho, Wo, Cout) NHWC in bf16 or fp32 with SAME padding
``d * (k - 1) // 2``.

:func:`plan` picks, from the shape alone, the tile width, the split of the
K steps over blocks and the small-C packing; the launch passes its integers
to the kernel, so the CPU tests can check every decision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tdrn_tpu_torch import _build

Tensor = torch.Tensor

CHANNEL_MULTIPLE = 16
_IN = (torch.bfloat16, torch.float32)
_OUT = (torch.bfloat16, torch.float32)

# The kernel's fixed geometry (csrc/qconv.cu) and the card it is planned for.
BM = 128  # pixels of a block tile
BK = 128  # bytes of K a step
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # shared memory a block may use (227 KB)
STATIC_SMEM = 16  # the kernel's static shared memory (the split flag)
MAX_SPLITS = 4  # the last block adds at most 3 other partial slices
STAGE_BUDGET = 192 * 1024  # shared memory for the stages of a block
MAX_TILES = 4096  # tickets in csrc/qconv.cu


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


def act_scale(xscale: Tensor) -> Tensor:
    """``s = 127 / xscale``, the fp32 step that quantizes a QConv's input."""
    return fp32_div(127.0, xscale)


def dequant_factor(wscale: Tensor, xscale: Tensor) -> Tensor:
    """``fac = wscale * (xscale / 127)``, the per-channel fp32 epilogue scale,
    with the JAX QConv's two fp32 operations."""
    return wscale * fp32_div(xscale, 127.0)


def quantize_nhwc(x: Tensor, s: Tensor) -> Tensor:
    """:func:`quantize_act` with the step ``s = 127 / xscale`` given."""
    b, c, h, w = x.shape
    q = torch.clamp(torch.round(x.float() * s), -127.0, 127.0)
    cp = padded_channels(c)
    out = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    out[..., :c] = q.permute(0, 2, 3, 1)  # exact: q holds integers in [-127, 127]
    if cp > c:
        out[..., c:] = 0
    return out


def quantize_act(x: Tensor, xscale: Tensor) -> Tensor:
    """The JAX QConv's input quantization, ``clip(round(x * (127 / xscale)),
    -127, 127)`` in fp32, of an NCHW tensor (any memory format) into a new
    contiguous int8 NHWC tensor whose channels are zero-padded to a multiple
    of 16. ``xscale`` is the fp32 0-dim scale; 127 / xscale is one fp32
    division, as in the JAX package. On the card K5 does this in its loader;
    this function is the first half of :func:`qconv_plain`, and calibration's."""
    return quantize_nhwc(x, act_scale(xscale))


def conv_out_size(n: int, k: int, stride: int, dilation: int) -> int:
    pad = dilation * (k - 1) // 2
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


class Plan(NamedTuple):
    """K5's launch decisions for one conv shape (csrc/qconv.cu reads them)."""

    bn: int  # output channels of a block tile: 64, 128 or 256
    splits: int  # blocks sharing a tile's K steps (split-k), 1 for none
    stages: int  # depth of the shared-memory ring
    flat: bool  # small-C packing: K over (tap, channel) flattened, padded to 32
    k: int  # K = KH * KW * C, the true depth
    kp: int  # the packed weights' row length
    ksteps: int  # k32 wgmma steps (kp / 32, rounded up)
    kblocks: int  # K steps of 128 bytes
    m_tiles: int
    n_tiles: int
    smem: int  # dynamic shared memory of a block, bytes (the kernel adds STATIC_SMEM)
    grid: int  # persistent blocks (one an SM at most), each walking the work units grid apart

    def ranges(self):
        """The K steps of each split, [first, last): every step once."""
        return [(z * self.kblocks // self.splits, (z + 1) * self.kblocks // self.splits)
                for z in range(self.splits)]


def plan(b: int, h: int, w: int, c: int, cout: int, k: int, stride: int = 1,
         dilation: int = 1) -> Plan:
    """K5's plan for a (B, H, W, C) -> Cout conv with a k x k kernel.

    - Small-C packing where C % 16 != 0 (the stems' 3 and 12 channels): the
      loader gathers values along (tap, channel) flattened, K padded to 32.
    - BN 64 for Cout <= 64, 128 for Cout <= 128; above that 256 when the
      256-wide tiles still fill the card (each input is then quantized for
      half as many tiles), else 128. One block an SM (two consumer
      warpgroups and one producer warpgroup at BN 256, two below), with as
      many stages as fit in 192 KB, at most 8.
    - Split-k where the tiles fill fewer than the card's SMs: the K steps
      are shared out over up to 4 work units a tile, each split at least
      four steps where there are that many (never with small C, whose
      loader takes whole units).
    - A persistent grid: at most one block an SM, each walking the work
      units (a tile and a split) grid apart.
    """
    ho, wo = conv_out_size(h, k, stride, dilation), conv_out_size(w, k, stride, dilation)
    m = b * ho * wo
    flat = c % CHANNEL_MULTIPLE != 0
    kk = k * k * c
    kp = -(-kk // 32) * 32 if flat else kk
    ksteps, kblocks = -(-kp // 32), -(-kp // BK)
    m_tiles = -(-m // BM)
    if cout <= 64:
        bn = 64
    elif cout <= 128 or m_tiles * -(-cout // 256) < SMS:
        bn = 128
    else:
        bn = 256
    stages = min(8, STAGE_BUDGET // (BM * BK + bn * BK))
    n_tiles = -(-cout // bn)
    tiles = m_tiles * n_tiles
    splits = 1
    if tiles < SMS and not flat:  # the small-C loader takes whole units
        splits = max(1, min(SMS // tiles, max(1, kblocks // 4), MAX_SPLITS))
    smem = stages * (BM * BK + bn * BK) + 16 * stages + 1024
    grid = min(tiles * splits, SMS)
    return Plan(bn, splits, stages, flat, kk, kp, ksteps, kblocks, m_tiles, n_tiles, smem, grid)


def pack_weight(w: Tensor) -> Tensor:
    """QConv's int8 (Cout, KH, KW, C) weights as K5's (Cout, Kp) matrix: row k
    = (ky * KW + kx) * C + c, zero-padded to Kp (a multiple of 32) where
    C % 16 != 0. Contiguous, on w's device; made once per QConv."""
    cout, kh, kw, c = w.shape
    flat = w.reshape(cout, kh * kw * c)
    if c % CHANNEL_MULTIPLE:
        kk = kh * kw * c
        flat = F.pad(flat, (0, -(-kk // 32) * 32 - kk))
    return flat.contiguous()


def qconv_plain(x: Tensor, w: Tensor, s: Tensor, fac: Tensor, bias: Tensor, stride: int = 1,
                dilation: int = 1, out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """:func:`quantize_act`'s rounding (with ``s = 127 / xscale`` given), then
    a float64 convolution of the int8 values (exact: |acc| < 2**53), read as
    int32, then ``float(acc) * fac + bias`` as two fp32 operations, rounded to
    ``out_dtype``. Returns (B, Ho, Wo, Cout) NHWC, contiguous."""
    xq = quantize_nhwc(x, s)
    kh, kw = w.shape[1], w.shape[2]
    w = F.pad(w, (0, xq.shape[-1] - w.shape[-1]))
    pad = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=pad, dilation=dilation)
    acc = acc.to(torch.int32).float()
    y = acc * fac[:, None, None] + bias[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def qconv(x: Tensor, w: Tensor, s: Tensor, fac: Tensor, bias: Tensor, *, stride: int = 1,
          dilation: int = 1, out_dtype: torch.dtype = torch.bfloat16,
          wpack: Tensor | None = None) -> Tensor:
    """``float(conv_s32(q(x), w)) * fac + bias`` rounded to ``out_dtype``, with
    ``q(x) = clamp(rint(float(x) * s), -127, 127)``.

    x: (B, C, H, W) bf16 or fp32, any memory format; w: (Cout, KH, KW, C)
    int8; s: the fp32 0-dim ``127 / xscale``; fac = wscale * (xscale / 127)
    and bias: (Cout,) fp32. SAME padding ``dilation * (k - 1) // 2``.
    ``wpack`` is ``pack_weight(w)``, made once by the caller (made here when
    not given). Returns (B, Ho, Wo, Cout) NHWC in ``out_dtype``. On the card
    Cout must be even; a channels_last copy of x is made only where C % 16
    == 0 and x is not channels_last already.
    """
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, C, H, W), got shape {tuple(x.shape)}")
    bsz, c, h, wd = x.shape
    if x.dtype not in _IN:
        raise TypeError(f"x: dtype {x.dtype}, expected one of {_IN}")
    if w.dim() != 4:
        raise ValueError(f"w: expected (Cout, KH, KW, C), got shape {tuple(w.shape)}")
    cout, kh, kw = w.shape[0], w.shape[1], w.shape[2]
    _build.require(w, "w", (cout, kh, kw, c), torch.int8)
    _build.require(s, "s", ())
    _build.require(fac, "fac", (cout,))
    _build.require(bias, "bias", (cout,))
    if kh != kw:
        raise ValueError(f"w: K5 takes square kernels, got {kh}x{kw}")
    if int(stride) < 1 or int(dilation) < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride} and {dilation}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be one of {_OUT}")
    ho, wo = conv_out_size(h, kh, stride, dilation), conv_out_size(wd, kw, stride, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output pixels for {h}x{wd} and a {kh}x{kw} kernel")
    pl = plan(bsz, h, wd, c, cout, kh, int(stride), int(dilation))
    if wpack is not None:
        _build.require(wpack, "wpack", (cout, pl.kp), torch.int8)
    if _build.route(x, w, s, fac, bias, *(() if wpack is None else (wpack,))) == "cpu":
        return qconv_plain(x, w, s, fac, bias, stride, dilation, out_dtype)
    if cout % 2:
        raise ValueError(f"the qconv kernel takes an even Cout, got {cout}")
    if x.numel() >= 2**31:
        raise ValueError("x: the qconv kernel indexes its input with 32-bit strides")
    if not pl.flat:
        x = x.contiguous(memory_format=torch.channels_last)
        if x.data_ptr() % 16:
            raise ValueError("x: the qconv kernel needs a 16-byte aligned input")
    if wpack is None:
        wpack = pack_weight(w)
    if wpack.data_ptr() % 16:
        raise ValueError("wpack: the qconv kernel needs 16-byte aligned weights")
    out = torch.empty((bsz, ho, wo, cout), dtype=out_dtype, device=x.device)
    ws = None
    if pl.splits > 1:
        ws = torch.empty((pl.splits, bsz * ho * wo, cout), dtype=torch.int32, device=x.device)
    sb, sc, sh, sw = x.stride()
    with torch.cuda.device(x.device):
        err = _build.entry("qconv")(
            x.data_ptr(), wpack.data_ptr(), s.data_ptr(), fac.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            bsz, h, wd, c, cout, kh, kw, int(stride), int(dilation), sb, sh, sw, sc,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            pl.bn, pl.splits, pl.stages, int(pl.flat), pl.kp, pl.grid, _build.stream_of(x),
        )
    _build.check("qconv", err)
    qconv.launches += 1
    return out


qconv.launches = 0
