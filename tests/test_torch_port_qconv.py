"""K5's plain version and plan on the CPU (ops/qconv.py).

Since K5 quantizes on load, its plain version ``qconv_plain`` takes the float
activations: it is ``quantize_act``'s rounding followed by the float64
convolution of the int8 values. It is held bit for bit
- against the JAX QConv (``tdrn_tpu/models/layers.py``) on the same float
  input and int8 parameters, and
- against the JAX package's own int8 activations (``jnp.clip(jnp.round(x *
  (127 / xscale)))``) put through the port's float64 int8 convolution,
  the route the port took before quantize-on-load,
in bf16 and fp32 input and output, on NCHW and channels_last inputs, at
C = 3, 12 and 64, stride 2 and dilation 3, with inputs past +-xscale.

The plan (tile width, split-k, small-C packing) is checked over every
distinct conv shape of the four int8 paths that chip_smoke.py drives.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from tdrn_tpu.models.layers import QConv as JQConv
from tdrn_tpu_torch.models.layers import QConv
from tdrn_tpu_torch.ops import qconv as q
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, H, W, Cin, Cout, k, stride, dilation): every distinct QConv call of
# VID_320 int8 (37 a step), ResNet-101 vid_512 int8 (126), s2d + light and
# hybrid int8 (37 each), as chip_smoke.py's qconv_calls records them.
INT8_PATH_SHAPES = [
    (4, 5, 5, 256, 256, 3, 1, 1), (4, 5, 5, 512, 256, 1, 1, 1), (4, 5, 5, 512, 256, 3, 1, 1),
    (4, 5, 5, 512, 512, 3, 1, 1), (4, 10, 10, 256, 256, 3, 1, 1), (4, 10, 10, 256, 512, 3, 2, 1),
    (4, 10, 10, 512, 256, 1, 1, 1), (4, 10, 10, 512, 256, 3, 1, 1), (4, 10, 10, 512, 512, 3, 1, 1),
    (4, 10, 10, 512, 1024, 3, 1, 3), (4, 10, 10, 1024, 256, 1, 1, 1), (4, 10, 10, 1024, 256, 3, 1, 1),
    (4, 10, 10, 1024, 1024, 1, 1, 1), (4, 20, 20, 256, 256, 3, 1, 1), (4, 20, 20, 512, 256, 1, 1, 1),
    (4, 20, 20, 512, 256, 3, 1, 1), (4, 20, 20, 512, 512, 3, 1, 1), (4, 40, 40, 256, 256, 3, 1, 1),
    (4, 40, 40, 256, 512, 3, 1, 1), (4, 40, 40, 512, 256, 1, 1, 1), (4, 40, 40, 512, 256, 3, 1, 1),
    (4, 40, 40, 512, 512, 3, 1, 1), (4, 80, 80, 128, 256, 3, 1, 1), (4, 80, 80, 256, 256, 3, 1, 1),
    (4, 160, 160, 12, 64, 3, 1, 1), (4, 160, 160, 64, 64, 3, 1, 1), (4, 160, 160, 64, 128, 3, 1, 1),
    (4, 160, 160, 128, 128, 3, 1, 1), (4, 320, 320, 3, 64, 3, 1, 1), (4, 320, 320, 64, 64, 3, 1, 1),
    (16, 5, 5, 256, 256, 3, 1, 1), (16, 5, 5, 512, 256, 3, 1, 1), (16, 5, 5, 512, 512, 3, 1, 1),
    (16, 8, 8, 256, 256, 3, 1, 1), (16, 8, 8, 512, 256, 3, 1, 1), (16, 8, 8, 512, 512, 3, 1, 1),
    (16, 10, 10, 256, 256, 3, 1, 1), (16, 10, 10, 256, 512, 3, 2, 1), (16, 10, 10, 512, 256, 3, 1, 1),
    (16, 10, 10, 512, 512, 3, 1, 1), (16, 10, 10, 512, 1024, 3, 1, 3), (16, 10, 10, 1024, 256, 1, 1, 1),
    (16, 10, 10, 1024, 256, 3, 1, 1), (16, 10, 10, 1024, 1024, 1, 1, 1), (16, 16, 16, 256, 256, 3, 1, 1),
    (16, 16, 16, 256, 512, 3, 2, 1), (16, 16, 16, 512, 256, 3, 1, 1), (16, 16, 16, 512, 512, 3, 1, 1),
    (16, 16, 16, 512, 2048, 1, 1, 1), (16, 16, 16, 2048, 256, 1, 1, 1), (16, 16, 16, 2048, 256, 3, 1, 1),
    (16, 16, 16, 2048, 512, 1, 1, 1), (16, 20, 20, 256, 256, 3, 1, 1), (16, 20, 20, 512, 256, 3, 1, 1),
    (16, 20, 20, 512, 512, 3, 1, 1), (16, 32, 32, 256, 256, 3, 1, 1), (16, 32, 32, 256, 1024, 1, 1, 1),
    (16, 32, 32, 512, 256, 3, 1, 1), (16, 32, 32, 512, 512, 3, 1, 1), (16, 32, 32, 512, 512, 3, 2, 1),
    (16, 32, 32, 1024, 256, 1, 1, 1), (16, 32, 32, 1024, 256, 3, 1, 1), (16, 32, 32, 1024, 512, 1, 1, 1),
    (16, 32, 32, 1024, 2048, 1, 2, 1), (16, 40, 40, 256, 256, 3, 1, 1), (16, 40, 40, 256, 512, 3, 1, 1),
    (16, 40, 40, 512, 256, 3, 1, 1), (16, 40, 40, 512, 512, 3, 1, 1), (16, 64, 64, 128, 128, 3, 1, 1),
    (16, 64, 64, 128, 512, 1, 1, 1), (16, 64, 64, 256, 256, 3, 1, 1), (16, 64, 64, 256, 256, 3, 2, 1),
    (16, 64, 64, 512, 128, 1, 1, 1), (16, 64, 64, 512, 256, 1, 1, 1), (16, 64, 64, 512, 256, 3, 1, 1),
    (16, 64, 64, 512, 512, 3, 1, 1), (16, 64, 64, 512, 1024, 1, 2, 1), (16, 80, 80, 128, 256, 3, 1, 1),
    (16, 80, 80, 256, 256, 3, 1, 1), (16, 128, 128, 64, 64, 1, 1, 1), (16, 128, 128, 64, 64, 3, 1, 1),
    (16, 128, 128, 64, 256, 1, 1, 1), (16, 128, 128, 128, 128, 3, 2, 1), (16, 128, 128, 256, 64, 1, 1, 1),
    (16, 128, 128, 256, 128, 1, 1, 1), (16, 128, 128, 256, 512, 1, 2, 1), (16, 160, 160, 64, 128, 3, 1, 1),
    (16, 160, 160, 128, 128, 3, 1, 1), (16, 320, 320, 3, 64, 3, 1, 1), (16, 320, 320, 64, 64, 3, 1, 1),
    (16, 512, 512, 3, 64, 7, 2, 1),
]

# (Cin, kernel, stride, dilation)
CASES = {"c3_3x3": (3, 3, 1, 1), "c12_3x3_s2": (12, 3, 2, 1), "c64_3x3_dil3": (64, 3, 1, 3),
         "c64_1x1_s2": (64, 1, 2, 1)}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}
COUT = 24


def _params(rng, k, cin):
    kernel = rng.integers(-127, 128, (k, k, cin, COUT)).astype(np.int8)
    wscale = rng.uniform(1e-3, 5e-3, COUT).astype(np.float32)
    xscale = np.float32(rng.uniform(2.0, 6.0))
    bias = rng.normal(0, 0.1, COUT).astype(np.float32)
    return kernel, wscale, xscale, bias


def _int8_conv(xq, w, fac, bias, stride, dilation, out_dtype):
    """The port's float64 int8 convolution and epilogue on int8 NHWC
    activations with zero-padded channels: the route before quantize-on-load."""
    w = F.pad(w, (0, xq.shape[-1] - w.shape[-1]))
    kh, kw = w.shape[1], w.shape[2]
    pad = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=pad, dilation=dilation).to(torch.int32).float()
    y = acc * fac[:, None, None] + bias[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_qconv_plain_matches_jax_bit_for_bit(case, out):
    cin, k, s, d = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    kernel, wscale, xscale, bias = _params(rng, k, cin)
    # Past +-xscale: about a sixth of the values clamp to +-127.
    x = rng.uniform(-1.4, 1.4, (2, 13, 15, cin)).astype(np.float32) * xscale
    params = {"params": {"kernel": jnp.asarray(kernel), "wscale": jnp.asarray(wscale),
                         "xscale": jnp.asarray(xscale), "bias": jnp.asarray(bias)}}
    tout, jout = DTYPES[out]
    w = torch.from_numpy(kernel.transpose(3, 0, 1, 2).copy())
    xs, ws_ = torch.tensor(xscale), torch.from_numpy(wscale)
    sc, fac, tb = q.act_scale(xs), q.dequant_factor(ws_, xs), torch.from_numpy(bias)
    clamped = 0
    for xin, (tin, jin) in DTYPES.items():
        xj = jnp.asarray(x, jin)
        ref = np.asarray(JQConv(COUT, (k, k), stride=s, dilation=d, dtype=jout).apply(params, xj),
                         np.float32)
        xq_jax = np.asarray(jnp.clip(jnp.round(xj.astype(jnp.float32) * (127.0 / jnp.float32(xscale))),
                                     -127.0, 127.0).astype(jnp.int8))
        clamped = max(clamped, int((np.abs(xq_jax) == 127).sum()))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tin).permute(0, 3, 1, 2)
        for layout in (torch.contiguous_format, torch.channels_last):
            xl = xt.contiguous(memory_format=layout)
            got = q.qconv_plain(xl, w, sc, fac, tb, s, d, tout)
            assert got.dtype == tout and tuple(got.shape) == ref.shape
            # The JAX QConv, bit for bit.
            np.testing.assert_array_equal(got.float().numpy(), ref, err_msg=f"{xin} in, {layout}")
            # quantize_act is the JAX quantization, bit for bit; through the
            # port's earlier int8 route it gives the same output.
            xq = q.quantize_act(xl, xs)
            np.testing.assert_array_equal(xq[..., :cin].numpy(), xq_jax)
            assert torch.equal(_int8_conv(xq, w, fac, tb, s, d, tout), got)
            # The wrapper's CPU route is the plain version, packed or not.
            assert torch.equal(q.qconv(xl, w, sc, fac, tb, stride=s, dilation=d, out_dtype=tout,
                                       wpack=q.pack_weight(w)), got)
    assert clamped > 0


def test_plan_covers_every_k_step_of_every_int8_path_shape():
    """Every split covers each K step exactly once, the small-C packing is
    taken exactly where C < 16, every plan fits 227 KB of shared memory, and
    only 128-wide (or narrower) tiles are split."""
    assert len(INT8_PATH_SHAPES) == len(set(INT8_PATH_SHAPES)) == 91
    kinds = set()
    for shape in INT8_PATH_SHAPES:
        b, h, w, c, cout, k, s, d = shape
        p = q.plan(*shape)
        steps = [kb for lo, hi in p.ranges() for kb in range(lo, hi)]
        assert steps == list(range(p.kblocks)), shape
        assert all(hi > lo for lo, hi in p.ranges()), shape
        assert p.flat == (c < 16), shape
        assert p.k == k * k * c and p.kp >= p.k and p.kp % (32 if p.flat else 16) == 0, shape
        assert p.kblocks == -(-p.kp // q.BK) and p.ksteps == -(-p.kp // 32), shape
        assert p.smem + q.STATIC_SMEM <= q.SMEM_LIMIT, shape
        assert p.bn in (64, 128, 256) and 3 <= p.stages <= 8, shape
        assert 1 <= p.grid <= min(q.SMS, p.m_tiles * p.n_tiles * p.splits), shape
        assert not (p.flat and p.splits > 1), shape
        assert p.splits == 1 or (p.bn <= 128 and p.m_tiles * p.n_tiles < min(q.SMS, q.MAX_TILES)), shape
        assert 1 <= p.splits <= q.MAX_SPLITS, shape
        ho, wo = q.conv_out_size(h, k, s, d), q.conv_out_size(w, k, s, d)
        assert p.m_tiles == -(-b * ho * wo // q.BM) and p.n_tiles == -(-cout // p.bn), shape
        kinds.add((p.bn, p.splits > 1, p.flat))
    # conv1_1 packs 27 -> 32 (one k32 step), the s2d stem 108 -> 128, the 7x7 147 -> 160.
    assert q.plan(16, 320, 320, 3, 64, 3).kp == 32 and q.plan(16, 320, 320, 3, 64, 3).ksteps == 1
    assert q.plan(4, 160, 160, 12, 64, 3).kp == 128
    assert q.plan(16, 512, 512, 3, 64, 7, 2).kp == 160
    # Every tile width, split and unsplit, and the packed stems occur.
    assert {(64, False, True), (64, False, False), (128, True, False), (128, False, False),
            (256, False, False)} <= kinds


def test_pack_weight_is_the_kernels_k_order():
    """Row k of the packed matrix is (ky * KW + kx) * C + c, zero past K."""
    rng = np.random.default_rng(5)
    for c in (3, 12, 16, 64):
        w = torch.from_numpy(rng.integers(-127, 128, (8, 3, 3, c)).astype(np.int8))
        p = q.pack_weight(w)
        kp = q.plan(1, 8, 8, c, 8, 3).kp
        assert p.shape == (8, kp) and p.is_contiguous()
        for ky, kx, ch in ((0, 0, 0), (1, 2, c - 1), (2, 2, c // 2)):
            assert torch.equal(p[:, (ky * 3 + kx) * c + ch], w[:, ky, kx, ch])
        assert int(p[:, 9 * c:].abs().sum()) == 0


def test_qconv_layer_derives_its_scales_and_packing_once(monkeypatch):
    """QConv makes s, fac and the packed weights when its buffers are loaded
    (not per forward), with the JAX package's fp32 operations, keeps them
    fp32/int8 through a cast and matches the plain version."""
    from tdrn_tpu_torch.models import layers

    rng = np.random.default_rng(6)
    kernel, wscale, xscale, bias = _params(rng, 3, 3)
    mod = QConv(3, COUT, 3, dtype=torch.bfloat16)
    sd = {"weight": torch.from_numpy(kernel.transpose(3, 0, 1, 2).copy()),
          "wscale": torch.from_numpy(wscale), "xscale": torch.tensor(xscale),
          "bias": torch.from_numpy(bias)}
    mod.load_state_dict(sd)
    assert set(mod.state_dict()) == set(sd)  # the derived buffers are not persistent
    assert mod.s.item() == np.float32(127.0) / xscale
    np.testing.assert_array_equal(mod.fac.numpy(), wscale * (xscale / np.float32(127.0)))
    assert torch.equal(mod.wpack, q.pack_weight(sd["weight"]))
    calls = []
    for name in ("act_scale", "dequant_factor", "pack_weight"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, fn=fn: calls.append(1) or fn(*a))
    mod = mod.bfloat16()
    x = torch.from_numpy(rng.uniform(-6, 6, (1, 3, 9, 11)).astype(np.float32)).bfloat16()
    y = mod(x)
    assert not calls and mod.s.dtype == mod.fac.dtype == torch.float32
    assert mod.wpack.dtype == torch.int8
    ref = q.qconv_plain(x, sd["weight"], mod.s, mod.fac, mod.bias, 1, 1, torch.bfloat16)
    assert torch.equal(y.permute(0, 2, 3, 1), ref)
    mod.load_state_dict(sd)  # a load remakes them
    assert len(calls) == 3
