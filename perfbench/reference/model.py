"""The plain reference of the benchmark's detectors: TDRN on VGG-16 or ResNet-101.

A frozen, functional restatement of the published model (DRN/TDRN,
arXiv:1807.08638, on RefineDet, arXiv:1711.06897) as the measured program
builds it: backbone -> L2Norm on the two shallow sources -> ARM heads -> TCB
top-down pyramid -> ARM-guided re-sampling -> ConvGRU carry -> ODM heads. It
computes in float32 with plain ``torch.nn.functional`` calls, reads its
weights from a dict keyed by parameter name (the benchmark draws that dict;
:func:`param_spec` lists its names and shapes), and imports nothing of the
program.

``lowp``, where given, rounds every tensor that the serving profile holds
in bf16: both operands and the output of every convolution of the backbone,
the TCB and the temporal cell, the norms' and residual adds' outputs, the
L2Norm, re-sampling and gate outputs and the carried state. The benchmark's
control puts a lower precision there (``perfbench.reference.fp8``). The
module keeps the contract of perfbench/reference/__init__.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]
LowP = Optional[Callable[[Tensor], Tensor]]

VGG_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
RESNET101 = (3, 4, 23, 3)
# Top-level groups the serving profile keeps in float32.
FP32_GROUPS = ("arm", "odm", "l2norm0", "l2norm1")


def _w(cfg) -> Callable[[int], int]:
    mult = float(cfg.get("width_mult", 1.0))
    return lambda c: max(8, int(c * mult))


def anchors_per_cell(cfg) -> List[int]:
    return [1 + 2 * len(ars) for ars in cfg["aspect_ratios"]]


def source_channels(cfg) -> Tuple[int, ...]:
    w = _w(cfg)
    if cfg["backbone"] == "vgg16":
        return (w(512), w(512), w(1024), w(512))
    return (4 * w(128), 4 * w(256), 4 * w(512), w(512))


def param_spec(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in a fixed order. kind is
    ``kernel`` (conv or deconv weight), ``bias``, ``bn_scale`` (a ResNet
    norm's scale, 1 as built), ``bn3_scale`` (a bottleneck's last norm) or
    ``l2norm`` (10 on conv4_3, 8 on conv5_3, as built)."""
    w = _w(cfg)
    spec: List[Tuple[str, tuple, str]] = []

    def conv(name, cout, cin, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "kernel"))
        spec.append((f"{name}.bias", (cout,), "bias"))

    def norm(name, c, last=False):
        spec.append((f"{name}.scale", (c,), "bn3_scale" if last else "bn_scale"))
        spec.append((f"{name}.bias", (c,), "bias"))

    if cfg["backbone"] == "vgg16":
        cin = 3
        for si, (n, ch) in enumerate(VGG_STAGES):
            for ci in range(n):
                conv(f"backbone.conv{si + 1}_{ci + 1}", w(ch), cin, 3)
                cin = w(ch)
        conv("backbone.conv6", w(1024), cin, 3)
        conv("backbone.conv7", w(1024), w(1024), 1)
        conv("backbone.conv6_1", w(256), w(1024), 1)
        conv("backbone.conv6_2", w(512), w(256), 3)
    elif cfg["backbone"] == "resnet101":
        conv("backbone.stem", w(64), 3, 7)
        norm("backbone.stem_bn", w(64))
        cin = w(64)
        for si, (n, f) in enumerate(zip(RESNET101, (w(64), w(128), w(256), w(512)))):
            for bi in range(n):
                blk = f"backbone.stage{si + 1}_{bi}"
                conv(f"{blk}.conv1", f, cin, 1)
                norm(f"{blk}.bn1", f)
                conv(f"{blk}.conv2", f, f, 3)
                norm(f"{blk}.bn2", f)
                conv(f"{blk}.conv3", 4 * f, f, 1)
                norm(f"{blk}.bn3", 4 * f, last=True)
                if bi == 0:
                    conv(f"{blk}.proj", 4 * f, cin, 1)
                    norm(f"{blk}.proj_bn", 4 * f)
                cin = 4 * f
        conv("backbone.extra1", w(256), cin, 1)
        conv("backbone.extra2", w(512), w(256), 3)
    else:
        raise ValueError(f"unknown backbone {cfg['backbone']!r}")

    src = source_channels(cfg)
    spec.append(("l2norm0.scale", (src[0],), "l2norm"))
    spec.append(("l2norm1.scale", (src[1],), "l2norm"))
    apc = anchors_per_cell(cfg)
    for k, (a, c) in enumerate(zip(apc, src)):
        conv(f"arm.loc{k}", a * 4, c, 3)
        conv(f"arm.conf{k}", a * 2, c, 3)
    ch = int(cfg["tcb_channels"])
    for k, c in enumerate(src):
        conv(f"tcb.tcb{k}.conv1", ch, c, 3)
        conv(f"tcb.tcb{k}.conv2", ch, ch, 3)
        conv(f"tcb.tcb{k}.conv3", ch, ch, 3)
        if k < len(src) - 1:  # ConvTranspose2d weight: (in, out, kh, kw)
            spec.append((f"tcb.tcb{k}.deconv.weight", (ch, ch, 2, 2), "kernel"))
            spec.append((f"tcb.tcb{k}.deconv.bias", (ch,), "bias"))
    if cfg["temporal_cell"] != "convgru":
        raise ValueError("the reference has the ConvGRU cell only")
    for k in range(len(src)):
        conv(f"temporal.gru{k}.gates", 2 * ch, 2 * ch, 3)
        conv(f"temporal.gru{k}.cand", ch, 2 * ch, 3)
    for k, a in enumerate(apc):
        conv(f"odm.loc{k}", a * 4, ch, 3)
        conv(f"odm.conf{k}", a * int(cfg["num_classes"]), ch, 3)
    return spec


# --------------------------------------------------------------------- layers


def _conv(p: Params, name: str, x: Tensor, stride: int = 1, dilation: int = 1,
          lowp: LowP = None) -> Tensor:
    w = p[f"{name}.weight"].float()
    b = p[f"{name}.bias"].float()
    if lowp is None:
        return F.conv2d(x, w, b, stride, dilation * (w.shape[-1] - 1) // 2, dilation)
    return lowp(F.conv2d(lowp(x), lowp(w), b, stride, dilation * (w.shape[-1] - 1) // 2,
                         dilation))


def _deconv(p: Params, name: str, x: Tensor, lowp: LowP = None) -> Tensor:
    w = p[f"{name}.weight"].float()
    if lowp is None:
        return F.conv_transpose2d(x, w, p[f"{name}.bias"].float(), stride=2)
    return lowp(F.conv_transpose2d(lowp(x), lowp(w), p[f"{name}.bias"].float(), stride=2))


def _same(x: Tensor) -> Tensor:
    return x


def _affine(p: Params, name: str, x: Tensor, lowp: LowP = None) -> Tensor:
    q = lowp or _same
    return q(x * p[f"{name}.scale"].float()[:, None, None] + p[f"{name}.bias"].float()[:, None, None])


def vgg16(p: Params, x: Tensor, lowp: LowP = None) -> List[Tensor]:
    """(B, 3, H, W) -> conv4_3, conv5_3, conv7, conv6_2 (VGG-16, reduced fc)."""
    sources = []
    for si, (n, _) in enumerate(VGG_STAGES):
        if si == 4:
            x = F.max_pool2d(x, 2, 2)  # pool4
        for ci in range(n):
            x = F.relu(_conv(p, f"backbone.conv{si + 1}_{ci + 1}", x, lowp=lowp))
        if si < 3:
            x = F.max_pool2d(x, 2, 2)
        elif si >= 3:
            sources.append(x)
    x = F.max_pool2d(x, 2, 2)  # pool5
    x = F.relu(_conv(p, "backbone.conv6", x, dilation=3, lowp=lowp))
    x = F.relu(_conv(p, "backbone.conv7", x, lowp=lowp))
    sources.append(x)
    x = F.relu(_conv(p, "backbone.conv6_1", x, lowp=lowp))
    sources.append(F.relu(_conv(p, "backbone.conv6_2", x, stride=2, lowp=lowp)))
    return sources


def resnet101(p: Params, x: Tensor, lowp: LowP = None) -> List[Tensor]:
    """(B, 3, H, W) -> C3, C4, C5 and the extra stage (ResNet-101, frozen norms)."""
    q = lowp or _same
    x = F.relu(_affine(p, "backbone.stem_bn", _conv(p, "backbone.stem", x, stride=2, lowp=lowp),
                       lowp))
    x = F.max_pool2d(x, 3, 2, padding=1)
    sources = []
    for si, n in enumerate(RESNET101):
        for bi in range(n):
            blk = f"backbone.stage{si + 1}_{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            if bi == 0:
                short = _affine(p, f"{blk}.proj_bn", _conv(p, f"{blk}.proj", x, stride, lowp=lowp),
                                lowp)
            else:
                short = x
            y = F.relu(_affine(p, f"{blk}.bn1", _conv(p, f"{blk}.conv1", x, lowp=lowp), lowp))
            y = F.relu(_affine(p, f"{blk}.bn2", _conv(p, f"{blk}.conv2", y, stride, lowp=lowp),
                               lowp))
            y = _affine(p, f"{blk}.bn3", _conv(p, f"{blk}.conv3", y, lowp=lowp), lowp)
            x = F.relu(q(y + short))
        if si >= 1:
            sources.append(x)
    x = F.relu(_conv(p, "backbone.extra1", x, lowp=lowp))
    sources.append(F.relu(_conv(p, "backbone.extra2", x, stride=2, lowp=lowp)))
    return sources


def l2norm(p: Params, name: str, x: Tensor) -> Tensor:
    norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
    return x / norm * p[f"{name}.scale"].float()[None, :, None, None]


def head(p: Params, name: str, feats: List[Tensor], outputs: int) -> Tuple[Tensor, Tensor]:
    locs, confs = [], []
    for k, x in enumerate(feats):
        b = x.shape[0]
        locs.append(_conv(p, f"{name}.loc{k}", x).permute(0, 2, 3, 1).reshape(b, -1, 4))
        confs.append(_conv(p, f"{name}.conf{k}", x).permute(0, 2, 3, 1).reshape(b, -1, outputs))
    return torch.cat(locs, 1), torch.cat(confs, 1)


def tcb(p: Params, sources: List[Tensor], lowp: LowP = None) -> List[Tensor]:
    q = lowp or _same
    outs: List[Tensor] = [None] * len(sources)  # type: ignore[list-item]
    deeper = None
    for k in reversed(range(len(sources))):
        name = f"tcb.tcb{k}"
        x = _conv(p, f"{name}.conv2", F.relu(_conv(p, f"{name}.conv1", sources[k], lowp=lowp)),
                  lowp=lowp)
        if deeper is not None:
            x = q(x + _deconv(p, f"{name}.deconv", deeper, lowp=lowp))
        deeper = F.relu(_conv(p, f"{name}.conv3", F.relu(x), lowp=lowp))
        outs[k] = deeper
    return outs


def bilinear_shift(feat: Tensor, dy: Tensor, dx: Tensor) -> Tensor:
    """Sample feat (B, C, H, W) at each cell shifted by (dy, dx) cells,
    border-clamped, bilinearly."""
    b, c, h, w = feat.shape
    ys = (torch.arange(h, dtype=feat.dtype, device=feat.device)[None, :, None] + dy).clamp(0, h - 1)
    xs = (torch.arange(w, dtype=feat.dtype, device=feat.device)[None, None, :] + dx).clamp(0, w - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, None], (xs - x0)[:, None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    flat = feat.reshape(b, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = at(y0, x0) + (at(y0, x1) - at(y0, x0)) * wx
    bot = at(y1, x0) + (at(y1, x1) - at(y1, x0)) * wx
    return top + (bot - top) * wy


def arm_guided_sampling(cfg, feats: List[Tensor], arm_loc: Tensor) -> List[Tensor]:
    """Shift each TCB map by its cells' mean ARM centre offset, in cells."""
    outs, start = [], 0
    for k, feat in enumerate(feats):
        f, a = cfg["feature_maps"][k], anchors_per_cell(cfg)[k]
        loc = arm_loc[:, start:start + f * f * a].reshape(-1, f, f, a, 4)
        shift = loc[..., :2].mean(dim=3) * cfg["variance"][0] * (cfg["min_sizes"][k] / cfg["steps"][k])
        outs.append(bilinear_shift(feat, shift[..., 1], shift[..., 0]))
        start += f * f * a
    return outs


def convgru(p: Params, name: str, x: Tensor, h: Tensor, lowp: LowP = None) -> Tensor:
    q = lowp or _same
    c = x.shape[1]
    gates = q(torch.sigmoid(_conv(p, f"{name}.gates", torch.cat([x, h], 1), lowp=lowp)))
    z, r = gates[:, :c], gates[:, c:]
    cand = q(torch.tanh(_conv(p, f"{name}.cand", torch.cat([x, q(r * h)], 1), lowp=lowp)))
    return q((1.0 - z) * h + z * cand)


def zero_state(cfg, batch: int, device) -> List[Tensor]:
    ch = int(cfg["tcb_channels"])
    return [torch.zeros((batch, ch, f, f), device=device) for f in cfg["feature_maps"]]


def preprocess(cfg, frames_u8: Tensor) -> Tensor:
    """uint8 (B, H, W, 3) RGB at the model's size -> float32 NCHW minus the pixel means."""
    if tuple(frames_u8.shape[1:3]) != (cfg["size"], cfg["size"]):
        raise ValueError("the reference takes frames at the model's size")
    mean = torch.tensor(cfg["pixel_means"], dtype=torch.float32, device=frames_u8.device)
    return (frames_u8.float() - mean).permute(0, 3, 1, 2)


def forward(cfg, p: Params, x: Tensor, state: List[Tensor], lowp: LowP = None):
    """x: preprocessed (B, 3, H, W); state: per-scale (B, C, f, f).
    Returns ((arm_loc, arm_conf, odm_loc, odm_conf), new_state)."""
    q = lowp or _same
    backbone = vgg16 if cfg["backbone"] == "vgg16" else resnet101
    sources = backbone(p, x, lowp)
    sources[0] = q(l2norm(p, "l2norm0", sources[0]))
    sources[1] = q(l2norm(p, "l2norm1", sources[1]))
    arm_loc, arm_conf = head(p, "arm", sources, 2)
    feats = [q(f) for f in arm_guided_sampling(cfg, tcb(p, sources, lowp), arm_loc)]
    new_state = [convgru(p, f"temporal.gru{k}", f, h, lowp) for k, (f, h) in
                 enumerate(zip(feats, state))]
    odm_loc, odm_conf = head(p, "odm", new_state, int(cfg["num_classes"]))
    return (arm_loc, arm_conf, odm_loc, odm_conf), new_state
