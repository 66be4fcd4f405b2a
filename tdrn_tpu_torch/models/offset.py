"""ARM-guided feature re-sampling (the port of ``tdrn_tpu/models/offset.py``), NCHW.

Per scale, the ARM's predicted center shift, averaged over a cell's anchors
and converted to feature-map cells, re-samples the TCB map bilinearly at the
shifted position of each cell (border-clamped).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Tensor = torch.Tensor


def bilinear_shift(feat: Tensor, dy: Tensor, dx: Tensor) -> Tensor:
    """Re-sample feat (B, C, H, W) at per-cell offsets dy, dx (B, H, W) in cell units."""
    b, c, h, w = feat.shape
    ys = torch.arange(h, dtype=feat.dtype, device=feat.device)[None, :, None] + dy
    xs = torch.arange(w, dtype=feat.dtype, device=feat.device)[None, None, :] + dx
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]  # (B, 1, H, W)
    wx = (xs - x0)[:, None]
    y0 = y0.long()
    x0 = x0.long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    flat = feat.reshape(b, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    f00, f01 = gather(y0, x0), gather(y0, x1)
    f10, f11 = gather(y1, x0), gather(y1, x1)
    top = f00 + (f01 - f00) * wx
    bot = f10 + (f11 - f10) * wx
    return top + (bot - top) * wy


def arm_guided_offsets(
    arm_loc_scale: Tensor, feature_map: int, anchors_per_cell: int,
    variance0: float, size_ratio: float,
) -> Tuple[Tensor, Tensor]:
    """(B, H*W*A, 4) ARM loc slice of one scale -> per-cell (dy, dx) in cell units:
    mean(loc_xy over the cell's anchors) * var0 * (min_size / step)."""
    b = arm_loc_scale.shape[0]
    loc = arm_loc_scale.reshape(b, feature_map, feature_map, anchors_per_cell, 4)
    cell_shift = loc[..., :2].mean(dim=3) * variance0 * size_ratio  # (B, H, W, 2)
    return cell_shift[..., 1], cell_shift[..., 0]


def apply_arm_guided_sampling(feats: List[Tensor], arm_loc: Tensor, cfg) -> List[Tensor]:
    """Shift each TCB scale by its ARM-predicted offsets."""
    outs = []
    start = 0
    for k, feat in enumerate(feats):
        f, a = cfg.feature_maps[k], cfg.anchors_per_cell[k]
        n = f * f * a
        ratio = cfg.min_sizes[k] / cfg.steps[k]
        dy, dx = arm_guided_offsets(arm_loc[:, start:start + n], f, a, cfg.variance[0], ratio)
        outs.append(bilinear_shift(feat, dy.to(feat.dtype), dx.to(feat.dtype)))
        start += n
    return outs
