"""Box geometry primitives (the port of ``tdrn_tpu/ops/boxes.py``).

Conventions: ``xyxy`` corner form [x1, y1, x2, y2] and ``cxcywh`` center form,
normalized to [0, 1]; encode and decode use the SSD variances (0.1, 0.2). The IoU here
is the exact operation sequence the NMS kernel (csrc/nms_suppress.cu)
repeats, so its keep mask is bit-equal to the plain version.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def point_form(boxes: Tensor) -> Tensor:
    """cxcywh -> xyxy."""
    cxy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)


def center_size(boxes: Tensor) -> Tensor:
    """xyxy -> cxcywh."""
    tl, br = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(tl + br) / 2, br - tl], dim=-1)


def intersect(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise intersection area. a: (..., N, 4) xyxy, b: (..., M, 4) -> (..., N, M)."""
    max_xy = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    min_xy = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    inter = (max_xy - min_xy).clamp(min=0.0)
    return inter[..., 0] * inter[..., 1]


def area(boxes: Tensor) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0) * (
        boxes[..., 3] - boxes[..., 1]
    ).clamp(min=0.0)


def iou(a: Tensor, b: Tensor, eps: float = 0.0) -> Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) -> (..., N, M); union floored at 1e-12."""
    inter = intersect(a, b)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps if eps > 0 else 1e-12)


def encode(matched: Tensor, priors: Tensor, variances=(0.1, 0.2)) -> Tensor:
    """Encode (..., P, 4) xyxy ground-truth boxes matched to (..., P, 4)
    cxcywh priors -> (..., P, 4) regression targets [dcx, dcy, dw, dh]."""
    g = center_size(matched)
    g_cxy = (g[..., :2] - priors[..., :2]) / (variances[0] * priors[..., 2:])
    g_wh = torch.log(torch.clamp(g[..., 2:] / priors[..., 2:], min=1e-12)) / variances[1]
    return torch.cat([g_cxy, g_wh], dim=-1)


def decode(loc: Tensor, priors: Tensor, variances=(0.1, 0.2)) -> Tensor:
    """Decode (..., P, 4) offsets against (..., P, 4) cxcywh priors -> xyxy boxes."""
    cxy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
