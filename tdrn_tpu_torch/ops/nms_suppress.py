"""K2 wrapper: greedy NMS suppression of score-sorted candidates, and its plain version.

Port of ``tdrn_tpu/ops/nms_pallas.py::suppress_sorted``. A CUDA tensor goes to
the hand-written kernel (csrc/nms_suppress.cu), a CPU tensor to
:func:`suppress_plain`. Both return the same keep mask, bit for bit.
"""

from __future__ import annotations

import torch

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.ops import boxes as B

Tensor = torch.Tensor

MAX_K = 1024  # the kernel keeps a row's K x K bitmask in one block's shared memory


def suppress_plain(boxes: Tensor, scores: Tensor, iou_thresh: float) -> Tensor:
    """Jacobi fixpoint of greedy NMS (``tdrn_tpu/ops/nms.py``): iterate
    ``keep <- init & ~(keep @ S)`` with S[i, j] = "i outranks j and their IoU
    is above the threshold" until it stops changing. Exact on 0/1 values; any
    fixpoint equals the sequential greedy sweep."""
    k = scores.shape[-1]
    ranks = torch.arange(k, device=scores.device)
    sup = (B.iou(boxes, boxes) > iou_thresh) & (ranks[:, None] < ranks[None, :])
    sup = sup.to(torch.float32)
    init = scores > 0.0
    keep = init
    while True:
        suppressed = (keep.to(torch.float32).unsqueeze(-2) @ sup).squeeze(-2) > 0.5
        new = init & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return torch.where(keep, scores, torch.zeros((), device=scores.device))


def suppress_sorted(boxes: Tensor, scores: Tensor, iou_thresh: float = 0.45) -> Tensor:
    """Greedy-suppress score-sorted candidates.

    boxes: (N, K, 4) xyxy, each row sorted by descending score; scores: (N, K)
    with 0 marking empty slots. Returns (N, K) scores with suppressed entries
    zeroed.
    """
    n, k = scores.shape[0], scores.shape[-1]
    _build.require(boxes, "boxes", (n, k, 4))
    _build.require(scores, "scores", (n, k))
    if _build.route(boxes, scores) == "cpu":
        return suppress_plain(boxes, scores, iou_thresh)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the NMS kernel takes 1 <= K <= {MAX_K} candidates, got {k}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    out = torch.empty_like(scores)
    if n == 0:
        return out
    with torch.cuda.device(scores.device):
        err = _build.entry("nms_suppress")(
            boxes.data_ptr(), scores.data_ptr(), out.data_ptr(), n, k,
            float(iou_thresh), _build.stream_of(scores),
        )
    _build.check("nms_suppress", err)
    suppress_sorted.launches += 1
    return out


suppress_sorted.launches = 0
