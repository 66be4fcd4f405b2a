"""Target assignment for training (the port of ``tdrn_tpu/ops/matching.py``).

Matching is a fixed-shape function over *padded* ground truth (``max_gt``
boxes and a validity mask), batched over any leading axes by broadcasting,
so a batch of images is matched in one set of tensor operations, on the
device, with no loop over images.

The semantics are the JAX package's:
  * invalid GT rows are set to -1 before any argmax, so they never win;
  * each GT's best prior is force-assigned to it with overlap 2.0; where GTs
    share a best prior the later one wins (the max of ``claims * gt_rank``,
    no scatter);
  * every other prior takes its best GT (argmax, first index on ties) and is
    background below the IoU threshold;
  * labels are 0-based object classes and the conf target is the label + 1
    (0 = background); loc targets are zero on background priors.

Against ARM-refined anchors (the ODM's ``refine_match``), pass the decoded
ARM boxes in center form as ``priors``, one set per image.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tdrn_tpu_torch.ops import boxes as B
from tdrn_tpu_torch.utils.logging import span

Tensor = torch.Tensor


class MatchResult(NamedTuple):
    loc_targets: Tensor  # (..., P, 4) encoded regression targets
    conf_targets: Tensor  # (..., P) int32; 0 = background, c+1 = object class c
    matched_ious: Tensor  # (..., P) best IoU per prior (2.0 where force-assigned)


def match(
    truths: Tensor,
    labels: Tensor,
    valid: Tensor,
    priors_cxcywh: Tensor,
    threshold: float = 0.5,
    variances: Tuple[float, float] = (0.1, 0.2),
) -> MatchResult:
    """Assign padded GT boxes to priors.

    truths: (..., G, 4) xyxy in [0, 1], zero-padded rows allowed.
    labels: (..., G) int 0-based class ids (padding rows arbitrary).
    valid:  (..., G) bool mask of real GT rows.
    priors_cxcywh: (P, 4), or (..., P, 4) with the GT's leading axes.
    """
    g = truths.shape[-2]
    p = priors_cxcywh.shape[-2]
    dev = truths.device
    overlaps = B.iou(truths, B.point_form(priors_cxcywh))  # (..., G, P)
    overlaps = torch.where(valid[..., None], overlaps, -1.0)

    best_prior_idx = overlaps.argmax(dim=-1)  # (..., G)
    best_truth_overlap = overlaps.amax(dim=-2)  # (..., P)
    best_truth_idx = overlaps.argmax(dim=-2)  # (..., P)

    # Last-wins force-assignment: for each prior, the largest valid GT index
    # (1-based, so 0 = unclaimed) whose best prior it is.
    claims = valid[..., None] & (best_prior_idx[..., None] == torch.arange(p, device=dev))
    gt_rank = torch.arange(1, g + 1, device=dev)[:, None]
    last_claim = (claims * gt_rank).amax(dim=-2)  # (..., P)
    forced = last_claim > 0
    best_truth_idx = torch.where(forced, last_claim - 1, best_truth_idx)
    best_truth_overlap = torch.where(forced, 2.0, best_truth_overlap)

    matched = torch.gather(
        truths, -2, best_truth_idx[..., None].expand(*best_truth_idx.shape, 4))
    conf = torch.gather(labels, -1, best_truth_idx).to(torch.int32) + 1
    conf = torch.where(best_truth_overlap < threshold, 0, conf)
    loc = B.encode(matched, priors_cxcywh, variances)
    # Background priors get zero loc targets (masked in the loss anyway, but
    # finite where padding rows are degenerate).
    loc = torch.where((conf > 0)[..., None], loc, 0.0)
    return MatchResult(loc, conf, best_truth_overlap)


def match_batch(
    truths: Tensor,
    labels: Tensor,
    valid: Tensor,
    priors_cxcywh: Tensor,
    threshold: float = 0.5,
    variances: Tuple[float, float] = (0.1, 0.2),
) -> MatchResult:
    """:func:`match` over a leading batch axis of the GT tensors (B, G, ...);
    priors are (P, 4) (shared) or (B, P, 4) (per-image refined anchors)."""
    if priors_cxcywh.dim() not in (2, 3):
        raise ValueError(f"priors must be (P, 4) or (B, P, 4), got {tuple(priors_cxcywh.shape)}")
    with span("tdrn::match"):
        return match(truths, labels, valid, priors_cxcywh, threshold, variances)
