"""Dual-refinement multibox loss (the port of ``tdrn_tpu/train/loss.py``).

  * ARM branch: binary objectness targets from matching GT to the static
    priors; SmoothL1 on positives; cross-entropy with 3:1 sort-based
    hard-negative mining.
  * ODM branch: anchors are first refined by the ARM regression (detached),
    GT is re-matched against the refined anchors, and anchors whose ARM
    background score (detached) exceeds ``arm_filter_thresh`` are left out
    of the ODM loss entirely (negative-anchor filtering).

Matching and mining are fixed-shape tensor operations over the whole batch,
so the loss runs on the device with no loop over images. Losses are
normalized by the positive count over the batch. ``count_reduce`` turns a
rank's count into the count of the global batch (an all_reduce, in the
data-parallel step of train/trainer.py) before the clamp to 1, as the JAX
package's single program counts over the whole sharded batch.

Mining picks the JAX package's anchors: a stable descending sort of the
background CE (``torch.argsort(stable=True)``, as ``jnp.argsort`` is stable),
ranks from its inverse permutation, and ``ranks < num_neg`` compared as
floats. ``torch.topk`` orders ties otherwise and is not used.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.ops import boxes as B
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.matching import match_batch

Tensor = torch.Tensor
CountReduce = Optional[Callable[[Tensor], Tensor]]


class Targets(NamedTuple):
    """Padded per-image ground truth (fixed shapes)."""

    boxes: Tensor  # (B, G, 4) xyxy in [0, 1]
    labels: Tensor  # (B, G) int 0-based class ids
    valid: Tensor  # (B, G) bool


def smooth_l1(x: Tensor) -> Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-element CE; logits (..., C), labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def _positives(pos: Tensor, count_reduce: CountReduce) -> Tensor:
    """max(number of positives, 1) as float32, the count reduced first."""
    n = pos.sum()
    if count_reduce is not None:
        n = count_reduce(n)
    return torch.clamp(n, min=1).float()


def _mine_negatives(ce_bg: Tensor, pos: Tensor, eligible: Tensor,
                    neg_pos_ratio: float) -> Tensor:
    """Sort-based hard-negative mining per image.

    ce_bg: (B, P) background-CE ranking metric.
    pos: (B, P) positive mask. eligible: (B, P) anchors allowed as negatives.
    Returns the (B, P) negative mask, ~ratio * num_pos entries per image.
    """
    with torch.profiler.record_function("tdrn::mine"):
        return _mine(ce_bg, pos, eligible, neg_pos_ratio)


def _mine(ce_bg: Tensor, pos: Tensor, eligible: Tensor, neg_pos_ratio: float) -> Tensor:
    p = ce_bg.shape[-1]
    num_pos = pos.sum(dim=-1)  # (B,)
    num_neg = torch.clamp(neg_pos_ratio * num_pos, 0, p - 1).float()  # (B,)
    candidate = eligible & ~pos
    metric = torch.where(candidate, ce_bg.detach(), -torch.inf)
    # Each anchor's rank in the descending metric order (ties: lowest index first).
    order = torch.argsort(-metric, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(p, device=order.device).expand_as(order))
    return candidate & (ranks < num_neg[..., None])


def multibox_loss(
    loc_pred: Tensor,
    conf_pred: Tensor,
    priors: Tensor,
    targets: Targets,
    cfg: DetectorConfig,
    neg_pos_ratio: float = 3.0,
    overlap_thresh: float = 0.5,
    count_reduce: CountReduce = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Single-stage MultiBox loss for the plain SSD model: match, SmoothL1 on
    positives and CE with 3:1 sort-based hard-negative mining, normalized by
    the batch's positive count (``count_reduce`` of it)."""
    m = match_batch(targets.boxes, targets.labels, targets.valid, priors,
                    overlap_thresh, cfg.variance)
    pos = m.conf_targets > 0
    n = _positives(pos, count_reduce)
    loc_l = torch.where(pos[..., None], smooth_l1(loc_pred - m.loc_targets), 0.0).sum()
    ce = _cross_entropy(conf_pred, m.conf_targets)
    bg_ce = _cross_entropy(conf_pred, torch.zeros_like(m.conf_targets))
    neg = _mine_negatives(bg_ce, pos, torch.ones_like(pos), neg_pos_ratio)
    conf_l = torch.where(pos | neg, ce, 0.0).sum()
    metrics = {"loc": loc_l / n, "conf": conf_l / n, "num_pos": n}
    return metrics["loc"] + metrics["conf"], metrics


def refine_multibox_loss(
    preds: RawPredictions,
    priors: Tensor,
    targets: Targets,
    cfg: DetectorConfig,
    neg_pos_ratio: float = 3.0,
    overlap_thresh: float = 0.5,
    count_reduce: CountReduce = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (total loss, metrics with the arm/odm loc and conf parts and the
    positive counts). ``count_reduce`` maps each positive count to the one
    the losses are divided by (default: the batch's own)."""
    var = cfg.variance

    # ARM: binary objectness against the static priors.
    arm_m = match_batch(targets.boxes, torch.zeros_like(targets.labels), targets.valid,
                        priors, overlap_thresh, var)
    arm_pos = arm_m.conf_targets > 0  # (B, P)
    n_arm = _positives(arm_pos, count_reduce)
    arm_loc_l = torch.where(arm_pos[..., None], smooth_l1(preds.arm_loc - arm_m.loc_targets),
                            0.0).sum()
    arm_ce = _cross_entropy(preds.arm_conf, arm_pos.to(torch.int32))
    arm_bg_ce = _cross_entropy(preds.arm_conf, torch.zeros_like(arm_m.conf_targets))
    arm_neg = _mine_negatives(arm_bg_ce, arm_pos, torch.ones_like(arm_pos), neg_pos_ratio)
    arm_conf_l = torch.where(arm_pos | arm_neg, arm_ce, 0.0).sum()

    # ODM: classes against the ARM-refined anchors.
    refined = B.decode(preds.arm_loc.detach(), priors, var)  # (B, P, 4)
    odm_m = match_batch(targets.boxes, targets.labels, targets.valid, B.center_size(refined),
                        overlap_thresh, var)
    # Negative-anchor filtering: ARM-confident background anchors are excluded.
    arm_bg = torch.softmax(preds.arm_conf.detach(), dim=-1)[..., 0]
    keep = arm_bg <= cfg.arm_filter_thresh
    odm_pos = (odm_m.conf_targets > 0) & keep
    n_odm = _positives(odm_pos, count_reduce)
    odm_loc_l = torch.where(odm_pos[..., None], smooth_l1(preds.odm_loc - odm_m.loc_targets),
                            0.0).sum()
    odm_ce = _cross_entropy(preds.odm_conf, odm_m.conf_targets)
    odm_bg_ce = _cross_entropy(preds.odm_conf, torch.zeros_like(odm_m.conf_targets))
    odm_neg = _mine_negatives(odm_bg_ce, odm_pos, keep, neg_pos_ratio)
    odm_conf_l = torch.where(odm_pos | odm_neg, odm_ce, 0.0).sum()

    metrics = {
        "arm_loc": arm_loc_l / n_arm,
        "arm_conf": arm_conf_l / n_arm,
        "odm_loc": odm_loc_l / n_odm,
        "odm_conf": odm_conf_l / n_odm,
        "num_pos_arm": n_arm,
        "num_pos_odm": n_odm,
    }
    total = metrics["arm_loc"] + metrics["arm_conf"] + metrics["odm_loc"] + metrics["odm_conf"]
    return total, metrics
