"""K1 wrapper: the fused ARM->ODM refinement cascade, and its plain version.

Port of ``tdrn_tpu/ops/cascade_pallas.py::fused_refine_cascade``. A CUDA
tensor goes to the hand-written kernel (csrc/cascade.cu), a CPU tensor to
:func:`cascade_plain`, which repeats the kernel's formula in tensor ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdrn_tpu_torch import _build

Tensor = torch.Tensor


def cascade_plain(
    arm_loc: Tensor, arm_conf: Tensor, odm_loc: Tensor, odm_conf: Tensor,
    priors: Tensor, v0: float, v1: float, arm_thresh: float,
) -> Tuple[Tensor, Tensor]:
    """The kernel's formula: refined anchor in center form, max-subtracted
    softmax, ARM filter ``bg <= thresh`` and class 0 zeroed.

    Returns (boxes (B, P, 4) xyxy, scores_cm (B, C, P))."""
    pcx, pcy, pw, ph = priors.unbind(-1)
    acx = pcx + arm_loc[..., 0] * v0 * pw
    acy = pcy + arm_loc[..., 1] * v0 * ph
    aw = pw * torch.exp(arm_loc[..., 2] * v1)
    ah = ph * torch.exp(arm_loc[..., 3] * v1)
    cx = acx + odm_loc[..., 0] * v0 * aw
    cy = acy + odm_loc[..., 1] * v0 * ah
    w = aw * torch.exp(odm_loc[..., 2] * v1)
    h = ah * torch.exp(odm_loc[..., 3] * v1)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)

    e = torch.exp(odm_conf - odm_conf.amax(dim=-1, keepdim=True))
    sm = e / e.sum(dim=-1, keepdim=True)
    mb = torch.maximum(arm_conf[..., 0], arm_conf[..., 1])
    e0 = torch.exp(arm_conf[..., 0] - mb)
    e1 = torch.exp(arm_conf[..., 1] - mb)
    bg = e0 / (e0 + e1)
    c = odm_conf.shape[-1]
    keep = (bg <= arm_thresh)[..., None] & (
        torch.arange(c, device=odm_conf.device) > 0
    )
    scores = torch.where(keep, sm, torch.zeros((), device=sm.device))
    return boxes, scores.transpose(1, 2).contiguous()


def fused_refine_cascade(
    preds, priors: Tensor, cfg, per_anchor: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """preds: RawPredictions (B, P, .) float32; priors (P, 4) center form.

    Returns (boxes (B, P, 4) xyxy, scores_cm (B, C, P)): softmax scores,
    ARM-filtered, background row zeroed, CLASS-MAJOR for the per-class NMS.
    per_anchor, a (B, P) float32 buffer, receives each anchor's max over its
    C scores, the prefilter's score: ``scores_cm.amax(dim=1)`` bit for bit,
    which the kernel takes as it stores the scores.
    """
    b, p, _ = preds.arm_loc.shape
    c = preds.odm_conf.shape[-1]
    _build.require(preds.arm_loc, "arm_loc", (b, p, 4))
    _build.require(preds.arm_conf, "arm_conf", (b, p, 2))
    _build.require(preds.odm_loc, "odm_loc", (b, p, 4))
    _build.require(preds.odm_conf, "odm_conf", (b, p, c))
    _build.require(priors, "priors", (p, 4))
    outs = ()
    if per_anchor is not None:
        _build.require(per_anchor, "per_anchor", (b, p))
        outs = (per_anchor,)
    v0, v1 = float(cfg.variance[0]), float(cfg.variance[1])
    thresh = float(cfg.arm_filter_thresh)
    args = (preds.arm_loc, preds.arm_conf, preds.odm_loc, preds.odm_conf, priors)
    if _build.route(*args, *outs) == "cpu":
        boxes, scores_cm = cascade_plain(*args, v0, v1, thresh)
        if per_anchor is not None:
            torch.amax(scores_cm, dim=1, out=per_anchor)
        return boxes, scores_cm
    # The kernel reads boxes and priors as float4.
    if any(t.data_ptr() % 16 for t in (preds.arm_loc, preds.odm_loc, priors)):
        raise ValueError("arm_loc, odm_loc and priors must be 16-byte aligned")
    boxes = torch.empty((b, p, 4), dtype=torch.float32, device=priors.device)
    scores_cm = torch.empty((b, c, p), dtype=torch.float32, device=priors.device)
    with torch.cuda.device(priors.device):
        err = _build.entry("cascade")(
            *(t.data_ptr() for t in args), boxes.data_ptr(), scores_cm.data_ptr(),
            None if per_anchor is None else per_anchor.data_ptr(),
            b, p, c, v0, v1, thresh, _build.stream_of(priors),
        )
    _build.check("cascade", err)
    fused_refine_cascade.launches += 1
    return boxes, scores_cm


fused_refine_cascade.launches = 0
