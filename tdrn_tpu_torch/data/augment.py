"""SSD training augmentation (the port of ``tdrn_tpu/data/augment.py``).

Photometric distortion (brightness/contrast/saturation/hue + channel swap),
expand onto a mean-filled canvas (<= 4x), IoU-constrained random crop,
horizontal mirror, resize and mean subtraction, as host-side numpy
transforms; the port's copy computes bit for bit what the JAX package's
does on the same ``np.random.Generator``.

The pipeline is split into **sample** (draw every random parameter) and
**apply** (deterministic given an ``AugmentParams``) stages:

  * VID clip training augments all ``seq_len`` frames of a clip with the
    SAME draw, so the temporal module trains on spatially coherent
    sequences (``data/vid.py``);
  * randomness flows through an explicit ``np.random.Generator`` argument, so
    concurrent loader workers each use their own per-sample generator (seeded
    from (seed, salt, index)) instead of racing on one shared bit generator.

The HSV conversion, the expand canvas and the float32 resize call OpenCV
(``cv2``), imported inside those functions: training needs ``cv2``, while
serving and evaluation, which never import this module's transforms, do not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

Array = np.ndarray

# IoU-constraint choices for the random crop (reference's sample options):
# each entry is (min_iou); None = no crop; "any" = unconstrained crop.
_CROP_MODES = (None, 0.1, 0.3, 0.7, 0.9, "any")


# ---------------------------------------------------------------------------
# Photometric distortion
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhotoParams:
    """One draw of the photometric-distortion randomness."""

    brightness: Optional[float]  # additive delta, or None
    contrast: Optional[float]  # multiplicative factor, or None
    contrast_first: bool  # reference randomizes contrast-vs-HSV order
    saturation: Optional[float]
    hue: Optional[float]  # degrees in [-18, 18] (OpenCV H range 0..180)
    perm: Optional[Tuple[int, int, int]]  # channel shuffle


def sample_photo(rng: np.random.Generator) -> PhotoParams:
    return PhotoParams(
        brightness=float(rng.uniform(-32, 32)) if rng.random() < 0.5 else None,
        contrast_first=bool(rng.random() < 0.5),
        contrast=float(rng.uniform(0.5, 1.5)) if rng.random() < 0.5 else None,
        saturation=float(rng.uniform(0.5, 1.5)) if rng.random() < 0.5 else None,
        hue=float(rng.uniform(-18, 18)) if rng.random() < 0.5 else None,
        perm=tuple(int(i) for i in rng.permutation(3)) if rng.random() < 0.5 else None,
    )


def apply_photo(img: Array, p: PhotoParams, inplace: bool = False) -> Array:
    """Deterministic photometric distortion. img: float32 RGB HWC.

    The saturation/hue ops run as uint8 LUT gathers on the HSV channels —
    bitwise-identical to the float formulation (every u8 value maps through
    the same ``float op -> truncating u8 cast``; tested), but without the two
    full-image fp32<->u8 round trips. ``inplace=True`` lets a caller that owns
    ``img`` skip the defensive copy.
    """
    img = img if inplace else img.copy()
    if p.brightness is not None:
        img += p.brightness
    if p.contrast_first and p.contrast is not None:
        img *= p.contrast
    if p.saturation is not None or p.hue is not None:
        import cv2

        hsv = cv2.cvtColor(
            np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
        )
        if p.saturation is not None:
            lut = np.clip(
                np.arange(256, dtype=np.float32) * p.saturation, 0, 255
            ).astype(np.uint8)
            hsv[..., 1] = lut[hsv[..., 1]]
        if p.hue is not None:
            lut = ((np.arange(256, dtype=np.float32) + p.hue) % 180).astype(
                np.uint8
            )
            hsv[..., 0] = lut[hsv[..., 0]]
        img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)
    if not p.contrast_first and p.contrast is not None:
        img *= p.contrast
    if p.perm is not None:
        img = img[..., list(p.perm)]
    return np.clip(img, 0, 255, out=img)


# ---------------------------------------------------------------------------
# Expand (zoom-out onto a mean canvas)
# ---------------------------------------------------------------------------

ExpandParams = Tuple[float, float, float]  # (ratio, left, top) in pixels


def _shift_boxes(boxes: Array, left: float, top: float) -> Array:
    """Translate boxes into expanded-canvas coordinates (shared by the
    sequential and fused expand paths so the semantics live in one place)."""
    boxes = boxes.copy()
    if len(boxes):
        boxes[:, 0::2] += left
        boxes[:, 1::2] += top
    return boxes


def sample_expand(h: int, w: int, rng: np.random.Generator) -> Optional[ExpandParams]:
    if rng.random() < 0.5:
        return None
    ratio = float(rng.uniform(1.0, 4.0))
    left = float(rng.uniform(0, w * ratio - w))
    top = float(rng.uniform(0, h * ratio - h))
    return (ratio, left, top)


def apply_expand(
    img: Array, boxes: Array, p: ExpandParams, mean: Tuple[float, float, float]
) -> Tuple[Array, Array]:
    import cv2

    ratio, left, top = p
    h, w, c = img.shape
    eh, ew = int(h * ratio), int(w * ratio)
    il, it = int(left), int(top)
    # cv2.copyMakeBorder's C fill+copy is ~4x numpy's broadcast fill on the
    # up-to-16x-area canvas (identical values: constant border + paste).
    canvas = cv2.copyMakeBorder(
        img, it, eh - it - h, il, ew - il - w, cv2.BORDER_CONSTANT,
        value=tuple(float(m) for m in mean),
    )
    return canvas, _shift_boxes(boxes, left, top)


def apply_expand_crop(
    img: Array,
    boxes: Array,
    labels: Array,
    ep: ExpandParams,
    rect: Array,
    mean: Tuple[float, float, float],
):
    """Fused expand+crop: materialize ONLY the crop window of the expanded
    canvas. Bitwise-identical to ``apply_crop(*apply_expand(...), rect)``
    (tested) — but the expand ratio is up to 4x per axis, so the full canvas
    is up to 16x the image while the crop keeps ≤ its own window, so the
    full-canvas fill+copy is skipped.
    """
    ratio, left, top = ep
    h, w, c = img.shape
    x1, y1, x2, y2 = int(rect[0]), int(rect[1]), int(rect[2]), int(rect[3])
    out = np.empty((y2 - y1, x2 - x1, c), img.dtype)
    out[...] = mean
    il, it = int(left), int(top)  # image placement on the virtual canvas
    oy1, oy2 = max(it, y1), min(it + h, y2)
    ox1, ox2 = max(il, x1), min(il + w, x2)
    if oy2 > oy1 and ox2 > ox1:
        out[oy1 - y1 : oy2 - y1, ox1 - x1 : ox2 - x1] = img[
            oy1 - it : oy2 - it, ox1 - il : ox2 - il
        ]
    return _crop_boxes(out, _shift_boxes(boxes, left, top), labels, rect)


# ---------------------------------------------------------------------------
# IoU-constrained random crop
# ---------------------------------------------------------------------------


def sample_crop_rect(
    shape: Tuple[int, ...], boxes: Array, rng: np.random.Generator, max_trials: int = 50
) -> Optional[Array]:
    """Draw an IoU-constrained crop rect against ``boxes`` (the clip's
    reference frame in clip mode). None = keep the full image."""
    if len(boxes) == 0:
        return None
    h, w = shape[0], shape[1]
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2  # (N, 2), trial-invariant
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])  # (N,)
    while True:
        mode = _CROP_MODES[rng.integers(len(_CROP_MODES))]
        if mode is None:
            return None
        min_iou = 0.0 if mode == "any" else float(mode)
        # All max_trials candidate rects at once, with the same distributions
        # and first-passing-trial selection as a loop of scalar draws.
        cw = rng.uniform(0.3 * w, w, max_trials)  # (T,)
        ch = rng.uniform(0.3 * h, h, max_trials)
        left = rng.uniform(0, 1, max_trials) * (w - cw)
        top = rng.uniform(0, 1, max_trials) * (h - ch)
        rects = np.stack([left, top, left + cw, top + ch], axis=1)  # (T, 4)
        aspect_ok = (0.5 <= cw / ch) & (cw / ch <= 2.0)
        # IoU of every rect against every box: (T, N).
        ix1 = np.maximum(rects[:, None, 0], boxes[None, :, 0])
        iy1 = np.maximum(rects[:, None, 1], boxes[None, :, 1])
        ix2 = np.minimum(rects[:, None, 2], boxes[None, :, 2])
        iy2 = np.minimum(rects[:, None, 3], boxes[None, :, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        r_area = (cw * ch)[:, None]
        ious = inter / np.maximum(r_area + areas[None] - inter, 1e-12)
        iou_ok = ious.min(axis=1) >= min_iou
        inside = (
            (centers[None, :, 0] > rects[:, None, 0])
            & (centers[None, :, 1] > rects[:, None, 1])
            & (centers[None, :, 0] < rects[:, None, 2])
            & (centers[None, :, 1] < rects[:, None, 3])
        )  # (T, N)
        cx1 = np.maximum(boxes[None, :, 0], rects[:, None, 0])
        cy1 = np.maximum(boxes[None, :, 1], rects[:, None, 1])
        cx2 = np.minimum(boxes[None, :, 2], rects[:, None, 2])
        cy2 = np.minimum(boxes[None, :, 3], rects[:, None, 3])
        nondegen = (cx2 - cx1 >= 2.0) & (cy2 - cy1 >= 2.0)
        # Require at least one surviving (center-inside AND non-degenerate
        # after clipping) box, like apply_crop keeps.
        keep_ok = (inside & nondegen).any(axis=1)
        passing = np.flatnonzero(aspect_ok & iou_ok & keep_ok)
        if len(passing):
            return rects[passing[0]]


def _crop_boxes(new_img: Array, boxes: Array, labels: Array, rect: Array):
    """Box-side crop logic for an already-materialized crop window."""
    if len(boxes) == 0:
        return new_img, boxes, labels
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2
    inside = (
        (centers[:, 0] > rect[0])
        & (centers[:, 1] > rect[1])
        & (centers[:, 0] < rect[2])
        & (centers[:, 1] < rect[3])
    )
    new_boxes = boxes[inside].copy()
    new_boxes[:, :2] = np.maximum(new_boxes[:, :2], rect[:2]) - rect[:2]
    new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], rect[2:]) - rect[:2]
    new_labels = labels[inside]
    # Drop degenerate slivers (clipped to <2px): their encode targets
    # (log of ~0 extents) explode the loc loss.
    ok = ((new_boxes[:, 2] - new_boxes[:, 0]) >= 2.0) & (
        (new_boxes[:, 3] - new_boxes[:, 1]) >= 2.0
    )
    return new_img, new_boxes[ok], new_labels[ok]


def apply_crop(img: Array, boxes: Array, labels: Array, rect: Array):
    """Crop to ``rect``, keeping boxes whose centers fall inside (may keep
    none — a clip's non-reference frames can legitimately lose all boxes)."""
    new_img = img[int(rect[1]) : int(rect[3]), int(rect[0]) : int(rect[2])]
    return _crop_boxes(new_img, boxes, labels, rect)


def apply_mirror(img: Array, boxes: Array):
    _, w, _ = img.shape
    img = img[:, ::-1]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 0::2] = w - boxes[:, 2::-2]
    return img, boxes


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """One complete draw of the SSDAugmentation randomness (per image, or per
    clip when shared across a VID training sequence)."""

    photo: Optional[PhotoParams]
    expand: Optional[ExpandParams]
    crop_rect: Optional[np.ndarray]  # in post-expand pixel coords
    mirror: bool


class SSDAugmentation:
    """Full train-time pipeline (reference ``SSDAugmentation`` semantics).

    __call__(img uint8 RGB HWC, boxes pixel xyxy (N,4), labels (N,), rng=None)
      -> (float32 (size,size,3) mean-subtracted, boxes normalized xyxy, labels)

    ``rng`` defaults to the instance generator for single-threaded use; loader
    workers pass an explicit per-sample generator. ``sample_params``/``apply``
    expose the two stages for clip-consistent VID augmentation.
    """

    def __init__(self, size: int, mean=(123.0, 117.0, 104.0), seed: Optional[int] = None,
                 photometric: bool = True):
        self.size = size
        self.mean = mean
        self.photometric = photometric
        self.rng = np.random.default_rng(seed)

    def sample_params(
        self, shape: Tuple[int, ...], boxes: Array, rng: np.random.Generator
    ) -> AugmentParams:
        """Draw all randomness against one reference frame's shape + boxes."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        photo = sample_photo(rng) if self.photometric else None
        h, w = shape[0], shape[1]
        ep = sample_expand(h, w, rng)
        if ep is not None:
            _, left, top = ep
            eboxes = boxes.copy()
            if len(eboxes):
                eboxes[:, 0::2] += left
                eboxes[:, 1::2] += top
            eshape = (int(h * ep[0]), int(w * ep[0]))
        else:
            eboxes, eshape = boxes, (h, w)
        rect = sample_crop_rect(eshape, eboxes, rng)
        return AugmentParams(photo, ep, rect, bool(rng.random() < 0.5))

    def apply(self, img: Array, boxes: Array, labels: Array, p: AugmentParams):
        """Deterministically apply a parameter draw to one frame."""
        import cv2

        img = img.astype(np.float32)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int32)

        if p.photo is not None:
            img = apply_photo(img, p.photo, inplace=True)  # img is our copy
        if p.expand is not None and p.crop_rect is not None:
            # Fused: materialize only the crop window of the expanded canvas
            # (bitwise-equal to expand-then-crop; see apply_expand_crop).
            img, boxes, labels = apply_expand_crop(
                img, boxes, labels, p.expand, p.crop_rect, self.mean
            )
        elif p.expand is not None:
            img, boxes = apply_expand(img, boxes, p.expand, self.mean)
        elif p.crop_rect is not None:
            img, boxes, labels = apply_crop(img, boxes, labels, p.crop_rect)
        if p.mirror:
            img, boxes = apply_mirror(img, boxes)

        h, w, _ = img.shape
        img = cv2.resize(img, (self.size, self.size)).astype(np.float32)
        img -= self.mean
        if len(boxes):
            boxes = boxes / np.asarray([w, h, w, h], np.float32)
            boxes = np.clip(boxes, 0.0, 1.0)
            # final degenerate filter (mirrors the crop-stage one)
            ok = ((boxes[:, 2] - boxes[:, 0]) >= 2.0 / self.size) & (
                (boxes[:, 3] - boxes[:, 1]) >= 2.0 / self.size
            )
            boxes, labels = boxes[ok], labels[ok]
        return img, boxes, labels

    def __call__(self, img: Array, boxes: Array, labels: Array,
                 rng: Optional[np.random.Generator] = None):
        rng = self.rng if rng is None else rng
        params = self.sample_params(img.shape, boxes, rng)
        return self.apply(img, boxes, labels, params)


class BaseTransform:
    """Eval/stream host-side preprocess (the reference's ``BaseTransform``):
    float32 resize and mean subtraction. The detectors preprocess on the
    device (``ops/preprocess.py``); this exists for parity and for host-side
    tooling."""

    def __init__(self, size: int, mean=(123.0, 117.0, 104.0)):
        self.size = size
        self.mean = mean

    def __call__(self, img: Array):
        import cv2

        out = cv2.resize(img.astype(np.float32), (self.size, self.size))
        return out - self.mean
