"""Typed detector configurations.

The port's own copy of ``tdrn_tpu/config.py``: the same frozen dataclass and
the same named geometries, field for field (tests/test_torch_port_geometry.py
holds them equal). RefineDet geometry: 4 detection scales, 3 anchors per cell
(aspect ratios {1, 2, 1/2}), variances (0.1, 0.2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

ScaleTuple = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static geometry + post-processing configuration for one detector variant."""

    name: str
    num_classes: int  # including background class 0
    size: int  # square input resolution
    feature_maps: ScaleTuple
    steps: ScaleTuple
    min_sizes: ScaleTuple
    aspect_ratios: Tuple[Tuple[float, ...], ...]  # extra ratios per scale (r and 1/r added)
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = True
    conf_thresh: float = 0.01
    nms_thresh: float = 0.45
    top_k: int = 200
    # Approximate candidate selection; the port supports only False (exact,
    # equal scores ranked lowest index first) and raises otherwise.
    approx_topk: bool = False
    # ARM->ODM decode + softmax + filter as one kernel emitting class-major
    # scores (ops/cascade.py); False = the plain decode_two_stage path.
    fused_cascade: bool = False
    # Image-wide top-M anchor cap before the per-class NMS (0 = off). Exact
    # whenever fewer than M anchors clear conf_thresh.
    prefilter_anchors: int = 0
    # < 1.0 selects an approximate prefilter; the port raises for it.
    prefilter_recall: float = 1.0
    # ARM negative-anchor filter threshold.
    arm_filter_thresh: float = 0.99
    # RGB pixel means subtracted by the preprocess.
    pixel_means: Tuple[float, float, float] = (123.0, 117.0, 104.0)
    seq_len: int = 8

    @property
    def anchors_per_cell(self) -> Tuple[int, ...]:
        return tuple(1 + 2 * len(ars) for ars in self.aspect_ratios)

    @property
    def num_priors(self) -> int:
        return sum(
            f * f * a for f, a in zip(self.feature_maps, self.anchors_per_cell)
        )


def _cfg(name: str, num_classes: int, size: int, **kw) -> DetectorConfig:
    if size == 320:
        geom = dict(
            feature_maps=(40, 20, 10, 5),
            steps=(8, 16, 32, 64),
            min_sizes=(32, 64, 128, 256),
            aspect_ratios=((2.0,), (2.0,), (2.0,), (2.0,)),
        )
    elif size == 512:
        geom = dict(
            feature_maps=(64, 32, 16, 8),
            steps=(8, 16, 32, 64),
            min_sizes=(32, 64, 128, 256),
            aspect_ratios=((2.0,), (2.0,), (2.0,), (2.0,)),
        )
    else:
        raise ValueError(f"unsupported size {size}")
    geom.update(kw)
    return DetectorConfig(name=name, num_classes=num_classes, size=size, **geom)


# Tiny config for tests: same 4-scale topology at 64x64.
TINY_64 = DetectorConfig(
    name="tiny_64",
    num_classes=4,
    size=64,
    feature_maps=(8, 4, 2, 1),
    steps=(8, 16, 32, 64),
    min_sizes=(8, 16, 32, 48),
    aspect_ratios=((2.0,), (2.0,), (2.0,), (2.0,)),
)

# Pascal VOC: 20 classes + background.
VOC_320 = _cfg("voc_320", num_classes=21, size=320)
VOC_512 = _cfg("voc_512", num_classes=21, size=512)

# ImageNet VID: 30 classes + background.
VID_320 = _cfg("vid_320", num_classes=31, size=320)
VID_512 = _cfg("vid_512", num_classes=31, size=512)

CONFIGS = {c.name: c for c in (VOC_320, VOC_512, VID_320, VID_512, TINY_64)}


def get_config(name: str) -> DetectorConfig:
    return CONFIGS[name]
