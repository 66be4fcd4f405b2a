"""Datasets, augmentation and the input pipeline (the port of
``tdrn_tpu/data``): the VOC and VID readers with their padded training
samples, the SSD augmentation, the prefetching loader and image
decode/encode/resize without OpenCV."""

from tdrn_tpu_torch.data.augment import BaseTransform, SSDAugmentation  # noqa: F401
from tdrn_tpu_torch.data.vid import VID_CLASSES, VIDDetection, collate_clips  # noqa: F401
from tdrn_tpu_torch.data.voc import (  # noqa: F401
    VOC_CLASSES,
    VOCDetection,
    collate_batch,
    pad_targets,
)
