"""Datasets and host image I/O (the port of ``tdrn_tpu/data``): the VOC and
VID readers the CLIs use, and image decode/encode/resize without OpenCV."""

from tdrn_tpu_torch.data.vid import VID_CLASSES, VIDDetection  # noqa: F401
from tdrn_tpu_torch.data.voc import VOC_CLASSES, VOCDetection  # noqa: F401
