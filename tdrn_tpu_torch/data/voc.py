"""Pascal VOC detection dataset, the parts the eval and test CLIs read (the
port of ``tdrn_tpu/data/voc.py``): the class list, the annotation parser and
``VOCDetection``'s index of a VOCdevkit tree with its raw items. Images are
decoded by data/image.py. The padded training samples come with the input
pipeline."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from tdrn_tpu_torch.data import image

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

_CLASS_TO_IDX = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(path: str, keep_difficult: bool = False):
    """Parse one annotation file -> (boxes pixel xyxy (N,4) f32, labels (N,) i32,
    difficult (N,) bool)."""
    root = ET.parse(path).getroot()
    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        name = obj.find("name").text.lower().strip()
        if name not in _CLASS_TO_IDX:
            continue
        diff = int(obj.find("difficult").text) if obj.find("difficult") is not None else 0
        if diff and not keep_difficult:
            continue
        bb = obj.find("bndbox")
        # 0-based pixel coords (VOC's are 1-based)
        box = [
            float(bb.find("xmin").text) - 1,
            float(bb.find("ymin").text) - 1,
            float(bb.find("xmax").text) - 1,
            float(bb.find("ymax").text) - 1,
        ]
        boxes.append(box)
        labels.append(_CLASS_TO_IDX[name])
        difficult.append(bool(diff))
    return (
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32),
        np.asarray(difficult, bool),
    )


class VOCDetection:
    """VOC07+12-style dataset over a VOCdevkit root.

    image_sets: e.g. [("2007", "test")] for eval.
    """

    def __init__(
        self,
        root: str,
        image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"), ("2012", "trainval")),
        keep_difficult: bool = False,
    ):
        self.root = root
        self.keep_difficult = keep_difficult
        self.ids: List[Tuple[str, str]] = []
        for year, split in image_sets:
            base = os.path.join(root, f"VOC{year}")
            with open(os.path.join(base, "ImageSets", "Main", f"{split}.txt")) as f:
                for line in f:
                    self.ids.append((base, line.strip()))

    def __len__(self):
        return len(self.ids)

    def image_path(self, index: int) -> str:
        base, img_id = self.ids[index]
        return os.path.join(base, "JPEGImages", f"{img_id}.jpg")

    def raw_item(self, index: int):
        """(img uint8 RGB HWC, boxes pixel xyxy, labels, difficult, img_id)."""
        base, img_id = self.ids[index]
        img = image.imread(self.image_path(index))
        boxes, labels, difficult = parse_voc_xml(
            os.path.join(base, "Annotations", f"{img_id}.xml"), self.keep_difficult
        )
        return img, boxes, labels, difficult, img_id
