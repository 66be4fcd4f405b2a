"""Pascal VOC detection dataset (the port of ``tdrn_tpu/data/voc.py``): the
class list, the annotation parser and ``VOCDetection`` over a VOCdevkit tree,
with its raw items (eval) and its *fixed-shape padded* training samples
(image (H, W, 3), boxes (G, 4) normalized xyxy, labels (G,), valid (G,)),
augmented by a transform (data/augment.py) with all randomness drawn from a
per-sample generator seeded by (seed, salt, index). Images are decoded by
data/image.py; ``collate_batch`` stacks samples into a batch."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, List, Optional, Sequence, Tuple

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

    image_sets: e.g. [("2007", "trainval"), ("2012", "trainval")] for
    training, [("2007", "test")] for eval. transform: (img, boxes, labels)
    -> (img, boxes01, labels), e.g. ``SSDAugmentation``, for the training
    samples.
    """

    def __init__(
        self,
        root: str,
        image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"), ("2012", "trainval")),
        transform: Optional[Callable] = None,
        keep_difficult: bool = False,
        max_gt: int = 60,
        seed: int = 0,
    ):
        self.root = root
        self.transform = transform
        self.keep_difficult = keep_difficult
        self.max_gt = max_gt
        self.seed = seed
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

    def sample_with_rng(self, index: int, rng: np.random.Generator):
        """One padded sample with all randomness drawn from ``rng`` (thread-
        safe: callers create a fresh generator per call)."""
        img, boxes, labels, _, _ = self.raw_item(index)
        if self.transform is not None:
            if hasattr(self.transform, "sample_params"):
                img, boxes01, labels = self.transform(img, boxes, labels, rng=rng)
            else:
                img, boxes01, labels = self.transform(img, boxes, labels)
        else:
            h, w, _ = img.shape
            boxes01 = boxes / np.asarray([w, h, w, h], np.float32)
        return pad_targets(img, boxes01, labels, self.max_gt)

    def sample(self, index: int, salt: int = 0):
        """Deterministic per-(seed, salt, index) sample; the loader passes the
        epoch as ``salt`` so augmentation varies across epochs."""
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, salt, index)))
        return self.sample_with_rng(index, rng)

    def __getitem__(self, index: int):
        """Fixed-shape padded sample for the train step."""
        return self.sample(index, 0)


def pad_targets(img: np.ndarray, boxes01: np.ndarray, labels: np.ndarray, max_gt: int):
    """Pad ragged GT to (max_gt, ...) + validity mask (the fixed-shape contract)."""
    g = min(len(boxes01), max_gt)
    b = np.zeros((max_gt, 4), np.float32)
    lab = np.zeros((max_gt,), np.int32)
    v = np.zeros((max_gt,), bool)
    if g:
        b[:g] = boxes01[:g]
        lab[:g] = labels[:g]
        v[:g] = True
    return img, b, lab, v


def collate_batch(samples):
    """Stack fixed-shape samples -> batch arrays (images float32)."""
    imgs, bs, ls, vs = zip(*samples)
    return (
        np.stack(imgs).astype(np.float32),
        np.stack(bs),
        np.stack(ls),
        np.stack(vs),
    )
