"""ImageNet VID dataset in frame mode, the parts the eval CLI and the motion
breakdown read (the port of ``tdrn_tpu/data/vid.py``): the class list, the
per-frame annotation parser (with track ids) and ``VIDDetection``'s index
of an ILSVRC2015 VID tree with its frame loader. Images are decoded by
data/image.py. Clip sampling comes with the input pipeline."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np

from tdrn_tpu_torch.data import image

# The 30 ImageNet VID classes: (wnid, human name).
VID_WNID_CLASSES = (
    ("n02691156", "airplane"), ("n02419796", "antelope"), ("n02131653", "bear"),
    ("n02834778", "bicycle"), ("n01503061", "bird"), ("n02924116", "bus"),
    ("n02958343", "car"), ("n02402425", "cattle"), ("n02084071", "dog"),
    ("n02121808", "domestic_cat"), ("n02503517", "elephant"), ("n02118333", "fox"),
    ("n02510455", "giant_panda"), ("n02342885", "hamster"), ("n02374451", "horse"),
    ("n02129165", "lion"), ("n01674464", "lizard"), ("n02484322", "monkey"),
    ("n03790512", "motorcycle"), ("n02324045", "rabbit"), ("n02509815", "red_panda"),
    ("n02411705", "sheep"), ("n01726692", "snake"), ("n02355227", "squirrel"),
    ("n02129604", "tiger"), ("n04468005", "train"), ("n01662784", "turtle"),
    ("n04530566", "watercraft"), ("n02062744", "whale"), ("n02391049", "zebra"),
)
VID_CLASSES = tuple(name for _, name in VID_WNID_CLASSES)
_WNID_TO_IDX = {wnid: i for i, (wnid, _) in enumerate(VID_WNID_CLASSES)}


def parse_vid_xml(path: str):
    """One VID frame annotation -> (boxes pixel xyxy, labels, track_ids)."""
    root = ET.parse(path).getroot()
    boxes, labels, tracks = [], [], []
    for obj in root.iter("object"):
        wnid = obj.find("name").text.strip()
        if wnid not in _WNID_TO_IDX:
            continue
        bb = obj.find("bndbox")
        boxes.append(
            [
                float(bb.find("xmin").text),
                float(bb.find("ymin").text),
                float(bb.find("xmax").text),
                float(bb.find("ymax").text),
            ]
        )
        labels.append(_WNID_TO_IDX[wnid])
        tid = obj.find("trackid")
        tracks.append(int(tid.text) if tid is not None else -1)
    return (
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32),
        np.asarray(tracks, np.int32),
    )


class VIDDetection:
    """ILSVRC VID dataset, frame mode.

    root layout: <root>/Data/VID/<split>/... and <root>/Annotations/VID/<split>/...
    ``snippets`` lists (snippet dir, [frame stems]) in order, ``frames`` the
    flat (snippet dir, stem) pairs.
    """

    def __init__(self, root: str, split: str = "val"):
        self.root = root
        self.split = split
        data_dir = os.path.join(root, "Data", "VID", split)
        self.snippets: List[Tuple[str, List[str]]] = []
        self.frames: List[Tuple[str, str]] = []
        for dirpath, _dirnames, filenames in sorted(os.walk(data_dir)):
            stems = sorted(os.path.splitext(f)[0] for f in filenames if f.endswith(".JPEG"))
            if not stems:
                continue
            rel = os.path.relpath(dirpath, data_dir)
            self.snippets.append((rel, stems))
            self.frames.extend((rel, s) for s in stems)

    def __len__(self):
        return len(self.frames)

    def _load_frame(self, rel: str, stem: str):
        """(img uint8 RGB HWC, boxes pixel xyxy, labels) of one frame."""
        img_path = os.path.join(self.root, "Data", "VID", self.split, rel, stem + ".JPEG")
        ann_path = os.path.join(
            self.root, "Annotations", "VID", self.split, rel, stem + ".xml"
        )
        img = image.imread(img_path)
        if os.path.exists(ann_path):
            boxes, labels, _ = parse_vid_xml(ann_path)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        return img, boxes, labels
