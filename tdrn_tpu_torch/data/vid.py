"""ImageNet VID dataset (the port of ``tdrn_tpu/data/vid.py``): the class
list, the per-frame annotation parser (with track ids) and ``VIDDetection``
over an ILSVRC2015 VID tree, with its frame loader (eval, motion breakdown)
and its fixed-shape padded training samples: single frames
(``mode="frame"``) or clips of ``seq_len`` consecutive frames of one
snippet (``mode="clip"``), augmented with one draw a clip. Images are
decoded by data/image.py; ``collate_clips`` stacks clips into the
(T, B, ...) layout of the clip train step."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, List, Optional, Tuple

import numpy as np

from tdrn_tpu_torch.data import image
from tdrn_tpu_torch.data.voc import pad_targets

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
    """ILSVRC VID dataset.

    mode="frame": a sample is one padded frame (like VOCDetection).
    mode="clip":  a sample is a (seq_len, ...) stack of consecutive frames of
                  one snippet (random start).
    root layout: <root>/Data/VID/<split>/... and <root>/Annotations/VID/<split>/...
    ``snippets`` lists (snippet dir, [frame stems]) in order, ``frames`` the
    flat (snippet dir, stem) pairs.
    """

    def __init__(
        self,
        root: str,
        split: str = "val",
        mode: str = "frame",
        seq_len: int = 8,
        transform: Optional[Callable] = None,
        max_gt: int = 60,
        seed: int = 0,
    ):
        if mode not in ("frame", "clip"):
            raise ValueError(f"mode must be 'frame' or 'clip', got {mode!r}")
        self.root = root
        self.split = split
        self.mode = mode
        self.seq_len = seq_len
        self.transform = transform
        self.max_gt = max_gt
        self.seed = seed
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
        return len(self.snippets) if self.mode == "clip" else len(self.frames)

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

    def _prepare(self, img, boxes, labels, rng: Optional[np.random.Generator] = None):
        if self.transform is not None:
            if rng is not None and hasattr(self.transform, "sample_params"):
                img, boxes01, labels = self.transform(img, boxes, labels, rng=rng)
            else:
                img, boxes01, labels = self.transform(img, boxes, labels)
        else:
            h, w, _ = img.shape
            boxes01 = boxes / np.asarray([w, h, w, h], np.float32)
        return pad_targets(img, boxes01, labels, self.max_gt)

    def sample_with_rng(self, index: int, rng: np.random.Generator):
        """One sample with all randomness drawn from ``rng`` (thread-safe:
        callers create a fresh generator per call)."""
        if self.mode == "frame":
            rel, stem = self.frames[index]
            return self._prepare(*self._load_frame(rel, stem), rng=rng)
        rel, stems = self.snippets[index]
        t = self.seq_len
        pad_from = None
        if len(stems) >= t:
            start = int(rng.integers(0, len(stems) - t + 1))
            chosen = stems[start:start + t]
        else:
            # A short snippet keeps the clip's (T, ...) shape by repeating its
            # last frame, and the repeats get all their GT marked invalid
            # below: a frame with no valid GT has no positives and so no mined
            # negatives, and trains nothing. The masked tail sits at the clip's
            # end, so its state updates never feed a loss-bearing frame.
            chosen = stems + [stems[-1]] * (t - len(stems))
            pad_from = len(stems)
        frames = [self._load_frame(rel, s) for s in chosen]
        if self.transform is not None and hasattr(self.transform, "sample_params"):
            # Clip-consistent augmentation: ONE draw (photometric, expand, crop
            # rect, mirror) for every frame. The IoU-constrained crop anchors
            # on the frame with the most GT; other frames keep the boxes that
            # survive it.
            ref = max(range(len(frames)), key=lambda i: len(frames[i][1]))
            params = self.transform.sample_params(frames[ref][0].shape, frames[ref][1], rng)
            samples = [pad_targets(*self.transform.apply(img, b, lab, params), self.max_gt)
                       for img, b, lab in frames]
        else:
            samples = [self._prepare(img, b, lab, rng=rng) for img, b, lab in frames]
        imgs, bs, ls, vs = zip(*samples)
        vs = np.stack(vs)
        if pad_from is not None:
            vs[pad_from:] = False  # the masked tail trains nothing
        return np.stack(imgs), np.stack(bs), np.stack(ls), vs

    def sample(self, index: int, salt: int = 0):
        """Deterministic per-(seed, salt, index) sample; the loader passes the
        epoch as ``salt`` so augmentation varies across epochs."""
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, salt, index)))
        return self.sample_with_rng(index, rng)

    def __getitem__(self, index: int):
        return self.sample(index, 0)


def collate_clips(samples):
    """Stack (T, ...) clip samples -> (T, B, ...) arrays (images float32)."""
    imgs, bs, ls, vs = zip(*samples)
    return (
        np.stack(imgs).swapaxes(0, 1).astype(np.float32),
        np.stack(bs).swapaxes(0, 1),
        np.stack(ls).swapaxes(0, 1),
        np.stack(vs).swapaxes(0, 1),
    )
