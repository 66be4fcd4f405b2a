"""Streaming inference (the port of ``tdrn_tpu/inference.py``).

One step per batch of frames: uint8 frames -> preprocess -> TDRN forward with
the per-stream temporal state that stays on the device -> detect_topk.
``StreamingDetector`` serves S independent streams in the lanes of one batch,
with per-stream reset and active masks.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np
import torch

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.models.detector import TDRN
from tdrn_tpu_torch.ops.detection import detect_topk
from tdrn_tpu_torch.ops.nms import TopDetections
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.ops.priors import prior_boxes


class StreamingDetector:
    """Stateful per-frame detector over S concurrent streams.

    detect(frames_u8) -> TopDetections with boxes (S,K,4) in [0,1] xyxy,
    scores (S,K) and classes (S,K).
    """

    def __init__(
        self,
        model: TDRN,
        num_streams: int = 1,
        top_k: Optional[int] = None,
        prefilter: Optional[int] = None,
        chunk: int = 1,
        device=None,
    ):
        """prefilter: image-wide anchor cap before the per-class NMS
        (cfg.prefilter_anchors); None keeps the config's setting.
        device: where the model and its state live (CUDA unless "cpu")."""
        if chunk != 1:
            raise NotImplementedError("chunk > 1 is not ported yet")
        self.device = _build.resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        if prefilter is not None:
            self.cfg = dataclasses.replace(self.cfg, prefilter_anchors=int(prefilter))
        self.num_streams = num_streams
        self.top_k = top_k or model.cfg.top_k
        self.priors = prior_boxes(self.cfg, self.device)
        self._reset_lock = threading.Lock()
        self._pending_reset: set = set()
        self._state = model.zero_state(num_streams) if model.temporal_enabled else None

    @property
    def state(self):
        """The carried per-scale state, (S, C, f, f) tensors (None if not temporal)."""
        return self._state

    def reset(self, stream_ids: Optional[List[int]] = None):
        """Mark streams for a state reset at the next frame (clip boundary).
        Safe against a concurrent detect(): a reset queued mid-step applies on
        the next step."""
        if stream_ids is None:
            stream_ids = list(range(self.num_streams))
        with self._reset_lock:
            self._pending_reset |= set(stream_ids)

    @torch.inference_mode()
    def _step(self, frames_u8, reset, active):
        x = preprocess_batch(frames_u8, self.cfg, self.model.dtype)
        state = self._state
        if state is not None:
            # Per-stream reset: zero this lane's carried features.
            keep = (1.0 - reset)[:, None, None, None]
            state = [s * keep.to(s.dtype) for s in state]
        preds, new_state = self.model(x, state)
        if state is not None:
            # Inactive lanes keep their post-reset state.
            a = (active > 0)[:, None, None, None]
            new_state = [torch.where(a, ns, s) for ns, s in zip(new_state, state)]
        return new_state, detect_topk(preds, self.priors, self.cfg, self.top_k)

    def detect(self, frames_u8, active=None) -> TopDetections:
        """frames_u8: (S, H, W, 3) uint8 RGB (numpy or tensor). active: optional
        (S,) 0/1 mask; lanes with 0 do not advance their state this step and
        their detections must be ignored."""
        with self._reset_lock:
            pending = self._pending_reset
            self._pending_reset = set()
        reset = np.zeros((self.num_streams,), np.float32)
        for i in pending:
            reset[i] = 1.0
        if active is None:
            active = np.ones((self.num_streams,), np.float32)
        try:
            frames = torch.as_tensor(frames_u8).to(self.device)
            if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[0] != self.num_streams:
                raise ValueError(
                    f"frames must be uint8 ({self.num_streams}, H, W, 3), got "
                    f"{frames.dtype} {tuple(frames.shape)}"
                )
            self._state, det = self._step(
                frames,
                torch.as_tensor(reset, device=self.device),
                torch.as_tensor(active, dtype=torch.float32).to(self.device),
            )
        except Exception:
            # A failed step must not swallow queued clip-boundary resets.
            with self._reset_lock:
                self._pending_reset |= pending
            raise
        return det


def make_single_image_forward(
    model: TDRN, top_k: Optional[int] = None, prefilter: Optional[int] = None
):
    """Single-image detect: (B, H, W, 3) uint8 -> TopDetections, zero state."""
    cfg = model.cfg
    if prefilter is not None:
        cfg = dataclasses.replace(cfg, prefilter_anchors=int(prefilter))
    k = top_k or cfg.top_k

    @torch.inference_mode()
    def run(images_u8: torch.Tensor) -> TopDetections:
        x = preprocess_batch(images_u8, cfg, model.dtype)
        state = model.zero_state(images_u8.shape[0]) if model.temporal_enabled else None
        preds, _ = model(x, state)
        return detect_topk(preds, prior_boxes(cfg, x.device), cfg, k)

    return run
